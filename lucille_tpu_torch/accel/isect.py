"""Dense closest hit and any-hit: the CUDA kernels' wrappers and their
plain torch twins.

Counterparts of lucille_tpu/accel/pallas_isect.py:270-387
(`pallas_closest_hit`) and :472-552 (`pallas_any_hit`).  The kernels are
csrc/isect.cu; `closest_hit` and `any_hit` take the scene (its packs:
`tris`, `boxes`, `sboxes`, `sub_boxes` and `n_tris`), launch the kernels
for CUDA tensors and run `closest_hit_reference` / `any_hit_reference`
on the triangle pack for CPU tensors.  Both twins share the kernels'
Moller-Trumbore arithmetic (`_mt_tile`, with the division by the
determinant), not the BVH any-hit's division-free signed-volume test
(accel/bvh_isect.py).

The closest hit takes an optional per-ray `tmax` as the any-hit does (a
hit needs 0 < t < tmax; the dirt map's gather is bounded by its gather
distance), where lucille_tpu answers a bounded closest hit with its MXU
path (accel/dispatch.py:13-19, 37-42), which the port does not have.
A bounce wavefront passes its live-lane mask as `active` to either
kernel: a dead ray does no work and reports a miss (closest hit) or
False (any-hit), where lucille_tpu compacts the live rays to the front
(accel/dispatch.py:22-41); the twins trace the live rays alone.

When the rays alone cannot fill the card, the kernels split the
triangle range too (`split_layout`, chosen on the host from the ray
count, the scene's real tiles and the card's SM count).

Counters (the port's own definition; only nrays is held to lucille_tpu).
The kernels walk supertiles, tiles and 8-triangle groups, one walk a
warp: ``ntrav`` is group visits summed over the lanes that reach the
group's box, ``ntests`` real triangles tested summed over lanes; beside
them ``warp_ntrav`` and ``warp_ntests``, the warps' own group visits and
triangle steps (a step tests one triangle for every lane), so ntests /
(32 warp_ntests) is the walk's SIMT efficiency.  The closest hit always
counts (the renderer sums ntests and ntrav); the any-hit counts only
when asked (`counters=True`), since no render path reads its counters.
The twins visit no group (ntrav 0) and test every slot for every live
ray.
"""

from __future__ import annotations

import functools

import torch

from lucille_tpu_torch.accel.pack import SUB, SUPER, TC
from lucille_tpu_torch.kernels.build import LaunchCounts, check, library

DET_EPS = 1.0e-14  # the reference's |det| floor (bvh.c:746)
WARP = 32
BLOCK = 128  # rays per CUDA block (csrc/isect.cu)
NSTAT = 4  # a warp walk's counters per warp (csrc/isect.cu, csrc/bvh.cu)
# blocks of rays per SM below which the triangle range is split (twice
# what an SM holds at once: the split also shortens each warp's walk)
FILL = 32

COUNTS = LaunchCounts()  # the closest hit
ANY_COUNTS = LaunchCounts()


def walk_stats(stats: torch.Tensor) -> dict:
    """A warp walk's NSTAT counters, summed on the device (module
    docstring)."""
    s = stats.view(-1, NSTAT).sum(dim=0, dtype=torch.int64)
    return {"ntrav": s[0], "ntests": s[1], "warp_ntrav": s[2],
            "warp_ntests": s[3]}


def split_layout(B: int, n_tris: int, n_sms: int) -> tuple[int, int]:
    """(chunks, supertiles a chunk) for B rays on a scene of n_tris real
    triangles: one chunk when ceil(B / BLOCK) blocks reach FILL blocks an
    SM, else the real supertiles cut into about FILL * n_sms / blocks
    equal ranges along the grid's second dimension.  Shapes only, so
    nothing waits on the card."""
    n_super = -(-(-(-n_tris // TC)) // SUPER)
    blocks = max(1, -(-B // BLOCK))
    want = -(-FILL * n_sms // blocks)
    if n_super <= 1 or want <= 1:
        return 1, max(n_super, 1)
    per = -(-n_super // min(want, n_super))
    return -(-n_super // per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_inputs(scene, org, dirn):
    """The scene's packs as accel/pack builds them (scene/types), and the
    rays beside them."""
    tris = scene.tris
    dev = tris.device
    for name, a in (("tris", tris), ("boxes", scene.boxes),
                    ("sboxes", scene.sboxes), ("sub_boxes", scene.sub_boxes),
                    ("org", org), ("dirn", dirn)):
        if a is None or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32")
        if a.device != dev:
            raise ValueError(f"{name} on {a.device}, tris on {dev}")
    if tris.dim() != 2 or tris.shape[0] != 16 or tris.shape[1] % TC:
        raise ValueError(f"tris: need (16, k*{TC}), got {tuple(tris.shape)}")
    npad = tris.shape[1]
    n_tiles = npad // TC
    for name, a, n in (("boxes", scene.boxes, n_tiles),
                       ("sboxes", scene.sboxes, -(-n_tiles // SUPER)),
                       ("sub_boxes", scene.sub_boxes, npad // SUB)):
        if tuple(a.shape) != (8, n):
            raise ValueError(f"{name}: need (8, {n}), got {tuple(a.shape)}")
    if not 0 <= scene.n_tris <= npad:
        raise ValueError(f"n_tris {scene.n_tris} outside [0, {npad}]")
    if tris.data_ptr() % 16:
        raise ValueError("tris: the kernels read 16-byte words")
    if org.dim() != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError(f"org/dirn: need (B, 3), got {tuple(org.shape)}, "
                         f"{tuple(dirn.shape)}")


def closest_hit(scene, org, dirn, tmax=None, active=None) -> dict:
    """Closest hit with 0 < t < tmax of rays org, dirn (B, 3) f32 against
    the scene's dense packs; tmax None (unbounded), a float or (B,);
    active None or (B,) bool, the live rays of a bounce wavefront.
    Returns {t, u, v (B,) f32, tri (B,) i32 (-1 on a miss), ntrav, ntests
    () i64}, from the kernel also warp_ntrav and warp_ntests; a miss, and
    a ray that is not active, reports t +inf, u = v = 0, tri -1."""
    _check_inputs(scene, org, dirn)
    if org.device.type == "cpu":
        return closest_hit_reference(scene.tris, org, dirn, tmax, active)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    return closest_hit_kernel(scene, org, dirn, tmax, active)


def _layout(scene, org, counters: bool = True):
    """(chunks, supertiles a chunk, stats buffer or None) of a launch."""
    B, dev = org.shape[0], org.device
    chunks, per = split_layout(B, scene.n_tris, _sm_count(dev.index))
    if not counters:
        return chunks, per, None
    n_warps = -(-B // BLOCK) * (BLOCK // WARP)
    stats = torch.empty(NSTAT * chunks * n_warps, dtype=torch.int32,
                        device=dev)
    return chunks, per, stats


def _scene_args(scene) -> tuple:
    """The packs' pointers and sizes in lt_closest_hit's order."""
    return (scene.tris.data_ptr(), scene.tris.shape[1], scene.n_tris,
            scene.boxes.data_ptr(), scene.boxes.shape[1],
            scene.sboxes.data_ptr(), scene.sboxes.shape[1],
            scene.sub_boxes.data_ptr())


def closest_hit_kernel(scene, org, dirn, tmax=None, active=None) -> dict:
    """Launch csrc/isect.cu's closest hit on the current stream (CUDA
    tensors only); tmax None passes no bound to the kernel."""
    _check_inputs(scene, org, dirn)
    if org.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {org.device}")
    active = ray_limits(org, None, active)[1]
    if tmax is not None:
        tmax = ray_limits(org, tmax)[0]
    B = org.shape[0]
    dev = org.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    u = torch.empty(B, dtype=torch.float32, device=dev)
    v = torch.empty(B, dtype=torch.float32, device=dev)
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    chunks, per, stats = _layout(scene, org)
    keys = torch.empty(B if chunks > 1 else 0, dtype=torch.int64, device=dev)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lt_closest_hit(
            org.data_ptr(), dirn.data_ptr(),
            None if tmax is None else tmax.data_ptr(),
            None if active is None else active.data_ptr(), B,
            *_scene_args(scene), chunks, per, t.data_ptr(), u.data_ptr(),
            v.data_ptr(), tri.data_ptr(),
            keys.data_ptr() if chunks > 1 else None, stats.data_ptr(), stream,
        )
    check("lt_closest_hit", err)
    COUNTS.kernel += 1
    return {"t": t, "u": u, "v": v, "tri": tri, **walk_stats(stats)}


def _plain_stats(tris, org, active) -> dict:
    """The twins' counters: no group visited, every slot tested by every
    live ray."""
    n_live = (torch.tensor(org.shape[0], device=org.device) if active is None
              else active.sum())
    return {"ntrav": torch.zeros((), dtype=torch.int64, device=org.device),
            "ntests": n_live.to(torch.int64) * tris.shape[1]}


def closest_hit_reference(tris, org, dirn, tmax=None, active=None,
                          ray_chunk: int = 65536) -> dict:
    """Plain torch twin: every live ray against every tile, t_best
    starting at its tmax (None: unbounded, a float or (B,)), the tile's
    Moller-Trumbore chain in the kernel's operation order, the lowest
    index among equal t (argmin takes the first minimum within a tile,
    the strict t < t_best across tiles); a miss, and a ray that is not
    active, reports t +inf, u = v = 0, tri -1."""
    COUNTS.plain += 1
    tmax, active = ray_limits(org, tmax, active)
    res = live_scan(lambda o, d, tm: closest_scan(tris, o, d, tm, ray_chunk),
                    org, dirn, tmax, active,
                    {"t": float("inf"), "u": 0.0, "v": 0.0, "tri": -1})
    res["t"] = torch.where(res["tri"] >= 0, res["t"], float("inf"))
    return {**res, **_plain_stats(tris, org, active)}


def _mt_tile(tile, o, d):
    """Moller-Trumbore of rays o, d (each a list of three (b, 1) columns)
    against one (16, TC) tile [v0 | e1 | e2] in the kernels' operation
    order: (valid |det| > DET_EPS, u, v, t), each (b, TC)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tile[r][None, :] for r in range(9)
    )
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    valid = a.abs() > DET_EPS
    inva = torch.where(valid, 1.0 / torch.where(valid, a, 1.0), 0.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    u = (sx * px + sy * py + sz * pz) * inva
    v = (qx * dx + qy * dy + qz * dz) * inva
    t = (e2x * qx + e2y * qy + e2z * qz) * inva
    return valid, u, v, t


def _hit(valid, u, v, t, t_lim):
    """The kernels' hit test, 0 < t < t_lim ((b, 1))."""
    return (valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 0.0) & (t < t_lim))


def mt_single(org, dirn, v0, e1, e2):
    """Moller-Trumbore, one gathered triangle per ray, all (B, 3), in the
    kernels' operation order (lucille_tpu/accel/ugrid.py:_mt_single):
    (t, u, v, hit) with hit |det| > DET_EPS, u, v >= 0, u + v <= 1; the
    grid walk's twin (accel/ugrid.py) and `bvh_diag` (accel/traverse.py)
    test t themselves."""
    ox, oy, oz = org.unbind(1)
    dx, dy, dz = dirn.unbind(1)
    v0x, v0y, v0z = v0.unbind(1)
    e1x, e1y, e1z = e1.unbind(1)
    e2x, e2y, e2z = e2.unbind(1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    valid = a.abs() > DET_EPS
    inva = torch.where(valid, 1.0 / torch.where(valid, a, 1.0), 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    u = (sx * px + sy * py + sz * pz) * inva
    v = (qx * dx + qy * dy + qz * dz) * inva
    t = (e2x * qx + e2y * qy + e2z * qz) * inva
    hit = valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def closest_scan(tris, org, dirn, tmax, ray_chunk: int = 65536) -> dict:
    """Nearest hit of every ray over every triangle with 0 < t < tmax
    (B,), the lowest index winning a tie: {t (tmax on a miss), u, v,
    tri (-1 on a miss)}.  The arithmetic of closest_hit_reference; the
    tile-BVH twin shares it."""
    B = org.shape[0]
    n_tiles = tris.shape[1] // TC
    dev = org.device
    t_all = tmax.clone()
    u_all = torch.zeros(B, device=dev)
    v_all = torch.zeros(B, device=dev)
    tri_all = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for lo in range(0, B, ray_chunk):
        hi = min(B, lo + ray_chunk)
        o = [org[lo:hi, c : c + 1] for c in range(3)]  # (b, 1)
        d = [dirn[lo:hi, c : c + 1] for c in range(3)]
        t_best = t_all[lo:hi]
        u_best = u_all[lo:hi]
        v_best = v_all[lo:hi]
        tri_best = tri_all[lo:hi]
        for k in range(n_tiles):
            valid, u, v, t = _mt_tile(tris[:, k * TC : (k + 1) * TC], o, d)
            hit = _hit(valid, u, v, t, t_best[:, None])
            t_m = torch.where(hit, t, float("inf"))
            tc, j = torch.min(t_m, dim=1)  # first index among equal minima
            better = tc < t_best
            rows = torch.arange(hi - lo, device=dev)
            t_best.copy_(torch.where(better, tc, t_best))
            u_best.copy_(torch.where(better, u[rows, j], u_best))
            v_best.copy_(torch.where(better, v[rows, j], v_best))
            tri_best.copy_(torch.where(better, (j + k * TC).to(torch.int32),
                                       tri_best))
    return {"t": t_all, "u": u_all, "v": v_all, "tri": tri_all}


def live_scan(scan, org, dirn, tmax, active, dead: dict) -> dict:
    """scan(org, dirn, tmax) -> {name: (n,) tensor} run on the live rays
    only (every ray when active is None); a dead ray's entries are the
    `dead` fill values."""
    if active is None:
        return scan(org, dirn, tmax)
    live = torch.nonzero(active)[:, 0]
    got = scan(org[live], dirn[live], tmax[live])
    out = {}
    for k, v in got.items():
        full = torch.full((org.shape[0],), dead[k], dtype=v.dtype,
                          device=v.device)
        full[live] = v
        out[k] = full
    return out


def ray_limits(org, tmax, active=None):
    """tmax None (unbounded), a float or (B,) -> contiguous (B,) f32;
    active None or (B,) bool -> contiguous (B,) bool or None."""
    B, dev = org.shape[0], org.device
    if tmax is None:
        tmax = torch.full((B,), float("inf"), device=dev)
    else:
        tmax = torch.broadcast_to(
            torch.as_tensor(tmax, dtype=torch.float32, device=dev), (B,)
        ).contiguous()
    if active is not None:
        if active.dtype != torch.bool or tuple(active.shape) != (B,):
            raise ValueError(f"active: need ({B},) bool, got "
                             f"{tuple(active.shape)} {active.dtype}")
        if active.device != dev:
            raise ValueError(f"active on {active.device}, rays on {dev}")
        active = active.contiguous()
    return tmax, active


def any_hit(scene, org, dirn, tmax=None, active=None,
            counters: bool = False) -> dict:
    """Whether rays org, dirn (B, 3) f32 hit a triangle of the scene's
    dense packs with 0 < t < tmax (None: unbounded, a float or (B,));
    active None or (B,) bool.  Returns {occ (B,) bool (False for a ray
    that is not active)}; with counters also ntrav, ntests () i64, from
    the kernel warp_ntrav and warp_ntests too."""
    _check_inputs(scene, org, dirn)
    tmax, active = ray_limits(org, tmax, active)
    if org.device.type == "cpu":
        res = any_hit_reference(scene.tris, org, dirn, tmax, active)
        if counters:
            res.update(_plain_stats(scene.tris, org, active))
        return res
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    return any_hit_kernel(scene, org, dirn, tmax, active, counters)


def any_hit_kernel(scene, org, dirn, tmax, active=None,
                   counters: bool = False) -> dict:
    """Launch csrc/isect.cu's any-hit on the current stream (CUDA tensors
    only); tmax (B,) f32, active None or (B,) bool; the walk's counters
    only when asked (any_hit)."""
    _check_inputs(scene, org, dirn)
    if org.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {org.device}")
    tmax, active = ray_limits(org, tmax, active)
    B = org.shape[0]
    dev = org.device
    occ = torch.empty(B, dtype=torch.bool, device=dev)
    chunks, per, stats = _layout(scene, org, counters)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lt_any_hit(
            org.data_ptr(), dirn.data_ptr(), tmax.data_ptr(),
            None if active is None else active.data_ptr(), B,
            *_scene_args(scene), chunks, per, occ.data_ptr(),
            None if stats is None else stats.data_ptr(), stream,
        )
    check("lt_any_hit", err)
    ANY_COUNTS.kernel += 1
    return {"occ": occ} if stats is None else {"occ": occ,
                                                **walk_stats(stats)}


def any_hit_reference(tris, org, dirn, tmax, active=None,
                      ray_chunk: int = 65536) -> dict:
    """Plain torch twin of the any-hit: every ray against every triangle
    with the kernel's Moller-Trumbore test and 0 < t < tmax (B,), an
    any-reduce over the triangles; inactive rays report False."""
    ANY_COUNTS.plain += 1
    B = org.shape[0]
    occ = torch.zeros(B, dtype=torch.bool, device=org.device)
    for lo in range(0, B, ray_chunk):
        hi = min(B, lo + ray_chunk)
        o = [org[lo:hi, c : c + 1] for c in range(3)]  # (b, 1)
        d = [dirn[lo:hi, c : c + 1] for c in range(3)]
        t_lim = tmax[lo:hi, None]
        for k in range(tris.shape[1] // TC):
            valid, u, v, t = _mt_tile(tris[:, k * TC : (k + 1) * TC], o, d)
            occ[lo:hi] |= _hit(valid, u, v, t, t_lim).any(dim=1)
    if active is not None:
        occ &= active
    return {"occ": occ}
