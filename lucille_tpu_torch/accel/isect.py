"""Dense closest hit and any-hit: the CUDA kernels' wrappers and their
plain torch twins.

Counterparts of lucille_tpu/accel/pallas_isect.py:270-387
(`pallas_closest_hit`) and :472-552 (`pallas_any_hit`).  The kernels are
csrc/isect.cu; `closest_hit` and `any_hit` launch them for CUDA tensors
and run `closest_hit_reference` / `any_hit_reference` for CPU tensors.
Both twins share the kernels' Moller-Trumbore arithmetic (`_mt_tile`,
with the division by the determinant), not the BVH any-hit's
division-free signed-volume test (accel/bvh_isect.py).

A bounce wavefront passes its live-lane mask as `active` to either
kernel: a dead ray does no work and reports a miss (closest hit) or
False (any-hit), where lucille_tpu compacts the live rays to the front
(accel/dispatch.py:22-41); the twins trace the live rays alone.

Counters (the port's own definition; only nrays is held to lucille_tpu):
``ntrav`` is the number of (warp of 32 rays, 128-triangle tile) pairs
tested by the closest hit, ``ntests`` = ntrav * 128 * 32 ray-triangle
tests.  The kernel skips a tile for a warp none of whose rays reaches
the tile's box; the plain twin skips nothing, so it reports every pair.
The any-hit counts nothing, as lucille_tpu's does not.
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel.pack import TC
from lucille_tpu_torch.kernels.build import LaunchCounts, check, library

DET_EPS = 1.0e-14  # the reference's |det| floor (bvh.c:746)
WARP = 32
BLOCK = 256  # rays per CUDA block (csrc/isect.cu)

COUNTS = LaunchCounts()  # the closest hit
ANY_COUNTS = LaunchCounts()


def _check_inputs(tris, boxes, org, dirn):
    dev = tris.device
    for name, a in (("tris", tris), ("boxes", boxes), ("org", org),
                    ("dirn", dirn)):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32, got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"{name} on {a.device}, tris on {dev}")
    if tris.dim() != 2 or tris.shape[0] != 16 or tris.shape[1] % TC:
        raise ValueError(f"tris: need (16, k*{TC}), got {tuple(tris.shape)}")
    if tuple(boxes.shape) != (8, tris.shape[1] // TC):
        raise ValueError(f"boxes: need (8, {tris.shape[1] // TC}), "
                         f"got {tuple(boxes.shape)}")
    if org.dim() != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError(f"org/dirn: need (B, 3), got {tuple(org.shape)}, "
                         f"{tuple(dirn.shape)}")


def closest_hit(tris, boxes, org, dirn, active=None) -> dict:
    """tris (16, Npad) [v0|e1|e2] and boxes (8, n_tiles) from accel/pack;
    org, dirn (B, 3) f32; active None or (B,) bool, the live rays of a
    bounce wavefront.  Returns {t, u, v (B,) f32, tri (B,) i32 (-1 on a
    miss), ntrav () i64}; a ray that is not active reports a miss (t
    +inf, u = v = 0, tri -1)."""
    _check_inputs(tris, boxes, org, dirn)
    active = ray_limits(org, None, active)[1]
    if org.device.type == "cpu":
        return closest_hit_reference(tris, org, dirn, active)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    return closest_hit_kernel(tris, boxes, org, dirn, active)


def closest_hit_kernel(tris, boxes, org, dirn, active=None) -> dict:
    """Launch csrc/isect.cu on the current stream (CUDA tensors only)."""
    _check_inputs(tris, boxes, org, dirn)
    if org.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {org.device}")
    active = ray_limits(org, None, active)[1]
    B = org.shape[0]
    dev = org.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    u = torch.empty(B, dtype=torch.float32, device=dev)
    v = torch.empty(B, dtype=torch.float32, device=dev)
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    n_blocks = -(-B // BLOCK)
    ntile = torch.empty(n_blocks * (BLOCK // WARP), dtype=torch.int32,
                        device=dev)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lt_closest_hit(
            org.data_ptr(), dirn.data_ptr(),
            None if active is None else active.data_ptr(), B, tris.data_ptr(),
            tris.shape[1], boxes.data_ptr(), boxes.shape[1], t.data_ptr(),
            u.data_ptr(), v.data_ptr(), tri.data_ptr(), ntile.data_ptr(),
            stream,
        )
    check("lt_closest_hit", err)
    COUNTS.kernel += 1
    return {"t": t, "u": u, "v": v, "tri": tri,
            "ntrav": ntile.sum(dtype=torch.int64)}


def closest_hit_reference(tris, org, dirn, active=None,
                          ray_chunk: int = 65536) -> dict:
    """Plain torch twin: every live ray against every tile, the tile's
    Moller-Trumbore chain in the kernel's operation order, the lowest
    index among equal t (argmin takes the first minimum within a tile,
    the strict t < t_best across tiles); a ray that is not active
    reports a miss."""
    COUNTS.plain += 1
    B = org.shape[0]
    inf = torch.full((B,), float("inf"), device=org.device)
    res = live_scan(lambda o, d, tm: closest_scan(tris, o, d, tm, ray_chunk),
                    org, dirn, inf, active,
                    {"t": float("inf"), "u": 0.0, "v": 0.0, "tri": -1})
    n_warps = -(-B // WARP)
    res["ntrav"] = torch.tensor(n_warps * (tris.shape[1] // TC),
                                dtype=torch.int64, device=org.device)
    return res


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


def any_hit(tris, boxes, org, dirn, tmax=None, active=None) -> dict:
    """tris (16, Npad) [v0|e1|e2] and boxes (8, n_tiles) from accel/pack;
    org, dirn (B, 3) f32; tmax None (unbounded), a float or (B,); active
    None or (B,) bool.  Returns {occ (B,) bool: some triangle is hit with
    0 < t < tmax; False for a ray that is not active}."""
    _check_inputs(tris, boxes, org, dirn)
    tmax, active = ray_limits(org, tmax, active)
    if org.device.type == "cpu":
        return any_hit_reference(tris, org, dirn, tmax, active)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    return any_hit_kernel(tris, boxes, org, dirn, tmax, active)


def any_hit_kernel(tris, boxes, org, dirn, tmax, active=None) -> dict:
    """Launch csrc/isect.cu's any-hit on the current stream (CUDA tensors
    only); tmax (B,) f32, active None or (B,) bool."""
    _check_inputs(tris, boxes, org, dirn)
    if org.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {org.device}")
    tmax, active = ray_limits(org, tmax, active)
    B = org.shape[0]
    dev = org.device
    occ = torch.empty(B, dtype=torch.bool, device=dev)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lt_any_hit(
            org.data_ptr(), dirn.data_ptr(), tmax.data_ptr(),
            None if active is None else active.data_ptr(), B,
            tris.data_ptr(), tris.shape[1], boxes.data_ptr(), boxes.shape[1],
            occ.data_ptr(), stream,
        )
    check("lt_any_hit", err)
    ANY_COUNTS.kernel += 1
    return {"occ": occ}


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
