"""Tile-BVH closest hit and any-hit: the CUDA kernels' wrappers and their
plain torch twins.

Counterparts of lucille_tpu/accel/pallas_bvh.py:310-590
(`_bvh_closest_kernel`, `pallas_bvh_closest_hit`) and :598-807
(`_bvh_anyhit_kernel`, `pallas_bvh_any_hit`).  The kernels are
csrc/bvh.cu; `bvh_closest_hit` and `bvh_any_hit` launch them for CUDA
tensors and run `bvh_closest_hit_reference` / `bvh_any_hit_reference`
for CPU tensors.  The twins walk no tree: they test every triangle, with
the kernels' arithmetic, so they answer the same question by the plain
route.  Hits and occlusion do not depend on the order triangles are
tested in; a triangle id can differ only at an exact tie in t across two
leaves, where the kernel keeps the one it visited first and the twin the
lowest slot.

Counters (the port's own definition; only nrays is held to lucille_tpu).
The closest hit (a warp a ray, csrc/bvh.cu): ``ntrav`` is node visits
summed over rays, ``ntests`` real triangles tested (a leaf's
``leaf_real``, no padding) summed over rays; ``warp_ntrav`` and
``warp_ntests`` are the warps' own node visits (a warp's are its ray's)
and leaf chunk steps (a step tests up to 32 triangles), so ntests / (32
warp_ntests) is the SIMT efficiency in the leaves.  The any-hit (one
walk a warp of 32 rays): ``ntrav`` is node visits summed over the lanes
that reach the node, ``ntests`` real triangles tested summed over
lanes; ``warp_ntrav`` and ``warp_ntests`` are the warps' own node visits
and triangle steps (a step tests one leaf triangle for every lane that
still needs it), so ntests / (32 warp_ntests) is the walk's SIMT
efficiency.  ``nmiss`` is 0, because the kernels read triangles from HBM
through L2 and keep no tile cache whose misses lucille_tpu's counter
would count.  The twins visit no node (ntrav 0) and test every slot for
every ray.
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel.isect import (
    DET_EPS,
    NSTAT,
    closest_scan,
    live_scan,
    ray_limits,
    walk_stats,
)
from lucille_tpu_torch.accel.pack import TC
from lucille_tpu_torch.base.timer import traced
from lucille_tpu_torch.device import host_sync
from lucille_tpu_torch.kernels.build import LaunchCounts, check, library

STACK = 64  # stack entries of csrc/bvh.cu's walks (per thread or warp)
BLOCK = 128  # threads per CUDA block
WARP = 32  # lanes a ray in the closest hit, rays a walk in the any-hit

CLOSEST_COUNTS = LaunchCounts()
ANY_COUNTS = LaunchCounts()


def _inputs(tris, nodes, org, dirn, tmax, depth):
    """Checks the operands; returns tmax as a (B,) f32 tensor."""
    dev = tris.device
    for name, a in (("tris", tris), ("nodes", nodes), ("org", org),
                    ("dirn", dirn)):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32, got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"{name} on {a.device}, tris on {dev}")
    if tris.dim() != 2 or tris.shape[0] != 16 or tris.shape[1] % TC:
        raise ValueError(f"tris: need (16, k*{TC}), got {tuple(tris.shape)}")
    if nodes.dim() != 2 or nodes.shape[1] != 8:
        raise ValueError(f"nodes: need (M, 8), got {tuple(nodes.shape)}")
    if org.dim() != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError(f"org/dirn: need (B, 3), got {tuple(org.shape)}, "
                         f"{tuple(dirn.shape)}")
    if depth > STACK:
        raise ValueError(f"tree depth {depth} exceeds the kernels' "
                         f"{STACK}-entry stack")
    return ray_limits(org, tmax)[0]


def _launch(name, dev, *args):
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
    check(name, err)


def check_leaf_real(leaf_real, nodes) -> None:
    """The kernels' real-triangle count per leaf: (M,) int32 beside the
    node pack (scene.leaf_real)."""
    if (leaf_real is None or leaf_real.dtype != torch.int32
            or leaf_real.device != nodes.device
            or tuple(leaf_real.shape) != (nodes.shape[0],)):
        raise ValueError(f"leaf_real: need ({nodes.shape[0]},) int32 on "
                         f"{nodes.device}")


@traced("accel.bvh_closest_hit")
def bvh_closest_hit(tris, nodes, org, dirn, tmax=None, active=None, *,
                    depth: int, leaf_real=None) -> dict:
    """tris (16, Npad) [v0|e1|e2] from pack_tris, nodes (M, 8) from
    pack_nodes with the tree's depth; org, dirn (B, 3) f32; tmax None
    (unbounded), a float or (B,); active None or (B,) bool, the live rays
    of a bounce wavefront; leaf_real (M,) int32, each leaf's real
    triangles (scene.leaf_real), which the kernel needs.  Returns {t
    (tmax on a miss), u, v (B,) f32, tri (B,) i32 slot (-1 on a miss),
    ntrav, ntests () i64}, from the kernel also warp_ntrav and
    warp_ntests; a ray that is not active walks nothing and reports a
    miss."""
    tmax = _inputs(tris, nodes, org, dirn, tmax, depth)
    active = ray_limits(org, None, active)[1]
    if org.device.type == "cpu":
        return bvh_closest_hit_reference(tris, org, dirn, tmax, active)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    check_leaf_real(leaf_real, nodes)
    B = org.shape[0]
    dev = org.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    u = torch.empty(B, dtype=torch.float32, device=dev)
    v = torch.empty(B, dtype=torch.float32, device=dev)
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    stats = torch.empty(NSTAT * B, dtype=torch.int32, device=dev)
    _launch("lt_bvh_closest_hit", dev, org.data_ptr(), dirn.data_ptr(),
            tmax.data_ptr(), None if active is None else active.data_ptr(),
            B, tris.data_ptr(), tris.shape[1], nodes.data_ptr(),
            leaf_real.data_ptr(), depth, t.data_ptr(), u.data_ptr(),
            v.data_ptr(), tri.data_ptr(), stats.data_ptr())
    CLOSEST_COUNTS.kernel += 1
    return {"t": t, "u": u, "v": v, "tri": tri, **walk_stats(stats)}


@traced("accel.bvh_any_hit")
def bvh_any_hit(tris, nodes, org, dirn, tmax=None, *, depth: int,
                leaf_real=None) -> dict:
    """Operands as bvh_closest_hit; leaf_real (M,) int32, each leaf's
    real triangles (scene.leaf_real), which the kernel needs.  Returns
    {occ (B,) bool: some triangle is hit with 0 < t < tmax, ntrav, ntests
    () i64}, from the kernel also warp_ntrav and warp_ntests."""
    tmax = _inputs(tris, nodes, org, dirn, tmax, depth)
    if org.device.type == "cpu":
        return bvh_any_hit_reference(tris, org, dirn, tmax)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    check_leaf_real(leaf_real, nodes)
    B = org.shape[0]
    dev = org.device
    occ = torch.empty(B, dtype=torch.bool, device=dev)
    stats = torch.empty(NSTAT * -(-B // BLOCK) * (BLOCK // WARP),
                        dtype=torch.int32, device=dev)
    _launch("lt_bvh_any_hit", dev, org.data_ptr(), dirn.data_ptr(),
            tmax.data_ptr(), B, tris.data_ptr(), tris.shape[1],
            nodes.data_ptr(), leaf_real.data_ptr(), occ.data_ptr(),
            stats.data_ptr())
    ANY_COUNTS.kernel += 1
    return {"occ": occ, **walk_stats(stats)}


def _plain_stats(tris, B, dev) -> dict:
    return {"ntrav": torch.zeros((), dtype=torch.int64, device=dev),
            "ntests": torch.tensor(B * tris.shape[1], dtype=torch.int64,
                                   device=dev)}


@traced("accel.bvh_closest_hit_reference")
def bvh_closest_hit_reference(tris, org, dirn, tmax, active=None,
                              ray_chunk: int = 65536) -> dict:
    """Plain torch twin of the closest hit: every live ray against every
    triangle (isect.closest_scan), t_best starting at tmax (B,); the
    lowest slot wins a tie; a dead ray reports a miss at its tmax."""
    CLOSEST_COUNTS.plain += 1
    res = live_scan(lambda o, d, tm: closest_scan(tris, o, d, tm, ray_chunk),
                    org, dirn, tmax, active,
                    {"t": 0.0, "u": 0.0, "v": 0.0, "tri": -1})
    if active is not None:
        res["t"] = torch.where(active, res["t"], tmax)
    n_live = (org.shape[0] if active is None
              else host_sync(int, active.sum()))
    return {**res, **_plain_stats(tris, n_live, org.device)}


@traced("accel.bvh_any_hit_reference")
def bvh_any_hit_reference(tris, org, dirn, tmax,
                          ray_chunk: int = 65536) -> dict:
    """Plain torch twin of the any-hit: every ray against every triangle
    with the kernel's division-free signed-volume test, in its operation
    order (pallas_bvh.py:648-672)."""
    ANY_COUNTS.plain += 1
    occ = occlusion_scan(tris, org, dirn, tmax, ray_chunk)
    return {"occ": occ, **_plain_stats(tris, org.shape[0], org.device)}


def occlusion_scan(tris, org, dirn, tmax=None,
                   ray_chunk: int = 65536) -> torch.Tensor:
    """(B,) bool: some triangle of the pack is hit by the division-free
    signed-volume test with 0 < t < tmax (B,), or with 0 < t when tmax
    is None (the fused AO gather's unbounded test, pallas_bvh.py:889-917).
    The arithmetic of both any-hit twins, in the kernels' operation
    order (pallas_bvh.py:648-672)."""
    B = org.shape[0]
    occ = torch.zeros(B, dtype=torch.bool, device=org.device)
    for lo in range(0, B, ray_chunk):
        hi = min(B, lo + ray_chunk)
        ox, oy, oz = (org[lo:hi, c : c + 1] for c in range(3))
        dx, dy, dz = (dirn[lo:hi, c : c + 1] for c in range(3))
        for k in range(tris.shape[1] // TC):
            tile = tris[:, k * TC : (k + 1) * TC]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tile[r][None, :] for r in range(9)
            )
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            a = e1x * px + e1y * py + e1z * pz
            sx = ox - v0x
            sy = oy - v0y
            sz = oz - v0z
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            u = sx * px + sy * py + sz * pz
            v = qx * dx + qy * dy + qz * dz
            w = a - u - v
            t = e2x * qx + e2y * qy + e2z * qz
            inside = ((torch.minimum(torch.minimum(u, v), w) >= 0.0)
                      | (torch.maximum(torch.maximum(u, v), w) <= 0.0))
            ta = t * a
            hit = inside & (ta > 0.0) & (a.abs() > DET_EPS)
            if tmax is not None:
                hit &= ta < tmax[lo:hi, None] * (a * a)
            occ[lo:hi] |= hit.any(dim=1)
    return occ
