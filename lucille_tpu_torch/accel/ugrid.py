"""Uniform-grid accelerator: the host CSR build, the CUDA DDA walk's
wrappers and their plain torch twin.

Counterpart of lucille_tpu/accel/ugrid.py, the grid the reference's
`ri_ugrid_intersect` never traced (a stub, ugrid.c:376-385):

- `build_ugrid` is lucille_tpu's build, copied as it is (NumPy): each
  triangle's bounding box rasterized into the cells it overlaps, flattened
  into a CSR table (`cell_start` offsets into `tri_idx`), res ~ cbrt(2 N)
  capped at 64, the scene's box grown by a 1e-4 margin;
- `grid_packs` builds the walk's two packs of a built grid, once per
  scene beside the grid itself (scene/compile.py): the cell occupancy
  bitmask and the slot-order triangle pack;
- `closest_hit` and `any_hit` take the scene's grid (`grid_cell_start`,
  `grid_tri_idx`, `grid_box`, `grid_res`, the packs) and its triangle
  tables, launch csrc/ugrid.cu for CUDA tensors and run
  `grid_walk_reference` for CPU tensors.

The walk is a CUDA kernel, 1 or 8 lanes a ray (`group_lanes`), where
lucille_tpu runs a lock-step `lax.while_loop` over the wavefront that
ends on any(alive) (`_traverse`, :166-268).  In torch that loop reads
the device once a step to decide whether to go on, and a renderer tile
may not wait on the card; its alternative, a fixed trip count, would run
~3 res (1 + the largest cell's chunks) full-width steps for every
wavefront.  The kernel runs each ray's own walk to its end, which is
what the lock-step loop computes for it (csrc/ugrid.cu: empty cells
skipped on the occupancy bitmask, a cell's chunks tested by the group's
lanes together); `grid_walk_reference` is that loop, on the CPU (and on
the card only where chip_smoke.py holds the kernel against it).

Counters: `ntests` (triangle slots tested) and `ntrav` (cell advances)
are lucille_tpu's, the reference's ntesttris / ngridtravs; they depend on
each ray's walk alone and are held to lucille_tpu's exactly.  The closest
hit always counts (the renderer sums its counters); the any-hit only
when asked, as nothing on the render paths reads them.  Asked through
`grid_walk_kernel`, the kernel also reports its warps' own advance and
chunk steps (`warp_ntrav`, `warp_ntests`, csrc/ugrid.cu).  A ray that is
not active walks nothing and counts nothing (lucille_tpu's grid ignores
the mask and walks every lane).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lucille_tpu_torch.accel.isect import (
    NSTAT,
    mt_single,
    ray_limits,
    walk_stats,
)
from lucille_tpu_torch.base.timer import traced
from lucille_tpu_torch.kernels.build import LaunchCounts, check, library

K = 4  # triangles tested a step (4-wide packets, ugrid.c:657)
MAX_RES = 64  # the reference's grid resolution (ugrid.c GRIDSIZE)
BIG = 1.0e30
BLOCK = 128  # threads per CUDA block (csrc/ugrid.cu)
WARP = 32
# the walk's lanes a ray (`group_lanes`): 8 where the rays walk far (a
# grid of at least GROUP_RES cells an axis) and 8 lanes a ray leave
# room on the card (B x 8 <= GROUP_THREADS), else 1.  Both thresholds
# lie between H100 runs on either side of them (profile_lanes.py,
# PERF.md): 8 lanes lost on a 9^3 grid at 36,864-518,400 rays a launch
# and won on 17^3-64^3 grids at 16,384-65,536 (64^3 also at 131,044);
# at 262,144 they lost on 32^3 and 64^3
GROUP = 8
GROUP_RES = 12
GROUP_THREADS = 1 << 20

COUNTS = LaunchCounts()  # the closest hit
ANY_COUNTS = LaunchCounts()


@dataclass
class UGridData:
    cell_start: np.ndarray  # (res^3 + 1,) i32 CSR offsets
    tri_idx: np.ndarray  # (M,) i32 triangle ids, cell-major
    bbmin: np.ndarray  # (3,) f32 grid bounds (scene bbox + margin)
    bbmax: np.ndarray  # (3,) f32
    res: int  # cells per axis (cubic, like the reference)


def build_ugrid(v0, v1, v2, density: float = 2.0,
                max_res: int = MAX_RES) -> UGridData:
    """Host-side grid build: triangle-bbox rasterization into a CSR table
    (lucille_tpu/accel/ugrid.py:52-108)."""
    n = len(v0)
    allv = np.concatenate([v0, v1, v2]) if n else np.zeros((1, 3))
    bbmin = allv.min(axis=0).astype(np.float64)
    bbmax = allv.max(axis=0).astype(np.float64)
    diag = float(np.linalg.norm(bbmax - bbmin))
    margin = max(diag, 1.0) * 1.0e-4
    bbmin -= margin
    bbmax += margin
    res = int(np.clip(round((density * max(n, 1)) ** (1.0 / 3.0)), 2, max_res))
    w = (bbmax - bbmin) / res

    if n == 0:
        return UGridData(
            cell_start=np.zeros(res**3 + 1, np.int32),
            tri_idx=np.zeros(1, np.int32),
            bbmin=bbmin.astype(np.float32),
            bbmax=bbmax.astype(np.float32),
            res=res,
        )

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    lo = np.clip(((tmin - bbmin) / w).astype(np.int64), 0, res - 1)
    hi = np.clip(((tmax - bbmin) / w).astype(np.int64), 0, res - 1)

    cell_ids = []
    tri_ids = []
    for i in range(n):
        xs = np.arange(lo[i, 0], hi[i, 0] + 1)
        ys = np.arange(lo[i, 1], hi[i, 1] + 1)
        zs = np.arange(lo[i, 2], hi[i, 2] + 1)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        ids = (gx + res * (gy + res * gz)).ravel()
        cell_ids.append(ids)
        tri_ids.append(np.full(len(ids), i, dtype=np.int64))
    cell_ids = np.concatenate(cell_ids)
    tri_ids = np.concatenate(tri_ids)
    order = np.argsort(cell_ids, kind="stable")
    cell_ids = cell_ids[order]
    tri_ids = tri_ids[order]
    cell_start = np.searchsorted(
        cell_ids, np.arange(res**3 + 1, dtype=np.int64)
    ).astype(np.int32)
    return UGridData(
        cell_start=cell_start,
        tri_idx=tri_ids.astype(np.int32),
        bbmin=bbmin.astype(np.float32),
        bbmax=bbmax.astype(np.float32),
        res=res,
    )


def grid_packs(cell_start, tri_idx, v0, e1, e2):
    """The walk's packs of a built grid (NumPy, csrc/ugrid.cu): the cell
    occupancy bitmask, (ceil(res^3 / 32),) i32, cell c's bit at c % 32 of
    word c // 32, set where the cell lists a slot; and the slot-order
    triangle pack, (M, 12) f32, for each CSR slot j the triangle
    tri_idx[j] as three float4: v0 xyz with the id's bits in column 3,
    e1 xyz and 0, e2 xyz and 0."""
    cell_start = np.asarray(cell_start)
    full = cell_start[1:] > cell_start[:-1]
    bits = np.zeros(-(-len(full) // 32) * 32, dtype=bool)
    bits[:len(full)] = full
    occupied = np.packbits(bits, bitorder="little").view("<i4")
    ids = np.asarray(tri_idx, dtype=np.int32)
    tris = np.zeros((len(ids), 12), dtype=np.float32)
    tris[:, 0:3] = np.asarray(v0)[ids]
    tris[:, 3] = ids.view(np.float32)
    tris[:, 4:7] = np.asarray(e1)[ids]
    tris[:, 8:11] = np.asarray(e2)[ids]
    return occupied.astype(np.int32), tris


def group_lanes(scene, B: int) -> int:
    """Lanes a ray of the walk, 1 or GROUP, from static data alone
    (nothing read from the card): GROUP where the scene's grid has at
    least GROUP_RES cells an axis, so that a walk crosses many cells and
    the group's lanes test a cell's chunks together and skip its empty
    cells in one step, and B x GROUP <= GROUP_THREADS; else 1, where the
    walks are short or B rays already fill the card."""
    if scene.grid_res >= GROUP_RES and B * GROUP <= GROUP_THREADS:
        return GROUP
    return 1


def _check_inputs(scene, org, dirn):
    dev = scene.tri_v0.device
    for name, a, dtype in (
            ("tri_v0", scene.tri_v0, torch.float32),
            ("tri_e1", scene.tri_e1, torch.float32),
            ("tri_e2", scene.tri_e2, torch.float32),
            ("grid_cell_start", scene.grid_cell_start, torch.int32),
            ("grid_tri_idx", scene.grid_tri_idx, torch.int32),
            ("grid_box", scene.grid_box, torch.float32),
            ("grid_occupied", scene.grid_occupied, torch.int32),
            ("grid_tris", scene.grid_tris, torch.float32),
            ("org", org, torch.float32), ("dirn", dirn, torch.float32)):
        if a is None or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype}")
        if a.device != dev:
            raise ValueError(f"{name} on {a.device}, the scene on {dev}")
    res = scene.grid_res
    if res < 1 or tuple(scene.grid_cell_start.shape) != (res**3 + 1,):
        raise ValueError(f"grid_cell_start: need ({res}^3 + 1,) for res {res}")
    if tuple(scene.grid_occupied.shape) != (-(-res**3 // 32),):
        raise ValueError(f"grid_occupied: need (ceil({res}^3 / 32),)")
    if tuple(scene.grid_tris.shape) != (scene.grid_tri_idx.shape[0], 12):
        raise ValueError("grid_tris: need (M, 12), a row a slot")
    if tuple(scene.grid_box.shape) != (6,):
        raise ValueError("grid_box: need (6,) [bbmin | bbmax]")
    if org.dim() != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError(f"org/dirn: need (B, 3), got {tuple(org.shape)}, "
                         f"{tuple(dirn.shape)}")


def closest_hit(scene, org, dirn, tmax=None, active=None) -> dict:
    """Closest hit with 0 < t < tmax (None: unbounded, a float or (B,)) of
    rays org, dirn (B, 3) f32 through the scene's grid; active None or
    (B,) bool.  Returns {t, u, v (B,) f32, tri (B,) i32 (-1 on a miss),
    ntrav, ntests () i64}; a miss, and a ray that is not active, reports
    t +inf, u = v = 0, tri -1."""
    return _walk(scene, org, dirn, tmax, active, False, True)


def any_hit(scene, org, dirn, tmax=None, active=None,
            counters: bool = False) -> dict:
    """Whether each ray hits a triangle with 0 < t < tmax through the
    scene's grid: {occ (B,) bool (False for a ray that is not active)};
    with counters also ntrav, ntests () i64."""
    return _walk(scene, org, dirn, tmax, active, True, counters)


def _walk(scene, org, dirn, tmax, active, any_hit: bool,
          counters: bool) -> dict:
    _check_inputs(scene, org, dirn)
    if org.device.type == "cpu":
        res = grid_walk_reference(scene, org, dirn, tmax, active, any_hit)
        return res if counters else {"occ": res["occ"]}
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    return grid_walk_kernel(scene, org, dirn, tmax, active, any_hit,
                            counters, warp_steps=False)


@traced("accel.grid_walk_kernel")
def grid_walk_kernel(scene, org, dirn, tmax=None, active=None,
                     any_hit: bool = False, counters: bool = True,
                     warp_steps: bool = True) -> dict:
    """Launch csrc/ugrid.cu's closest hit (or with any_hit its any-hit) on
    the current stream (CUDA tensors only), `group_lanes` lanes a ray;
    results as closest_hit / any_hit, the counters only with `counters`
    (else the launch gets no stats buffer and counts nothing), and with
    `warp_steps` also the warps' own advance and chunk steps,
    warp_ntrav and warp_ntests (csrc/ugrid.cu)."""
    _check_inputs(scene, org, dirn)
    if org.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {org.device}")
    tmax = None if tmax is None else ray_limits(org, tmax)[0]
    active = ray_limits(org, None, active)[1]
    B, dev = org.shape[0], org.device
    lanes = group_lanes(scene, B)
    stats = None
    if counters:
        warps = -(-B * lanes // BLOCK) * (BLOCK // WARP)
        stats = torch.empty(NSTAT * warps, dtype=torch.int32, device=dev)
    grid = (scene.grid_tris.data_ptr(), scene.grid_cell_start.data_ptr(),
            scene.grid_occupied.data_ptr(), scene.grid_box.data_ptr(),
            scene.grid_res, lanes)
    rays = (org.data_ptr(), dirn.data_ptr(),
            None if tmax is None else tmax.data_ptr(),
            None if active is None else active.data_ptr(), B)
    stats_ptr = None if stats is None else stats.data_ptr()
    level = 0 if stats is None else (2 if warp_steps else 1)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if any_hit:
            occ = torch.empty(B, dtype=torch.bool, device=dev)
            err = lib.lt_grid_any_hit(*rays, *grid, occ.data_ptr(),
                                      stats_ptr, level, stream)
            out = {"occ": occ}
        else:
            out = {"t": torch.empty(B, dtype=torch.float32, device=dev),
                   "u": torch.empty(B, dtype=torch.float32, device=dev),
                   "v": torch.empty(B, dtype=torch.float32, device=dev),
                   "tri": torch.empty(B, dtype=torch.int32, device=dev)}
            err = lib.lt_grid_closest_hit(
                *rays, *grid, *(out[k].data_ptr() for k in "tuv"),
                out["tri"].data_ptr(), stats_ptr, level, stream)
    check("lt_grid_any_hit" if any_hit else "lt_grid_closest_hit", err)
    (ANY_COUNTS if any_hit else COUNTS).kernel += 1
    if stats is None:
        return out
    res = walk_stats(stats)
    if not warp_steps:
        del res["warp_ntrav"], res["warp_ntests"]
    return {**out, **res}


def _dda_init(scene, org, dirn):
    """Ray-vs-grid entry (lucille_tpu/accel/ugrid.py:_dda_init): (alive,
    cell (B, 3) i64, tmaxv (B, 3), tdelta (B, 3), step (B, 3) i64)."""
    res = scene.grid_res
    gmin, gmax = scene.grid_box[:3], scene.grid_box[3:]
    w = (gmax - gmin) / res
    safe = dirn.abs() > 1.0e-20
    invd = torch.where(safe, 1.0 / torch.where(safe, dirn, 1.0), BIG)
    t0 = (gmin - org) * invd
    t1 = (gmax - org) * invd
    tnear = torch.minimum(t0, t1).amax(dim=1)
    tfar = torch.maximum(t0, t1).amin(dim=1)
    alive = (tnear <= tfar) & (tfar > 0.0)
    t_enter = torch.clamp_min(tnear, 0.0)
    p = org + (t_enter + 1.0e-6)[:, None] * dirn
    cell = torch.clamp(torch.floor((p - gmin) / w), 0, res - 1).long()
    step = (dirn > 0).long() - (dirn < 0).long()
    next_b = gmin + (cell + (step > 0).long()).to(torch.float32) * w
    moving = step != 0
    tmaxv = torch.where(moving, (next_b - org) * invd, BIG)
    tdelta = torch.where(moving, w * invd.abs(), BIG)
    return alive, cell, tmaxv, tdelta, step


def _cell_range(scene, cell, reads=None, entering=None):
    """The CSR range [start, end) of each ray's cell; with `reads`, marks
    the two offsets read by the rays `entering` the cell."""
    res = scene.grid_res
    cid = cell[:, 0] + res * (cell[:, 1] + res * cell[:, 2])
    if reads is not None:
        reads["cell_start"][cid[entering]] = True
        reads["cell_start"][cid[entering] + 1] = True
    starts = scene.grid_cell_start.long()
    return starts[cid], starts[cid + 1]


@traced("accel.grid_walk_reference")
def grid_walk_reference(scene, org, dirn, tmax=None, active=None,
                        any_hit: bool = False, reads=None) -> dict:
    """Plain torch twin: lucille_tpu's lock-step walk (ugrid.py:166-268) of
    every live ray, a step testing a chunk of K triangles of the ray's
    cell or advancing it one cell, until no ray is alive; a walk ends
    after 4 res advances, as the kernel's does (csrc/ugrid.cu).  Results
    as closest_hit / any_hit.  With `reads` a dict, it also gets the
    walk's distinct reads as bool masks: "cell_start" over
    grid_cell_start, "tri_idx" over grid_tri_idx (the slots tested) and
    "tris" over the triangles (those tested), the bytes the walk must
    move (chip_smoke.grid_bound); and per ray, (B,) i64, "steps", its
    steps (chunks tested and advances), and "empty", its advances into a
    cell that lists no slot."""
    (ANY_COUNTS if any_hit else COUNTS).plain += 1
    B, dev = org.shape[0], org.device
    res = scene.grid_res
    t_cap, active = ray_limits(org, tmax, active)
    alive, cell, tmaxv, tdelta, step = _dda_init(scene, org, dirn)
    if active is not None:
        alive = alive & active
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    if reads is not None:
        reads.update({k: torch.zeros(n, dtype=torch.bool, device=dev)
                      for k, n in (("cell_start", res**3 + 1),
                                   ("tri_idx", scene.grid_tri_idx.numel()),
                                   ("tris", scene.tri_v0.shape[0]))})
        reads.update(steps=zero.clone(), empty=zero.clone())
    cursor, cend = _cell_range(scene, cell, reads, alive)
    cursor = torch.where(alive, cursor, zero)
    cend = torch.where(alive, cend, zero)
    tri_idx = scene.grid_tri_idx.long()
    M = tri_idx.shape[0]
    t = torch.full((B,), float("inf"), device=dev)
    u = torch.zeros(B, device=dev)
    v = torch.zeros(B, device=dev)
    tri = torch.full((B,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(B, dtype=torch.bool, device=dev)
    nadv = zero.clone()
    ntests = torch.zeros((), dtype=torch.int64, device=dev)
    ntrav = torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    while bool(alive.any()):
        if reads is not None:
            reads["steps"] += alive
        testing = alive & (cursor < cend)
        found = torch.zeros(B, dtype=torch.bool, device=dev)
        for k in range(K):
            j = cursor + k
            m = testing & (j < cend)
            ti = tri_idx[torch.clamp(j, 0, M - 1)]
            if reads is not None:
                reads["tri_idx"][j[m]] = True
                reads["tris"][ti[m]] = True
            tt, uu, vv, hh = mt_single(org, dirn, scene.tri_v0[ti],
                                        scene.tri_e1[ti], scene.tri_e2[ti])
            ok = m & hh & (tt > 0.0) & (tt < t) & (tt < t_cap)
            t = torch.where(ok, tt, t)
            u = torch.where(ok, uu, u)
            v = torch.where(ok, vv, v)
            tri = torch.where(ok, ti, tri)
            found = found | ok
        ntests = ntests + (torch.clamp(cend - cursor, 0, K) * testing).sum()
        cursor = torch.where(testing, cursor + K, cursor)

        adv = alive & ~testing
        tmin3 = tmaxv.amin(dim=1)
        settled = adv & ((t <= tmin3) | (tmin3 > t_cap))
        axis = torch.argmin(tmaxv, dim=1)  # the first among equal minima
        onehot = torch.zeros((B, 3), dtype=torch.bool, device=dev)
        onehot[rows, axis] = True
        moved_axis = onehot & adv[:, None]
        cell = torch.where(moved_axis, cell + step, cell)
        tmaxv = torch.where(moved_axis, tmaxv + tdelta, tmaxv)
        nadv = nadv + adv.long()
        out = ((cell < 0) | (cell >= res)).any(dim=1)
        alive_n = alive & ~(adv & (settled | out | (nadv >= 4 * res)))
        if any_hit:
            occ = occ | found
            alive_n = alive_n & ~found
        moved = adv & alive_n
        s2, e2 = _cell_range(scene, torch.clamp(cell, 0, res - 1), reads,
                             moved)
        if reads is not None:
            reads["empty"] += moved & (s2 == e2)
        cursor = torch.where(moved, s2, cursor)
        cend = torch.where(moved, e2, cend)
        ntrav = ntrav + adv.sum()
        alive = alive_n
    stats = {"ntrav": ntrav, "ntests": ntests}
    if any_hit:
        return {"occ": occ, **stats}
    return {"t": t, "u": u, "v": v, "tri": tri.to(torch.int32), **stats}
