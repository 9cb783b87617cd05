"""Fused AO occlusion gather: lane ordering, the CUDA kernel's wrapper and
its plain torch twin.

Counterpart of lucille_tpu/accel/pallas_ao.py:453-681, both outputs.
Hit lanes are compacted to the front in the JAX package's exact order —
a stable hit-first partition below 8 triangle tiles, the stable
(normal octant, Morton cell) sort from 8 tiles — because the per-lane
jitter is indexed by compacted slot: slot j reads jitter[:, j].  The
counts are scattered back to raster order.

`ao_occlusion_bits` (pallas_ao_occlusion_bits) returns, beside the
counts, which strata are occluded — ceil(S/32) int32 rows, bit s % 32 of
row s // 32 for stratum s — and the jitter, both scattered back to
raster order, so that the sunsky gather can recompute each stratum's
direction (`stratum_directions`, the kernel's own formula) and weight
the open ones by the sky.

The kernel is csrc/ao.cu; `ao_occlusion` and `ao_occlusion_bits` launch
it for CUDA tensors, laid out by `gather_layout`, and run
`ao_occlusion_reference` on the compacted hit lanes for CPU tensors.
The packs they read are the scene's own (`scene.occ`, `scene.boxes`,
`scene.sboxes`, `scene.sub_boxes`, built once in
scene/types.from_numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from lucille_tpu_torch.accel.isect import DET_EPS
from lucille_tpu_torch.accel.pack import SUB, TC
from lucille_tpu_torch.base.timer import traced
from lucille_tpu_torch.kernels.build import LaunchCounts, check, library

R2_A1 = 0.7548776662466927  # R2 additive-recurrence constants (plastic
R2_A2 = 0.5698402909980532  # number alpha, alpha^2), rounded to f32 in use
STRATUM_CULL_MIN_TILES = 8  # lucille_tpu's switch to the Morton lane order
# lucille_tpu runs the fused gather on scenes of at most this many (padded)
# triangles (pallas_ao.py:102, its VMEM budget); above it its sunsky gather
# scans the strata with another jitter, which the port does not copy
MAX_TRIS_FOR_MEGAKERNEL = 131072
AO_BLOCK = 128  # threads a block of csrc/ao.cu
NSTAT = 7  # the kernel's counters per warp (gather_stats)

COUNTS = LaunchCounts()  # the counts alone
BITS_COUNTS = LaunchCounts()  # the counts with the per-stratum bits


def partition_order(hit: torch.Tensor):
    """Stable partition of lane indices, hit lanes first.  Returns
    (order (B,) i64, nhit () i32): lane order[j] fills compacted slot j."""
    hit_i = hit.to(torch.int32)
    nhit = hit_i.sum(dtype=torch.int32)
    pos = torch.where(hit, torch.cumsum(hit_i, 0) - 1,
                      nhit + torch.cumsum(1 - hit_i, 0) - 1)
    order = torch.empty_like(pos, dtype=torch.int64)
    order[pos.long()] = torch.arange(hit.shape[0], device=hit.device)
    return order, nhit


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Interleave the low 8 bits of x with two zero bits (i32)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def compaction_order(bbox_min, bbox_max, P_off, b2, hit, n_tri_tiles: int):
    """Lane order for the compaction step (pallas_ao.py:462-489).  Below
    STRATUM_CULL_MIN_TILES tiles: `partition_order`.  From there, hit
    lanes are sorted stably by (shading-normal octant, Morton cell of the
    shading point) so neighbouring slots hold nearby origins."""
    if n_tri_tiles < STRATUM_CULL_MIN_TILES:
        return partition_order(hit)
    ext = torch.clamp_min(bbox_max - bbox_min, 1e-12)
    q = ((P_off - bbox_min) / ext * 256.0).to(torch.int32).clamp(0, 255)
    morton = ((_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1)
              | _spread3(q[:, 2]))
    octant = ((b2[:, 0] > 0).to(torch.int32) * 4
              + (b2[:, 1] > 0).to(torch.int32) * 2
              + (b2[:, 2] > 0).to(torch.int32))
    key = torch.where(hit, octant * (1 << 24) + morton,
                      torch.full_like(morton, 1 << 29))
    order = torch.sort(key, stable=True).indices
    return order, hit.to(torch.int32).sum(dtype=torch.int32)


def _gather(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int, nphi: int,
            want_bits: bool):
    """The compacted gather: (order, occ (B,) and, with want_bits, bits
    (ceil(S/32), B) i32, both in compacted order)."""
    B = P_off.shape[0]
    if tuple(jitter.shape) != (2, B) or jitter.dtype != torch.float32:
        raise ValueError(f"jitter: need (2, {B}) f32, got "
                         f"{tuple(jitter.shape)} {jitter.dtype}")
    if ntheta < 1 or nphi < 1:
        raise ValueError(f"ntheta, nphi must be >= 1, got {ntheta}, {nphi}")
    order, nhit = compaction_order(scene.bbox_min, scene.bbox_max, P_off, b2,
                                   hit, scene.boxes.shape[1])
    rays = torch.cat([P_off, b0, b1, b2], dim=1)[order].T.contiguous()
    jitter = jitter.contiguous()
    dev = P_off.device
    if dev.type == "cuda":
        out = ao_occlusion_kernel(scene, rays, jitter, nhit, ntheta, nphi,
                                  want_bits)
    elif dev.type == "cpu":
        n = int(nhit)
        ref = ao_occlusion_reference(scene.occ, rays[:, :n], jitter[:, :n],
                                     ntheta, nphi, want_bits=want_bits)
        occ = torch.zeros(B, device=dev)
        if want_bits:
            occ[:n] = ref[0]
            bits = torch.zeros((ref[1].shape[0], B), dtype=torch.int32,
                               device=dev)
            bits[:, :n] = ref[1]
            out = (occ, bits)
        else:
            occ[:n] = ref
            out = occ
    else:
        raise ValueError(f"unsupported device {dev}")
    return order, out


def ao_occlusion(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                 nphi: int) -> torch.Tensor:
    """Occlusion counts for a wavefront of primary hits.

    P_off, b0, b1, b2: (B, 3) f32 offset shading points and orthonormal
    basis (b2 = shading normal); hit: (B,) bool; jitter: (2, B) f32
    uniforms, column j belonging to compacted slot j.  Returns (B,) f32:
    how many of the ntheta * nphi strata are occluded (0 where not hit)."""
    order, occ_sorted = _gather(scene, P_off, b0, b1, b2, hit, jitter,
                                ntheta, nphi, False)
    occ = torch.empty_like(occ_sorted)
    occ[order] = occ_sorted
    return occ


def ao_occlusion_bits(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                      nphi: int):
    """The gather with its per-stratum output (pallas_ao_occlusion_bits,
    pallas_ao.py:557-571,667-681).  Operands as ao_occlusion.  Returns
    (occ (B,) f32, bits (ceil(S/32), B) i32, u01 (2, B) f32), all in
    raster order: bit s % 32 of bits[s // 32, b] is set when stratum s of
    lane b is occluded (0 where not hit), and u01[:, b] is the jitter
    column lane b's strata were drawn from (the column of its compacted
    slot)."""
    order, (occ_sorted, bits_sorted) = _gather(
        scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi, True)
    occ = torch.empty_like(occ_sorted)
    occ[order] = occ_sorted
    bits = torch.empty_like(bits_sorted)
    bits[:, order] = bits_sorted
    u01 = torch.empty_like(jitter)
    u01[:, order] = jitter
    return occ, bits, u01


def gather_layout(S: int, B: int) -> tuple[int, int, int]:
    """csrc/ao.cu's launch for S strata and B lanes: (C strata a thread, T
    threads a lane, blocks of AO_BLOCK threads).  A lane's strata are cut
    into chunks of C (4 up to 16 strata, else 16: C divides 32, so a chunk
    never straddles two bits rows); its T threads take chunks t, t + T,
    t + 2T, ...  T is a power of two, the least that covers the chunks in
    one round, at most 32.  A block holds AO_BLOCK / T lanes, each warp one chunk of
    neighbouring lanes."""
    C = 4 if S <= 16 else 16
    T = 1
    while T < 32 and T * C < S:
        T *= 2
    return C, T, -(-B * T // AO_BLOCK)


def gather_stats(stats: torch.Tensor) -> dict:
    """The gather's NSTAT counters a warp, summed on the device:
    supertile, tile, quarter-tile and group box tests (a stratum against a
    box), triangle set-ups, (triangle, stratum) tests, and the warps' test
    steps."""
    s = stats.view(-1, NSTAT).sum(dim=0, dtype=torch.int64)
    return {"super_tests": s[0], "tile_tests": s[1], "quarter_tests": s[2],
            "group_tests": s[3], "setups": s[4], "tests": s[5],
            "warp_steps": s[6]}


@traced("accel.ao_occlusion_kernel")
def ao_occlusion_kernel(scene, rays, jitter, nact, ntheta: int, nphi: int,
                        want_bits: bool = False, counters: bool = False):
    """Launch csrc/ao.cu on the current stream (CUDA tensors only).

    scene: a dense scene, whose packs (occ, boxes, sboxes, sub_boxes) the
    kernel reads, the first n_tris columns of occ its real triangles;
    rays (12, B) [P_off | b0 | b1 | b2] in compacted order, jitter (2, B),
    nact () i32 on the device (lanes at or past it report 0).  Returns
    occ (B,) f32, or (occ, bits (ceil(S/32), B) i32) with want_bits, in
    compacted order; with counters, (that, `gather_stats`'s dict), the
    counters read nowhere on the render paths."""
    B = rays.shape[1]
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    tris, boxes, sboxes, sub = (scene.occ, scene.boxes, scene.sboxes,
                                scene.sub_boxes)
    for name, a in (("occ", tris), ("boxes", boxes), ("sboxes", sboxes),
                    ("sub_boxes", sub), ("rays", rays), ("jitter", jitter)):
        if (a is None or a.dtype != torch.float32 or not a.is_contiguous()
                or a.device != dev):
            raise ValueError(f"{name}: need contiguous float32 on {dev}")
    if (tris.shape[0] != 16 or tris.shape[1] != boxes.shape[1] * TC
            or sub.shape[1] * SUB != tris.shape[1]):
        raise ValueError(f"occ {tuple(tris.shape)} / boxes "
                         f"{tuple(boxes.shape)} / sub_boxes "
                         f"{tuple(sub.shape)} mismatch")
    if tris.data_ptr() % 16 or sub.data_ptr() % 16:
        raise ValueError("occ, sub_boxes: the kernel reads them 16 bytes at "
                         "a time and needs them 16-byte aligned")
    n_tris = scene.n_tris
    if not 0 <= n_tris <= tris.shape[1]:
        raise ValueError(f"n_tris {n_tris} outside 0..{tris.shape[1]}")
    if rays.shape[0] != 12 or tuple(jitter.shape) != (2, B):
        raise ValueError(f"rays {tuple(rays.shape)} / jitter "
                         f"{tuple(jitter.shape)} mismatch")
    if nact.dtype != torch.int32 or nact.numel() != 1 or nact.device != dev:
        raise ValueError("nact: need one int32 on the rays' device")
    occ = torch.empty(B, dtype=torch.float32, device=dev)
    bits = (torch.empty((-(-ntheta * nphi // 32), B), dtype=torch.int32,
                        device=dev) if want_bits else None)
    chunk, tpl, grid = gather_layout(ntheta * nphi, B)
    stats = (torch.zeros(NSTAT * grid * (AO_BLOCK // 32), dtype=torch.int32,
                         device=dev) if counters else None)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lt_ao_occlusion(
            rays.data_ptr(), jitter.data_ptr(), B, nact.data_ptr(),
            tris.data_ptr(), tris.shape[1], n_tris, boxes.data_ptr(),
            boxes.shape[1], sboxes.data_ptr(), sboxes.shape[1],
            sub.data_ptr(), ntheta, nphi, 1.0 / ntheta, 1.0 / nphi, chunk,
            tpl, grid, occ.data_ptr(),
            None if bits is None else bits.data_ptr(),
            None if stats is None else stats.data_ptr(), stream,
        )
    check("lt_ao_occlusion", err)
    (BITS_COUNTS if want_bits else COUNTS).kernel += 1
    out = (occ, bits) if want_bits else occ
    return (out, gather_stats(stats)) if counters else out


def stratum_directions(b0, b1, b2, u01, ntheta: int, nphi: int):
    """The kernel's stratified cosine directions (pallas_ao.py:172-194),
    every stratum of every lane at once: (S, n, 3) f32 for lanes with
    basis b0, b1, b2 (n, 3) and uniforms u01 (2, n).  Stratum s shifts the
    lane's pair by the R2 Cranley-Patterson offsets frac(s * a1),
    frac(s * a2) and maps it into cell (s % ntheta, s // ntheta):
    cos_t = sqrt(z0), phi = 2 pi z1, lz = sqrt(max(1 - z0, 0)).  Every
    operation rounds in f32 as the kernel's does."""
    S = ntheta * nphi
    dev = b0.device
    s = torch.arange(S, dtype=torch.float32, device=dev)
    sh0 = s * R2_A1
    sh0 = sh0 - torch.floor(sh0)
    sh1 = s * R2_A2
    sh1 = sh1 - torch.floor(sh1)
    u0 = u01[0][None, :] + sh0[:, None]
    u0 = u0 - torch.floor(u0)
    u1 = u01[1][None, :] + sh1[:, None]
    u1 = u1 - torch.floor(u1)
    si = torch.arange(S, dtype=torch.int32, device=dev)
    fi = (si % ntheta).to(torch.float32)
    fj = (si // ntheta).to(torch.float32)
    z0 = (fi[:, None] + u0) * (1.0 / ntheta)
    z1 = (fj[:, None] + u1) * (1.0 / nphi)
    cos_t = torch.sqrt(z0)
    phi = (2.0 * np.pi) * z1
    lx = torch.cos(phi) * cos_t
    ly = torch.sin(phi) * cos_t
    lz = torch.sqrt(torch.clamp_min(1.0 - z0, 0.0))
    return (lx[..., None] * b0[None] + ly[..., None] * b1[None]
            + lz[..., None] * b2[None])


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """(S, n) bool per-stratum flags -> (ceil(S/32), n) i32 rows, bit
    s % 32 of row s // 32 for stratum s."""
    S, n = flags.shape
    rows = -(-S // 32)
    f = torch.zeros((rows * 32, n), dtype=torch.int64, device=flags.device)
    f[:S] = flags.to(torch.int64)
    weight = torch.ones(32, dtype=torch.int64, device=flags.device) << (
        torch.arange(32, device=flags.device))
    words = (f.reshape(rows, 32, n) * weight[None, :, None]).sum(dim=1)
    # the unsigned 32-bit word as the int32 with the same bits
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def unpack_bits(bits: torch.Tensor, S: int) -> torch.Tensor:
    """(ceil(S/32), n) i32 rows -> (S, n) bool flags (pack_bits' inverse)."""
    s = torch.arange(S, device=bits.device)
    return ((bits[s // 32] >> (s % 32)[:, None].to(torch.int32)) & 1) == 1


@traced("accel.ao_occlusion_reference")
def ao_occlusion_reference(tris, rays, u01, ntheta: int, nphi: int,
                           lane_chunk: int = 16384, want_bits: bool = False):
    """Plain torch twin for lanes that all hit: rays (12, n) [P_off | b0 |
    b1 | b2], u01 (2, n) each lane's own uniforms.  Every stratum against
    every triangle with the signed-volume test in the kernel's operation
    order (occlusion_test_reference, pallas_ao.py:428-450).  Returns (n,)
    f32 occluded-stratum counts, or with want_bits (counts, (ceil(S/32),
    n) i32 bits)."""
    (BITS_COUNTS if want_bits else COUNTS).plain += 1
    n = rays.shape[1]
    S = ntheta * nphi
    n_tiles = tris.shape[1] // TC
    occluded = torch.zeros((S, n), dtype=torch.bool, device=rays.device)
    for lo in range(0, n, lane_chunk):
        hi = min(n, lo + lane_chunk)
        ox, oy, oz = (rays[c, lo:hi][None, :] for c in range(3))
        dirs = stratum_directions(*(rays[3 * c : 3 * c + 3, lo:hi].T
                                    for c in (1, 2, 3)),
                                  u01[:, lo:hi], ntheta, nphi)
        for k in range(n_tiles):
            tile = tris[:, k * TC : (k + 1) * TC]
            col = [tile[r][:, None] for r in range(12)]  # (TC, 1)
            pax, pay, paz = col[0] - ox, col[1] - oy, col[2] - oz
            pbx, pby, pbz = col[3] - ox, col[4] - oy, col[5] - oz
            pcx, pcy, pcz = col[6] - ox, col[7] - oy, col[8] - oz
            nx, ny, nz = col[9], col[10], col[11]
            cbcx = pby * pcz - pbz * pcy
            cbcy = pbz * pcx - pbx * pcz
            cbcz = pbx * pcy - pby * pcx
            ccax = pcy * paz - pcz * pay
            ccay = pcz * pax - pcx * paz
            ccaz = pcx * pay - pcy * pax
            s_n = pax * nx + pay * ny + paz * nz
            for s in range(S):
                dx, dy, dz = (dirs[s, :, c][None, :] for c in range(3))
                U = dx * cbcx + dy * cbcy + dz * cbcz
                V = dx * ccax + dy * ccay + dz * ccaz
                dn = dx * nx + dy * ny + dz * nz
                W = dn - U - V
                inside = ((torch.minimum(torch.minimum(U, V), W) >= 0.0)
                          | (torch.maximum(torch.maximum(U, V), W) <= 0.0))
                hit = inside & (s_n * dn > 0.0) & (dn.abs() > DET_EPS)
                occluded[s, lo:hi] |= hit.any(dim=0)
    counts = occluded.sum(dim=0).to(torch.float32)
    return (counts, pack_bits(occluded)) if want_bits else counts
