"""The roofline yardstick: the work a kernel's inputs need, and the
least time the card could take for it.

Frozen copies of chip_smoke.py at commit d8e7cf1, so that a later change
to the program cannot move them:

- the peaks and the f32 operations a test costs (chip_smoke.py:334-348);
- `bound` (chip_smoke.py:927-934);
- `tiles_reached` (chip_smoke.py:937-949);
- `gather_need` (chip_smoke.py:1160-1230), the dense AO gather's needed
  box and triangle tests, its strata's directions from the benchmark's
  own `reference.ao.stratum_directions`;
- `need_walk` (chip_smoke.py:1363-1517), the tile BVH's needed node
  visits and triangle tests;
- `reached_bytes` (chip_smoke.py:2048-2052).

They count the need of the data (each ray's tests up to its first
occluder), not the work a kernel happens to do, so a roofline read from
them stays the same whatever implements the kernel.  The packs they read
(`scene.occ`, `scene.boxes`, `scene.sub_boxes`; the tile BVH's `tris`
and `nodes`) are the kernel's own inputs, in the layout of d8e7cf1: TC
triangles a tile, SUB a group.
"""

from __future__ import annotations

from reference.ao import DET_EPS, stratum_directions

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): f32 outside
# the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations: a Moller-Trumbore test, the signed-volume test, one
# (stratum, triangle) test of the AO gather, a ray against a box, a
# tile-BVH node visit (two child boxes and the ordering)
MT_OPS, SV_OPS, AO_OPS, SLAB_OPS, NODE_OPS = 56, 58, 30, 25, 56
TC = 128  # triangles a tile of the dense packs
SUB = 8  # triangles a group box of the dense gather
N_NEED = 65536  # rays on which need_walk counts a tile-BVH gather's work


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def tiles_reached(boxes, org, dirn, tmax):
    """(B, n_tiles) bool: the ray reaches the tile's box before tmax (the
    kernels' slab test).  A tile of padding alone (an empty box, min +inf
    and max -inf) is never reached: no ray needs it."""
    import torch

    inv = 1.0 / torch.where(dirn.abs() > 1e-20, dirn, 1e-20)
    lo = (boxes[0:3].T[None] - org[:, None]) * inv[:, None]
    hi = (boxes[3:6].T[None] - org[:, None]) * inv[:, None]
    tn = torch.minimum(lo, hi).amax(dim=-1)
    tf = torch.maximum(lo, hi).amin(dim=-1)
    filled = (boxes[0:3] <= boxes[3:6]).all(dim=0)[None]
    return filled & (tn <= tf) & (tf > 0) & (tn < tmax[:, None])


def gather_need(scene, P_off, b0, b1, b2, u01, ntheta: int, nphi: int,
                budget: int = 1 << 24) -> dict:
    """The work the dense AO gather needs on hit lanes P_off, b0, b1, b2
    (n, 3) with uniforms u01 (2, n) at ntheta x nphi strata, counted at
    the grain csrc/ao.cu proves is enough: each stratum's ray walks the
    scene's real triangles in slot order, up to and including its first
    occluder (all of them when it is open); it tests the box of each tile
    it reaches, the box of each SUB-triangle group that holds a real
    triangle in a tile it reaches, and each real triangle of a group whose
    box it reaches.  Works on about `budget` (ray, group) pairs at a time.
    Returns {"tiles", "groups", "tests": those counts (Python ints),
    "occluded": (S, n) bool, the strata that have an occluder}."""
    import torch


    n, S, n_tris = P_off.shape[0], ntheta * nphi, scene.n_tris
    n_real, n_groups = -(-n_tris // TC), -(-n_tris // SUB)
    dev = P_off.device
    occ = scene.occ[:, :n_tris]
    tile_of = torch.arange(n_groups, device=dev) // (TC // SUB)
    k = torch.arange(n_real, device=dev)
    g_lo = k * (TC // SUB)
    g_hi = torch.clamp_max(g_lo + TC // SUB - 1, n_groups - 1)
    in_group = torch.arange(SUB, device=dev)
    none = scene.n_pad  # past every slot: an open stratum walks them all
    tiles = groups = tests = 0
    occluded = torch.zeros((S, n), dtype=torch.bool, device=dev)
    step = max(1, budget // (S * max(n_groups, 1)))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        d = stratum_directions(b0[lo:hi], b1[lo:hi], b2[lo:hi], u01[:, lo:hi],
                               ntheta, nphi).reshape(-1, 3)  # row s * m + l
        o = P_off[lo:hi].repeat(S, 1)
        far = torch.full((o.shape[0],), float("inf"), device=dev)
        t_reach = tiles_reached(scene.boxes[:, :n_real], o, d, far)
        g_reach = tiles_reached(scene.sub_boxes[:, :n_groups], o, d,
                                far) & t_reach[:, tile_of]
        ray, grp = torch.nonzero(g_reach, as_tuple=True)
        j = grp[:, None] * SUB + in_group  # (pairs, SUB) slots
        real = j < n_tris
        col = occ[:, torch.clamp_max(j, n_tris - 1)]  # (16, pairs, SUB)
        ox, oy, oz = (o[ray, c][:, None] for c in range(3))
        wx, wy, wz = (d[ray, c][:, None] for c in range(3))
        pax, pay, paz = col[0] - ox, col[1] - oy, col[2] - oz
        pbx, pby, pbz = col[3] - ox, col[4] - oy, col[5] - oz
        pcx, pcy, pcz = col[6] - ox, col[7] - oy, col[8] - oz
        nx, ny, nz = col[9], col[10], col[11]
        U = (wx * (pby * pcz - pbz * pcy) + wy * (pbz * pcx - pbx * pcz)
             + wz * (pbx * pcy - pby * pcx))
        V = (wx * (pcy * paz - pcz * pay) + wy * (pcz * pax - pcx * paz)
             + wz * (pcx * pay - pcy * pax))
        dn = wx * nx + wy * ny + wz * nz
        W = dn - U - V
        s_n = pax * nx + pay * ny + paz * nz
        hit = (real & ((torch.minimum(torch.minimum(U, V), W) >= 0.0)
                       | (torch.maximum(torch.maximum(U, V), W) <= 0.0))
               & (s_n * dn > 0.0) & (dn.abs() > DET_EPS))
        first = torch.full((o.shape[0],), none, dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, ray, torch.where(hit, j, none).amin(dim=1), "amin")
        tests += int((real & (j <= first[ray][:, None])).sum())
        last_g = torch.clamp_max(first // SUB, n_groups - 1)[:, None]
        per_tile = torch.clamp_min(torch.minimum(last_g, g_hi) - g_lo + 1, 0)
        groups += int((per_tile * t_reach).sum())
        tiles += int((t_reach & (k <= (first // TC)[:, None])).sum())
        occluded[:, lo:hi] = (first < none).reshape(S, hi - lo)
    return {"tiles": tiles, "groups": groups, "tests": tests,
            "occluded": occluded}


def need_walk(tris, nodes, org, dirn, closest: bool, depth: int,
              chunk: int = 16384, tmax=None) -> dict:
    """The tile-BVH work rays org, dirn (R, 3) need, counted by walking
    the tree in plain torch: each ray enters the root, at an inner node
    tests both child boxes and enters the near child first (the one on
    the low side of the split axis when the ray's direction along it is
    >= 0), skipping a child it does not reach (the closest hit: whose
    entry is not before its best t), as csrc/bvh.cu's kernels 4 and 5
    walk; a leaf tests its real triangles in slot order (padding slots,
    all zero, are no work), the any-hit (unbounded signed-volume test)
    up to its first hit and then stopping, the closest hit
    (Moller-Trumbore, 0 < t < best t, which starts at tmax (R,), None:
    unbounded) every one, a leaf's least t, the lowest slot on equal t,
    replacing the best only if nearer.  Returns {"hit" (R,) bool (hit or
    occluded), "t" (R,) the closest hit's best t (tmax on a miss), "tri"
    (R,) its slot (-1 on a miss), "inner" inner nodes entered, "nodes"
    nodes entered, "tests" real triangles tested, "distinct_nodes" the
    nodes some ray entered, "leaf_tris" the real triangles of the leaves
    some ray entered (Python ints)}."""
    import torch


    R, dev = org.shape[0], org.device
    inf = float("inf")
    ints = nodes.view(torch.int32)
    meta, link = ints[:, 3].long(), ints[:, 7].long()
    lo, hi = nodes[:, 0:3], nodes[:, 4:7]
    real = (tris[0:9] != 0).any(dim=0)
    L = int(meta.max()) * TC
    lane = torch.arange(L, device=dev)
    inv = 1.0 / torch.where(dirn.abs() > 1e-20, dirn,
                            torch.full_like(dirn, 1e-20))

    def slab(n, rows):
        t0 = (lo[n] - org[rows]) * inv[rows]
        t1 = (hi[n] - org[rows]) * inv[rows]
        return (torch.minimum(t0, t1).amax(dim=1),
                torch.maximum(t0, t1).amin(dim=1))

    cur = torch.zeros(R, dtype=torch.long, device=dev)
    sp = torch.zeros(R, dtype=torch.long, device=dev)
    stack = torch.zeros((R, depth + 1), dtype=torch.long, device=dev)
    stack_tn = torch.zeros((R, depth + 1), device=dev)
    t_best = (torch.full((R,), inf, device=dev) if tmax is None
              else tmax.to(torch.float32).clone())
    tri = torch.full((R,), -1, dtype=torch.long, device=dev)
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    entered = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
    n_inner = n_nodes = 0
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        idx = torch.nonzero(cur >= 0)[:, 0]
        if idx.numel() == 0:
            break
        n_nodes += idx.numel()
        c = cur[idx]
        entered[c] = True
        m = meta[c]
        leaf = m > 0
        nxt = torch.full_like(c, -1)

        # inner nodes: both child boxes, the near child first
        inner = ~leaf
        ii, ci = idx[inner], c[inner]
        n_inner += ii.numel()
        c0, c1 = ci + 1, link[ci]
        tn0, tf0 = slab(c0, ii)
        tn1, tf1 = slab(c1, ii)
        bound = t_best[ii] if closest else inf
        r0 = (tn0 <= tf0) & (tf0 > 0) & (tn0 < bound)
        r1 = (tn1 <= tf1) & (tf1 > 0) & (tn1 < bound)
        near0 = dirn[ii, -m[inner] - 1] >= 0
        near = torch.where(near0, c0, c1)
        far = torch.where(near0, c1, c0)
        rn = torch.where(near0, r0, r1)
        rf = torch.where(near0, r1, r0)
        push = rn & rf
        pi = ii[push]
        stack[pi, sp[pi]] = far[push]
        stack_tn[pi, sp[pi]] = torch.where(near0, tn1, tn0)[push]
        sp[pi] += 1
        nxt[inner] = torch.where(rn, near, torch.where(rf, far, -1))

        # leaves: the real triangles in slot order
        li, cl = idx[leaf], c[leaf]
        first, count = link[cl] * TC, m[leaf] * TC
        stop = torch.zeros(li.numel(), dtype=torch.bool, device=dev)
        for a in range(0, li.numel(), chunk):
            rows = li[a : a + chunk]
            inleaf = lane[None] < count[a : a + chunk, None]
            k = torch.where(inleaf, first[a : a + chunk, None] + lane[None], 0)
            rv = inleaf & real[k]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tris[r][k] for r in range(9))
            ox, oy, oz = (org[rows, i : i + 1] for i in range(3))
            dx, dy, dz = (dirn[rows, i : i + 1] for i in range(3))
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            u = sx * px + sy * py + sz * pz
            v = qx * dx + qy * dy + qz * dz
            t = e2x * qx + e2y * qy + e2z * qz
            if closest:
                valid = det.abs() > 1e-14
                inva = torch.where(valid, 1.0 / torch.where(valid, det, 1.0),
                                   0.0)
                u, v, t = u * inva, v * inva, t * inva
                h = (valid & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                     & (t > 0) & (t < t_best[rows, None]) & rv)
                tc, j = torch.where(h, t, inf).min(dim=1)  # first of equals
                better = h.any(dim=1)
                t_best[rows] = torch.where(better, tc, t_best[rows])
                tri[rows] = torch.where(better, k.gather(1, j[:, None])[:, 0],
                                        tri[rows])
                hit[rows] |= better
                tests += rv.sum()
            else:
                w = det - u - v
                inside = ((torch.minimum(torch.minimum(u, v), w) >= 0)
                          | (torch.maximum(torch.maximum(u, v), w) <= 0))
                h = inside & (t * det > 0) & (det.abs() > 1e-14) & rv
                anyh = h.any(dim=1)
                upto = torch.cumsum(rv, dim=1).gather(
                    1, h.to(torch.int8).argmax(dim=1, keepdim=True))[:, 0]
                tests += torch.where(anyh, upto, rv.sum(dim=1)).sum()
                hit[rows] = anyh
                stop[a : a + chunk] = anyh
        nxt[leaf] = torch.where(stop, -2, -1)  # -2: occluded, walk ends
        cur[idx] = nxt

        # pop: the closest hit only a child still nearer than its best t
        while True:
            pi = torch.nonzero((cur == -1) & (sp > 0))[:, 0]
            if pi.numel() == 0:
                break
            sp[pi] -= 1
            cand = stack[pi, sp[pi]]
            if closest:
                cand = torch.where(stack_tn[pi, sp[pi]] < t_best[pi], cand, -1)
            cur[pi] = cand
    leaves = torch.nonzero(entered & (meta > 0))[:, 0]
    per_tile = torch.cumsum(
        torch.cat([real.new_zeros(1, dtype=torch.long),
                   real.view(-1, TC).sum(dim=1)]), dim=0)
    leaf_tris = per_tile[link[leaves] + meta[leaves]] - per_tile[link[leaves]]
    return {"hit": hit, "t": t_best, "tri": tri, "inner": n_inner,
            "nodes": n_nodes, "tests": int(tests),
            "distinct_nodes": int(entered.sum()),
            "leaf_tris": int(leaf_tris.sum())}


def reached_bytes(need) -> int:
    """The bytes a walk must read at least once: the real triangles of
    the leaves the rays reach (36 B each, the nine rows) and the nodes
    they enter (32 B each)."""
    return need["leaf_tris"] * 36 + need["distinct_nodes"] * 32
