"""Host-side binned-SAH BVH build, flattened to skip-link arrays.

A host copy of lucille_tpu/accel/bvh.py (``BVH``, ``build_bvh``,
``_build_bvh_numpy``): ``lucille_tpu.accel`` cannot be imported without
jax, because its package __init__ pulls in the jax intersectors.  The
tests hold both builds equal, array for array.

The build is the reference's binned SAH (src/render/bvh.c:
``bvh_construct`` bvh.c:1329, bin edges bvh.c:1572, min-cost cut
bvh.c:1231, surface-area metric bvh.c:1191), emitted as flat arrays:

- nodes in depth-first order; the left child of inner node ``i`` is
  ``i + 1``;
- every node stores a **skip link**, the index of the next node in DFS
  order once its subtree is done (``n_nodes`` = done);
- leaves own contiguous triangle ranges of at most ``leaf_size``; the
  triangle permutation is returned so callers reorder their arrays.

``build_bvh`` prefers the C++ builder (native/bvh_builder.cpp, loaded
through the port's native/loader.py) and falls back to the NumPy build
below, exactly as the original does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NBINS = 16
TRAVERSAL_COST = 1.0
ISECT_COST = 1.0


@dataclass
class BVH:
    bbmin: np.ndarray  # (M, 3) f32
    bbmax: np.ndarray  # (M, 3) f32
    skip: np.ndarray  # (M,) i32
    first: np.ndarray  # (M,) i32
    count: np.ndarray  # (M,) i32 (0 = inner node)
    order: np.ndarray  # (N,) permutation of input triangles
    depth: int = 0


def build_bvh(v0, v1, v2, leaf_size: int = 8, use_native: bool = True) -> BVH:
    """Binned-SAH build; prefers the C++ builder (native/bvh_builder.cpp,
    10-50x faster on big scenes), falling back to the NumPy implementation
    below (identical output layout and invariants)."""
    if use_native:
        from lucille_tpu_torch.native.loader import native_build_bvh

        out = native_build_bvh(v0, v1, v2, leaf_size)
        if out is not None:
            bbmin, bbmax, skip, first, count, order = out
            return BVH(
                bbmin=bbmin, bbmax=bbmax, skip=skip, first=first,
                count=count, order=order,
            )
    return _build_bvh_numpy(v0, v1, v2, leaf_size)


def _build_bvh_numpy(v0, v1, v2, leaf_size: int = 8) -> BVH:
    n = len(v0)
    tbmin = np.minimum(np.minimum(v0, v1), v2)
    tbmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tbmin + tbmax)

    order = np.arange(n, dtype=np.int64)

    bbmins, bbmaxs, skips, firsts, counts = [], [], [], [], []

    max_depth = 0

    def emit(bmn, bmx, first, count):
        bbmins.append(bmn)
        bbmaxs.append(bmx)
        skips.append(-1)  # patched later
        firsts.append(first)
        counts.append(count)
        return len(skips) - 1

    def sah_split(idx):
        """Return (axis, bin_threshold_mask) or None for leaf."""
        c = centroid[idx]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            return None
        # bin centroids (bvh.c bin_triangle_edge semantics, on centroids)
        scale = NBINS * (1.0 - 1e-6) / ext[axis]
        bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int64)
        np.clip(bins, 0, NBINS - 1, out=bins)

        # per-bin counts and bbox accumulation
        cnt = np.bincount(bins, minlength=NBINS)
        binmin = np.full((NBINS, 3), np.inf)
        binmax = np.full((NBINS, 3), -np.inf)
        bmn = tbmin[idx]
        bmx = tbmax[idx]
        for b in range(NBINS):
            m = bins == b
            if m.any():
                binmin[b] = bmn[m].min(axis=0)
                binmax[b] = bmx[m].max(axis=0)

        # prefix/suffix sweep for SAH (find_cut_from_bin, bvh.c:1231)
        lmin = np.minimum.accumulate(binmin, axis=0)
        lmax = np.maximum.accumulate(binmax, axis=0)
        rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
        lcnt = np.cumsum(cnt)
        rcnt = np.cumsum(cnt[::-1])[::-1]

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        # split after bin k: left = bins [0..k], right = [k+1..]
        la = area(lmin, lmax)[:-1]
        ra = area(rmin, rmax)[1:]
        lc = lcnt[:-1]
        rc = rcnt[1:]
        cost = la * lc + ra * rc
        cost[lc == 0] = np.inf
        cost[rc == 0] = np.inf
        k = int(np.argmin(cost))
        if not np.isfinite(cost[k]):
            return None
        # leaf-vs-split test (SAH with unit costs)
        parent_area = area(
            tbmin[idx].min(axis=0)[None], tbmax[idx].max(axis=0)[None]
        )[0]
        split_cost = TRAVERSAL_COST + ISECT_COST * cost[k] / max(parent_area, 1e-30)
        leaf_cost = ISECT_COST * len(idx)
        if len(idx) <= leaf_size and split_cost >= leaf_cost:
            return None
        return bins <= k

    # iterative DFS with explicit stack; each frame patches its own skip
    # link once its subtree has been emitted.
    out_pos = 0  # next triangle slot in the reordered array
    stack = [(order, 0)]  # (triangle ids, depth); root emitted inside loop
    final_order = np.empty(n, dtype=np.int64)

    # We emit nodes recursively through an explicit machine:
    def build(idx, depth):
        nonlocal out_pos, max_depth
        max_depth = max(max_depth, depth)
        bmn = tbmin[idx].min(axis=0)
        bmx = tbmax[idx].max(axis=0)
        if len(idx) <= leaf_size:
            node = emit(bmn, bmx, out_pos, len(idx))
            final_order[out_pos : out_pos + len(idx)] = idx
            out_pos += len(idx)
            skips[node] = -2  # leaf marker until patched
            return node
        mask = sah_split(idx)
        if mask is None:
            # fallback: median split on the widest axis (degenerate SAH)
            c = centroid[idx]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            med = np.argsort(c[:, axis], kind="stable")
            half = len(idx) // 2
            left_idx = idx[med[:half]]
            right_idx = idx[med[half:]]
            if len(left_idx) == 0 or len(right_idx) == 0:
                node = emit(bmn, bmx, out_pos, len(idx))
                final_order[out_pos : out_pos + len(idx)] = idx
                out_pos += len(idx)
                return node
        else:
            left_idx = idx[mask]
            right_idx = idx[~mask]
        node = emit(bmn, bmx, 0, 0)
        build(left_idx, depth + 1)
        right = build(right_idx, depth + 1)
        del right
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if n > 0:
            build(order, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(skips)
    bbmin = np.asarray(bbmins, dtype=np.float32).reshape(m, 3)
    bbmax = np.asarray(bbmaxs, dtype=np.float32).reshape(m, 3)
    first = np.asarray(firsts, dtype=np.int32)
    count = np.asarray(counts, dtype=np.int32)

    # patch skip links: skip[i] = the next node after i's subtree in DFS
    # order.  Subtree extents come from a single pass using the fact that
    # children are contiguous after their parent.
    skip = np.full(m, m, dtype=np.int32)
    stack2: list = []
    # reconstruct subtree sizes: walk nodes; leaves end themselves;
    # inner nodes own everything until their skip target.
    # A parent's subtree = itself + left subtree + right subtree, and the
    # left child is at parent+1.  We can compute subtree ends iteratively:
    end = np.zeros(m, dtype=np.int32)
    for i in range(m - 1, -1, -1):
        if count[i] > 0:
            end[i] = i + 1
        else:
            left = i + 1
            right = end[left]
            end[i] = end[right]
    for i in range(m):
        skip[i] = end[i]

    return BVH(
        bbmin=bbmin,
        bbmax=bbmax,
        skip=skip,
        first=first,
        count=count,
        order=final_order,
        depth=max_depth,
    )
