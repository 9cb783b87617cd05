"""AO gather: lane order, occlusion counts and the shading basis of the
port (plain torch twin on the CPU) against lucille_tpu's Pallas kernel in
interpret mode, fed JAX's own jitter draw.

Tolerances: lane orders are exact (the jitter is indexed by compacted
slot, so any difference would scramble it).  Occlusion counts equal on
>= 99% of lanes and within 1 elsewhere, the bound test_pallas_ao.py uses:
a stratum direction differs by an ulp where XLA's and torch's cos/sin
round differently.  Basis and normals within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_intersect import _random_soup, _scene_from_tris
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import native_builders  # noqa: F401


def _soup(n_tris, seed=5):
    v0, v1, v2 = _random_soup(n_tris, seed=seed)
    return _scene_from_tris(v0, v1, v2, "pallas")


def _lanes(B, seed=1, quantize=False):
    """Shading points, unit normals, hit mask.  quantize=True snaps points
    to a coarse grid so many lanes share a Morton cell (exercises the
    stable sort's tie order)."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(-4, 4, (B, 3))
    if quantize:
        P = np.round(P)
    N = rng.normal(size=(B, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    hit = rng.uniform(size=B) < 0.8
    return P.astype(np.float32), N.astype(np.float32), hit


# 400 triangles -> 512 padded -> 4 tiles: hit-first partition.
# 1100 -> 1280 -> 10 tiles: octant + Morton sort.
@pytest.mark.parametrize("n_tris,n_tiles", [(400, 4), (1100, 10)])
@pytest.mark.parametrize("quantize", [False, True])
def test_lane_orders_exact(n_tris, n_tiles, quantize):
    from lucille_tpu.accel.pallas_ao import compaction_order as jax_order
    from lucille_tpu.accel.pallas_ao import partition_order as jax_partition
    from lucille_tpu.transport.ao import ortho_basis
    from lucille_tpu_torch.accel.ao import compaction_order, partition_order
    from lucille_tpu_torch.scene.types import from_numpy

    sc = _soup(n_tris)
    assert -(-sc.tri_v0.shape[0] // 128) == n_tiles
    P, N, hit = _lanes(1000, quantize=quantize)
    b2 = np.array(ortho_basis(jnp.asarray(N))[2])
    o_ref, n_ref = jax_order(sc, jnp.asarray(P), jnp.asarray(b2),
                             jnp.asarray(hit), n_tiles)
    scene = from_numpy(sc, "cpu")
    order, nhit = compaction_order(scene.bbox_min, scene.bbox_max,
                                   torch.from_numpy(P), torch.from_numpy(b2),
                                   torch.from_numpy(hit), n_tiles)
    np.testing.assert_array_equal(order.numpy(), np.asarray(o_ref))
    assert int(nhit) == int(n_ref)
    o_ref, n_ref = jax_partition(jnp.asarray(hit))
    order, nhit = partition_order(torch.from_numpy(hit))
    np.testing.assert_array_equal(order.numpy(), np.asarray(o_ref))
    assert int(nhit) == int(n_ref)


@pytest.mark.parametrize(
    "n_tris,ntheta,nphi", [(700, 4, 4), (700, 3, 3), (1100, 4, 4),
                           (700, 2, 2), (700, 3, 5)])
def test_ao_occlusion_matches_pallas(n_tris, ntheta, nphi):
    from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion
    from lucille_tpu.transport.ao import ortho_basis
    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.scene.types import from_numpy

    sc = _soup(n_tris)
    B = 256
    P, N, hit = _lanes(B)
    b0, b1, b2 = (np.array(b) for b in ortho_basis(jnp.asarray(N)))
    key = jax.random.key(7)
    ref = np.asarray(pallas_ao_occlusion(
        sc, jnp.asarray(P), jnp.asarray(b0), jnp.asarray(b1),
        jnp.asarray(b2), jnp.asarray(hit), key, ntheta, nphi, interpret=True))
    jitter = torch.from_numpy(
        np.array(jax.random.uniform(key, (2, B), dtype=jnp.float32)))
    ao.COUNTS.reset()
    t = torch.from_numpy
    got = ao.ao_occlusion(from_numpy(sc, "cpu"), t(P), t(b0), t(b1), t(b2),
                          t(hit), jitter, ntheta, nphi).numpy()
    assert (ao.COUNTS.kernel, ao.COUNTS.plain) == (0, 1)
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff != 0).mean() <= 0.01
    assert np.all(got[~hit] == 0)
    assert ref[hit].mean() > 0.5  # the case exercises occlusion


@pytest.mark.parametrize("S", [1, 4, 15, 25, 64, 256, 576])
def test_gather_layout_covers_every_stratum_once(S):
    """csrc/ao.cu's work split as accel/ao.py:gather_layout lays it out:
    thread t of a lane, in round r, takes chunk c = r * T + t, strata [c *
    C, c * C + C) below S; of each g = min(T, 32 / C) consecutive threads
    of the lane the first stores the bits row its chunk starts, ORed from
    the g chunks.  Every stratum falls to exactly one thread, every bits
    row is stored by exactly one thread from exactly its own strata, and
    the grid covers every lane."""
    from lucille_tpu_torch.accel.ao import AO_BLOCK, gather_layout

    B = 1000
    C, T, grid = gather_layout(S, B)
    assert C in (4, 16) and 32 % C == 0
    assert T in (1, 2, 4, 8, 16, 32)
    assert grid * (AO_BLOCK // T) >= B > (grid - 1) * (AO_BLOCK // T)
    n_chunks = -(-S // C)
    rounds = -(-n_chunks // T)
    assert rounds == 1 or T == 32  # one round unless a lane is a warp
    g = min(T, 32 // C)
    strata, rows = [], {}
    for r in range(rounds):
        for t in range(T):
            c = r * T + t
            strata += [s for s in range(c * C, c * C + C) if s < S]
            if t % g == 0 and c * C < S:
                row = c * C // 32
                assert row not in rows
                rows[row] = {s for cc in range(c, c + g)
                             for s in range(cc * C, cc * C + C) if s < S}
    assert sorted(strata) == list(range(S))
    assert sorted(rows) == list(range(-(-S // 32)))
    for row, held in rows.items():
        assert held == set(range(32 * row, min(32 * row + 32, S)))


def _walk_gather_one(occ, boxes, sub, n_tris, o, w):
    """One stratum ray (o, w: (3,) f32) walked as csrc/ao.cu walks it, one
    slot at a time: each real tile whose box it reaches, in it each group
    of 8 slots that holds a real triangle, in a group whose box it
    reaches each real triangle, stopping at the first that occludes.
    Returns (occluded, tile box tests, group box tests, triangle tests)."""
    from lucille_tpu_torch.accel.isect import DET_EPS

    f32 = np.float32
    inv = f32(1) / np.where(np.abs(w) > f32(1e-20), w, f32(1e-20))

    def reaches(box, k):
        t0, t1 = (box[0:3, k] - o) * inv, (box[3:6, k] - o) * inv
        tn, tf = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
        return bool(tn <= tf and tf > 0)

    def occludes(j):
        pa, pb, pc = (occ[3 * r : 3 * r + 3, j] - o for r in range(3))
        n = occ[9:12, j]
        cbc = (pb[1] * pc[2] - pb[2] * pc[1], pb[2] * pc[0] - pb[0] * pc[2],
               pb[0] * pc[1] - pb[1] * pc[0])
        cca = (pc[1] * pa[2] - pc[2] * pa[1], pc[2] * pa[0] - pc[0] * pa[2],
               pc[0] * pa[1] - pc[1] * pa[0])
        U = w[0] * cbc[0] + w[1] * cbc[1] + w[2] * cbc[2]
        V = w[0] * cca[0] + w[1] * cca[1] + w[2] * cca[2]
        dn = w[0] * n[0] + w[1] * n[1] + w[2] * n[2]
        W = dn - U - V
        s_n = pa[0] * n[0] + pa[1] * n[1] + pa[2] * n[2]
        inside = min(U, V, W) >= 0 or max(U, V, W) <= 0
        return inside and s_n * dn > 0 and abs(dn) > f32(DET_EPS)

    tiles = groups = tests = 0
    for k in range(-(-n_tris // 128)):
        if not reaches(boxes, k):
            continue
        tiles += 1
        for g in range(16 * k, min(16 * k + 16, -(-n_tris // 8))):
            groups += 1
            if not reaches(sub, g):
                continue
            for j in range(8 * g, min(8 * g + 8, n_tris)):
                tests += 1
                if occludes(j):
                    return True, tiles, groups, tests
    return False, tiles, groups, tests


@pytest.mark.parametrize("n_tris", [300, 1100])
def test_gather_need_counts(n_tris):
    """chip_smoke.gather_need, the work the dense gather's bound charges:
    the strata it finds occluded are exactly the plain twin's bits, and
    its box and triangle counts equal a walk of one stratum ray at a time,
    slot by slot, on a sample of the lanes (exactly)."""
    from chip_smoke import gather_need

    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.scene.types import from_numpy
    from lucille_tpu_torch.ops.frame import ortho_basis

    scene = from_numpy(_soup(n_tris), "cpu")
    B, ntheta, nphi = 200, 3, 4
    S = ntheta * nphi
    P, N, _hit = _lanes(B)
    P = torch.from_numpy(P)
    b0, b1, b2 = ortho_basis(torch.from_numpy(N))
    rng = np.random.default_rng(3)
    u01 = torch.from_numpy(rng.uniform(size=(2, B)).astype(np.float32))
    got = gather_need(scene, P, b0, b1, b2, u01, ntheta, nphi, budget=5000)
    rays = torch.cat([P, b0, b1, b2], dim=1).T.contiguous()
    _occ, bits = ao.ao_occlusion_reference(scene.occ, rays, u01, ntheta,
                                           nphi, want_bits=True)
    assert torch.equal(got["occluded"], ao.unpack_bits(bits, S))
    assert 0.05 < got["occluded"].float().mean() < 0.95
    lanes = rng.choice(B, 10, replace=False)
    dirs = ao.stratum_directions(b0, b1, b2, u01, ntheta, nphi).numpy()
    walks = [_walk_gather_one(scene.occ.numpy(), scene.boxes.numpy(),
                              scene.sub_boxes.numpy(), scene.n_tris,
                              P[i].numpy(), dirs[s, i])
             for s in range(S) for i in lanes]
    part = gather_need(scene, P[lanes], b0[lanes], b1[lanes], b2[lanes],
                       u01[:, lanes], ntheta, nphi)
    assert part["occluded"].reshape(-1).tolist() == [w[0] for w in walks]
    assert (part["tiles"], part["groups"], part["tests"]) == tuple(
        sum(w[j] for w in walks) for j in (1, 2, 3))
    # the culls: far fewer triangle tests than every real one per stratum
    assert 0 < got["tests"] < 0.5 * n_tris * S * B


def _walk_thread(scene, o, nrm, dirs):
    """One thread of csrc/ao.cu walking its strata `dirs` (C, 3) from
    point o with normal nrm (3,) f32, as the kernel's `walk` does, one
    slot at a time.  Returns ((supertile, tile, quarter and group box
    tests, set-ups, tests), {quad's first slot: its strata that meet
    it})."""
    f32 = np.float32
    occ, sboxes, boxes, sub = (a.numpy() for a in (
        scene.occ, scene.sboxes, scene.boxes, scene.sub_boxes))
    n_tris = scene.n_tris
    inv = f32(1) / np.where(np.abs(dirs) > f32(1e-20), dirs, f32(1e-20))

    def reaches(box, k, q):
        t0, t1 = (box[0:3, k] - o) * inv[q], (box[3:6, k] - o) * inv[q]
        tn, tf = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
        return bool(tn <= tf and tf > 0)

    def below(box, k):
        c = np.where(nrm > 0, box[3:6, k], box[0:3, k])
        return not ((c[0] - o[0]) * nrm[0] + (c[1] - o[1]) * nrm[1]
                    + (c[2] - o[2]) * nrm[2] >= 0)

    def occludes(j, q):
        w = dirs[q]
        pa, pb, pc = (occ[3 * r : 3 * r + 3, j] - o for r in range(3))
        n = occ[9:12, j]
        cbc = (pb[1] * pc[2] - pb[2] * pc[1], pb[2] * pc[0] - pb[0] * pc[2],
               pb[0] * pc[1] - pb[1] * pc[0])
        cca = (pc[1] * pa[2] - pc[2] * pa[1], pc[2] * pa[0] - pc[0] * pa[2],
               pc[0] * pa[1] - pc[1] * pa[0])
        U = w[0] * cbc[0] + w[1] * cbc[1] + w[2] * cbc[2]
        V = w[0] * cca[0] + w[1] * cca[1] + w[2] * cca[2]
        dn = w[0] * n[0] + w[1] * n[1] + w[2] * n[2]
        W = dn - U - V
        s_n = pa[0] * n[0] + pa[1] * n[1] + pa[2] * n[2]
        inside = min(U, V, W) >= 0 or max(U, V, W) <= 0
        return inside and s_n * dn > 0 and abs(dn) > f32(1e-14)

    def quarter_box(c0):
        g = sub[:, c0 // 8 : c0 // 8 + 4]
        return np.concatenate([g[0:3].min(axis=1), g[3:6].max(axis=1)])[
            :, None]

    pending = set(range(len(dirs)))
    supers = tiles = quarters = groups = setups = tests = 0
    quads = {}
    n_real = -(-n_tris // 128)
    for sk in range(-(-n_real // 16)):
        if not pending or below(sboxes, sk):
            continue
        supers += len(pending)
        in_s = {q for q in pending if reaches(sboxes, sk, q)}
        for k in range(16 * sk, min(16 * sk + 16, n_real)):
            in_t = in_s & pending
            if not in_t or below(boxes, k):
                continue
            tiles += len(in_t)
            in_t = {q for q in in_t if reaches(boxes, k, q)}
            for q0 in range(128 * k, min(128 * k + 128, n_tris), 32):
                in_t &= pending
                quarters += len(in_t)
                box = quarter_box(q0)
                in_q = {q for q in in_t if reaches(box, 0, q)}
                for c0 in range(q0, min(q0 + 32, n_tris), 8):
                    in_q &= pending
                    groups += len(in_q)
                    sr = {q for q in in_q if reaches(sub, c0 // 8, q)}
                    for c in range(c0, min(c0 + 8, n_tris), 4):
                        quads[c] = len(sr)
                        if sr:
                            setups += min(4, n_tris - c)
                        for q in sorted(sr):
                            for j in range(c, min(c + 4, n_tris)):
                                tests += 1
                                if occludes(j, q):
                                    sr.discard(q)
                                    pending.discard(q)
                                    break
    return (supers, tiles, quarters, groups, setups, tests), quads


@pytest.mark.parametrize("n_tris,nphi", [(300, 4), (1100, 4), (300, 7)])
def test_gather_walk_counts(n_tris, nphi):
    """chip_smoke.gather_walk, the plain count of csrc/ao.cu's counters
    that tests/test_torch_gpu.py holds the kernel's to, on the soups of
    test_gather_need_counts: its occluded strata are gather_need's, and
    the walk keeps slot order, so its tests equal gather_need's, and it
    box-tests only the groups of quarters a stratum reaches, so its group
    box tests are at most gather_need's; every counter equals one thread
    at a time walking as
    the kernel does (`_walk_thread`), the warps' test steps the most
    strata a thread of the warp takes into each quad times its
    triangles, with lanes past n_live idle.  3x4 strata: 4 a thread; 3x7:
    16 a thread."""
    from chip_smoke import gather_need, gather_walk

    from lucille_tpu_torch.accel.ao import AO_BLOCK, gather_layout
    from lucille_tpu_torch.scene.types import from_numpy
    from lucille_tpu_torch.ops.frame import ortho_basis

    scene = from_numpy(_soup(n_tris), "cpu")
    B, n_live, ntheta = 200, 150, 3
    S = ntheta * nphi
    P, N, _hit = _lanes(B)
    P = torch.from_numpy(P)
    b0, b1, b2 = ortho_basis(torch.from_numpy(N))
    rng = np.random.default_rng(3)
    u01 = torch.from_numpy(rng.uniform(size=(2, B)).astype(np.float32))
    rays = torch.cat([P, b0, b1, b2], dim=1).T.contiguous()
    got = gather_walk(scene, rays, u01, n_live, ntheta, nphi)
    need = gather_need(scene, P[:n_live], b0[:n_live], b1[:n_live],
                       b2[:n_live], u01[:, :n_live], ntheta, nphi)
    assert torch.equal(got.pop("occluded"), need["occluded"])
    assert got["tests"] == need["tests"]
    assert got["group_tests"] <= need["groups"]
    assert got["tile_tests"] >= need["tiles"]
    from lucille_tpu_torch.accel.ao import stratum_directions

    dirs = stratum_directions(b0, b1, b2, u01, ntheta, nphi).numpy()
    C, T, grid = gather_layout(S, B)
    lanes = AO_BLOCK // T
    total = np.zeros(6, dtype=np.int64)
    warp_quads = {}
    for gt in range(grid * AO_BLOCK):
        lane = gt // AO_BLOCK * lanes + gt % AO_BLOCK % lanes
        chunk = gt % AO_BLOCK // lanes
        strata = [s for s in range(chunk * C, chunk * C + C) if s < S]
        if lane >= n_live or not strata:
            continue
        counts, quads = _walk_thread(scene, P[lane].numpy(),
                                     b2[lane].numpy(),
                                     dirs[strata, lane])
        total += counts
        most = warp_quads.setdefault(gt // 32, {})
        for c, m in quads.items():
            most[c] = max(most.get(c, 0), m)
    steps = sum(m * min(4, n_tris - c) for most in warp_quads.values()
                for c, m in most.items())
    assert (got["super_tests"], got["tile_tests"], got["quarter_tests"],
            got["group_tests"], got["setups"], got["tests"]) == tuple(
                int(x) for x in total)
    assert got["warp_steps"] == steps


def test_scene_packs_are_the_pack_functions():
    """from_numpy builds the kernels' packs once; each equals its pack
    function's output on the same scene (dense: tris, occ, boxes,
    sboxes, sub_boxes; tile BVH: tris)."""
    from lucille_tpu_torch.accel.pack import (
        SUB,
        pack_boxes,
        pack_occ,
        pack_super_boxes,
        pack_tris,
    )
    from lucille_tpu_torch.scene.types import from_numpy

    scene = from_numpy(_soup(2500), "cpu")  # 20 tiles, 2 supertiles
    assert torch.equal(scene.tris, pack_tris(scene))
    assert torch.equal(scene.occ, pack_occ(scene))
    assert torch.equal(scene.boxes, pack_boxes(scene))
    assert torch.equal(scene.sboxes, pack_super_boxes(pack_boxes(scene)))
    assert torch.equal(scene.sub_boxes, pack_boxes(scene, SUB))
    assert scene.sub_boxes.shape == (8, scene.n_pad // SUB)
    v0, v1, v2 = _random_soup(700, seed=5)
    bvh = from_numpy(_scene_from_tris(v0, v1, v2, "bvh"), "cpu")
    assert bvh.accel == "pbvh" and bvh.occ is None and bvh.sub_boxes is None
    assert torch.equal(bvh.tris, pack_tris(bvh))


def test_pack_occ_and_super_boxes_match_jax():
    from lucille_tpu.accel.pallas_ao import _pack_occ
    from lucille_tpu.accel.pallas_isect import _pack_boxes, _pack_super_boxes
    from lucille_tpu_torch.accel.pack import (
        pack_boxes,
        pack_occ,
        pack_super_boxes,
    )
    from lucille_tpu_torch.scene.types import from_numpy

    sc = _soup(2500)  # 20 tiles -> 2 supertiles, the second ragged
    scene = from_numpy(sc, "cpu")
    tris, npad = _pack_occ(sc)
    got, want = pack_occ(scene).numpy(), np.asarray(tris)
    # vertices exact; XLA:CPU contracts the cross product's a*b - c*d into
    # an FMA, so the normal rows agree to one rounding of a product
    np.testing.assert_array_equal(got[:9], want[:9])
    np.testing.assert_array_equal(got[12:], want[12:])
    np.testing.assert_allclose(got[9:12], want[9:12], rtol=0, atol=1e-6)
    boxes = _pack_boxes(sc, npad)
    sboxes, n_super = _pack_super_boxes(boxes, npad // 128)
    assert n_super == 2
    np.testing.assert_array_equal(
        pack_super_boxes(pack_boxes(scene)).numpy(), np.asarray(sboxes))


def test_ortho_basis_and_interp_normal_close():
    from lucille_tpu.transport.ao import _interp_normal as jax_interp
    from lucille_tpu.transport.ao import ortho_basis as jax_basis
    from lucille_tpu_torch.scene.types import from_numpy
    from lucille_tpu_torch.ops.frame import ortho_basis
    from lucille_tpu_torch.transport.ao import _interp_normal

    rng = np.random.default_rng(4)
    N = rng.normal(size=(2000, 3))
    N[:5] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0, 0, -0.99999]]
    N = (N / np.linalg.norm(N, axis=-1, keepdims=True)).astype(np.float32)
    for a, b in zip(ortho_basis(torch.from_numpy(N)), jax_basis(jnp.asarray(N))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)

    sc = _soup(300)
    res = {
        "tri": rng.integers(-1, 300, 500).astype(np.int32),
        "u": rng.uniform(0, 0.5, 500).astype(np.float32),
        "v": rng.uniform(0, 0.5, 500).astype(np.float32),
    }
    want = np.asarray(jax_interp(sc, {k: jnp.asarray(v) for k, v in res.items()}))
    got = _interp_normal(from_numpy(sc, "cpu"),
                         {k: torch.from_numpy(v) for k, v in res.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
