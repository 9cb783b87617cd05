"""The CUDA kernels against their plain torch twins, on the card.

These need a CUDA card (the kernels have no CPU mode) and skip without
one.  The file imports no jax, so it runs where jax is not installed; on
a machine with a card, from the repository root:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(--noconftest: tests/conftest.py sets up jax's CPU mesh for the other
tests.)  Tolerances: the kernels are built with --fmad=false and follow
their twins' operation order, so answers agree exactly except where the
kernels' conservative culls or the device's cos/sin round a boundary case
the other way: triangle ids on all but 1e-3 of the rays, t/u/v within
1e-6 relative, occlusion counts on all but 1e-3 of the lanes and within 1,
the dense any-hit's answers and the AO gather's per-stratum bits on all
but 1e-3 of the rays / lanes, the sunsky gather's sky sums within 1e-5
relative plus 1e-3.
The tile-BVH kernels visit leaves in another order than their twins
test slots, so a triangle id may also differ at an exact tie in t across
two leaves (the ray onto a shared edge below); hits and occlusion do not
depend on the order.  A frame whose tiles replay their CUDA graphs
(render/graphs.py) equals the eager frame bit for bit.
"""

import functools

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _soup_scene(n, seed=5, accel="pallas", node_budget=None):
    """n random triangles in a 10-unit box, as a scene on cuda (the dense
    tiles, or the tile BVH with accel="bvh"; a small node_budget makes
    its leaves grow to several tiles)."""
    import functools
    from unittest import mock

    from lucille_tpu_torch.accel import tile_bvh
    from lucille_tpu_torch.ri.types import (
        AttributeState,
        GeomData,
        SceneDescription,
    )
    from lucille_tpu_torch.scene.compile import compile_scene

    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3))
    pos = np.concatenate([c + rng.normal(0, 0.3, (n, 3)) for _ in range(3)])
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1)
    desc = SceneDescription()
    desc.geoms.append(GeomData(positions=pos, indices=idx.astype(np.int32),
                               attrs=AttributeState()))
    desc.options.accel_method = accel
    if node_budget is None:
        return compile_scene(desc, "cuda")
    build = functools.partial(tile_bvh.build_tile_bvh,
                              node_budget=node_budget)
    with mock.patch.object(tile_bvh, "build_tile_bvh", build):
        return compile_scene(desc, "cuda")


def _gather_inputs(n_tris, B):
    """A dense soup scene on cuda and B lanes of AO gather input: rays
    (12, B) [P | b0 | b1 | b2] at random points with random normals, and
    (2, B) uniforms."""
    from lucille_tpu_torch.transport.ao import ortho_basis

    scene = _soup_scene(n_tris)
    rng = np.random.default_rng(1)
    P = torch.tensor(rng.uniform(-4, 4, (B, 3)), dtype=torch.float32,
                     device="cuda")
    N = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(B, 3)), dtype=torch.float32,
                     device="cuda"), dim=-1)
    b0, b1, b2 = ortho_basis(N)
    rays = torch.cat([P, b0, b1, b2], dim=1).T.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(2)
    u01 = torch.rand((2, B), device="cuda", generator=gen)
    return scene, rays, u01


def _shell_rays(B, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-4, 4, (B, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device="cuda"),
            torch.tensor(d, dtype=torch.float32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1000, 4096])
def test_closest_hit_kernel_matches_plain(B):
    _need_card()
    from lucille_tpu_torch.accel.isect import (
        closest_hit_kernel,
        closest_hit_reference,
    )

    scene = _soup_scene(700)
    o, d = _shell_rays(B)
    got = closest_hit_kernel(scene, o, d)
    ref = closest_hit_reference(scene.tris, o, d)
    assert (got["tri"] >= 0).float().mean() > 0.2
    assert (got["tri"] != ref["tri"]).float().mean() <= 1e-3
    same = (got["tri"] == ref["tri"]) & (ref["tri"] >= 0)
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=1e-6,
                                   atol=1e-7)
    assert torch.all(torch.isinf(got["t"][got["tri"] < 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris,ntheta", [(400, 5), (1100, 4), (2500, 8)])
def test_ao_kernel_matches_plain(n_tris, ntheta):
    """Scenes below and above the Morton-order threshold and with 2
    supertiles; S = 25 is not a multiple of the kernel's 16-stratum chunk.
    Lanes at or past nact report 0."""
    _need_card()
    from lucille_tpu_torch.accel import ao

    scene, rays, u01 = _gather_inputs(n_tris, 1000)
    nact = torch.tensor(900, dtype=torch.int32, device="cuda")
    got = ao.ao_occlusion_kernel(scene, rays, u01, nact, ntheta, ntheta)
    ref = ao.ao_occlusion_reference(scene.occ, rays[:, :900], u01[:, :900],
                                    ntheta, ntheta)
    assert torch.all(got[900:] == 0)
    assert ref.mean() > 1.0  # the case exercises occlusion
    diff = (got[:900] - ref).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("tmax", ["none", "scalar", "rows"])
@pytest.mark.parametrize("masked", [False, True])
def test_any_hit_kernel_matches_plain(tmax, masked):
    """The dense any-hit with no tmax, one tmax for all rays and a tmax row;
    with an active mask, dead rays report False."""
    _need_card()
    from lucille_tpu_torch.accel.isect import any_hit, any_hit_reference

    scene = _soup_scene(1100)  # 9 tiles
    B = 5000
    rng = np.random.default_rng(1)
    o = torch.tensor(rng.uniform(-4, 4, (B, 3)), dtype=torch.float32,
                     device="cuda")
    d = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(B, 3)), dtype=torch.float32, device="cuda"), dim=-1)
    t_arg = {"none": None, "scalar": 3.0,
             "rows": torch.tensor(rng.uniform(0.5, 12, B), dtype=torch.float32,
                                  device="cuda")}[tmax]
    active = (torch.tensor(rng.uniform(size=B) < 0.6, device="cuda")
              if masked else None)
    tris = scene.tris
    got = any_hit(scene, o, d, t_arg, active)["occ"]
    t_row = torch.broadcast_to(torch.as_tensor(
        float("inf") if t_arg is None else t_arg, dtype=torch.float32,
        device="cuda"), (B,)).contiguous()
    ref = any_hit_reference(tris, o, d, t_row, active)["occ"]
    assert 0.1 < ref.float().mean() < 0.9
    assert (got != ref).float().mean() <= 1e-3
    if masked:
        assert not torch.any(got[~active])


def _cube_faces(lo, hi, n):
    """(9, n) rows [v0 | e1 | e2] on cuda: the 12 triangles of the box
    [lo, hi]^3 repeated to n slots.  Every ray from outside toward the
    inside crosses the box first, every ray from inside crosses it on the
    way out."""
    faces = []
    for ax in range(3):
        a, b = (ax + 1) % 3, (ax + 2) % 3
        for side in (lo, hi):
            for c0, s in ((lo, 1.0), (hi, -1.0)):
                v0 = np.zeros(3)
                v0[ax], v0[a], v0[b] = side, c0, c0
                e1, e2 = np.zeros(3), np.zeros(3)
                e1[a] = s * (hi - lo)
                e2[b] = s * (hi - lo)
                faces.append(np.concatenate([v0, e1, e2]))
    faces = torch.tensor(np.array(faces).T, dtype=torch.float32,
                         device="cuda")  # (9, 12)
    return faces.repeat(1, -(-n // 12))[:, :n]


def _cube_poison(scene, lo, hi):
    """A copy of the dense scene whose pad slots hold the box [lo, hi]^3
    (`_cube_faces`), its tile and group boxes and n_tris left as they
    are: a kernel that tested a pad slot would answer differently."""
    import dataclasses

    tris = scene.tris.clone()
    tris[:9, scene.n_tris:] = _cube_faces(lo, hi,
                                          tris.shape[1] - scene.n_tris)
    return dataclasses.replace(scene, tris=tris)


def _check_dense_stats(res):
    """The dense walk's counters: lane work within the warps' steps."""
    ntrav, ntests = int(res["ntrav"]), int(res["ntests"])
    wtrav, wtests = int(res["warp_ntrav"]), int(res["warp_ntests"])
    assert 0 < ntrav <= 32 * wtrav
    assert 0 < ntests <= 32 * wtests
    assert ntests <= 8 * ntrav and wtests <= 8 * wtrav


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_tris", [322, 600, 3000])
def test_dense_kernels_never_test_padding(n_tris, masked):
    """322 and 600 triangles: the last real tile is partly padding and the
    next tile is padding alone; 3000: two supertiles, the second ragged.
    The pad slots of a copy hold a box around the soup that every ray
    crosses: both kernels answer on it as their twins do on the scene
    itself, with dead lanes reporting a miss / False."""
    _need_card()
    from lucille_tpu_torch.accel import isect

    scene = _soup_scene(n_tris)
    assert scene.n_pad - n_tris > 128 or n_tris == 3000
    poisoned = _cube_poison(scene, -6.5, 6.5)
    o, d = _shell_rays(4096, seed=2)
    rng = np.random.default_rng(4)
    active = (torch.tensor(rng.uniform(size=4096) < 0.6, device="cuda")
              if masked else None)
    got = isect.closest_hit_kernel(poisoned, o, d, active=active)
    ref = isect.closest_hit_reference(scene.tris, o, d, active=active)
    live = torch.ones_like(o[:, 0], dtype=torch.bool) if active is None \
        else active
    assert (ref["tri"][live] >= 0).float().mean() > 0.1
    assert int(got["tri"].max()) < n_tris
    assert (got["tri"] != ref["tri"]).float().mean() <= 1e-3
    same = (got["tri"] == ref["tri"]) & (ref["tri"] >= 0)
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=1e-6,
                                   atol=1e-7)
    _check_dense_stats(got)
    # from inside the box every ray leaves through a pad slot
    P = torch.tensor(rng.uniform(-4, 4, (4096, 3)), dtype=torch.float32,
                     device="cuda")
    occ = isect.any_hit_kernel(poisoned, P, d, torch.full(
        (4096,), float("inf"), device="cuda"), active, counters=True)
    want = isect.any_hit_reference(scene.tris, P, d, torch.full(
        (4096,), float("inf"), device="cuda"), active)["occ"]
    assert 0.05 < want[live].float().mean() < 0.9
    assert (occ["occ"] != want).float().mean() <= 1e-3
    _check_dense_stats(occ)
    if masked:
        assert not got["t"][~active].isfinite().any()
        assert not occ["occ"][~active].any()


def _ordered_scene(v0, e1, e2):
    """Dense packs of triangles in the given order (no Morton sort),
    padded to 256 as scene/compile pads: the fields the dense kernels and
    accel/pack read."""
    from types import SimpleNamespace

    from lucille_tpu_torch.accel.pack import (
        SUB,
        pack_boxes,
        pack_super_boxes,
        pack_tris,
    )

    n = len(v0)
    n_pad = -(-n // 256) * 256
    rows = [torch.tensor(np.concatenate([a, np.zeros((n_pad - n, 3))]),
                         dtype=torch.float32, device="cuda")
            for a in (v0, e1, e2)]
    sc = SimpleNamespace(tri_v0=rows[0], tri_e1=rows[1], tri_e2=rows[2],
                         n_tris=n, n_pad=n_pad, device=rows[0].device)
    sc.tris = pack_tris(sc)
    sc.boxes = pack_boxes(sc)
    sc.sboxes = pack_super_boxes(sc.boxes)
    sc.sub_boxes = pack_boxes(sc, SUB)
    return sc


@pytest.mark.gpu
def test_dense_kernels_split_across_the_grid():
    """256 rays on 102 tiles: the kernels split the triangle range across
    the grid's second dimension (the dense strata scan's case).  One
    triangle copied into the first and the last chunk: the rays onto it
    tie exactly in t, and the lower index wins, as in the twin; every
    other answer equals the twin's, for the closest hit, and for the
    any-hit with a per-ray tmax and dead lanes."""
    _need_card()
    from lucille_tpu_torch.accel import isect
    from lucille_tpu_torch.accel.pack import SUPER, TC

    n, B = 13000, 256
    rng = np.random.default_rng(7)
    c = rng.uniform(-5, 5, (n, 3))
    v0 = c + rng.normal(0, 0.3, (n, 3))
    e1 = rng.normal(0, 0.3, (n, 3))
    e2 = rng.normal(0, 0.3, (n, 3))
    first, last = 5, n - 3
    for i in (first, last):  # a large triangle above the soup, facing +z
        v0[i], e1[i], e2[i] = (-3, -3, 8), (6, 0, 0), (0, 6, 0)
    scene = _ordered_scene(v0, e1, e2)
    chunks, per = isect.split_layout(B, n, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert chunks > 1
    assert first // (TC * SUPER) // per != last // (TC * SUPER) // per
    o, d = _shell_rays(B, seed=3)
    k = B // 2  # the first half straight down onto the copies
    xy = rng.uniform(-2, 0, (k, 2))
    o[:k] = torch.tensor(np.c_[xy, np.full(k, 20.0)], dtype=torch.float32,
                         device="cuda")
    d[:k] = torch.tensor([0.0, 0.0, -1.0], device="cuda")
    got = isect.closest_hit_kernel(scene, o, d)
    ref = isect.closest_hit_reference(scene.tris, o, d)
    assert torch.all(got["tri"][:k] == first) and torch.all(
        ref["tri"][:k] == first)
    assert torch.equal(got["t"][:k], ref["t"][:k])
    assert (got["tri"] != ref["tri"]).float().mean() <= 1e-3
    same = (got["tri"] == ref["tri"]) & (ref["tri"] >= 0)
    for key in ("t", "u", "v"):
        torch.testing.assert_close(got[key][same], ref[key][same], rtol=1e-6,
                                   atol=1e-7)
    assert torch.all(torch.isinf(got["t"][got["tri"] < 0]))
    _check_dense_stats(got)
    tmax = torch.tensor(rng.uniform(1, 25, B), dtype=torch.float32,
                        device="cuda")
    active = torch.tensor(rng.uniform(size=B) < 0.7, device="cuda")
    occ = isect.any_hit_kernel(scene, o, d, tmax, active)
    want = isect.any_hit_reference(scene.tris, o, d, tmax, active)["occ"]
    assert 0.1 < want.float().mean() < 0.9
    assert (occ["occ"] != want).float().mean() <= 1e-3
    assert not occ["occ"][~active].any()


def _tie_scene(n, rng):
    """n small random triangles in the order given (no Morton sort), with
    one large triangle above them, facing +z, copied into slots 5 and
    n - 3; (scene, first, last)."""
    c = rng.uniform(-5, 5, (n, 3))
    v0 = c + rng.normal(0, 0.3, (n, 3))
    e1 = rng.normal(0, 0.3, (n, 3))
    e2 = rng.normal(0, 0.3, (n, 3))
    first, last = 5, n - 3
    for i in (first, last):
        v0[i], e1[i], e2[i] = (-3, -3, 8), (6, 0, 0), (0, 6, 0)
    return _ordered_scene(v0, e1, e2), first, last


@pytest.mark.gpu
@pytest.mark.parametrize("bound", ["unbounded", "random", "at_the_hit",
                                   "past_the_hit"])
@pytest.mark.parametrize("path", ["one_chunk", "split"])
def test_closest_hit_kernel_tmax_cases(path, bound):
    """Kernel 1 with a per-ray tmax (the dirt map's gather) against its
    twin, with a third of the lanes dead and every pad slot poisoned
    (`_cube_faces`: a kernel that tested one would answer otherwise).
    one_chunk: 600 triangles, 4096 rays; split: 13,000 triangles in their
    given order, 256 rays (the triangle range split across the grid),
    half of them straight down onto the two copies of one triangle in the
    first and last chunk, an exact tie in t.  at_the_hit: tmax is each
    ray's unbounded t, so every ray misses (a hit needs t < tmax);
    past_the_hit: one ulp more, so every answer is the unbounded one and
    the tie goes to the lower copy.  A bound only shortens the walk: no
    more lane tests than unbounded, and no fewer than chip_smoke.dense_need
    counts up to min(hit, tmax)."""
    _need_card()
    import copy

    from chip_smoke import dense_need
    from lucille_tpu_torch.accel import isect

    rng = np.random.default_rng(11)
    if path == "split":
        B = 256
        scene, first, _last = _tie_scene(13000, rng)
        poisoned = copy.copy(scene)
        poisoned.tris = scene.tris.clone()
        poisoned.tris[:9, scene.n_tris:] = _cube_faces(
            -6.5, 6.5, scene.tris.shape[1] - scene.n_tris)
        chunks, _per = isect.split_layout(
            B, scene.n_tris,
            torch.cuda.get_device_properties(0).multi_processor_count)
        assert chunks > 1
    else:
        B = 4096
        scene = _soup_scene(600)
        poisoned = _cube_poison(scene, -6.5, 6.5)
    o, d = _shell_rays(B, seed=5)
    k = B // 2
    if path == "split":  # the first half straight down onto the copies
        o[:k] = torch.tensor(np.c_[rng.uniform(-2, 0, (k, 2)),
                                   np.full(k, 20.0)],
                             dtype=torch.float32, device="cuda")
        d[:k] = torch.tensor([0.0, 0.0, -1.0], device="cuda")
    active = torch.tensor(rng.uniform(size=B) < 0.67, device="cuda")
    free = isect.closest_hit_reference(scene.tris, o, d)
    inf = torch.full((B,), float("inf"), device="cuda")
    hit_t = torch.where(free["tri"] >= 0, free["t"], 30.0)
    tmax = {"unbounded": None,
            "random": torch.tensor(rng.uniform(1, 25, B), dtype=torch.float32,
                                   device="cuda"),
            "at_the_hit": hit_t,
            "past_the_hit": torch.nextafter(hit_t, inf)}[bound]
    got = isect.closest_hit_kernel(poisoned, o, d, tmax, active)
    ref = isect.closest_hit_reference(scene.tris, o, d, tmax, active)
    assert int(got["tri"].max()) < scene.n_tris
    assert (got["tri"] != ref["tri"]).float().mean() <= 1e-3
    same = (got["tri"] == ref["tri"]) & (ref["tri"] >= 0)
    for key in ("t", "u", "v"):
        torch.testing.assert_close(got[key][same], ref[key][same], rtol=1e-6,
                                   atol=1e-7)
    miss = got["tri"] < 0
    assert torch.all(torch.isinf(got["t"][miss]))
    assert not got["u"][miss].any() and not got["v"][miss].any()
    assert torch.all(got["tri"][~active] < 0)
    live_hits = (ref["tri"][active] >= 0).float().mean()
    if bound == "at_the_hit":
        assert torch.all(miss)
    else:
        assert live_hits > 0.1
    if bound == "past_the_hit":
        assert torch.equal(got["tri"], torch.where(active, free["tri"], -1))
    if path == "split" and bound != "at_the_hit":
        tie = active[:k] & (free["t"][:k] < (inf[:k] if tmax is None
                                              else tmax[:k]))
        assert tie.any() and torch.all(got["tri"][:k][tie] == first)
    # the walk's work: within the unbounded walk's, above the need
    unbounded = isect.closest_hit_kernel(poisoned, o, d, None, active)
    assert int(got["ntests"]) <= int(unbounded["ntests"])
    t_end = torch.where(got["tri"] >= 0, torch.nextafter(got["t"], inf),
                        inf if tmax is None else tmax)
    need = dense_need(scene, o, d, t_end, live=active)
    assert int(got["ntests"]) >= need["groups"]
    _check_dense_stats(got)


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris,ntheta",
                         [(400, 5), (1100, 8), (400, 16), (300, 8),
                          (2500, 24)])
def test_ao_bits_kernel_matches_plain(n_tris, ntheta):
    """The gather's bits output below and above the Morton-order threshold,
    S = 25 (one part-filled row), 64 (two rows), 256 (eight, for
    --gather-rays 256) and 576 (eighteen: 36 chunks of 16, so each
    thread of a lane's 32 takes two rounds), on soups of 3 tiles (the
    last part-filled), 4, 9 and 20 tiles (two supertiles, the second
    ragged): counts as test_ao_kernel_matches_plain, bits on all but
    1e-3 of the lanes, each lane's count equal to its popcount, rows 0
    at or past nact."""
    _need_card()
    from lucille_tpu_torch.accel import ao

    scene, rays, u01 = _gather_inputs(n_tris, 1000)
    nact = torch.tensor(900, dtype=torch.int32, device="cuda")
    S = ntheta * ntheta
    occ, bits = ao.ao_occlusion_kernel(scene, rays, u01, nact, ntheta, ntheta,
                                       want_bits=True)
    ref_occ, ref_bits = ao.ao_occlusion_reference(
        scene.occ, rays[:, :900], u01[:, :900], ntheta, ntheta,
        want_bits=True)
    assert bits.shape == (-(-S // 32), 1000) and bits.dtype == torch.int32
    assert torch.all(occ[900:] == 0) and torch.all(bits[:, 900:] == 0)
    assert torch.equal(ao.unpack_bits(bits, S).sum(dim=0).float(), occ)
    assert ref_occ.mean() > 1.0
    differ = (bits[:, :900] != ref_bits).any(dim=0)
    assert differ.float().mean() <= 1e-3
    plain = ao.ao_occlusion_kernel(scene, rays, u01, nact, ntheta, ntheta)
    assert torch.equal(plain, occ)


@pytest.mark.gpu
@pytest.mark.parametrize("n_live", ["none", "all"])
@pytest.mark.parametrize("ntheta,nphi", [(2, 2), (3, 5)])
@pytest.mark.parametrize("n_tris", [300, 400, 1300])
def test_ao_kernel_layouts_match_plain(n_tris, ntheta, nphi, n_live):
    """Both instantiations at S = 4 (2x2, Whitted's dome: one thread a
    lane) and S = 15 (3x5, ntheta != nphi: four threads of 4 strata, the
    last chunk ragged), on soups of 3 tiles (the last part-filled), 4
    tiles (hit-first lane order) and 11 tiles (Morton order), with nact
    = 0 (the dead-bounce launch: every output 0) and nact = B (every
    lane live): counts and bits as test_ao_bits_kernel_matches_plain,
    each lane's count its bits' popcount."""
    _need_card()
    from lucille_tpu_torch.accel import ao

    B = 1000
    scene, rays, u01 = _gather_inputs(n_tris, B)
    n = 0 if n_live == "none" else B
    nact = torch.tensor(n, dtype=torch.int32, device="cuda")
    S = ntheta * nphi
    launch = lambda bits: ao.ao_occlusion_kernel(  # noqa: E731
        scene, rays, u01, nact, ntheta, nphi, want_bits=bits)
    occ, bits = launch(True)
    assert torch.equal(launch(False), occ)
    assert bits.shape == (1, B)
    assert torch.equal(ao.unpack_bits(bits, S).sum(dim=0).float(), occ)
    if n == 0:
        assert not torch.any(occ) and not torch.any(bits)
        return
    ref_occ, ref_bits = ao.ao_occlusion_reference(
        scene.occ, rays, u01, ntheta, nphi, want_bits=True)
    assert 0.25 < ref_occ.mean() < S - 0.25  # both answers occur
    diff = (occ - ref_occ).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3
    assert (bits != ref_bits).any(dim=0).float().mean() <= 1e-3


def _occ_poison(scene, lo, hi):
    """A copy of the dense scene whose occlusion pack's pad slots hold the
    box [lo, hi]^3 (`_cube_faces`, as [v0 | v1 | v2 | n]), its boxes and
    n_tris left as they are: a gather that tested a pad slot would find
    every stratum of a lane inside the box occluded."""
    import dataclasses

    f = _cube_faces(lo, hi, scene.occ.shape[1] - scene.n_tris)
    v0, e1, e2 = f[0:3], f[3:6], f[6:9]
    occ = scene.occ.clone()
    occ[:12, scene.n_tris:] = torch.cat(
        [v0, v0 + e1, v0 + e2, torch.linalg.cross(e1, e2, dim=0)])
    return dataclasses.replace(scene, occ=occ)


@pytest.mark.gpu
@pytest.mark.parametrize("want_bits", [False, True])
@pytest.mark.parametrize("n_tris,ntheta,nphi", [
    (300, 8, 8), (322, 2, 2), (400, 8, 8), (600, 3, 5), (3000, 8, 8)])
def test_ao_kernel_never_tests_padding(n_tris, ntheta, nphi, want_bits):
    """The pad slots past n_tris of a copy hold a box around the lanes'
    points (every stratum of every lane meets it): the gather answers on
    the copy exactly as on the scene.  300 and 322 triangles: the last
    tile part-filled; 400 and 600: a part-filled tile then one of padding
    alone; 3000: two supertiles, the second ragged."""
    _need_card()
    from lucille_tpu_torch.accel import ao

    scene, rays, u01 = _gather_inputs(n_tris, 1000)
    poisoned = _occ_poison(scene, -6.5, 6.5)
    nact = torch.tensor(900, dtype=torch.int32, device="cuda")
    S = ntheta * nphi
    ref = ao.ao_occlusion_reference(poisoned.occ, rays[:, :100],
                                    u01[:, :100], ntheta, nphi)
    assert torch.all(ref == S)  # the twin, which tests them, meets them
    got = ao.ao_occlusion_kernel(poisoned, rays, u01, nact, ntheta, nphi,
                                 want_bits)
    want = ao.ao_occlusion_kernel(scene, rays, u01, nact, ntheta, nphi,
                                  want_bits)
    for g, w in zip(got if want_bits else (got,),
                    want if want_bits else (want,)):
        assert torch.equal(g, w)
    occ = want[0] if want_bits else want
    assert occ[:900].mean() < S - 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris,ntheta,nphi,n_live", [
    (300, 3, 4, 1000), (1100, 8, 8, 700), (2500, 8, 8, 1000),
    (400, 2, 2, 300), (600, 16, 16, 200)])
def test_ao_kernel_counters(n_tris, ntheta, nphi, n_live):
    """The gather's counters (counters=True): two launches on equal
    inputs count alike; every counter equals chip_smoke.gather_walk's
    plain count of the same walk; and the walk keeps slot order, so its
    (stratum, triangle) tests equal chip_smoke.gather_need's, the work
    the data needs (its group box tests, of the quarters a stratum
    reaches, at most gather_need's).  Answers as without counters."""
    _need_card()
    from chip_smoke import gather_need, gather_walk

    from lucille_tpu_torch.accel import ao

    scene, rays, u01 = _gather_inputs(n_tris, 1000)
    nact = torch.tensor(n_live, dtype=torch.int32, device="cuda")
    S = ntheta * nphi
    (occ, bits), st = ao.ao_occlusion_kernel(scene, rays, u01, nact, ntheta,
                                             nphi, True, counters=True)
    (occ2, bits2), st2 = ao.ao_occlusion_kernel(scene, rays, u01, nact,
                                                ntheta, nphi, True,
                                                counters=True)
    plain = ao.ao_occlusion_kernel(scene, rays, u01, nact, ntheta, nphi,
                                   True)
    assert torch.equal(occ, plain[0]) and torch.equal(bits, plain[1])
    assert torch.equal(occ, occ2) and torch.equal(bits, bits2)
    got = {k: int(v) for k, v in st.items()}
    assert got == {k: int(v) for k, v in st2.items()}
    walk = gather_walk(scene, rays, u01, n_live, ntheta, nphi)
    assert torch.equal(walk.pop("occluded"),
                       ao.unpack_bits(bits[:, :n_live], S))
    assert got == walk
    b0, b1, b2 = (rays[3 * c:3 * c + 3, :n_live].T for c in (1, 2, 3))
    need = gather_need(scene, rays[0:3, :n_live].T, b0, b1, b2,
                       u01[:, :n_live], ntheta, nphi)
    assert got["tests"] == need["tests"] > 0
    assert got["group_tests"] <= need["groups"]
    assert got["tile_tests"] >= need["tiles"]
    assert 0 < got["tests"] <= 32 * got["warp_steps"]


@pytest.mark.gpu
@pytest.mark.parametrize("accel", ["pallas", "bvh"])
def test_sunsky_frame_matches_plain(accel):
    """The bundled scene as shipped (its sunsky light) rendered on the card
    and on the CPU's plain twins with the same jitter: every pixel within
    1e-3 of its value (relative, values in the thousands) but for at most
    1% of them (a flipped stratum)."""
    _need_card()
    from pathlib import Path

    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib

    rib = Path(__file__).resolve().parent / "golden" / "sunsky_scene.rib"

    def state():
        s = RiState()
        parse_rib(rib.read_text(), s)
        s.Format(48, 32)
        s.PixelSamples(2, 2)
        s.options.gather_nsamples = 16
        s.options.accel_method = accel
        return s

    from lucille_tpu_torch.sampling.jitter import HostSampler

    got = Renderer(state().scene, tile_size=16, device="cuda",
                   sampler=HostSampler(0, "cuda")).render_frame()
    ref = Renderer(state().scene, tile_size=16, device="cpu",
                   sampler=HostSampler(0, "cpu")).render_frame()
    assert ref.mean() > 100.0
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert (rel > 1e-3).mean() <= 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("ntheta,nphi", [(8, 8), (2, 2), (6, 7)])
def test_sky_gather_kernel_matches_plain(ntheta, nphi):
    """The sunsky gather's sky (csrc/ao.cu sky_gather_kernel) against its
    plain twin on the same compacted inputs: the first tile of the
    bundled scene as shipped (48x32, 2x2 samples, tile 16), kernel 3b's
    own bits of it, nact below the hit lanes and below B.  S = 64, 4 and
    42 (a bits row part-filled).  Every live lane's sum within 1e-5 of
    its value, relatively, plus 1e-3 (the values are in the thousands;
    the two sum in one order, and the device's arccos, exp, cos and sin
    may round an ulp apart from torch's); lanes at or past nact exactly
    0; the counters: the open (lane, stratum) pairs are the clear bits of
    the live lanes, the live lanes nact."""
    _need_card()
    from pathlib import Path

    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.render.renderer import Renderer, tile_eye_rays
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples
    from lucille_tpu_torch.sampling.jitter import HostSampler
    from lucille_tpu_torch.transport.ao import shading_frame

    rib = Path(__file__).resolve().parent / "golden" / "sunsky_scene.rib"
    st = RiState()
    parse_rib(rib.read_text(), st)
    st.Format(48, 32)
    st.PixelSamples(2, 2)
    r = Renderer(st.scene, tile_size=16, device="cuda",
                 sampler=HostSampler(0, "cuda"))
    sky = next(li.sunsky for li in r.lights if li.type == "sunsky")
    sub = torch.tensor(subpixel_samples(2, 2)[0], dtype=torch.float32,
                       device="cuda")
    org, dirn = tile_eye_rays(r.camera, 16, 0, 16, 16, sub)
    res = closest_hit(r.scene, org, dirn)
    P_off, b0, b1, b2 = shading_frame(r.scene, org, dirn, res)
    B = org.shape[0]
    jitter = r.sampler(16, 0).uniform((), (2, B))
    _order, nhit, rays, (_occ, bits) = ao._gather(
        r.scene, P_off, b0, b1, b2, res["hit"], jitter, ntheta, nphi, True)
    n = int(nhit) * 3 // 4
    assert 0 < n < int(nhit) < B
    nact = torch.tensor(n, dtype=torch.int32, device="cuda")
    S = ntheta * nphi
    ao.SKY_COUNTS.reset()
    col, cnt = ao.sky_gather_kernel(rays, jitter, bits, nact, ntheta, nphi,
                                    sky, counters=True)
    assert torch.equal(ao.sky_gather_kernel(rays, jitter, bits, nact, ntheta,
                                            nphi, sky), col)
    assert (ao.SKY_COUNTS.kernel, ao.SKY_COUNTS.plain) == (2, 0)
    ref = ao.sky_gather_reference(rays[:, :n], jitter[:, :n], bits[:, :n],
                                  ntheta, nphi, sky)
    assert col.shape == (B, 3) and col.dtype == torch.float32
    assert torch.all(col[n:] == 0)
    assert ref.min() > 100.0
    assert ((col[:n] - ref).abs() <= 1e-5 * ref.abs() + 1e-3).all()
    open_bits = ~ao.unpack_bits(bits[:, :n], S)
    assert 0 < open_bits.float().mean() < 1
    assert int(cnt["open_pairs"]) == int(open_bits.sum())
    assert int(cnt["live_lanes"]) == n


@pytest.mark.gpu
@pytest.mark.parametrize("bounded", [False, True])
def test_bvh_closest_hit_kernel_matches_plain(bounded):
    _need_card()
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.pack import pack_tris

    scene = _soup_scene(3000, accel="bvh")
    assert scene.accel == "pbvh" and scene.n_nodes > 1
    o, d = _shell_rays(4096)
    tmax = torch.full((4096,), float("inf"), device="cuda")
    if bounded:
        gen = torch.Generator(device="cuda").manual_seed(4)
        tmax = 8.0 + 8.0 * torch.rand(4096, device="cuda", generator=gen)
    tris = pack_tris(scene)
    got = bvh_isect.bvh_closest_hit(tris, scene.nodes, o, d, tmax,
                                    depth=scene.tree_depth,
                                    leaf_real=scene.leaf_real)
    ref = bvh_isect.bvh_closest_hit_reference(tris, o, d, tmax)
    hit = got["tri"] >= 0
    assert torch.equal(hit, ref["tri"] >= 0)
    assert 0.1 < hit.float().mean() < 1.0
    assert (got["tri"] != ref["tri"]).float().mean() <= 1e-3
    same = (got["tri"] == ref["tri"]) & hit
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=1e-6,
                                   atol=1e-7)
    assert torch.equal(got["t"][~hit], tmax[~hit])
    _check_closest_walk(got, tris, scene.nodes, o, d, scene.tree_depth, tmax)


@pytest.mark.gpu
@pytest.mark.parametrize("bounded", [False, True])
def test_bvh_any_hit_kernel_matches_plain(bounded):
    """tmax = inf is the AO gather's case: inf * a^2 must behave as in
    the twin (and in JAX)."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.pack import pack_tris

    scene = _soup_scene(3000, accel="bvh")
    rng = np.random.default_rng(1)
    o = torch.tensor(rng.uniform(-4, 4, (5000, 3)), dtype=torch.float32,
                     device="cuda")
    d = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(5000, 3)), dtype=torch.float32, device="cuda"),
        dim=-1)
    tmax = (torch.tensor(rng.uniform(0.5, 12, 5000), dtype=torch.float32,
                         device="cuda") if bounded else None)
    tris = pack_tris(scene)
    got = bvh_isect.bvh_any_hit(tris, scene.nodes, o, d, tmax,
                                depth=scene.tree_depth,
                                leaf_real=scene.leaf_real)
    ref = bvh_isect.bvh_any_hit_reference(
        tris, o, d, torch.full((5000,), float("inf"), device="cuda")
        if tmax is None else tmax)
    assert 0.1 < ref["occ"].float().mean() < 0.95
    assert (got["occ"] != ref["occ"]).float().mean() <= 1e-3
    _check_walk_stats(got, 5000)


def _check_walk_stats(res, n_rays):
    """The warp walk's counters: lane work within 32 lanes of the warps'
    work, and some of each."""
    ntrav, ntests = int(res["ntrav"]), int(res["ntests"])
    wtrav, wtests = int(res["warp_ntrav"]), int(res["warp_ntests"])
    assert n_rays <= ntrav <= 32 * wtrav
    assert 0 < ntests <= 32 * wtests


def _chain_tree(depth, n_real_max=128, seed=0):
    """A tile BVH built by hand as a chain of `depth` inner nodes: inner
    node i's first child is inner node i + 1 (the last one's a leaf), its
    second a leaf; every box is the whole scene's, so every ray reaches
    every node, and a walk that enters first children first holds `depth`
    entries on its stack at the chain's end.  Each leaf is one tile of a
    random soup's triangles, 1 to n_real_max of them real, the rest
    padding.  Returns (tris (16, npad), nodes (M, 8), leaf_real (M,) i32)
    on cuda, laid out as pack_tris, pack_nodes and scene.leaf_real."""
    from lucille_tpu_torch.accel.pack import TC
    from lucille_tpu_torch.accel.tile_bvh import tree_depth

    n_leaves = depth + 1
    m = 2 * depth + 1  # DFS: inner 0..depth-1, the chain's leaf, the rest
    rng = np.random.default_rng(seed)
    real = rng.integers(1, n_real_max + 1, n_leaves)
    tris = np.zeros((16, n_leaves * TC), np.float32)
    for tile, n in enumerate(real):
        c = rng.uniform(-5, 5, (n, 3))
        v = [c + rng.normal(0, 0.3, (n, 3)) for _ in range(3)]
        cols = slice(tile * TC, tile * TC + n)
        tris[0:3, cols] = v[0].T
        tris[3:6, cols] = (v[1] - v[0]).T
        tris[6:9, cols] = (v[2] - v[0]).T
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = -7.0
    nodes[:, 4:7] = 7.0
    bits = nodes.view(np.int32)
    leaf_real = np.zeros(m, np.int32)
    for i in range(depth):
        bits[i, 3] = -(i % 3 + 1)  # split axes x, y, z in turn
        bits[i, 7] = 2 * depth - i  # the second child, after the chain
    leaves = [depth] + [2 * depth - i for i in range(depth)]
    for tile, node in enumerate(leaves):
        bits[node, 3], bits[node, 7] = 1, tile
        leaf_real[node] = real[tile]
    assert tree_depth(nodes) == depth
    return (torch.tensor(tris, device="cuda"),
            torch.tensor(nodes, device="cuda"),
            torch.tensor(leaf_real, device="cuda"))


def _random_rays(B, seed, x_sign=None):
    """B rays from inside the soups' box in random directions; x_sign
    +1 points every direction's x up (the lanes agree on the near child
    of an x split), None leaves it random (they disagree)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (B, 3))
    d = rng.normal(size=(B, 3))
    if x_sign is not None:
        d[:, 0] = x_sign * np.abs(d[:, 0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device="cuda"),
            torch.tensor(d, dtype=torch.float32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["multitile", "parked", "deep-agree",
                                  "deep-mixed"])
@pytest.mark.parametrize("bounded", [False, True])
def test_bvh_any_hit_warp_walk_cases(case, bounded):
    """Kernel 5's warp walk against its twin: leaves of several tiles (a
    24-node budget); 70 parked rays (outside the box, pointing away: two
    whole warps and part of a third that leave at the root) among 3001
    (the last warp part-filled); a hand-built tree at the stack's depth
    whose lanes agree on every near child (the stack fills to 64) or
    disagree.  Parked rays report no occlusion."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.bvh_isect import STACK

    B = 3001
    if case.startswith("deep"):
        tris, nodes, leaf_real = _chain_tree(STACK)
        depth = STACK
        o, d = _random_rays(B, 2, 1.0 if case == "deep-agree" else None)
    else:
        scene = _soup_scene(3000, accel="bvh",
                            node_budget=24 if case == "multitile" else None)
        if case == "multitile":
            assert int(scene.nodes.view(torch.int32)[:, 3].max()) > 1
        tris, nodes, leaf_real = scene.tris, scene.nodes, scene.leaf_real
        depth = scene.tree_depth
        o, d = _random_rays(B, 3)
    if case == "parked":
        o[:70] = torch.tensor([40.0, 40.0, 40.0], device="cuda")
        d[:70] = torch.tensor([0.0, 0.0, 1.0], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    tmax = (0.5 + 11.5 * torch.rand(B, device="cuda", generator=gen)
            if bounded else torch.full((B,), float("inf"), device="cuda"))
    got = bvh_isect.bvh_any_hit(tris, nodes, o, d, tmax if bounded else None,
                                depth=depth, leaf_real=leaf_real)
    ref = bvh_isect.bvh_any_hit_reference(tris, o, d, tmax)["occ"]
    assert 0.1 < ref.float().mean() < 0.95
    assert (got["occ"] != ref).float().mean() <= 1e-3
    if case == "parked":
        assert not got["occ"][:70].any()
    _check_walk_stats(got, B - (70 if case == "parked" else 0))


def _check_closest_walk(got, tris, nodes, o, d, depth, tmax=None,
                        active=None):
    """Kernel 4 walks chip_smoke.need_walk's near-first walk exactly: on
    every live ray the same triangle and t, and the same node visits and
    real triangle tests; its leaf steps test at most a warp's 32
    triangles each."""
    from chip_smoke import need_walk

    live = (torch.arange(o.shape[0], device="cuda") if active is None
            else torch.nonzero(active)[:, 0])
    need = need_walk(tris, nodes, o[live], d[live], True, depth,
                     tmax=None if tmax is None else tmax[live])
    assert torch.equal(got["tri"][live].long(), need["tri"])
    torch.testing.assert_close(got["t"][live], need["t"], rtol=1e-6,
                               atol=1e-7)
    assert (int(got["ntrav"]), int(got["ntests"])) == (need["nodes"],
                                                       need["tests"])
    assert int(got["warp_ntrav"]) == need["nodes"]
    assert 0 <= int(got["ntests"]) <= 32 * int(got["warp_ntests"])
    return need


def _poison_pads(tris, lo, hi):
    """A copy of a tile-BVH pack whose pad slots (all zero) hold the box
    [lo, hi]^3 (`_cube_faces`): a kernel that tested a pad slot would
    answer differently."""
    pads = torch.nonzero(~(tris[0:9] != 0).any(dim=0))[:, 0]
    out = tris.clone()
    out[:9, pads] = _cube_faces(lo, hi, len(pads))
    return out


def _one_leaf_ties(n_real=70):
    """A tree of one leaf (one tile, n_real real slots, the rest padding):
    slots 3, 5 (one chunk) and 40, 69 (later chunks, 69 the last real
    slot) hold the same triangle, (-2, -2, 0) (2, -2, 0) (-2, 2, 0), the
    other real slots small triangles below it.  Rays straight down onto
    it from z = 5 tie at t = 5 on all four: the lowest, slot 3, must
    win."""
    rng = np.random.default_rng(8)
    tris = np.zeros((16, 128), np.float32)
    c = rng.uniform(-3, 3, (n_real, 3))
    c[:, 2] = rng.uniform(-4, -1, n_real)
    v = [c + rng.normal(0, 0.2, (n_real, 3)) for _ in range(3)]
    tris[0:3, :n_real] = v[0].T
    tris[3:6, :n_real] = (v[1] - v[0]).T
    tris[6:9, :n_real] = (v[2] - v[0]).T
    for slot in (3, 5, 40, n_real - 1):
        tris[0:9, slot] = [-2, -2, 0, 4, 0, 0, 0, 4, 0]
    nodes = np.zeros((1, 8), np.float32)
    nodes[0, 0:3], nodes[0, 4:7] = -6.0, 6.0
    bits = nodes.view(np.int32)
    bits[0, 3], bits[0, 7] = 1, 0
    return (torch.tensor(tris, device="cuda"),
            torch.tensor(nodes, device="cuda"),
            torch.tensor([n_real], dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["multitile", "ragged", "parked",
                                  "deep-agree", "deep-mixed", "poisoned",
                                  "tie"])
@pytest.mark.parametrize("bounded", [False, True])
def test_bvh_closest_hit_group_walk_cases(case, bounded):
    """Kernel 4 (a warp a ray) against its twin and against
    need_walk's walk: leaves of several tiles (a 24-node budget); leaves
    whose real triangles end inside a chunk; 300 dead rays and 70 parked
    ones (outside the box, pointing away) among 3001; a hand-built tree
    at the stack's depth whose rays agree on every near child (the stack
    fills to 64) or disagree; pad slots poisoned with triangles every ray
    meets, which change no answer; an exact tie in t inside one leaf,
    within a chunk and across chunks, where the lowest slot wins.
    Bounded: a random tmax per ray that cuts some hits short."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.bvh_isect import STACK

    B = 3001
    active = None
    if case.startswith("deep"):
        tris, nodes, leaf_real = _chain_tree(STACK)
        depth = STACK
        o, d = _random_rays(B, 2, 1.0 if case == "deep-agree" else None)
    elif case == "tie":
        tris, nodes, leaf_real = _one_leaf_ties()
        depth = 0
        rng = np.random.default_rng(9)  # points well inside the triangle
        uv = rng.uniform(0.02, 0.48, (B, 2))
        o = torch.tensor(np.c_[-2.0 + 4.0 * uv, np.full(B, 5.0)],
                         dtype=torch.float32, device="cuda")
        d = torch.tensor([[0.0, 0.0, -1.0]] * B, device="cuda")
    else:
        scene = _soup_scene(3000, accel="bvh",
                            node_budget=24 if case == "multitile" else None)
        tris, nodes, leaf_real = scene.tris, scene.nodes, scene.leaf_real
        depth = scene.tree_depth
        o, d = _shell_rays(B, seed=3)
        if case == "multitile":
            assert int(nodes.view(torch.int32)[:, 3].max()) > 1
        if case == "ragged":  # some leaf ends inside every lane count's chunk
            n = leaf_real[nodes.view(torch.int32)[:, 3] > 0]
            assert bool(((n % 32) % 4 != 0).any())
    if case == "parked":
        o[:70] = torch.tensor([40.0, 40.0, 40.0], device="cuda")
        d[:70] = torch.tensor([0.0, 0.0, 1.0], device="cuda")
        active = torch.ones(B, dtype=torch.bool, device="cuda")
        active[torch.randperm(B, generator=torch.Generator().manual_seed(
            3))[:300].to("cuda")] = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    tmax = (2.0 + 14.0 * torch.rand(B, device="cuda", generator=gen)
            if bounded else torch.full((B,), float("inf"), device="cuda"))
    if case == "tie" and bounded:  # half the rays end before the plane
        tmax[: B // 2], tmax[B // 2:] = 4.0, 6.0
    pack = _poison_pads(tris, -6.5, 6.5) if case == "poisoned" else tris
    got = bvh_isect.bvh_closest_hit(pack, nodes, o, d,
                                    tmax if bounded else None, active,
                                    depth=depth, leaf_real=leaf_real)
    ref = bvh_isect.bvh_closest_hit_reference(tris, o, d, tmax, active)
    hit = got["tri"] >= 0
    assert torch.equal(hit, ref["tri"] >= 0)
    assert 0.1 < hit.float().mean() < 1.0 or case == "tie"
    assert (got["tri"] != ref["tri"]).float().mean() <= 1e-3
    same = (got["tri"] == ref["tri"]) & hit
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=1e-6,
                                   atol=1e-7)
    assert torch.equal(got["t"][~hit], tmax[~hit])
    need = _check_closest_walk(got, tris, nodes, o, d, depth, tmax, active)
    if case == "tie":
        assert torch.all(got["tri"][hit] == 3)
        assert torch.all(got["t"][hit] == 5.0)
        assert int(hit.sum()) == (B - B // 2 if bounded else B)
    if active is not None:
        assert not hit[~active].any()
    if case == "parked":
        assert not hit[:70].any()


def _flat_grid_desc(n):
    """n x n unit squares in the plane z = 0, two triangles each, as a
    scene description asking for the tile BVH: every shared edge is
    exactly representable."""
    from lucille_tpu_torch.ri.types import (
        AttributeState,
        GeomData,
        SceneDescription,
    )

    xs, ys = np.meshgrid(np.arange(n + 1), np.arange(n + 1))
    pos = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3)
    a = (np.arange(n)[None, :] + (n + 1) * np.arange(n)[:, None]).ravel()
    idx = np.concatenate([np.stack([a, a + 1, a + n + 2], -1),
                          np.stack([a, a + n + 2, a + n + 1], -1)])
    desc = SceneDescription()
    desc.geoms.append(GeomData(positions=pos.astype(np.float32),
                               indices=idx.astype(np.int32),
                               attrs=AttributeState()))
    desc.options.accel_method = "bvh"
    return desc


def shared_edge_ray(tri_v0, tri_e1, tri_e2):
    """Two slots in different leaf tiles that share an edge, and a ray
    straight down onto the edge's midpoint: ((lo, hi) slots, origin (3,),
    direction (3,)).  Both triangles report t = 5 exactly."""
    from lucille_tpu_torch.accel.pack import TC

    v0 = np.asarray(tri_v0)
    corners = np.stack([v0, v0 + np.asarray(tri_e1),
                        v0 + np.asarray(tri_e2)], 1)
    edges = {}
    for slot in np.flatnonzero(np.any(corners != 0, axis=(1, 2))):
        for i, j in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(corners[slot, i]),
                                tuple(corners[slot, j]))))
            edges.setdefault(key, []).append(int(slot))
    (a, b), pair = next((k, sorted(s)) for k, s in edges.items()
                        if len(s) == 2 and s[0] // TC != s[1] // TC)
    org = np.array([(a[0] + b[0]) / 2, (a[1] + b[1]) / 2, 5.0], np.float32)
    return tuple(pair), org, np.array([0.0, 0.0, -1.0], np.float32)


@pytest.mark.gpu
def test_bvh_kernels_on_a_shared_edge_tie():
    """A ray straight down onto an edge shared by two triangles in
    different leaves: the twin keeps the lower slot, the kernel the one
    its walk meets first; both report t = 5."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.pack import pack_tris
    from lucille_tpu_torch.scene.compile import compile_scene

    scene = compile_scene(_flat_grid_desc(16), "cuda")  # 512 triangles
    pair, o, d = shared_edge_ray(scene.tri_v0.cpu(), scene.tri_e1.cpu(),
                                 scene.tri_e2.cpu())
    o = torch.tensor(o[None], device="cuda")
    d = torch.tensor(d[None], device="cuda")
    tris = pack_tris(scene)
    got = bvh_isect.bvh_closest_hit(tris, scene.nodes, o, d,
                                    depth=scene.tree_depth,
                                    leaf_real=scene.leaf_real)
    ref = bvh_isect.bvh_closest_hit_reference(
        tris, o, d, torch.full((1,), float("inf"), device="cuda"))
    assert float(got["t"][0]) == float(ref["t"][0]) == 5.0
    assert int(ref["tri"][0]) == pair[0]
    assert int(got["tri"][0]) in pair
    # the leaf the walk visits first keeps the tie
    _check_closest_walk(got, tris, scene.nodes, o, d, scene.tree_depth)
    occ = bvh_isect.bvh_any_hit(tris, scene.nodes, o, d,
                                depth=scene.tree_depth,
                                leaf_real=scene.leaf_real)["occ"]
    assert bool(occ[0])


@pytest.mark.gpu
def test_bvh_ao_gather_matches_plain():
    """The whole cone-tiled gather on the card (ray assembly, the any-hit
    kernel, the sum back to raster order) against the any-hit twin on the
    same gather rays; B = 1000 is not a multiple of the origin group."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_ao, bvh_isect
    from lucille_tpu_torch.accel.pack import pack_tris
    from lucille_tpu_torch.transport.ao import ortho_basis

    scene = _soup_scene(3000, accel="bvh")
    rng = np.random.default_rng(1)
    P = torch.tensor(rng.uniform(-4, 4, (1000, 3)), dtype=torch.float32,
                     device="cuda")
    N = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(1000, 3)), dtype=torch.float32, device="cuda"),
        dim=-1)
    b0, b1, b2 = ortho_basis(N)
    hit = torch.tensor(rng.uniform(size=1000) < 0.8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    jitter = torch.rand((2, 1000), device="cuda", generator=gen)
    bvh_isect.ANY_COUNTS.reset()
    occ, stats = bvh_ao.bvh_ao_occlusion(scene, P, b0, b1, b2, hit, jitter,
                                         4, 4)
    assert bvh_isect.ANY_COUNTS.kernel == 1 and bvh_isect.ANY_COUNTS.plain == 0
    oo, dd, order, (NG, S, G, Bpad) = bvh_ao.conetile_rays(
        scene, P, b0, b1, b2, hit, jitter, 4, 4)
    ref = bvh_isect.bvh_any_hit_reference(
        pack_tris(scene), oo, dd, torch.full((S * Bpad,), float("inf"),
                                             device="cuda"))["occ"]
    want = torch.zeros(Bpad, device="cuda")
    want[order] = ref.float().reshape(NG, S, G).sum(dim=1).reshape(-1)
    want = want[:1000] * hit.float()
    diff = (occ - want).abs()
    assert want[hit].mean() > 0.5
    assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3
    assert torch.all(occ[~hit] == 0) and int(stats["ntrav"]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("accel", ["pallas", "bvh"])
def test_closest_hit_active_matches_plain(accel):
    """A bounce wavefront's live mask: dead rays report a miss (t +inf on
    the dense tiles, tmax on the tile BVH), live rays the twin's hit."""
    _need_card()
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.accel import bvh_isect, isect
    from lucille_tpu_torch.accel.pack import pack_tris

    scene = _soup_scene(1500, accel=accel)
    o, d = _shell_rays(3000, seed=4)
    rng = np.random.default_rng(3)
    active = torch.tensor(rng.uniform(size=3000) < 0.6, device="cuda")
    got = closest_hit(scene, o, d, active=active)
    tris = pack_tris(scene)
    if accel == "pallas":
        ref = isect.closest_hit_reference(tris, o, d, active=active)
    else:
        inf = torch.full((3000,), float("inf"), device="cuda")
        ref = bvh_isect.bvh_closest_hit_reference(tris, o, d, inf, active)
    assert got["hit"][active].float().mean() > 0.2
    assert not got["hit"][~active].any()
    assert torch.all(torch.isinf(got["t"][~active]))
    assert (got["tri"] != torch.clamp_max(ref["tri"], scene.tri_v0.shape[0]
                                          - 1)).float().mean() <= 1e-3
    same = got["hit"] & (got["tri"] == ref["tri"])
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=1e-6,
                                   atol=1e-7)
    # every ray dead: nothing is tested
    none = closest_hit(scene, o, d, active=torch.zeros_like(active))
    assert not none["hit"].any()
    if accel == "bvh":
        assert int(none["ntrav"]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris,ntheta,nphi", [
    (3000, 8, 8), (3000, 3, 3), (800, 2, 2), (3000, 1, 1), (3000, 1, 2),
    (3000, 2, 3), (3000, 4, 5), (800, 3, 5), ("multitile", 4, 4),
    ("deep", 8, 8), ("deep", 2, 3)])
def test_bvh_ao_fused_kernel_matches_plain(n_tris, ntheta, nphi):
    """Kernel 6 against its twin on the same compacted slots, at every
    fused_layout: S = 64 (K = 4, 8 warps of 8 slots x 4 strata, 2 runs
    each), 9 and 15 (K = 1, 32 slots a warp, 8 warps), 4 (Whitted's dome:
    K = 4, one warp), 1 (K = 1, one warp), 2 and 6 (K = 2, one and three
    warps), 20 (K = 4, five warps), 16 on leaves of several tiles, and
    on the hand-built tree at the stack's depth; slots at or past nact
    (900 of 1000: a block part-live, the rest dead) report 0."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_ao
    from lucille_tpu_torch.accel.bvh_isect import STACK
    from lucille_tpu_torch.transport.ao import ortho_basis

    if n_tris == "deep":
        tris, nodes, leaf_real = _chain_tree(STACK)
        depth = STACK
    else:
        scene = _soup_scene(
            3000 if n_tris == "multitile" else n_tris, accel="bvh",
            node_budget=24 if n_tris == "multitile" else None)
        tris, nodes, leaf_real = scene.tris, scene.nodes, scene.leaf_real
        depth = scene.tree_depth
    S = ntheta * nphi
    K, warps = bvh_ao.fused_layout(S)
    assert S % K == 0 and 1 <= warps <= 8
    B = 1000
    rng = np.random.default_rng(1)
    P = torch.tensor(rng.uniform(-4, 4, (B, 3)), dtype=torch.float32,
                     device="cuda")
    N = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(B, 3)), dtype=torch.float32, device="cuda"), dim=-1)
    b0, b1, b2 = ortho_basis(N)
    rays = torch.cat([P, b0, b1, b2], dim=1).T.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(2)
    u01 = torch.rand((2, B), device="cuda", generator=gen)
    nact = torch.tensor(900, dtype=torch.int32, device="cuda")
    bvh_ao.FUSED_COUNTS.reset()
    got, stats = bvh_ao.bvh_ao_fused_kernel(tris, nodes, leaf_real, rays,
                                            u01, nact, ntheta, nphi,
                                            depth=depth)
    ref, _ = bvh_ao.bvh_ao_fused_reference(tris, rays[:, :900],
                                           u01[:, :900], ntheta, nphi)
    assert (bvh_ao.FUSED_COUNTS.kernel, bvh_ao.FUSED_COUNTS.plain) == (1, 1)
    assert torch.all(got[900:] == 0)
    edge = 0.5 if S >= 4 else 0.1 * S
    assert edge < ref.mean() < S - edge  # both answers occur
    diff = (got[:900] - ref).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3
    _check_walk_stats(stats, 900 * S)


@pytest.mark.gpu
def test_bvh_ao_fused_gather_selected_by_the_switch(monkeypatch):
    """LUCILLE_BVH_AO=fused routes bvh_ao_occlusion through kernel 6; a
    wavefront with no hit does no work and reports zeros."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_ao, bvh_isect
    from lucille_tpu_torch.transport.ao import ortho_basis

    scene = _soup_scene(3000, accel="bvh")
    rng = np.random.default_rng(1)
    P = torch.tensor(rng.uniform(-4, 4, (700, 3)), dtype=torch.float32,
                     device="cuda")
    b0, b1, b2 = ortho_basis(torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(700, 3)), dtype=torch.float32, device="cuda"),
        dim=-1))
    hit = torch.tensor(rng.uniform(size=700) < 0.8, device="cuda")
    jitter = torch.rand((2, 700), device="cuda")
    monkeypatch.setenv("LUCILLE_BVH_AO", "fused")
    for c in (bvh_ao.FUSED_COUNTS, bvh_isect.ANY_COUNTS):
        c.reset()
    occ, _ = bvh_ao.bvh_ao_occlusion(scene, P, b0, b1, b2, hit, jitter, 4, 4)
    none, st = bvh_ao.bvh_ao_occlusion(scene, P, b0, b1, b2,
                                       torch.zeros_like(hit), jitter, 4, 4)
    assert bvh_ao.FUSED_COUNTS.kernel == 2 and bvh_isect.ANY_COUNTS.kernel == 0
    assert occ[hit].mean() > 0.5 and torch.all(occ[~hit] == 0)
    assert torch.all(none == 0) and int(st["ntrav"]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("method,accel,mode", [
    ("whitted", "pallas", "cone"), ("pathtrace", "pallas", "cone"),
    ("whitted", "bvh", "cone"), ("whitted", "bvh", "fused")])
def test_integrator_frame_matches_plain(method, accel, mode, monkeypatch):
    """A 32x24 frame of the bundled scene (no light: the default dome) on
    the card against the same frame on the CPU, one numpy stream fed to
    both.  The card's sin/cos may round a bounce direction one ulp away
    from the CPU's, which can move a grazing ray: ray counts within
    1e-3, pixels within 1e-3 on all but 1% of them."""
    _need_card()
    from pathlib import Path

    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.sampling.jitter import HostSampler

    monkeypatch.setenv("LUCILLE_BVH_AO", mode)
    rib = Path(__file__).resolve().parent / "golden" / "sunsky_scene.rib"
    text = "".join(l for l in rib.read_text().splitlines(keepends=True)
                   if 'AreaLightSource "sunsky"' not in l)

    def desc():
        s = RiState()
        parse_rib(text, s)
        s.Format(32, 24)
        s.PixelSamples(2, 2)
        s.options.render_method = method
        s.options.accel_method = accel
        return s.scene

    rg = Renderer(desc(), tile_size=16, device="cuda",
                  sampler=HostSampler(0, "cuda"))
    rc = Renderer(desc(), tile_size=16, device="cpu",
                  sampler=HostSampler(0, "cpu"))
    got, ref = rg.render_frame(), rc.render_frame()
    assert abs(rg.stats.nrays - rc.stats.nrays) <= 1e-3 * rc.stats.nrays
    assert 0.1 < ref.mean() <= 1.0
    assert (np.abs(got - ref) > 1e-3).mean() <= 0.01


def _ibl_renderers(sampler, accel):
    """The bundled scene under an environment light on chip_smoke's
    sky (its 256x128 version, written here), as Whitted, on the card
    (dense tiles or the tile BVH)."""
    import chip_smoke as cs

    from lucille_tpu_torch.render.renderer import Renderer

    s = cs.bundled_state(48, 32, 2, light=cs.ibl_line(sampler),
                         method="whitted")
    s.options.accel_method = accel
    return Renderer(s.scene, tile_size=16, device="cuda")


@pytest.fixture
def small_sky(monkeypatch):
    """chip_smoke's environment maps at a test's size."""
    _need_card()
    import chip_smoke as cs

    monkeypatch.setattr(cs, "SKY", (256, 128))
    monkeypatch.setattr(cs, "PROBE", 96)
    cs.env_dir.cache_clear()
    yield cs
    cs.env_dir.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["importance", "structured"])
@pytest.mark.parametrize("accel", ["pallas", "bvh"])
def test_any_hit_kernels_on_environment_shadow_rays(accel, sampler,
                                                    small_sky):
    """Kernel 2 (dense) and kernel 5 (tile BVH) on the first bounce's
    importance-sampled and structured shadow rays (chip_smoke.
    env_shadow_rays: directions bunched toward the sky's sun), against
    their twins: answers equal on all but 1e-3 of the live rays, dead
    rays report no occlusion."""
    _need_card()
    from lucille_tpu_torch.accel import bvh_isect, isect

    r = _ibl_renderers(sampler, accel)
    P_off, wi, live = small_sky.env_shadow_rays(r, sampler)
    scene, R = r.scene, P_off.shape[0]
    inf = torch.full((R,), float("inf"), device="cuda")
    if accel == "pallas":
        got = isect.any_hit(scene, P_off, wi, None, live)["occ"]
        ref = isect.any_hit_reference(scene.tris, P_off, wi, inf,
                                      live)["occ"]
        assert not torch.any(got[~live])
    else:
        got = bvh_isect.bvh_any_hit(scene.tris, scene.nodes, P_off, wi,
                                    depth=scene.tree_depth,
                                    leaf_real=scene.leaf_real)["occ"]
        ref = bvh_isect.bvh_any_hit_reference(scene.tris, P_off, wi,
                                              inf)["occ"]
    occ = ref[live].float().mean().item()
    assert 0.001 < occ < 0.999
    assert (got[live] != ref[live]).float().mean().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mapping", [((64, 128), None), ((96, 96), None),
                                           ((64, 128), "angular")])
def test_env_fetch_on_the_card_matches_the_cpu(shape, mapping):
    """EnvMap.fetch on the card against the CPU on random directions and
    the lat-long seam: within 1e-5 of max(|value|, 1) on all but 1% of
    the lanes (f32 arccos / arctan2 may differ by an ulp and move a seam
    or rim direction one texel over)."""
    _need_card()
    from lucille_tpu_torch.lights.envmap import EnvMap

    rng = np.random.default_rng(2)
    img = rng.uniform(0.0, 3.0, shape + (3,)).astype(np.float32)
    v = rng.normal(size=(8192, 3))
    v[:64] = np.stack([-np.ones(64), rng.uniform(-0.9, 0.9, 64),
                       rng.choice([-1e-7, 0.0, 1e-7], 64)], axis=-1)
    d = torch.nn.functional.normalize(torch.tensor(v, dtype=torch.float32),
                                      dim=-1)
    got = EnvMap(img, mapping, device="cuda").fetch(d.cuda()).cpu().numpy()
    ref = EnvMap(img, mapping).fetch(d).numpy()
    err = np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1.0)
    assert (err <= 1e-5).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("name,params", [
    ("fog", {"distance": [5.0], "background": [0.2, 0.3, 0.5]}),
    ("depthcue", {"mindistance": [2.0], "maxdistance": [9.0]}),
    ("MOSAICfog", {"isMist": [1], "Sta": [1.0], "Di": [12.0], "Hi": [2.0],
                   "MistCol": [0.5, 0.5, 0.6]}),
    ("miefog", {"density": [0.1], "sundir": [0.3, 1.0, 0.2]})])
def test_atmosphere_on_the_card_matches_the_cpu(name, params):
    """Each built-in atmosphere on the card against the CPU: within 1e-5
    of max(|value|, 1) (miefog: on all but 1% of the lanes, and within
    1e-4 on all: the card's f32 arccos may differ from the CPU's by an
    ulp, which moves the lerp in the phase table's steep forward peak);
    escaped rays keep their radiance exactly."""
    _need_card()
    from lucille_tpu_torch.shading.pipeline import Atmosphere

    rng = np.random.default_rng(3)
    B = 4096
    args = [rng.uniform(0, 2, (B, 3)), rng.uniform(0, 20, B),
            rng.uniform(-3, 3, (B, 3)), rng.uniform(size=B) < 0.7,
            rng.normal(size=(B, 3))]
    args = [torch.tensor(a, dtype=torch.bool if a.dtype == bool
                         else torch.float32) for a in args]
    ref = Atmosphere(name, params, None, "cpu")(*args).numpy()
    got = Atmosphere(name, params, None, "cuda")(
        *(a.cuda() for a in args)).cpu().numpy()
    err = (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max(-1)
    if name == "miefog":
        assert (err <= 1e-5).mean() >= 0.99 and err.max() <= 1e-4
    else:
        assert err.max() <= 1e-5
    hit = args[3].numpy()
    np.testing.assert_array_equal(got[~hit], args[0].numpy()[~hit])


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["cosweight", "importance",
                                     "stratified", "structured"])
def test_ibl_frame_matches_plain(sampler, small_sky):
    """A 48x32 Whitted frame of the bundled scene under the sky (depth 2)
    on the card and on the CPU's twins, one numpy stream fed to both:
    equal ray counts, pixels within 1e-3 of max(|value|, 1) on all but
    1%."""
    _need_card()
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.sampling.jitter import HostSampler

    frames = {}
    for dev in ("cuda", "cpu"):
        s = small_sky.bundled_state(48, 32, 2, light=small_sky.ibl_line(
            sampler), method="whitted")
        s.options.max_ray_depth = 2
        r = Renderer(s.scene, tile_size=16, device=dev,
                     sampler=HostSampler(0, dev))
        frames[dev] = (r.render_frame(), r.stats.nrays)
    (got, n_got), (ref, n_ref) = frames["cuda"], frames["cpu"]
    assert n_got == n_ref and ref.mean() > 0.05
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert (rel > 1e-3).mean() <= 0.01


GPU_WHITTED_SL = (
    "surface gpuwhitted(float eta = 1.5; float Kd = .8; float Kt = .2;"
    "  float Ks = .2) {\n"
    "  normal Nn = faceforward(normalize(N), I);\n"
    "  Ci = Kd * ambient();\n"
    "  illuminance(P, Nn, PI/2) { Ci += Kd * Cl * (L . Nn); }\n"
    "  Ci += Ks * trace(P, reflect(I, Nn));\n"
    "  vector T = refract(I, Nn, (N.I) < 0 ? eta : 1/eta);\n"
    "  if (length(T) != 0.0) Ci += Kt * trace(P, T);\n"
    "}\n")


# uniform outputs: flatred with its parameter left at its default, a
# constant triple; and a uniform triple computed from a parameter and
# literals that meets the varying Cs and diffuse()
GPU_UNIFORM_SL = {
    "gpuflatred": "surface gpuflatred(float K = 1) "
                  "{ Ci = K * (1, 0.25, 0.1); }\n",
    "gpuconstred": "surface gpuconstred() { Ci = (1, 0, 0); }\n",
    "gpucomputed": "surface gpucomputed(float K = 0.5) {\n"
                   "  color c = K * (1, .25, .1) + (0.5, 0, 0.25);\n"
                   "  Ci = c * Cs * diffuse(N);\n"
                   "}\n",
}


@pytest.mark.gpu
@pytest.mark.parametrize("surface,accel", [("gpuwhitted", "pallas"),
                                           ("plastic", "bvh"),
                                           ("ambientocclusion", "pallas"),
                                           ("gpuflatred", "pallas"),
                                           ("gpuconstred", "bvh"),
                                           ("gpucomputed", "pallas")])
def test_shaded_frame_matches_plain(surface, accel, tmp_path):
    """An 80x60 frame of the bundled scene as shipped (its sunsky and sun
    lights) under the shader method, every geometry bound to whitted.sl
    (written here), plastic, ambientocclusion or a shader whose Ci is
    uniform or reads a computed uniform triple (GPU_UNIFORM_SL), on the
    card against the CPU's twins, one numpy stream fed to both: equal
    ray counts, pixels within 1e-3 of max(|value|, 1) on all but 1%;
    then a new Renderer's first frame on the card with no tile waiting
    on it (chip_smoke.no_host_sync; the kernels are built by then)."""
    _need_card()
    import chip_smoke as cs

    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.sampling.jitter import HostSampler

    (tmp_path / "gpuwhitted.sl").write_text(GPU_WHITTED_SL)
    for name, src in GPU_UNIFORM_SL.items():
        (tmp_path / f"{name}.sl").write_text(src)
    head = f'Option "searchpath" "shader" ["{tmp_path}"]\n'

    def state():
        s = cs.bundled_state(80, 60, 1, 16, method="shader", head=head,
                             world=f'Surface "{surface}"\n')
        s.options.accel_method = accel
        return s

    frames = {}
    for dev in ("cuda", "cpu"):
        r = Renderer(state().scene, tile_size=32, device=dev,
                     sampler=HostSampler(0, dev))
        frames[dev] = (r.render_frame(), r.stats.nrays)
    (got, n_got), (ref, n_ref) = frames["cuda"], frames["cpu"]
    assert n_got == n_ref and np.isfinite(got).all() and ref.mean() > 0.05
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert (rel > 1e-3).mean() <= 0.01
    r = Renderer(state().scene, tile_size=32, device="cuda")
    with cs.no_host_sync(r):
        assert np.isfinite(r.render_frame()).all()


@pytest.mark.gpu
def test_sl_atmosphere_on_the_card_matches_the_cpu(tmp_path):
    """An .sl volume shader (parameters, I's length, P, a varying if) on
    the card against the CPU within 1e-5 of max(|value|, 1), escaped rays
    unchanged, and the call making the host wait for nothing once the
    stage is bound."""
    _need_card()
    from lucille_tpu_torch.shading.pipeline import Atmosphere

    (tmp_path / "gpuslfog.sl").write_text(
        "volume gpuslfog(float d = 6; color bg = (0.2, 0.3, 0.5)) {\n"
        "  float f = 1 - exp(-length(I) / d);\n"
        "  Ci = mix(Ci, bg, f) + 0.01 * ycomp(P);\n"
        "  if (zcomp(I) > 15) Ci = Ci * 0.5;\n"
        "}\n")
    rng = np.random.default_rng(4)
    B = 4096
    args = [rng.uniform(0, 2, (B, 3)), rng.uniform(0, 20, B),
            rng.uniform(-3, 3, (B, 3)), rng.uniform(size=B) < 0.7,
            rng.normal(size=(B, 3))]
    args = [torch.tensor(a, dtype=torch.bool if a.dtype == bool
                         else torch.float32) for a in args]
    params, sp = {"d": [4.0]}, [str(tmp_path)]
    ref = Atmosphere("gpuslfog", params, sp, "cpu")(*args).numpy()
    atm = Atmosphere("gpuslfog", params, sp, "cuda")
    dev_args = [a.cuda() for a in args]
    atm(*dev_args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = atm(*dev_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = got.cpu().numpy()
    err = (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max(-1)
    assert err.max() <= 1e-5
    hit = args[3].numpy()
    np.testing.assert_array_equal(got[~hit], args[0].numpy()[~hit])
    assert np.abs(got[hit] - args[0].numpy()[hit]).max() > 0.05


def _grid_scene(pos, idx, device="cuda"):
    """Triangles pos[idx] (one mesh) as a scene on the uniform grid."""
    from lucille_tpu_torch.ri.types import (
        AttributeState,
        GeomData,
        SceneDescription,
    )
    from lucille_tpu_torch.scene.compile import compile_scene

    desc = SceneDescription()
    desc.geoms.append(GeomData(positions=np.asarray(pos, np.float64),
                               indices=np.asarray(idx, np.int32),
                               attrs=AttributeState()))
    desc.options.accel_method = "grid"
    scene = compile_scene(desc, device)
    assert scene.accel == "ugrid"
    return scene


def _far_pair():
    """Two small triangles at opposite corners of a 20-unit box: they
    stretch the grid's box, so that a cluster near the origin falls in a
    few cells."""
    t = np.asarray([[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0]])
    return np.concatenate([t - 10.0, t + 9.9])


def _grid_dense_case(case, rng, lanes):
    """(pos, idx, org, dir) of a case whose cells hold more than 4 lanes
    slots: "dense", 300 small triangles clustered at the origin;
    "group-ties", 13 triangles in one cell listed three times (ids k, k + 13, k + 26: exact
    ties in t across the lanes of a step and across steps); "hit-first"
    / "hit-last", 36 small triangles beside the rays' path and two that
    the rays cross, both in one cell of a res-4 grid, the first of them
    in the cell's first chunk / in the last chunk of the first step."""
    B = 4096
    if case in ("dense", "group-ties"):
        m = 300 if case == "dense" else 13
        lo, hi = (-0.8, 0.8) if case == "dense" else (1.5, 3.5)
        c = rng.uniform(lo, hi, (m, 3))
        tri = np.stack([c + rng.normal(0, 0.3, (m, 3)) for _ in range(3)])
        tgt = tri.mean(axis=0)[rng.integers(0, m, B)]
        if case == "group-ties":
            tri = np.concatenate([tri, tri, tri], axis=1)
        soup = np.concatenate([tri.transpose(1, 0, 2).reshape(-1, 3),
                               _far_pair()])
        o = rng.normal(size=(B, 3))
        o = 12.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = tgt + rng.normal(0, 0.05, (B, 3)) - o
    else:
        first = 1 if case == "hit-first" else 4 * lanes - 2
        tris = []
        for k in range(38):
            if k in (first, first + 5):  # across the rays' column
                z = 2.0 + 0.1 * (k != first)
                tris.append([[1.5, 1.5, z], [4.8, 1.5, z], [1.5, 4.8, z]])
            else:  # small, beside it, spread along z
                z = 0.5 + 0.1 * k
                tris.append([[0.2, 0.2, z], [0.8, 0.2, z + 0.05],
                             [0.2, 0.8, z + 0.1]])
        soup = np.concatenate([np.asarray(tris).reshape(-1, 3), _far_pair()])
        o = np.stack([rng.uniform(2.0, 2.8, B), rng.uniform(2.0, 2.8, B),
                      np.full(B, -12.0)], -1)
        d = np.stack([rng.normal(0, 0.005, B), rng.normal(0, 0.005, B),
                      np.ones(B)], -1)
    n = len(soup) // 3
    idx = np.arange(3 * n).reshape(n, 3)
    return soup, idx, o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@functools.cache
def _terrain_grid_scene():
    """The n = 256 terrain on the grid, built once (~5 s on the host)."""
    import chip_smoke as cs

    P, quads = cs.heightfield_grid(256)
    return _grid_scene(P, np.concatenate([quads[:, [0, 1, 2]],
                                          quads[:, [0, 2, 3]]]))


def _grid_terrain_case(rng):
    """(pos, idx, org, dir) on the n = 256 terrain (130,050 triangles: a
    res-64 grid, the largest bitmask): rays starting inside the grid
    above the terrain, nearly level, that cross many empty cells."""
    import chip_smoke as cs

    P, quads = cs.heightfield_grid(256)
    idx = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    B = 4096
    o = np.stack([rng.uniform(-4.5, 4.5, B), rng.uniform(0.55, 0.7, B),
                  rng.uniform(-4.5, 4.5, B)], -1)
    a = rng.uniform(0, 2 * np.pi, B)
    d = np.stack([np.cos(a), -rng.uniform(0.02, 0.3, B), np.sin(a)], -1)
    return P, idx, o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _grid_case(case, rng, lanes=1):
    """(pos, idx, org (B, 3), dir (B, 3)) numpy of one grid case."""
    if case in ("dense", "group-ties", "hit-first", "hit-last"):
        return _grid_dense_case(case, rng, lanes)
    if case == "terrain":
        return _grid_terrain_case(rng)
    n = 300
    c = rng.uniform(-5, 5, (n, 3))
    soup = np.concatenate([c + rng.normal(0, 0.3, (n, 3)) for _ in range(3)])
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1)
    B = 4096
    o = rng.normal(size=(B, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-4, 4, (B, 3)) - o
    if case == "sparse":  # a few clusters: most cells empty
        c = rng.uniform(-5, 5, (4, 3))[rng.integers(0, 4, n)]
        soup = np.concatenate([c + rng.normal(0, 0.2, (n, 3))
                               for _ in range(3)])
        d = c[rng.integers(0, n, B)] + rng.normal(0, 0.2, (B, 3)) - o
    elif case == "spanning":  # one triangle across the whole grid
        big = np.asarray([[-6, -6, -6], [6, -6, 6], [0, 6, 0]], np.float64)
        soup = np.concatenate([soup, big])
        idx = np.concatenate([idx, [[3 * n, 3 * n + 1, 3 * n + 2]]])
    elif case == "missing":  # rays beside the grid, or pointing away
        o = o * 2.0
        d = np.where(rng.uniform(size=(B, 1)) < 0.5, o, d + rng.normal(
            0, 3, (B, 3)))
    elif case == "axis":  # axis-parallel: two steps of 0
        axis = rng.integers(0, 3, B)
        d = np.zeros((B, 3))
        d[np.arange(B), axis] = np.where(rng.uniform(size=B) < 0.5, 1, -1)
        o = rng.uniform(-5, 5, (B, 3))
        o[np.arange(B), axis] = -12.0 * d[np.arange(B), axis]
    elif case == "ties":  # each triangle again, 5 ids later: exact ties
        m = 60       # in t, within a chunk or across chunks and cells
        tri = soup.reshape(3, n, 3)[:, :m]
        far = rng.uniform(40, 50, (3, 4, 3))
        parts = []
        for k in range(m):
            parts += [tri[:, k:k + 1], far] if k % 2 else [tri[:, k:k + 1]]
        parts += [tri]
        stack = np.concatenate(parts, axis=1)
        nt = stack.shape[1]
        soup = stack.reshape(-1, 3)
        idx = np.stack([np.arange(nt), np.arange(nt) + nt,
                        np.arange(nt) + 2 * nt], -1)
        tgt = tri.mean(axis=0)[rng.integers(0, m, B)]
        d = tgt + rng.normal(0, 0.05, (B, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return soup, idx, o, d


GRID_CASES = ["soup", "sparse", "spanning", "missing", "axis", "ties",
              "dense", "group-ties", "hit-first", "hit-last", "terrain"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRID_CASES)
@pytest.mark.parametrize("bound", ["unbounded", "random"])
@pytest.mark.parametrize("lanes", [1, 8])
def test_grid_kernel_matches_plain(case, bound, lanes, monkeypatch):
    """csrc/ugrid.cu, at both group sizes a ray, against the lock-step
    twin on the same rays: the same walk, so triangles, t, u, v,
    occlusion and both counters equal exactly (--fmad=false), with and
    without a finite tmax and an active mask (random, and dead rays
    interleaved with live ones), on empty cells, a triangle listed in
    every cell, rays that miss the grid, axis-parallel rays, exact ties
    in t (the first triangle tested wins: in one chunk, across the lanes
    of a step and across steps), cells of more than 4 lanes slots, an
    any-hit whose first hit lies in the cell's first chunk or in the last
    chunk of the step, and rays that start inside the n = 256 terrain's
    res-64 grid and cross many empty cells.  Both the launch that counts
    the warps' own steps and the entries as the render paths call them
    (`closest_hit` with its counters, `any_hit` without) answer the
    same; the warps' own step counts bound the rays' work."""
    _need_card()
    from lucille_tpu_torch.accel import ugrid

    monkeypatch.setattr(ugrid, "group_lanes", lambda scene, B: lanes)
    rng = np.random.default_rng(GRID_CASES.index(case))
    pos, idx, o, d = _grid_case(case, rng, lanes)
    scene = (_terrain_grid_scene() if case == "terrain"
             else _grid_scene(pos, idx))
    if case in ("dense", "group-ties", "hit-first", "hit-last"):
        slots = scene.grid_cell_start[1:] - scene.grid_cell_start[:-1]
        assert int(slots.max()) > 4 * lanes
    if case == "terrain":
        assert scene.grid_res == 64
    o = torch.tensor(o, dtype=torch.float32, device="cuda")
    d = torch.tensor(d, dtype=torch.float32, device="cuda")
    B = o.shape[0]
    tmax = None
    if bound == "random":
        tmax = torch.tensor(rng.uniform(5, 20, B), dtype=torch.float32,
                            device="cuda")
    active = torch.tensor(rng.uniform(size=B) < 0.7, device="cuda")
    interleaved = torch.arange(B, device="cuda") % 3 != 1
    for act in (None, active, interleaved):
        got = ugrid.grid_walk_kernel(scene, o, d, tmax, act)
        ref = ugrid.grid_walk_reference(scene, o, d, tmax, act)
        hits = (ref["tri"] >= 0).float().mean().item()
        assert case == "missing" or hits > 0.05, hits
        # with the warps' own steps, and as the render paths call it
        closest = ugrid.closest_hit(scene, o, d, tmax, act)
        keys = ("tri", "t", "u", "v", "ntests", "ntrav")
        assert set(closest) == set(keys)
        for k in keys:
            assert torch.equal(got[k], ref[k]), (k, act is None)
            assert torch.equal(closest[k], ref[k]), (k, act is None)
        occ = ugrid.grid_walk_kernel(scene, o, d, tmax, act, any_hit=True)
        occ_ref = ugrid.grid_walk_reference(scene, o, d, tmax, act,
                                            any_hit=True)
        for k in ("occ", "ntests", "ntrav"):
            assert torch.equal(occ[k], occ_ref[k]), (k, act is None)
        assert torch.equal(occ["occ"], ref["tri"] >= 0)
        plain = ugrid.any_hit(scene, o, d, tmax, act)
        assert set(plain) == {"occ"} and torch.equal(plain["occ"], occ["occ"])
        for res in (got, occ):
            assert int(res["ntests"]) <= 32 * ugrid.K * int(res["warp_ntests"])
            assert lanes * int(res["ntrav"]) <= 32 * int(res["warp_ntrav"])
    if case in ("ties", "group-ties"):  # the lower id wins each exact tie
        tied = got["tri"] >= 0
        low = scene.n_tris - 60 if case == "ties" else 13
        assert torch.all(got["tri"][tied] < low)
    if case in ("hit-first", "hit-last"):  # the first crossing's id
        first = 1 if case == "hit-first" else 4 * lanes - 2
        assert torch.all(got["tri"][got["tri"] >= 0] == first)


@pytest.mark.gpu
def test_mesh_of_one_card_matches_no_mesh():
    """A 64x32 AO frame on make_mesh(1) equals the same frame without a
    mesh on the card, with the same rays; the replica's constants were
    copied when it was built, so its first frame waits on the card in no
    tile (sync debug mode "error")."""
    _need_card()
    import chip_smoke as cs

    from lucille_tpu_torch.parallel.mesh import make_mesh
    from lucille_tpu_torch.render.renderer import Renderer

    def renderer(mesh):
        return Renderer(cs.bundled_state(64, 32, 2, 16, sunsky=False).scene,
                        tile_size=16, device="cuda", mesh=mesh)

    r0 = renderer(None)
    ref = r0.render_frame()
    r = renderer(make_mesh(1))
    assert r.mesh.devices == (torch.device("cuda", 0),)
    with cs.no_host_sync(r):
        got = r.render_frame()
    np.testing.assert_array_equal(got, ref)
    assert r.stats.nrays == r0.stats.nrays > 0


@pytest.mark.gpu
def test_fur_frame_on_the_card_matches_the_cpu():
    """The fur example's scene (400 strands, 25,602 triangles: the tile
    BVH's kernels 4 and 5) at 80x60, 1x1 samples, 4 AO rays, on the card
    against the CPU's twins, one numpy stream fed to both
    (chip_smoke.check_frame_twins: rays within 1e-3, pixels within 1e-3
    on all but 1%)."""
    _need_card()
    import chip_smoke as cs

    from lucille_tpu_torch.accel import bvh_isect

    assert cs.fur_twins_state().scene.ntriangles == 25602
    bvh_isect.CLOSEST_COUNTS.reset()
    got = cs.check_frame_twins("fur-twins", cs.fur_twins_state)
    assert got.shape == (60, 80, 3) and np.isfinite(got).all()
    assert bvh_isect.CLOSEST_COUNTS.kernel > 0


# -- tile graphs (render/graphs.py) ---------------------------------------

GRAPH_CELLS = {  # 6 tiles of 32 a frame, as the benchmark's cells have 6
    "bundled-ao": lambda cs: cs.bundled_state(96, 64, 2, 16, sunsky=False),
    "bundled-sunsky": lambda cs: cs.bundled_state(96, 64, 2, 16),
    "heightfield256": lambda cs: cs.heightfield_state(256, 96, 64,
                                                      pixelsamples=2,
                                                      gather=16),
}


def _graph_pair(cell, integrator=None):
    """(a Renderer of the cell whose tiles replay their graphs, one whose
    integrator is wrapped so its tiles render eagerly); `integrator`
    wraps the first one's integrator."""
    import chip_smoke as cs

    from lucille_tpu_torch.render.renderer import Renderer

    graphs, eager = (Renderer(GRAPH_CELLS[cell](cs).scene, tile_size=32,
                              device="cuda") for _ in range(2))
    ao = eager.integrator
    eager.integrator = lambda *a, **k: ao(*a, **k)  # no graph_key: eager
    if integrator is not None:
        graphs.integrator = integrator(graphs.integrator)
    return graphs, eager


def _traced_frame(r, kernels=False, **kw):
    """r.render_frame(**kw) under the profiler: (image, the frame's root
    span attrs), and with `kernels` (CUDA activity too) the hand-written
    kernels its device trace shows (chip_smoke.traced_launches)."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from lucille_tpu_torch.base.timer import get_timer

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if kernels else [])
    with profile(activities=activities) as prof:
        img = r.render_frame(**kw)
        if kernels:
            torch.cuda.synchronize()
    attrs = get_timer().recorded_frames(1)[0].spans[0].attrs
    return (img, attrs, cs.traced_launches(prof)) if kernels else (img, attrs)


def _launches():
    import chip_smoke as cs

    return {k: (c.kernel, c.plain) for k, c in cs.counters().items()}


def _reset_launches():
    import chip_smoke as cs

    for c in cs.counters().values():
        c.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(GRAPH_CELLS))
def test_replayed_frames_equal_eager_frames(cell):
    """Over two seeds and three frames each, a frame whose tiles replay
    their graphs is bit-equal to the eager frame, replays every tile
    (graph_tiles = tiles) and waits on the card once a tile.  Its
    launches are the eager frame's, both as its wrappers count them (a
    replayed tile adds its capture's) and as its device trace shows
    them; the eager frame's trace shows what its wrappers count.  The
    first frame renders eagerly and notes its tiles, and copies the
    subpixel table and weights (2 more syncs); the second captures each
    tile and replays it."""
    _need_card()
    import chip_smoke as cs

    from lucille_tpu_torch.render.graphs import TileGraph

    graphs, eager = _graph_pair(cell)
    n = 0
    for seed in (7, 2**31 + 5):
        for k in range(3):
            graphs.sampler.seed = eager.sampler.seed = seed + k
            _reset_launches()
            want, _attrs, want_traced = _traced_frame(eager, kernels=True)
            want_launches = _launches()
            assert want_traced == cs.by_kernel(
                {name: c for name, (c, _p) in want_launches.items()})
            _reset_launches()
            got, attrs, traced = _traced_frame(graphs, kernels=True)
            np.testing.assert_array_equal(got, want)
            assert traced == want_traced
            assert _launches() == want_launches
            assert attrs["tiles"] == 6
            assert attrs["graph_tiles"] == (0 if n == 0 else 6)
            assert attrs["host_syncs"] == (8 if n == 0 else 6)
            n += 1
    made = graphs.replicas[0].graphs
    assert len(made) == 6
    assert all(isinstance(g, TileGraph) for g in made.values())


@pytest.mark.gpu
def test_tiles_handed_out_survive_later_frames():
    """What tile_cb receives and render_frame returns from a replayed
    frame stays as it was through the next frames."""
    _need_card()
    graphs, _eager = _graph_pair("bundled-ao")
    graphs.render_frame()  # each tile seen
    graphs.render_frame()  # each tile captured
    tiles = []
    graphs.sampler.seed = 3
    img = graphs.render_frame(tile_cb=lambda x0, y0, t: tiles.append(t))
    kept, img0 = [t.copy() for t in tiles], img.copy()
    for seed in (4, 5):
        graphs.sampler.seed = seed
        assert not np.array_equal(graphs.render_frame(), img0)
    for t, k in zip(tiles, kept):
        np.testing.assert_array_equal(t, k)
    np.testing.assert_array_equal(img, img0)


@pytest.mark.gpu
def test_replayed_frame_waits_once_a_tile_under_sync_debug():
    """Under torch's sync debug mode "error" a replayed frame raises
    nothing, and counts 6 host syncs, one event wait a tile."""
    _need_card()
    graphs, _eager = _graph_pair("bundled-sunsky")
    graphs.render_frame()  # each tile seen
    graphs.render_frame()  # each tile captured
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _img, attrs = _traced_frame(graphs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert attrs["host_syncs"] == 6 and attrs["graph_tiles"] == 6


@pytest.mark.gpu
@pytest.mark.parametrize("before", [1, 2])
def test_recorders_around_launch_functions_see_the_frame(before):
    """The benchmark's recorders (benchmark/harness/capture.recording)
    replace the AO gather's launch function, after the tiles were seen
    once (their capture waits) or twice (their graphs wait): the frame
    under them renders eagerly and records its 6 gathers; the frame after
    replays."""
    _need_card()
    import sys
    from pathlib import Path

    bench = str(Path(__file__).resolve().parent.parent / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness.capture import recording

    graphs, eager = _graph_pair("bundled-ao")
    for _ in range(before):
        graphs.render_frame()
    captures = {}
    with recording(captures):
        got, attrs = _traced_frame(graphs)
    assert len(captures["ao_gather"]) == 6
    assert attrs["graph_tiles"] == 0
    np.testing.assert_array_equal(got, eager.render_frame())
    _img, attrs = _traced_frame(graphs)
    assert attrs["graph_tiles"] == 6


@pytest.mark.gpu
def test_a_tile_that_syncs_falls_back_to_eager():
    """An integrator that declares itself capturable but reads a device
    value in its tile fails its capture: every tile renders eagerly, with
    the eager frame's pixels, frame after frame."""
    _need_card()

    def syncing(ao):
        def stub(*args, **kwargs):
            radiance, aux = ao(*args, **kwargs)
            if aux["hit"].sum().item() < 0:  # a host sync, never true
                raise AssertionError
            return radiance, aux

        stub.graph_key = ao.graph_key
        return stub

    graphs, eager = _graph_pair("bundled-ao", syncing)
    for seed in (1, 2):
        graphs.sampler.seed = eager.sampler.seed = seed
        got, attrs = _traced_frame(graphs)
        np.testing.assert_array_equal(got, eager.render_frame())
        assert attrs["graph_tiles"] == 0
    graphs_made = graphs.replicas[0].graphs
    assert len(graphs_made) == 6 and all(g is None for g in graphs_made.values())
