"""The tile BVH (accel "pbvh"): the port's host build and node arrays, both
BVH twins and the cone-tiled AO gather against lucille_tpu, whose Pallas
kernels run in interpret mode.  numpy makes every input from a seed.

Tolerances:

- the BVH build, the tile layout and the node arrays: exact;
- closest hit: hit masks equal, triangle ids equal on all but 0.5% of
  the rays (an exact tie in t across two leaves goes to the leaf the JAX
  walk visits first, and to the lowest slot in the twin), t/u/v within
  1e-5 where both pick the same triangle, except on at most 2% of the
  rays, and there within 2e-4: the heightfield's camera sees the terrain
  at a grazing angle, where the f32 Moller-Trumbore chain is so
  ill-conditioned that XLA's fused and torch's unfused evaluation each
  lie up to ~1e-4 from an f64 evaluation;
- any-hit: the answer does not depend on the order of the tests, so
  occlusion is equal on all but 0.5% of the rays (XLA:CPU contracts
  products into FMAs, torch does not, which can flip a ray that grazes
  an edge);
- stratified directions within 1e-6 absolute (FMA contraction, and
  XLA's and torch's sin/cos differ by ulps);
- AO counts equal on all but 1e-3 of the lanes, and within 1; the same
  for the fused gather (kernel 6) against lucille_tpu's fused Pallas
  kernel, both fed the same (2, B) draw.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_intersect import _random_soup, _scene_from_tris
from test_torch_isect import _soup_rays
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import heightfield_state


def _soup(n_tris=700, seed=5):
    """lucille_tpu's pbvh SceneArrays of a random soup."""
    v0, v1, v2 = _random_soup(n_tris, seed=seed)
    return _scene_from_tris(v0, v1, v2, "bvh")


def _heightfield():
    from lucille_tpu.scene.compile import compile_scene

    return compile_scene(heightfield_state(35, accel="bvh", pkg="jax").scene
                         ).device_put()


def _heightfield_eye_rays(B, seed=1):
    """B eye rays of the 35x35 heightfield's camera over the frame."""
    from lucille_tpu_torch.ri.camera import generate_rays

    cam = heightfield_state(35, 64, 48).camera
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, 64, B).astype(np.float32)
    py = rng.uniform(0, 48, B).astype(np.float32)
    o, d = generate_rays(cam, torch.from_numpy(px), torch.from_numpy(py))
    return o.numpy(), d.numpy()


def _no_native(monkeypatch):
    """Both packages' build_bvh fall back to their NumPy builds."""
    for pkg in ("lucille_tpu", "lucille_tpu_torch"):
        monkeypatch.setattr(f"{pkg}.native.loader.native_build_bvh",
                            lambda *a, **k: None)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_build_bvh_equals_jax(seed, monkeypatch):
    from lucille_tpu.accel.bvh import build_bvh as jax_build
    from lucille_tpu.accel.pallas_bvh import build_tile_bvh as jax_tile
    from lucille_tpu_torch.accel.bvh import build_bvh
    from lucille_tpu_torch.accel.tile_bvh import build_tile_bvh

    v0, v1, v2 = _random_soup(1500, seed=seed)
    for leaf in (8, 128):
        want = jax_build(v0, v1, v2, leaf_size=leaf, use_native=False)
        got = build_bvh(v0, v1, v2, leaf_size=leaf, use_native=False)
        for f in ("bbmin", "bbmax", "skip", "first", "count", "order"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert got.depth == want.depth
    _no_native(monkeypatch)  # the tile builds below: NumPy on both sides
    for budget in (16384, 24):  # 24 nodes forces the leaf size to grow
        want = jax_tile(v0, v1, v2, node_budget=budget)
        got = build_tile_bvh(v0, v1, v2, node_budget=budget)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if budget == 24:
            assert got[3] <= 24 and got[2][2].max() > 1  # leaves grew


def test_tile_build_with_the_native_builder_equals_jax():
    from lucille_tpu.accel.pallas_bvh import build_tile_bvh as jax_tile
    from lucille_tpu_torch.accel.tile_bvh import build_tile_bvh

    v0, v1, v2 = _random_soup(3000, seed=4)
    for budget in (16384, 40):
        for a, b in zip(build_tile_bvh(v0, v1, v2, node_budget=budget),
                        jax_tile(v0, v1, v2, node_budget=budget)):
            np.testing.assert_array_equal(a, b)


def test_node_arrays_equal_jax():
    from lucille_tpu.accel.pallas_bvh import _node_arrays
    from lucille_tpu_torch.accel.pack import pack_nodes
    from lucille_tpu_torch.accel.tile_bvh import node_arrays, tree_depth

    for sc in (_soup(), _heightfield()):
        nbox, nmeta = _node_arrays(sc)
        got = node_arrays(sc.node_bbmin, sc.node_bbmax, sc.node_skip,
                          sc.node_first, sc.node_count)
        np.testing.assert_array_equal(got[0], np.asarray(nbox))
        np.testing.assert_array_equal(got[1], np.asarray(nmeta))
        # the kernels' pack carries the same boxes and links
        bits = pack_nodes(sc).numpy().view(np.int32)
        leaf = got[1][2] > 0
        np.testing.assert_array_equal(bits[:, 3], np.where(
            leaf, got[1][2], -(got[1][4] + 1)))
        np.testing.assert_array_equal(bits[:, 7], np.where(
            leaf, got[1][1], got[1][3]))
        assert 0 < tree_depth(pack_nodes(sc)) < sc.n_nodes


@pytest.mark.parametrize("budget", [16384, 24])
def test_leaf_real_counts_the_real_slots(budget, monkeypatch):
    """scene.leaf_real, each leaf's count of real triangles (the warp
    walk of csrc/bvh.cu stages those and no padding), equals the count of
    build_tile_bvh's real slots (src >= 0) in every leaf: one-tile leaves
    at lucille_tpu's node budget, multi-tile ones at 24 nodes; and
    lucille_tpu's SceneArrays of the same soup give the same counts."""
    import functools

    from lucille_tpu_torch.accel import tile_bvh
    from lucille_tpu_torch.accel.pack import TC
    from lucille_tpu_torch.ri.types import (
        AttributeState,
        GeomData,
        SceneDescription,
    )
    from lucille_tpu_torch.scene.compile import compile_scene
    from lucille_tpu_torch.scene.types import from_numpy

    v0, v1, v2 = (a.astype(np.float32) for a in _random_soup(1500, seed=1))
    n = len(v0)
    desc = SceneDescription()
    desc.geoms.append(GeomData(
        positions=np.concatenate([v0, v1, v2]),
        indices=np.stack([np.arange(n), np.arange(n) + n,
                          np.arange(n) + 2 * n], -1).astype(np.int32),
        attrs=AttributeState()))
    desc.options.accel_method = "bvh"
    build = tile_bvh.build_tile_bvh
    monkeypatch.setattr(tile_bvh, "build_tile_bvh",
                        functools.partial(build, node_budget=budget))
    scene = compile_scene(desc, "cpu")
    src, _nbox, nmeta, m = build(v0, v1, v2, node_budget=budget)
    want = np.zeros(m, dtype=np.int32)
    for i in np.flatnonzero(nmeta[2] > 0):
        lo, hi = nmeta[1][i] * TC, (nmeta[1][i] + nmeta[2][i]) * TC
        want[i] = (src[lo:hi] >= 0).sum()
    got = scene.leaf_real.numpy()
    assert scene.leaf_real.dtype == torch.int32
    np.testing.assert_array_equal(got, want)
    assert want.sum() == n and (nmeta[2].max() > 1) == (budget == 24)
    assert (got < nmeta[2] * TC).any()  # some leaf ends in padding
    if budget == 16384:
        jax_scene = from_numpy(_scene_from_tris(v0, v1, v2, "bvh"), "cpu")
        np.testing.assert_array_equal(jax_scene.leaf_real.numpy(), want)


def _bvh_cases():
    return {
        "soup700": lambda: (_soup(), *_soup_rays(512)),
        "heightfield35_eye": lambda: (_heightfield(),
                                      *_heightfield_eye_rays(1024)),
    }


# per-ray tmax ranges that cut about half of each case's hits short (the
# heightfield's eye hits lie 11.7 to 20.4 from the camera)
TMAX_RANGE = {"soup700": (8.0, 16.0), "heightfield35_eye": (12.0, 17.0),
              "soup700_gather": (0.5, 12.0)}


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("case", ["soup700", "heightfield35_eye"])
def test_closest_hit_twin_matches_pallas(case, bounded):
    from lucille_tpu.accel.pallas_bvh import pallas_bvh_closest_hit
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.scene.types import from_numpy

    sc, o, d = _bvh_cases()[case]()
    B = o.shape[0]
    tmax = None
    if bounded:
        tmax = np.random.default_rng(2).uniform(
            *TMAX_RANGE[case], B).astype(np.float32)
    ref = pallas_bvh_closest_hit(
        sc, jnp.asarray(o), jnp.asarray(d),
        tmax=None if tmax is None else jnp.asarray(tmax), interpret=True)
    scene = from_numpy(sc, "cpu")
    bvh_isect.CLOSEST_COUNTS.reset()
    got = closest_hit(scene, torch.from_numpy(o), torch.from_numpy(d),
                      None if tmax is None else torch.from_numpy(tmax))
    assert (bvh_isect.CLOSEST_COUNTS.kernel,
            bvh_isect.CLOSEST_COUNTS.plain) == (0, 1)
    hit_r = np.asarray(ref["hit"])
    hit = got["hit"].numpy()
    np.testing.assert_array_equal(hit, hit_r)
    assert 0.1 < hit.mean() < 1.0  # hits and misses both exercised
    tri_r = np.asarray(ref["tri"])
    tri = got["tri"].numpy()
    assert (hit & (tri != tri_r)).mean() <= 0.005
    same = hit & (tri == tri_r)
    for k in ("t", "u", "v"):
        a, b = got[k].numpy()[same], np.asarray(ref[k])[same]
        assert (~np.isclose(a, b, rtol=1e-5, atol=1e-5)).mean() <= 0.02, k
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4, err_msg=k)
    # a miss reports t = tmax
    want_t = np.inf if tmax is None else tmax
    np.testing.assert_array_equal(got["t"].numpy()[~hit],
                                  np.broadcast_to(want_t, (B,))[~hit])


def test_shared_edge_tie_against_pallas():
    """A ray onto an edge shared by two triangles of different leaves:
    both packages report t = 5 and one of the two triangles; the twin
    the lower slot."""
    from lucille_tpu.accel.pallas_bvh import pallas_bvh_closest_hit
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.scene.types import from_numpy
    from test_torch_gpu import _flat_grid_desc, shared_edge_ray

    sc = jax_compile(_flat_grid_desc(16)).device_put()
    pair, o, d = shared_edge_ray(sc.tri_v0, sc.tri_e1, sc.tri_e2)
    ref = pallas_bvh_closest_hit(sc, jnp.asarray(o[None]),
                                 jnp.asarray(d[None]), interpret=True)
    got = closest_hit(from_numpy(sc, "cpu"), torch.from_numpy(o[None]),
                      torch.from_numpy(d[None]))
    assert float(got["t"][0]) == float(ref["t"][0]) == 5.0
    assert int(got["tri"][0]) == pair[0] and int(ref["tri"][0]) in pair


def _gather_lanes(B, seed=1):
    """Origins in the soup's box, unit directions, as for AO rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("case", ["soup700", "heightfield35_eye"])
def test_any_hit_twin_matches_pallas(case, bounded):
    from lucille_tpu.accel.pallas_bvh import pallas_bvh_any_hit
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.dispatch import any_hit
    from lucille_tpu_torch.scene.types import from_numpy

    if case == "soup700":
        sc, (o, d) = _soup(), _gather_lanes(1024)
        case = "soup700_gather"
    else:
        sc, o, d = _bvh_cases()[case]()
    B = o.shape[0]
    tmax = None
    if bounded:
        tmax = np.random.default_rng(3).uniform(
            *TMAX_RANGE[case], B).astype(np.float32)
    ref = np.asarray(pallas_bvh_any_hit(
        sc, jnp.asarray(o), jnp.asarray(d),
        tmax=None if tmax is None else jnp.asarray(tmax), interpret=True))
    scene = from_numpy(sc, "cpu")
    bvh_isect.ANY_COUNTS.reset()
    got = any_hit(scene, torch.from_numpy(o), torch.from_numpy(d),
                  None if tmax is None else torch.from_numpy(tmax))
    assert (bvh_isect.ANY_COUNTS.kernel, bvh_isect.ANY_COUNTS.plain) == (0, 1)
    occ = got["occ"].numpy()
    assert 0.1 < ref.mean() < 0.95  # occluded and free rays both exercised
    assert (occ != ref).mean() <= 0.005


def test_any_hit_window_with_infinite_tmax():
    """tmax = inf: tmax * a^2 is inf for |a| > DET_EPS, so the window test
    t'a < inf holds for every finite t'a, as in JAX; an all-zero pad
    triangle gives inf * 0 = nan and never hits."""
    from lucille_tpu_torch.accel.bvh_isect import bvh_any_hit_reference
    from lucille_tpu_torch.accel.pack import TC

    tris = torch.zeros((16, TC))  # slot 3 real, the other 127 pads
    tri = [[-1, -1, 5], [2, 0, 0], [0, 2, 0]]  # v0, e1, e2 in z = 5
    for r in range(3):
        tris[3 * r : 3 * r + 3, 3] = torch.tensor(tri[r], dtype=torch.float32)
    org = torch.tensor([[-0.5, -0.5, 0.0], [-0.5, -0.5, 6.0],
                        [5.0, 5.0, 0.0]])
    dirn = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    for tmax, want in ((np.inf, [True, False, False]),
                       (6.0, [True, False, False]),
                       (4.0, [False, False, False])):
        res = bvh_any_hit_reference(tris, org, dirn, torch.full((3,), tmax))
        assert res["occ"].tolist() == want, tmax


def test_closest_twin_tie_goes_to_the_lowest_slot():
    from lucille_tpu_torch.accel.bvh_isect import bvh_closest_hit_reference
    from lucille_tpu_torch.accel.pack import TC

    tris = torch.zeros((16, 3 * TC))
    tri = [[-1, -1, 5], [2, 0, 0], [0, 2, 0]]
    for col in (2 * TC + 1, TC + 9, 2 * TC + 7):
        for r in range(3):
            tris[3 * r : 3 * r + 3, col] = torch.tensor(tri[r],
                                                        dtype=torch.float32)
    res = bvh_closest_hit_reference(tris, torch.tensor([[-0.5, -0.5, 0.0]]),
                                    torch.tensor([[0.0, 0.0, 1.0]]),
                                    torch.tensor([np.inf]))
    assert int(res["tri"][0]) == TC + 9 and float(res["t"][0]) == 5.0


@pytest.mark.parametrize("ntheta,nphi", [(8, 8), (3, 5)])
def test_stratified_dirs_close(ntheta, nphi):
    from lucille_tpu.accel.pallas_bvh import _stratified_dirs
    from lucille_tpu.transport.ao import ortho_basis
    from lucille_tpu_torch.accel.ao import stratum_directions

    rng = np.random.default_rng(6)
    N = rng.normal(size=(777, 3))
    N = (N / np.linalg.norm(N, axis=-1, keepdims=True)).astype(np.float32)
    b0, b1, b2 = (np.array(b) for b in ortho_basis(jnp.asarray(N)))
    key = jax.random.key(9)
    want = np.asarray(_stratified_dirs(jnp.asarray(b0), jnp.asarray(b1),
                                       jnp.asarray(b2), key, ntheta, nphi,
                                       777))
    u01 = np.array(jax.random.uniform(key, (2, 777), dtype=jnp.float32))
    t = torch.from_numpy
    got = stratum_directions(t(b0), t(b1), t(b2), t(u01), ntheta,
                             nphi).numpy()
    assert got.shape == want.shape == (ntheta * nphi, 777, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_stratum_tile_perm_equals_jax():
    from lucille_tpu.accel.pallas_bvh import _stratum_tile_perm
    from lucille_tpu_torch.accel.bvh_ao import stratum_tile_perm

    for ntheta, nphi in ((8, 8), (4, 4), (3, 3), (6, 4), (5, 7), (16, 16)):
        for K in (1, 2, 4, 8, 16):
            got = stratum_tile_perm(ntheta, nphi, K)
            np.testing.assert_array_equal(
                got, _stratum_tile_perm(ntheta, nphi, K))
            assert sorted(got.tolist()) == list(range(ntheta * nphi))


def _eye_lanes(sc, B):
    """Shading frames at the heightfield's eye hits (the port's own)."""
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.scene.types import from_numpy
    from lucille_tpu_torch.transport.ao import shading_frame

    scene = from_numpy(sc, "cpu")
    o, d = (torch.from_numpy(a) for a in _heightfield_eye_rays(B, seed=4))
    res = closest_hit(scene, o, d)
    P_off, b0, b1, b2 = (a.numpy() for a in shading_frame(scene, o, d, res))
    return P_off, b0, b1, b2, res["hit"].numpy()


def _soup_lanes(B):
    from lucille_tpu.transport.ao import ortho_basis

    rng = np.random.default_rng(1)
    P = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    N = rng.normal(size=(B, 3))
    N = (N / np.linalg.norm(N, axis=-1, keepdims=True)).astype(np.float32)
    b0, b1, b2 = (np.array(b) for b in ortho_basis(jnp.asarray(N)))
    return P, b0, b1, b2, rng.uniform(size=B) < 0.8


@pytest.mark.parametrize("case,ntheta,nphi", [
    ("soup", 4, 4), ("soup", 3, 3), ("heightfield", 4, 4)])
def test_bvh_ao_occlusion_matches_pallas(case, ntheta, nphi):
    """S = 9 clamps the strata per warp to 1 (9 is odd); B = 300 is not a
    multiple of the origin group."""
    from lucille_tpu.accel.pallas_bvh import pallas_bvh_ao_occlusion
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.bvh_ao import bvh_ao_occlusion
    from lucille_tpu_torch.scene.types import from_numpy

    if case == "soup":
        sc = _soup()
        P, b0, b1, b2, hit = _soup_lanes(300)
    else:
        sc = _heightfield()
        P, b0, b1, b2, hit = _eye_lanes(sc, 300)
    B = P.shape[0]
    key = jax.random.key(7)
    ref, _stats = pallas_bvh_ao_occlusion(
        sc, jnp.asarray(P), jnp.asarray(b0), jnp.asarray(b1),
        jnp.asarray(b2), jnp.asarray(hit), key, ntheta, nphi, interpret=True)
    ref = np.asarray(ref)
    jitter = torch.from_numpy(
        np.array(jax.random.uniform(key, (2, B), dtype=jnp.float32)))
    bvh_isect.ANY_COUNTS.reset()
    t = torch.from_numpy
    got, stats = bvh_ao_occlusion(from_numpy(sc, "cpu"), t(P), t(b0), t(b1),
                                  t(b2), t(hit), jitter, ntheta, nphi)
    got = got.numpy()
    assert (bvh_isect.ANY_COUNTS.kernel, bvh_isect.ANY_COUNTS.plain) == (0, 1)
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff != 0).mean() <= 1e-3
    assert np.all(got[~hit] == 0)
    assert ref[hit].mean() > 0.5  # the case exercises occlusion
    assert int(stats["ntrav"]) == 0 and int(stats["ntests"]) > 0  # twin


def test_cpu_pbvh_render_counts_twins_only():
    """A pbvh frame on the CPU runs both BVH twins and nothing else: no
    kernel launch, and neither dense wrapper."""
    from lucille_tpu_torch.accel import ao, bvh_isect, isect
    from lucille_tpu_torch.render.renderer import Renderer

    counts = (isect.COUNTS, ao.COUNTS, bvh_isect.CLOSEST_COUNTS,
              bvh_isect.ANY_COUNTS)
    for c in counts:
        c.reset()
    r = Renderer(heightfield_state(35, 16, 16, pixelsamples=1, gather=4,
                                   accel="bvh").scene,
                 tile_size=16, device="cpu")
    img = r.render_frame()
    assert np.isfinite(img).all() and img.mean() > 0
    assert [(c.kernel, c.plain) for c in counts] == [(0, 0), (0, 0), (0, 1),
                                                      (0, 1)]
    assert r.stats.nrays > 256


def test_wrappers_refuse_a_tree_deeper_than_the_stack():
    from lucille_tpu_torch.accel.bvh_isect import (
        STACK,
        bvh_any_hit,
        bvh_closest_hit,
    )

    tris = torch.zeros((16, 128))
    nodes = torch.zeros((1, 8))
    o = torch.zeros((4, 3))
    for fn in (bvh_closest_hit, bvh_any_hit):
        with pytest.raises(ValueError, match="stack"):
            fn(tris, nodes, o, o, depth=STACK + 1)
        fn(tris, nodes, o, o, depth=STACK)  # the deepest tree it takes


def test_dense_any_hit_is_not_ported():
    """(Named when the dense any-hit was still to port.)  The dispatch now
    serves any-hit on the dense tiles too: the same terrain on both accels
    gives the same answers (the Moller-Trumbore and the signed-volume
    tests agree but on edge-grazing rays), and the active mask reaches
    both."""
    from lucille_tpu_torch.accel.dispatch import any_hit
    from lucille_tpu_torch.scene.compile import compile_scene

    o, d = (torch.from_numpy(a) for a in _heightfield_eye_rays(1024))
    active = torch.from_numpy(np.random.default_rng(2).uniform(size=1024)
                              < 0.7)
    occ = {}
    for accel in ("pallas", "bvh"):
        scene = compile_scene(heightfield_state(35, accel=accel).scene, "cpu")
        occ[scene.accel] = any_hit(scene, o, d, 16.0, active)["occ"]
    assert 0.1 < occ["dense"].float().mean() < 0.9
    assert (occ["dense"] != occ["pbvh"]).float().mean() <= 0.005
    assert not occ["dense"][~active].any() and not occ["pbvh"][~active].any()


@pytest.mark.parametrize("case,ntheta,nphi", [
    ("soup", 4, 4), ("soup", 3, 3), ("heightfield", 4, 4),
    ("heightfield", 2, 2)])
def test_bvh_ao_fused_matches_pallas(case, ntheta, nphi, monkeypatch):
    """LUCILLE_BVH_AO=fused on both sides: the port's twin of kernel 6
    against lucille_tpu's `_bvh_ao_kernel` in interpret mode, with
    jitter column j belonging to compacted slot j on both; the soup is
    test_pallas_bvh's own."""
    from test_pallas_bvh import _random_soup as pallas_soup
    from test_pallas_bvh import _scene as pallas_scene

    from lucille_tpu.accel.pallas_bvh import pallas_bvh_ao_occlusion
    from lucille_tpu_torch.accel import bvh_ao, bvh_isect
    from lucille_tpu_torch.accel.bvh_ao import bvh_ao_occlusion
    from lucille_tpu_torch.accel.pack import pack_tris
    from lucille_tpu_torch.scene.types import from_numpy

    monkeypatch.setenv("LUCILLE_BVH_AO", "fused")
    if case == "soup":
        sc = pallas_scene(*pallas_soup(700, seed=5))
        P, b0, b1, b2, hit = _soup_lanes(300)
    else:
        sc = _heightfield()
        P, b0, b1, b2, hit = _eye_lanes(sc, 300)
    B = P.shape[0]
    key = jax.random.key(7)
    ref, _stats = pallas_bvh_ao_occlusion(
        sc, jnp.asarray(P), jnp.asarray(b0), jnp.asarray(b1),
        jnp.asarray(b2), jnp.asarray(hit), key, ntheta, nphi, interpret=True)
    ref = np.asarray(ref)
    jitter = torch.from_numpy(
        np.array(jax.random.uniform(key, (2, B), dtype=jnp.float32)))
    for c in (bvh_ao.FUSED_COUNTS, bvh_isect.ANY_COUNTS):
        c.reset()
    t = torch.from_numpy
    scene = from_numpy(sc, "cpu")
    got, stats = bvh_ao_occlusion(scene, t(P), t(b0), t(b1), t(b2), t(hit),
                                  jitter, ntheta, nphi)
    got = got.numpy()
    assert (bvh_ao.FUSED_COUNTS.kernel, bvh_ao.FUSED_COUNTS.plain) == (0, 1)
    assert bvh_isect.ANY_COUNTS.plain == 0  # not the cone gather
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff != 0).mean() <= 1e-3
    assert np.all(got[~hit] == 0)
    assert 0.1 < ref[hit].mean() < ntheta * nphi - 0.1  # both answers
    # the twin visits no node and tests every slot for every walk
    assert int(stats["ntrav"]) == 0
    assert int(stats["ntests"]) == (int(hit.sum()) * ntheta * nphi
                                    * pack_tris(scene).shape[1])


@pytest.mark.parametrize("mode", ["unset", "cone", "fused", "rebinned"])
def test_bvh_ao_mode_selection(mode, monkeypatch):
    """lucille_tpu's LUCILLE_BVH_AO switch, read at call time: cone by
    default, rebinned the re-binned gather (through the tile-BVH any-hit,
    like the cone gather, with the same answers: the same rays in another
    order), any other value the fused gather."""
    from lucille_tpu_torch.accel import bvh_ao, bvh_isect
    from lucille_tpu_torch.scene.types import from_numpy

    if mode == "unset":
        monkeypatch.delenv("LUCILLE_BVH_AO", raising=False)
    else:
        monkeypatch.setenv("LUCILLE_BVH_AO", mode)
    P, b0, b1, b2, hit = (torch.from_numpy(a) for a in _soup_lanes(64))
    jitter = torch.rand((2, 64))
    scene = from_numpy(_soup(), "cpu")
    for c in (bvh_ao.FUSED_COUNTS, bvh_isect.ANY_COUNTS):
        c.reset()
    occ, stats = bvh_ao.bvh_ao_occlusion(scene, P, b0, b1, b2, hit, jitter,
                                         2, 2)
    fused = mode == "fused"
    assert bvh_ao.FUSED_COUNTS.plain == int(fused)
    assert bvh_isect.ANY_COUNTS.plain == int(not fused)
    assert bvh_ao.gather_mode() == {"fused": "fused",
                                    "rebinned": "rebinned"}.get(mode, "cone")
    assert torch.all(occ[~hit] == 0) and occ[hit].mean() > 0
    if mode == "rebinned":  # no counters; the cone gather's answers
        assert stats == {}
        monkeypatch.setenv("LUCILLE_BVH_AO", "cone")
        cone, _ = bvh_ao.bvh_ao_occlusion(scene, P, b0, b1, b2, hit, jitter,
                                          2, 2)
        assert torch.equal(cone, occ)


def _walk_one(tris, nodes, o, d, closest):
    """One ray's near-first walk in numpy f32 scalars, slot by slot:
    (hit, inner nodes entered, nodes entered, real triangles tested, the
    closest hit's slot or -1)."""
    from lucille_tpu_torch.accel.pack import TC

    f = np.float32
    ints = nodes.view(np.int32)
    real = (tris[0:9] != 0).any(axis=0)
    inv = f(1) / np.where(np.abs(d) > f(1e-20), d, f(1e-20)).astype(f)

    def reach(n, bound):
        t0 = (nodes[n, 0:3] - o) * inv
        t1 = (nodes[n, 4:7] - o) * inv
        tn, tf = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
        return tn <= tf and tf > 0 and tn < bound, tn

    stack, cur, t_best, hit, tri = [], 0, f(np.inf), False, -1
    inner = visits = tests = 0
    while cur >= 0:
        visits += 1
        meta, link = int(ints[cur, 3]), int(ints[cur, 7])
        nxt = -1
        if meta > 0:
            for k in range(link * TC, (link + meta) * TC):
                if not real[k]:
                    continue
                tests += 1
                v0, e1, e2 = tris[0:3, k], tris[3:6, k], tris[6:9, k]
                p = np.array([d[1] * e2[2] - d[2] * e2[1],
                              d[2] * e2[0] - d[0] * e2[2],
                              d[0] * e2[1] - d[1] * e2[0]], f)
                a = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
                s = o - v0
                q = np.array([s[1] * e1[2] - s[2] * e1[1],
                              s[2] * e1[0] - s[0] * e1[2],
                              s[0] * e1[1] - s[1] * e1[0]], f)
                u = s[0] * p[0] + s[1] * p[1] + s[2] * p[2]
                v = q[0] * d[0] + q[1] * d[1] + q[2] * d[2]
                t = e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]
                if closest:
                    if abs(a) > 1e-14:
                        u, v, t = u * (f(1) / a), v * (f(1) / a), t * (f(1) / a)
                        if (0 <= u <= 1 and v >= 0 and u + v <= 1 and t > 0
                                and t < t_best):
                            t_best, hit, tri = t, True, k
                else:
                    w = a - u - v
                    if ((min(u, v, w) >= 0 or max(u, v, w) <= 0)
                            and t * a > 0 and abs(a) > 1e-14):
                        return True, inner, visits, tests, -1
        else:
            inner += 1
            c0, c1 = cur + 1, link
            bound = t_best if closest else f(np.inf)
            (r0, tn0), (r1, tn1) = reach(c0, bound), reach(c1, bound)
            near0 = d[-meta - 1] >= 0
            near, far = (c0, c1) if near0 else (c1, c0)
            rn, rf = (r0, r1) if near0 else (r1, r0)
            if rn and rf:
                stack.append((far, tn1 if near0 else tn0))
            nxt = near if rn else (far if rf else -1)
        while nxt < 0 and stack:
            n, tn = stack.pop()
            if not closest or tn < t_best:
                nxt = n
        cur = nxt
    return hit, inner, visits, tests, tri


@pytest.mark.parametrize("closest", [True, False])
@pytest.mark.parametrize("case", ["soup700", "heightfield35_eye"])
def test_need_walk_counts(case, closest):
    """chip_smoke.need_walk, the count of the work the tile-BVH kernels'
    bounds charge: its answers equal the plain twins' on all but 0.5% of
    the rays (the twins test every slot, the walk culls by box), and its
    node and real-triangle counts equal a walk of one ray at a time,
    slot by slot, on a sample of the rays (exactly)."""
    from chip_smoke import need_walk

    from lucille_tpu_torch.accel.bvh_isect import (
        bvh_any_hit_reference,
        bvh_closest_hit_reference,
    )
    from lucille_tpu_torch.accel.pack import pack_tris
    from lucille_tpu_torch.scene.types import from_numpy

    sc, o, d = _bvh_cases()[case]()
    if case == "soup700" and not closest:
        o, d = _gather_lanes(1024)
    scene = from_numpy(sc, "cpu")
    tris, nodes = pack_tris(scene), scene.nodes
    org, dirn = torch.from_numpy(o), torch.from_numpy(d)
    got = need_walk(tris, nodes, org, dirn, closest, scene.tree_depth,
                    chunk=100)
    inf = torch.full((o.shape[0],), float("inf"))
    if closest:
        ref = bvh_closest_hit_reference(tris, org, dirn, inf)["tri"] >= 0
    else:
        ref = bvh_any_hit_reference(tris, org, dirn, inf)["occ"]
    assert 0.1 < ref.float().mean() < 0.95  # hits and misses both exercised
    assert (got["hit"] != ref).float().mean() <= 0.005
    rows = np.random.default_rng(4).choice(o.shape[0], 24, replace=False)
    sub = need_walk(tris, nodes, org[rows], dirn[rows], closest,
                    scene.tree_depth)
    one = [_walk_one(tris.numpy(), nodes.numpy(), o[i], d[i], closest)
           for i in rows]
    assert sub["hit"].tolist() == [w[0] for w in one]
    assert (sub["inner"], sub["nodes"], sub["tests"]) == tuple(
        sum(w[j] for w in one) for j in (1, 2, 3))
    if closest:
        assert sub["tri"].tolist() == [w[4] for w in one]
    # the walk culls: far fewer tests than every real triangle per ray
    n_real = int((tris[0:9] != 0).any(dim=0).sum())
    assert 0 < got["tests"] < 0.5 * n_real * o.shape[0]
    assert got["inner"] < got["nodes"]


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("case", ["soup700", "heightfield35_eye"])
def test_need_walk_closest_answers(case, bounded):
    """need_walk's closest hit (its t and slot, which kernel 4 must report
    on every ray) against the plain twin: the same slot and t on every
    ray (no exact tie across leaves among these rays), tmax on a miss;
    the nodes and leaf triangles it reaches, which kernel 4's bound
    charges, lie within the tree and its real triangles."""
    from chip_smoke import need_walk

    from lucille_tpu_torch.accel.bvh_isect import bvh_closest_hit_reference
    from lucille_tpu_torch.accel.pack import pack_tris
    from lucille_tpu_torch.scene.types import from_numpy

    sc, o, d = _bvh_cases()[case]()
    B = o.shape[0]
    tmax = torch.full((B,), float("inf"))
    if bounded:
        tmax = torch.from_numpy(np.random.default_rng(2).uniform(
            *TMAX_RANGE[case], B).astype(np.float32))
    scene = from_numpy(sc, "cpu")
    tris, nodes = pack_tris(scene), scene.nodes
    org, dirn = torch.from_numpy(o), torch.from_numpy(d)
    got = need_walk(tris, nodes, org, dirn, True, scene.tree_depth,
                    chunk=100, tmax=tmax)
    ref = bvh_closest_hit_reference(tris, org, dirn, tmax)
    hit = ref["tri"] >= 0
    assert 0.1 < hit.float().mean() < 1.0
    assert torch.equal(got["tri"], ref["tri"].long())
    assert torch.equal(got["t"], ref["t"])
    assert torch.equal(got["hit"], hit)
    n_real = int((tris[0:9] != 0).any(dim=0).sum())
    assert 0 < got["distinct_nodes"] <= nodes.shape[0]
    assert 0 < got["leaf_tris"] <= n_real


def test_need_walk_keeps_the_first_leaf_on_a_tie():
    """A ray onto an edge shared by two triangles of different leaves
    (t = 5 on both): need_walk keeps the triangle of the leaf its walk
    visits first, as the one-ray walk does, where the twin keeps the
    lower slot."""
    from chip_smoke import need_walk
    from test_torch_gpu import _flat_grid_desc, shared_edge_ray

    from lucille_tpu_torch.accel.pack import pack_tris
    from lucille_tpu_torch.scene.compile import compile_scene

    scene = compile_scene(_flat_grid_desc(16), "cpu")
    pair, o, d = shared_edge_ray(scene.tri_v0, scene.tri_e1, scene.tri_e2)
    tris, nodes = pack_tris(scene), scene.nodes
    got = need_walk(tris, nodes, torch.from_numpy(o[None]),
                    torch.from_numpy(d[None]), True, scene.tree_depth)
    one = _walk_one(tris.numpy(), nodes.numpy(), o, d, True)
    assert float(got["t"][0]) == 5.0
    assert int(got["tri"][0]) == one[4] and one[4] in pair
    assert got["nodes"] == one[2] and got["tests"] == one[3]
