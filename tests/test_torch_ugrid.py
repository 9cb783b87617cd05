"""The uniform grid (accel/ugrid.py) against lucille_tpu's.

- `build_ugrid` and the compile's grid arrays: equal, bit for bit, on the
  bundled scene and the 35x35 heightfield.
- The walk's twin (`grid_walk_reference`, the lock-step loop the CUDA
  kernel is held to on the card) against `ugrid_closest_hit` and
  `ugrid_any_hit` on the same rays: the bundled scene's 80x60 eye rays
  (through the pixel centres) and a gather wavefront from their hits.
  Triangle ids, hit masks and the counters `ntests` (triangle slots
  tested) and `ntrav` (cell advances) are the walk's own, so they agree
  on all but a bounded share of the rays: XLA:CPU contracts a*b + c into
  one rounding (ROADMAP Queue 3), which can move t, an entry cell or a
  boundary distance by one rounding, and with it a near-tie or a walk
  (at most 1e-3 of the rays, and the counters' totals within 1e-3).
  On the rays whose triangle agrees, t agrees within 1e-5 of max(t, 1)
  and u, v (in [0, 1], each a difference of products) within 1e-5.
- The walk's packs (`grid_packs`, built once per scene): the occupancy
  bitmask equal to cell_start[1:] > cell_start[:-1] bit for bit in the
  kernel's word and bit order, and the slot-order pack equal to the
  triangle tables gathered by tri_idx with the id's bits in column 3,
  on the bundled scene, the 35x35 heightfield and the n = 256 terrain's
  res-64 grid (the largest bitmask); lucille_tpu's grid arrays carried
  over by from_numpy get the same packs.
- The wrappers' counters: the closest hit always returns them, the
  any-hit only when asked, equal to the twin's; the kernel's lanes a ray
  (`group_lanes`) from the grid's resolution and the wavefront's size.
- 80x60 AO and Whitted frames through the grid, both packages fed
  lucille_tpu's draws (`JaxSampler`): the strata scanned through the
  any-hit (AO) and the dome gathered by cosine-weighted shadow rays
  (Whitted, at depth 2), as lucille_tpu does under "ugrid": pixels
  within 1e-4 on all but 1% of the pixels, the ray counts equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_render import JaxSampler
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import bundled_state, heightfield_state

GRID_FIELDS = ("grid_cell_start", "grid_tri_idx", "grid_bbmin", "grid_bbmax")
# the share of rays (and of the counters' totals) one FMA rounding may move
FMA_SHARE = 1e-3


def _states(kind, pkg, **kw):
    if kind == "bundled":
        return bundled_state(accel="grid", pkg=pkg, **kw)
    return heightfield_state(35, accel="grid", pkg=pkg, **kw)


@pytest.mark.parametrize("kind", ["bundled", "heightfield35"])
def test_build_ugrid_matches_jax(kind):
    from lucille_tpu.accel.ugrid import build_ugrid as jax_build
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.accel.ugrid import build_ugrid
    from lucille_tpu_torch.scene.compile import compile_arrays

    ref = jax_compile(_states(kind, "jax").scene)
    got = compile_arrays(_states(kind, "torch").scene)
    assert ref.accel == got.accel == "ugrid"
    assert got.intersector == "ugrid"
    assert ref.grid_res == got.grid_res > 1
    for f in (*GRID_FIELDS, "tri_v0", "tri_e1", "tri_e2"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    n = got.n_tris
    v0, v1, v2 = (got.tri_v0[:n], got.tri_v0[:n] + got.tri_e1[:n],
                  got.tri_v0[:n] + got.tri_e2[:n])
    a, b = build_ugrid(v0, v1, v2), jax_build(v0, v1, v2)
    assert a.res == b.res
    for f in ("cell_start", "tri_idx", "bbmin", "bbmax"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _scenes_and_rays():
    """Both packages' bundled grid scenes and 80x60 eye rays (numpy)."""
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.scene.compile import compile_scene

    js = _states("bundled", "jax", width=80, height=60)
    jscene = jax_compile(js.scene).device_put()
    pscene = compile_scene(_states("bundled", "torch", width=80,
                                   height=60).scene, "cpu")
    xs, ys = np.meshgrid(np.arange(80, dtype=np.float32) + 0.5,
                         np.arange(60, dtype=np.float32) + 0.5)
    o, d = js.camera.generate_rays(jnp.asarray(xs.ravel()),
                                   jnp.asarray(ys.ravel()))
    return jscene, pscene, np.array(o), np.array(d)


def _gather_rays(o, d, t, hit, seed=0):
    """One random hemisphere-ish direction from every eye hit (misses
    keep their eye ray), starting just off the surface."""
    rng = np.random.default_rng(seed)
    P = o + np.where(hit, t, 0.0)[:, None] * d - 1e-3 * d
    w = rng.normal(size=o.shape).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return (np.where(hit[:, None], P, o).astype(np.float32),
            np.where(hit[:, None], w, d).astype(np.float32))


def _check_counters(ref, got):
    for k in ("ntests", "ntrav"):
        want, have = int(ref[k]), int(got[k])
        assert want > 0 and abs(want - have) <= FMA_SHARE * want, (k, want,
                                                                    have)


@pytest.mark.parametrize("wave", ["eye", "gather"])
def test_grid_walk_matches_jax(wave):
    from lucille_tpu.accel.ugrid import ugrid_any_hit, ugrid_closest_hit
    from lucille_tpu_torch.accel import ugrid

    jscene, pscene, o, d = _scenes_and_rays()
    if wave == "gather":
        eye = ugrid_closest_hit(jscene, jnp.asarray(o), jnp.asarray(d))
        o, d = _gather_rays(o, d, np.array(eye["t"]), np.array(eye["hit"]))
    ref = ugrid_closest_hit(jscene, jnp.asarray(o), jnp.asarray(d))
    got = ugrid.closest_hit(pscene, torch.from_numpy(o), torch.from_numpy(d))
    hit = np.array(ref["hit"])
    assert 0.2 < hit.mean() < 0.9
    tri_ref = np.where(hit, np.array(ref["tri"]), -1)
    same = got["tri"].numpy() == tri_ref
    assert (~same).mean() <= FMA_SHARE, (~same).sum()
    both = same & hit
    np.testing.assert_allclose(got["t"].numpy()[both],
                               np.array(ref["t"])[both], rtol=1e-5,
                               atol=1e-5)
    for k in ("u", "v"):  # in [0, 1], formed by cancelling products
        np.testing.assert_allclose(got[k].numpy()[both],
                                   np.array(ref[k])[both], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert np.isinf(got["t"].numpy()[~hit & same]).all()
    _check_counters(ref, got)

    # the any-hit, unbounded and with a finite tmax (the hit's t times a
    # factor in [0.5, 1.5): about half the hits lie beyond it)
    scale = np.random.default_rng(1).uniform(0.5, 1.5, hit.shape[0])
    tmax = np.where(hit, scale * np.array(ref["t"]), 1e3).astype(np.float32)
    for bound in (None, tmax):
        occ_ref = np.array(ugrid_any_hit(
            jscene, jnp.asarray(o), jnp.asarray(d),
            tmax=None if bound is None else jnp.asarray(bound)))
        occ = ugrid.any_hit(pscene, torch.from_numpy(o), torch.from_numpy(d),
                            tmax=None if bound is None else
                            torch.from_numpy(bound), counters=True)
        assert (occ["occ"].numpy() != occ_ref).mean() <= FMA_SHARE
        assert occ["occ"].numpy().mean() > (0.2 if bound is None else 0.0)
        assert int(occ["ntests"]) > 0 and int(occ["ntrav"]) > 0


def test_grid_active_lanes_walk_nothing():
    """A ray that is not active reports a miss and adds no test or
    advance; the live rays' answers are those of the full wavefront."""
    from lucille_tpu_torch.accel import ugrid

    _jscene, pscene, o, d = _scenes_and_rays()
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    full = ugrid.closest_hit(pscene, o, d)
    active = torch.arange(o.shape[0]) % 3 == 0
    part = ugrid.closest_hit(pscene, o, d, active=active)
    assert torch.equal(part["tri"][active], full["tri"][active])
    assert torch.all(part["tri"][~active] == -1)
    assert torch.isinf(part["t"][~active]).all()
    live = ugrid.closest_hit(pscene, o[active], d[active])
    assert int(part["ntests"]) == int(live["ntests"])
    assert int(part["ntrav"]) == int(live["ntrav"])
    occ = ugrid.any_hit(pscene, o, d, active=active)["occ"]
    assert not occ[~active].any()


@pytest.mark.parametrize("kind", ["bundled", "heightfield35",
                                  "heightfield256", "bundled-lucille_tpu"])
def test_grid_packs(kind):
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.scene.compile import compile_scene
    from lucille_tpu_torch.scene.types import from_numpy

    if kind == "heightfield256":  # 130,050 triangles: a res-64 grid
        state = heightfield_state(256, accel="grid")
    else:
        state = _states("bundled" if kind.startswith("bundled") else kind,
                        "torch")
    scene = compile_scene(state.scene, "cpu")
    if kind == "bundled-lucille_tpu":
        # lucille_tpu's arrays carry no packs: from_numpy builds the same
        own = scene
        scene = from_numpy(jax_compile(_states("bundled", "jax").scene),
                           "cpu")
        assert torch.equal(scene.grid_occupied, own.grid_occupied)
        assert torch.equal(scene.grid_tris, own.grid_tris)
    starts = scene.grid_cell_start.numpy()
    idx = scene.grid_tri_idx.numpy()
    res = scene.grid_res
    assert res == (64 if kind == "heightfield256" else res) > 1
    full = starts[1:] > starts[:-1]
    words = scene.grid_occupied.numpy()
    assert words.dtype == np.int32 and words.shape == (-(-res**3 // 32),)
    bits = (words[:, None] >> np.arange(32)) & 1  # bit c % 32 of word c // 32
    np.testing.assert_array_equal(bits.reshape(-1)[:res**3], full)
    assert not bits.reshape(-1)[res**3:].any()
    tris = scene.grid_tris.numpy()
    assert tris.shape == (idx.shape[0], 12) and tris.dtype == np.float32
    for cols, table in ((slice(0, 3), scene.tri_v0), (slice(4, 7),
                        scene.tri_e1), (slice(8, 11), scene.tri_e2)):
        np.testing.assert_array_equal(tris[:, cols], table.numpy()[idx])
    np.testing.assert_array_equal(tris[:, 3].view(np.int32), idx)
    assert not tris[:, [7, 11]].any()


@pytest.mark.parametrize("entry", ["closest", "any", "any-counted"])
def test_grid_counters_contract(entry):
    """The closest hit always returns the walk's counters, the any-hit
    only with counters=True; both equal the twin's."""
    from lucille_tpu_torch.accel import ugrid

    _jscene, pscene, o, d = _scenes_and_rays()
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    any_hit = entry != "closest"
    ref = ugrid.grid_walk_reference(pscene, o, d, any_hit=any_hit)
    if entry == "closest":
        got = ugrid.closest_hit(pscene, o, d)
    else:
        got = ugrid.any_hit(pscene, o, d, counters=entry == "any-counted")
    keys = ("occ",) if any_hit else ("tri", "t", "u", "v")
    if entry == "any":
        assert set(got) == {"occ"}
    else:
        keys += ("ntests", "ntrav")
        assert set(got) == set(keys)
    for k in keys:
        assert torch.equal(got[k], ref[k]), k
    assert int(ref["ntests"]) > 0 and int(ref["ntrav"]) > 0


@pytest.mark.parametrize("res,B,lanes", [
    (9, 36864, 1), (9, 518400, 1), (17, 65536, 8), (64, 131044, 8),
    (64, 262144, 1)])
def test_group_lanes(res, B, lanes):
    """The walk's lanes a ray from static data alone: GROUP where the
    grid has at least GROUP_RES cells an axis and B x GROUP lanes stay
    within GROUP_THREADS, else 1, at the shapes that set the thresholds
    on the card: the bundled scene's 9^3 grid at the default tile 64 and
    the headline tile (1), the 35x35 heightfield's 17^3 grid at 65,536
    rays (8), the n = 256 terrain's 64^3 grid at 131,044 rays (8) and
    262,144 (1)."""
    from types import SimpleNamespace

    from lucille_tpu_torch.accel import ugrid

    assert ugrid.group_lanes(SimpleNamespace(grid_res=res), B) == lanes
    long_walks = res >= ugrid.GROUP_RES
    room = B * ugrid.GROUP <= ugrid.GROUP_THREADS
    assert (lanes == ugrid.GROUP) == (long_walks and room)


@pytest.mark.parametrize("live", ["all", "none"])
def test_grid_walk_reads(live):
    """The twin's record of the walk's distinct reads (what
    chip_smoke.grid_bound charges as bytes) and of each ray's steps
    changes no answer; every slot it marks lies in a marked cell, every
    hit's triangle is marked, and there are at most as many slots and
    triangles as tests; the steps cover the counted advances and chunks;
    a wavefront with no live ray reads nothing and steps nowhere."""
    from lucille_tpu_torch.accel import ugrid

    _jscene, pscene, o, d = _scenes_and_rays()
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    active = torch.full((o.shape[0],), live == "all")
    reads = {}
    got = ugrid.closest_hit(pscene, o, d, active=active)
    marked = ugrid.grid_walk_reference(pscene, o, d, None, active,
                                       reads=reads)
    for k in ("tri", "t", "u", "v", "ntests", "ntrav"):
        assert torch.equal(got[k], marked[k]), k
    cells, slots, tris = reads["cell_start"], reads["tri_idx"], reads["tris"]
    assert slots.shape == pscene.grid_tri_idx.shape
    if live == "none":
        assert not (cells.any() or slots.any() or tris.any())
        assert not (reads["steps"].any() or reads["empty"].any())
        return
    starts = pscene.grid_cell_start.long()
    cell_of = torch.searchsorted(starts, torch.nonzero(slots)[:, 0],
                                 right=True) - 1
    assert cells[cell_of].all() and cells[cell_of + 1].all()
    assert tris[got["tri"][got["tri"] >= 0].long()].all()
    assert 0 < int(tris.sum()) <= int(slots.sum()) <= int(got["ntests"])
    # every live ray's steps: its chunks (at least ntests / K in all) and
    # its advances, some of them into empty cells
    steps, empty = reads["steps"], reads["empty"]
    assert int(steps.sum()) >= int(got["ntrav"]) + int(got["ntests"]) // 4
    assert 0 < int(empty.sum()) < int(got["ntrav"])


@pytest.mark.parametrize("method", ["ao", "whitted"])
def test_grid_frame_matches_jax(method):
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.accel import ugrid
    from lucille_tpu_torch.render.renderer import Renderer

    def make(pkg):
        s = _states("bundled", pkg, width=80, height=60, pixelsamples=1,
                    gather=16)
        s.options.render_method = method
        s.options.max_ray_depth = 2  # the eye hits and one bounce
        return s

    jr = JaxRenderer(make("jax").scene, tile_size=40)
    ref = jr.render_frame()
    ugrid.COUNTS.reset()
    ugrid.ANY_COUNTS.reset()
    r = Renderer(make("torch").scene, tile_size=40, device="cpu",
                 sampler=JaxSampler())
    got = r.render_frame()
    assert jr.scene.accel == r.scene.accel == "ugrid"
    assert r.stats.nrays == jr.stats.nrays
    off = np.abs(got - ref) > 1e-4 * np.maximum(np.abs(ref), 1.0)
    assert off.mean() <= 0.01
    assert 0.1 < ref.mean() < 1.0
    # every ray went through the grid's twin, 4 tiles: AO's eye rays and
    # its 16 strata; Whitted's two bounces, the dome's 4 shadow rays each
    want = {"ao": (4, 4 * 16), "whitted": (4 * 2, 4 * 2 * 4)}[method]
    assert (ugrid.COUNTS.plain, ugrid.ANY_COUNTS.plain) == want
