"""The dirt map (transport/dirtmap.py) against lucille_tpu's, and the dense
closest hit's tmax (kernel 1's twin) against a brute-force loop.

Both packages trace one 512-ray wavefront of the bundled scene's eye
rays, the port fed lucille_tpu's own draws (`JaxStream`: stratum si is
fold_in(key, si) on both sides).  Tolerances:

- tile BVH (accel "bvh"): lucille_tpu runs its kernel 4 in interpret
  mode, the port its twin; both are Moller-Trumbore in f32 in the same
  operation order, so the radiance agrees within 1e-5 on every lane;
- dense tiles (accel "pallas"): lucille_tpu's eye rays go through its
  Pallas kernel, but its gather (a closest hit with a tmax) through the
  MXU path (lucille_tpu/accel/dispatch.py:13-19, 37-42), which re-centres
  the scene and forms t from triple products at Precision.HIGHEST.  Its
  t therefore differs from the port's Moller-Trumbore t by f32 rounding
  (~1e-6 relative), and a gather ray that grazes an edge or ends within
  rounding of tmax can flip between hit and miss: one flipped stratum of
  S = 16 moves a lane's radiance by up to 1/16.  So at most 2% of the
  hit lanes may differ by more than 1e-4, and the mean |difference| over
  the hit lanes stays below 2e-3 (a flip on 2% of lanes at 1/16 each is
  1.25e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_isect import _soup_rays, _soup_scene
from test_torch_render import JaxStream
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import bundled_state

NTHETA = NPHI = 4


@pytest.mark.parametrize("accel", ["pallas", "bvh"])
def test_dirtmap_wavefront_matches_jax(accel):
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu.transport.dirtmap import dirtmap_radiance as jax_dirt
    from lucille_tpu_torch.accel import bvh_isect, isect
    from lucille_tpu_torch.scene.compile import compile_scene
    from lucille_tpu_torch.transport.dirtmap import dirtmap_radiance
    from test_torch_whitted import eye_rays

    B, S = 512, NTHETA * NPHI
    jdesc = bundled_state(16, 16, sunsky=False, accel=accel, pkg="jax").scene
    desc = bundled_state(16, 16, sunsky=False, accel=accel).scene
    jscene = jax_compile(jdesc).device_put()
    scene = compile_scene(desc, "cpu")
    assert scene.accel == ("dense" if accel == "pallas" else "pbvh")
    o, d = eye_rays(jdesc.camera, B, seed=5)
    key = jax.random.key(7)
    ref, jaux = jax_dirt(jscene, jnp.asarray(o), jnp.asarray(d), key, NTHETA,
                         NPHI)
    counts = isect.COUNTS if accel == "pallas" else bvh_isect.CLOSEST_COUNTS
    counts.reset()
    got, aux = dirtmap_radiance(scene, torch.from_numpy(o),
                                torch.from_numpy(d), JaxStream(key), NTHETA,
                                NPHI)
    assert counts.plain == 1 + S  # the eye rays, then one call a stratum
    ref, got = np.asarray(ref), got.numpy()
    hit = aux["hit"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(jaux["hit"]))
    assert 0.2 < hit.mean() < 1.0
    assert int(aux["nrays"]) == int(jaux["nrays"]) == B * (1 + S)
    assert np.all(got[~hit] == 0.0)
    assert np.all(got[:, 0] == got[:, 2])
    # both answers occur: some lanes are dirty, some clean
    assert (got[hit, 0] < 0.95).mean() > 0.05
    diff = np.abs(got - ref)[hit, 0]
    if accel == "bvh":
        assert diff.max() <= 1e-5
    else:
        assert (diff > 1e-4).mean() <= 0.02
        assert diff.mean() <= 2e-3


def _plane_scene(extra_rib=""):
    """lucille_tpu's tests/test_transport.py ground plane on the port."""
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib
    from lucille_tpu_torch.scene.compile import compile_scene

    s = RiState()
    parse_rib(
        "WorldBegin\n"
        'PointsPolygons [4] [0 3 2 1] "P" [-50 0 -50  50 0 -50  50 0 50  '
        '-50 0 50]\n' + extra_rib + "WorldEnd\n", s)
    return compile_scene(s.scene, "cpu")


def _down_rays(B=64, height=5.0):
    org = torch.stack([torch.linspace(-3, 3, B), torch.full((B,), height),
                       torch.linspace(-3, 3, B)], dim=-1)
    return org, torch.tensor([0.0, -1.0, 0.0]).expand(B, 3).contiguous()


@pytest.mark.parametrize("case", ["open_plane_is_clean", "corner_is_dirty"])
def test_dirtmap_plane_cases(case):
    """lucille_tpu's TestDirtmap (tests/test_transport.py:206-230) on the
    port: an open plane has no dirt, a wall beside the shading points
    adds some."""
    from lucille_tpu_torch.sampling.jitter import TileSampler
    from lucille_tpu_torch.transport.dirtmap import dirtmap_radiance

    wall = ('PointsPolygons [4] [0 1 2 3] "P" '
            '[-0.2 0 -50  -0.2 0 50  -0.2 50 50  -0.2 50 -50]\n')
    scene = _plane_scene(wall if case == "corner_is_dirty" else "")
    org, dirn = _down_rays(64)
    r, aux = dirtmap_radiance(scene, org, dirn, TileSampler(0, "cpu")(0, 0),
                              4, 4)
    vals = r.numpy()[aux["hit"].numpy()]
    assert len(vals) == 64
    if case == "open_plane_is_clean":
        np.testing.assert_allclose(vals, 1.0, atol=1e-5)
    else:
        assert vals.min() < 0.9


def _brute_closest(tris, org, dirn, tmax, active):
    """One ray and one triangle at a time: the nearest hit with
    0 < t < tmax, the lowest index on equal t, by isect._mt_tile's
    arithmetic; (t, tri) with (inf, -1) for a miss or a dead ray."""
    from lucille_tpu_torch.accel.isect import _mt_tile

    t_out, tri_out = [], []
    for i in range(org.shape[0]):
        best_t, best = float("inf"), -1
        if active[i]:
            o = [org[i : i + 1, c : c + 1] for c in range(3)]
            d = [dirn[i : i + 1, c : c + 1] for c in range(3)]
            valid, u, v, t = (x[0].numpy() for x in _mt_tile(tris, o, d))
            for j in range(tris.shape[1]):
                if (valid[j] and u[j] >= 0 and u[j] <= 1 and v[j] >= 0
                        and u[j] + v[j] <= 1 and 0 < t[j] < tmax[i]
                        and t[j] < best_t):
                    best_t, best = float(t[j]), j
        t_out.append(best_t)
        tri_out.append(best)
    return np.asarray(t_out, np.float32), np.asarray(tri_out)


@pytest.mark.parametrize("bound", ["random", "at_the_hit", "past_the_hit",
                                   "unbounded"])
def test_closest_twin_tmax_against_brute_force(bound):
    """closest_hit_reference with a per-ray tmax and dead lanes against a
    loop over every triangle: a hit exactly at tmax misses (at_the_hit:
    tmax is each ray's unbounded t, so every ray misses), one ulp past it
    keeps the unbounded answer, dead lanes miss."""
    from lucille_tpu_torch.accel.isect import closest_hit_reference
    from lucille_tpu_torch.scene.types import from_numpy

    scene = from_numpy(_soup_scene(), "cpu")
    o, d = (torch.from_numpy(a) for a in _soup_rays(96, seed=3))
    B = o.shape[0]
    rng = np.random.default_rng(8)
    active = torch.from_numpy(rng.uniform(size=B) < 0.75)
    free = closest_hit_reference(scene.tris, o, d)
    hit_t = torch.where(free["tri"] >= 0, free["t"], 30.0)
    inf = torch.tensor(float("inf"))
    tmax = {"random": torch.from_numpy(rng.uniform(0, 25, B).astype(
                np.float32)),
            "at_the_hit": hit_t,
            "past_the_hit": torch.nextafter(hit_t, inf),
            "unbounded": None}[bound]
    got = closest_hit_reference(scene.tris, o, d, tmax, active)
    lim = torch.full((B,), float("inf")) if tmax is None else tmax
    t_ref, tri_ref = _brute_closest(scene.tris[:, :scene.n_tris], o, d,
                                    lim.numpy(), active.numpy())
    np.testing.assert_array_equal(got["tri"].numpy(), tri_ref)
    np.testing.assert_array_equal(got["t"].numpy(), t_ref)
    miss = got["tri"] < 0
    assert torch.all(got["u"][miss] == 0) and torch.all(got["v"][miss] == 0)
    assert not torch.any(got["tri"][~active] >= 0)
    n_hit = int((got["tri"] >= 0).sum())
    if bound == "at_the_hit":
        assert n_hit == 0
    elif bound == "past_the_hit":
        want = torch.where(active, free["tri"], -1)
        assert torch.equal(got["tri"], want)
    else:
        assert 0 < n_hit < int(active.sum())


def test_dispatch_takes_a_dense_tmax():
    """accel/dispatch.closest_hit passes a scalar tmax to the dense twin
    as the dirt map's gather does: t beyond it misses."""
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.scene.types import from_numpy

    scene = from_numpy(_soup_scene(), "cpu")
    o, d = (torch.from_numpy(a) for a in _soup_rays(64, seed=4))
    free = closest_hit(scene, o, d)
    lim = float(free["t"][free["hit"]].median())
    got = closest_hit(scene, o, d, tmax=torch.tensor(lim))
    assert torch.equal(got["hit"], free["hit"] & (free["t"] < lim))
    assert torch.all(torch.isinf(got["t"][~got["hit"]]))
