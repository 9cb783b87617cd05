"""The library modules no render path calls, against lucille_tpu's:
transport/sss, shading/brdf, ops/spectrum, sampling/qmc, mc and rng,
accel/traverse (bvh_diag) and the BVH visualizer (tools/bvh_viz.py).

Tolerances:
- single_scattering, lane for lane on the dense tiles and on the tile
  BVH, both fed lucille_tpu's draws: within 1e-4 of max(|value|, 1e-3)
  on all but 1% of the lanes (a shadow ray from a point just under the
  surface can flip at an f32 rounding of the two packages' any-hits);
- each BRDF within 1e-6 relative (1e-6 absolute near 0), the modified
  phong's importance sample within 1e-5 (its direction goes through
  ortho_basis, sin and cos);
- spectrum and the NumPy qmc functions exactly (the same NumPy code);
  halton_torch against halton_jax within one f32 ulp;
- latin_hypercube: one sample in each of the n strata of every column,
  the same samples under the same seed, others under another;
- the rng streams: the same draws for the same (seed, frame, x, y), and
  distinct draws across coordinates;
- bvh_diag on the 35x35 heightfield's tile BVH: every ray's triangle,
  node visits, leaf visits and triangle tests equal to lucille_tpu's; the
  heatmap and the node boxes of tools/bvh_viz.py equal to
  tools_tpu/bvh_viz.py's.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import JaxStream
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import (
    BUNDLED_RIB,
    REPO,
    bundled_rib_text,
    front_end,
    heightfield_state,
)

LIGHTS_RIB = ('LightSource "pointlight" 2 "intensity" [12.0] "from" [-1 4 1]\n'
              'LightSource "distantlight" 3 "intensity" [1.5] '
              '"from" [2 6 3] "to" [0 0 0]\n')


def _sss_case(accel, pkg):
    """(scene, light tables) of the bundled scene as shipped (sunsky and
    sun) with a point and a distant light, or of the 35x35 heightfield
    under the same lights."""
    RiState, parse_rib = front_end(pkg)
    if accel == "pallas":
        s = RiState()
        parse_rib(bundled_rib_text(sunsky=True).replace(
            "WorldBegin\n", "WorldBegin\n" + LIGHTS_RIB, 1), s)
    else:
        from chip_smoke import heightfield_state as hf

        s = hf(35, light=LIGHTS_RIB, api=(RiState, parse_rib))
    s.options.accel_method = "bvh" if accel == "bvh" else "pallas"
    if pkg == "jax":
        from lucille_tpu.lights.tables import build_light_tables
        from lucille_tpu.scene.compile import compile_scene

        return (compile_scene(s.scene).device_put(),
                build_light_tables(s.scene), s.scene.camera)
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.scene.compile import compile_scene

    return (compile_scene(s.scene, "cpu"),
            build_light_tables(s.scene, device="cpu"), None)


@pytest.mark.parametrize("accel,phase", [("pallas", False), ("bvh", False),
                                          ("pallas", True)])
def test_single_scattering_matches_jax(accel, phase):
    from lucille_tpu.ops.mie import milk_phase_table as jax_milk
    from lucille_tpu.transport.sss import single_scattering as jax_sss
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.ops.mie import milk_phase_table
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.transport.common import interp_hit
    from lucille_tpu_torch.transport.sss import single_scattering

    sj, lj, cam = _sss_case(accel, "jax")
    st, lt, _ = _sss_case(accel, "torch")
    assert {li.type for li in lt} >= {"point", "distant"}
    B = 512
    rng = np.random.default_rng(4)
    px = rng.uniform(0, cam.horizontal_resolution, B).astype(np.float32)
    py = rng.uniform(0, cam.vertical_resolution, B).astype(np.float32)
    o, d = (np.array(a) for a in cam.generate_rays(jnp.asarray(px),
                                                    jnp.asarray(py)))
    res = closest_hit(st, torch.from_numpy(o), torch.from_numpy(d))
    h = interp_hit(st, res, torch.from_numpy(o), torch.from_numpy(d))
    hit = res["hit"].numpy()
    assert hit.mean() > 0.3
    P, N = h["P"].numpy(), h["Ns"].numpy()
    key = jax.random.key(6)
    table = (jax_milk(), milk_phase_table()) if phase else (None, None)
    want = np.asarray(jax_sss(sj, lj, jnp.asarray(P), jnp.asarray(N),
                              jnp.asarray(d), key, nsamples=2,
                              phase_table=table[0]))
    got = single_scattering(st, lt, torch.from_numpy(P), torch.from_numpy(N),
                            torch.from_numpy(d), StreamKey(JaxStream(key)),
                            nsamples=2, phase_table=table[1]).numpy()
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    close = (err <= 1e-4).all(axis=1)
    assert close[hit].mean() >= 0.99
    assert want[hit].mean() > 0 and np.isfinite(got).all()


def test_fresnel_diffuse_reflectance_matches_jax():
    from lucille_tpu.transport.sss import fresnel_diffuse_reflectance as ref
    from lucille_tpu_torch.transport.sss import fresnel_diffuse_reflectance

    for eta in (1.0, 1.3, 1.4, 2.0):
        assert fresnel_diffuse_reflectance(eta) == ref(eta)


def _unit(rng, n, up=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    if up:
        v[:, 2] = np.abs(v[:, 2]) + 0.2
    return v / np.linalg.norm(v, axis=1, keepdims=True)


BRDFS = {  # name: the arguments after wo, wi, n
    "lambert": lambda r, n: (np.float32(0.7),),
    "blinn": lambda r, n: (np.float32(0.3), np.float32(0.6),
                           np.float32(12.0)),
    "phong": lambda r, n: (np.float32(0.5), np.float32(0.4),
                           np.float32(8.0)),
    "modified_phong": lambda r, n: (np.float32(0.5), np.float32(0.4),
                                    np.float32(8.0)),
    "ward_anisotropic": lambda r, n: (_unit(r, n), _unit(r, n),
                                      np.float32(0.4), np.float32(0.3),
                                      np.float32(0.2), np.float32(0.35)),
    "ashikhmin_shirley": lambda r, n: (
        _unit(r, n), _unit(r, n), np.asarray([0.6, 0.5, 0.4], np.float32),
        np.asarray([0.2, 0.25, 0.3], np.float32), np.float32(10.0),
        np.float32(100.0)),
}


@pytest.mark.parametrize("name", sorted(BRDFS))
def test_brdf_matches_jax(name):
    from lucille_tpu.shading import brdf as jax_brdf
    from lucille_tpu_torch.shading import brdf

    rng = np.random.default_rng(sorted(BRDFS).index(name))
    n = 2048
    wo, wi, nrm = _unit(rng, n, up=True), _unit(rng, n), np.tile(
        np.float32([0, 0, 1]), (n, 1))
    extra = BRDFS[name](rng, n)
    want = np.asarray(getattr(jax_brdf, name)(
        jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(nrm),
        *(jnp.asarray(a) for a in extra)))
    got = getattr(brdf, name)(
        torch.from_numpy(wo), torch.from_numpy(wi), torch.from_numpy(nrm),
        *(torch.from_numpy(np.asarray(a)) for a in extra)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(want).max() > 0


def test_sample_modified_phong_matches_jax():
    from lucille_tpu.shading.brdf import sample_modified_phong as ref
    from lucille_tpu_torch.shading.brdf import sample_modified_phong

    rng = np.random.default_rng(8)
    n = 2048
    wi, nrm = _unit(rng, n), _unit(rng, n, up=True)
    u0, u1 = rng.uniform(size=(2, n)).astype(np.float32)
    want = ref(jnp.asarray(wi), jnp.asarray(nrm), jnp.asarray(u0),
               jnp.asarray(u1), 20.0)
    got = sample_modified_phong(torch.from_numpy(wi), torch.from_numpy(nrm),
                                torch.from_numpy(u0), torch.from_numpy(u1),
                                20.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_spectrum_matches_jax_exactly():
    from lucille_tpu.ops import spectrum as ref
    from lucille_tpu_torch.ops import spectrum

    for name in ("CIE_LAMBDA", "CIE_X", "CIE_Y", "CIE_Z", "XYZ2RGB"):
        np.testing.assert_array_equal(getattr(spectrum, name),
                                      getattr(ref, name))
    wl = np.linspace(350.0, 800.0, 91)
    vals = np.sin(np.arange(12)) + 1.5
    a, b = spectrum.RegularSpectrum(400, 700, vals), ref.RegularSpectrum(
        400, 700, vals)
    np.testing.assert_array_equal(a.sample(wl), b.sample(wl))
    pts = np.asarray([380.0, 450.0, 520.0, 610.0, 700.0, 780.0])
    a2 = spectrum.IrregularSpectrum(pts, vals[:6])
    b2 = ref.IrregularSpectrum(pts, vals[:6])
    np.testing.assert_array_equal(a2.sample(wl), b2.sample(wl))
    for spec in (a, a2):
        other = b if spec is a else b2
        np.testing.assert_array_equal(spectrum.spectrum_to_xyz(spec.sample),
                                      ref.spectrum_to_xyz(other.sample))
        np.testing.assert_array_equal(
            spectrum.spectrum_to_rgb(spec.sample, 2.0),
            ref.spectrum_to_rgb(other.sample, 2.0))
    xyz = np.asarray([0.2, 0.5, 0.9])
    np.testing.assert_array_equal(spectrum.xyz_to_rgb(xyz), ref.xyz_to_rgb(xyz))
    np.testing.assert_array_equal(spectrum.constrain_rgb([-0.2, 0.5, 1.0]),
                                  ref.constrain_rgb([-0.2, 0.5, 1.0]))


def test_qmc_matches_jax_exactly():
    from lucille_tpu.sampling import qmc as ref
    from lucille_tpu_torch.sampling import qmc

    np.testing.assert_array_equal(qmc.PRIMES, ref.PRIMES)
    for i, base in ((0, 2), (7, 2), (12345, 3), (999, 7)):
        assert qmc.radical_inverse(i, base) == ref.radical_inverse(i, base)
        assert qmc.halton(i, base) == ref.halton(i, base)
    pa, pb = qmc.faure_permutations(40), ref.faure_permutations(40)
    for b in range(2, 41):
        np.testing.assert_array_equal(pa[b], pb[b])
    i = np.arange(500)
    for dim in (1, 2, 5, 11):
        np.testing.assert_array_equal(
            qmc.generalized_halton(i, 3, dim, pa),
            ref.generalized_halton(i, 3, dim, pb))
        np.testing.assert_array_equal(
            qmc.generalized_hammersley(i, 3, 256, dim, pa),
            ref.generalized_hammersley(i, 3, 256, dim, pb))
    for k in (5, 12, 20):
        np.testing.assert_array_equal(qmc.fibonacci_lattice(k),
                                      ref.fibonacci_lattice(k))


@pytest.mark.parametrize("base", [2, 3, 5, 7])
def test_halton_torch_matches_halton_jax(base):
    from lucille_tpu.sampling.qmc import halton_jax
    from lucille_tpu_torch.sampling.qmc import halton, halton_torch

    i = np.arange(0, 65536, 7, dtype=np.int32)
    want = np.asarray(halton_jax(jnp.asarray(i), base))
    got = halton_torch(torch.from_numpy(i), base).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= ulp).all()
    assert abs(float(got[5]) - halton(int(i[5]), base)) < 1e-6


def test_latin_hypercube_strata_and_seed():
    from lucille_tpu_torch.sampling import latin_hypercube

    def draw(seed):
        return latin_hypercube(torch.Generator().manual_seed(seed), 64, 5)

    x = draw(3)
    assert x.shape == (64, 5) and x.dtype == torch.float32
    assert bool(((x >= 0) & (x < 1)).all())
    for d in range(5):  # one sample in each stratum of every column
        assert torch.equal(torch.sort((x[:, d] * 64).long()).values,
                           torch.arange(64))
    assert torch.equal(x, draw(3)) and not torch.equal(x, draw(4))
    assert not torch.equal(x[:, 0], x[:, 1])


def test_rng_streams_reproducible_and_distinct():
    from lucille_tpu_torch.sampling import fold_in_many, pixel_key
    from lucille_tpu_torch.sampling.rng import base_key

    base = base_key(7, "cpu")
    a = pixel_key(base, 3, 5).uniform((1000,))
    assert torch.equal(a, pixel_key(base_key(7, "cpu"), 3, 5).uniform((1000,)))
    assert pixel_key(base, 3, 5, frame=0).path == (0, 3, 5)
    draws = [pixel_key(base, x, y, f).uniform((1000,))
             for x, y, f in ((3, 5, 0), (5, 3, 0), (3, 6, 0), (3, 5, 1))]
    draws.append(pixel_key(base_key(8, "cpu"), 3, 5).uniform((1000,)))
    for i in range(len(draws)):
        for j in range(i + 1, len(draws)):
            assert not torch.equal(draws[i], draws[j]), (i, j)
    k = fold_in_many(pixel_key(base, 3, 5), 2, 9)
    assert k.path == (0, 3, 5, 2, 9)
    assert torch.equal(k.uniform((10,)), k.stream.uniform((0, 3, 5, 2, 9),
                                                          (10,)))
    assert abs(float(a.mean()) - 0.5) < 0.05


def test_bvh_diag_matches_jax():
    from lucille_tpu.accel.traverse import bvh_diag as ref
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.accel.traverse import bvh_diag
    from lucille_tpu_torch.scene.compile import compile_scene

    js = heightfield_state(35, 32, 32, accel="bvh", pkg="jax")
    jscene = jax_compile(js.scene).device_put()
    scene = compile_scene(heightfield_state(35, 32, 32, accel="bvh").scene,
                          "cpu")
    assert scene.n_nodes == jscene.n_nodes > 1
    xs, ys = np.meshgrid(np.arange(32, dtype=np.float32) + 0.5,
                         np.arange(32, dtype=np.float32) + 0.5)
    o, d = js.camera.generate_rays(jnp.asarray(xs.ravel()),
                                   jnp.asarray(ys.ravel()))
    want = ref(jscene, o, d)
    got = bvh_diag(scene, torch.from_numpy(np.array(o)),
                   torch.from_numpy(np.array(d)))
    for k in ("tri", "hit", "nvisits", "nleafs", "ntris"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    hit = np.asarray(want["hit"])
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(got["t"].numpy()[hit],
                               np.asarray(want["t"])[hit], rtol=1e-5)
    with pytest.raises(ValueError, match="tile BVH"):
        bvh_diag(compile_scene(heightfield_state(35).scene, "cpu"),
                 torch.zeros(1, 3), torch.ones(1, 3))


def test_bvh_viz_matches_tools_tpu(tmp_path):
    from lucille_tpu_torch.tools import bvh_viz

    sys.path.insert(0, str(REPO / "tools_tpu"))
    try:
        import bvh_viz as ref
    finally:
        sys.path.remove(str(REPO / "tools_tpu"))
    got, stats, scene = bvh_viz.render_diag(BUNDLED_RIB, 40, 30, "ntris",
                                            device="cpu")
    want, wstats, wscene = ref.render_diag(BUNDLED_RIB, 40, 30, "ntris")
    for k in ("nvisits", "nleafs", "ntris"):
        np.testing.assert_array_equal(stats[k], wstats[k], err_msg=k)
    np.testing.assert_array_equal(bvh_viz.heatmap(got), ref.heatmap(want))
    assert got.max() > got.min()
    a = bvh_viz.dump_boxes_obj(scene, tmp_path / "a.obj")
    b = ref.dump_boxes_obj(wscene, tmp_path / "b.obj")
    assert (a.read_text().splitlines()[1:]
            == b.read_text().splitlines()[1:])
    assert bvh_viz.main([str(BUNDLED_RIB), "-o", str(tmp_path / "h.hdr"),
                         "--width", "20", "--height", "15", "--device",
                         "cpu"]) == 0
