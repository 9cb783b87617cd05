"""The shading pipeline (shading/pipeline.py: displacement, atmosphere,
imager), its Mie tables (ops/mie.py) and noise (ops/noise.py), against
lucille_tpu's on the same NumPy-seeded inputs.

Tolerances:

- the Mie tables (the same NumPy f64 code): exactly; `phase_lookup`
  within 1e-6 of max(|value|, 1) (f32 arccos);
- perlin3 and turbulence3: within 1e-6 (the same int32 hashing; XLA may
  contract the fade's products into FMAs);
- each atmosphere: within 1e-5 of max(|value|, 1) (miefog's exp, arccos
  and the eye / sun dot product are f32 on both sides); escaped rays'
  radiance unchanged, exactly; the imagers (NumPy on both sides) and
  displace_scene (NumPy f64): exactly;
- the frames (fog or miefog, an imager, MOSAICdisplace) against
  lucille_tpu's Renderer through `test_torch_render.JaxSampler`: AO
  pixels within 1e-4 of max(|value|, 1) on all but 1%, the means within
  1e-3, alpha exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_render import JaxSampler
from test_torch_scene import bundled_rib_text, front_end
from test_torch_scene import one_torch_thread  # noqa: F401


def _close(got, want, tol):
    """(n,) bool: |got - want| <= tol max(|want|, 1), per row."""
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    return err.reshape(err.shape[0], -1).max(axis=1) <= tol


# -- ops/mie.py, ops/noise.py ----------------------------------------------

@pytest.mark.parametrize("args", [(600.0, 1000.0, 1.33, 1.0),
                                  (450.0, 250.0, 1.46, 1.33),
                                  (700.0, 3000.0, 1.5, 1.0)])
def test_mie_tables_match_jax_exactly(args):
    from lucille_tpu.ops import mie as jmie
    from lucille_tpu_torch.ops import mie

    np.testing.assert_array_equal(mie.phase_table(*args),
                                  jmie.phase_table(*args))
    for a, b in zip(mie.lorenz_mie_coefficients(*args),
                    jmie.lorenz_mie_coefficients(*args)):
        np.testing.assert_array_equal(a, b)
    assert mie.cross_sections(*args) == jmie.cross_sections(*args)
    assert mie.asymmetry(*args) == jmie.asymmetry(*args)
    np.testing.assert_array_equal(mie.milk_phase_table(args[0], args[1]),
                                  jmie.milk_phase_table(args[0], args[1]))


def test_phase_lookup_matches_jax():
    from lucille_tpu.ops import mie as jmie
    from lucille_tpu_torch.ops import mie

    table = mie.phase_table(600.0, 1000.0, 1.33)
    c = np.random.default_rng(0).uniform(-1.2, 1.2, 512).astype(np.float32)
    c[:4] = [-1.0, 1.0, 0.0, -0.5]
    got = mie.phase_lookup(torch.from_numpy(table.astype(np.float32)),
                           torch.from_numpy(c)).numpy()
    want = np.asarray(jmie.phase_lookup(table, jnp.asarray(c)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _close(got, want, 1e-6).all()
    np.testing.assert_array_equal(
        mie.phase_lookup(table, torch.from_numpy(c)).numpy(), got)


@pytest.mark.parametrize("fn", ["perlin3", "turbulence3"])
def test_noise_matches_jax(fn):
    from lucille_tpu.ops import noise as jnoise
    from lucille_tpu_torch.ops import noise

    rng = np.random.default_rng(4)
    p = rng.uniform(-300, 300, (512, 3)).astype(np.float32)
    p[:8] = np.floor(p[:8])  # lattice points: noise 0.5
    got = getattr(noise, fn)(torch.from_numpy(p)).numpy()
    want = np.asarray(getattr(jnoise, fn)(jnp.asarray(p)))
    assert got.shape == (512,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if fn == "perlin3":
        assert (0 <= got).all() and (got <= 1).all()
        np.testing.assert_allclose(got[:8], 0.5, atol=1e-6)
    grid = torch.from_numpy(p.reshape(8, 64, 3))
    np.testing.assert_array_equal(getattr(noise, fn)(grid).numpy(),
                                  got.reshape(8, 64))


# -- the atmosphere and imager stages --------------------------------------

ATMOSPHERES = {
    "fog": {"distance": [4.0], "background": [0.3, 0.4, 0.9]},
    "depthcue": {"mindistance": [3.0], "maxdistance": [12.0],
                 "color background": [0.5, 0.5, 0.5]},
    "MOSAICfog-0": {"isMist": [1.0], "Sta": [2.0], "Di": [15.0],
                    "MistCol": [0.8, 0.8, 0.9], "Misi": [0.1]},
    "MOSAICfog-1": {"isMist": [1.0], "Sta": [2.0], "Di": [15.0],
                    "MistType": [1.0], "Hi": [1.5], "MistCol": [1, 1, 1]},
    "MOSAICfog-2": {"isMist": [1.0], "Sta": [1.0], "Di": [9.0],
                    "MistType": [2.0], "MistCol": [0.2, 0.3, 0.4]},
    "MOSAICfog-off": {"Sta": [2.0], "Di": [15.0]},  # isMist 0: a no-op
    "miefog": {"density": [0.08], "albedo": [0.8], "sundir": [0.2, 1, 0.4],
               "suncolor": [1.0, 0.9, 0.7], "intensity": [2.0],
               "particlesize": [800.0]},
    "miefog-defaults": {},
}


def _wavefront(B=512, seed=3):
    rng = np.random.default_rng(seed)
    ci = rng.uniform(0, 2, (B, 3)).astype(np.float32)
    ray_len = rng.uniform(0, 20, B).astype(np.float32)
    P = rng.uniform(-3, 3, (B, 3)).astype(np.float32)
    hit = rng.uniform(size=B) < 0.7
    dirn = rng.normal(size=(B, 3)).astype(np.float32)
    return ci, ray_len, P, hit, dirn


@pytest.mark.parametrize("case", sorted(ATMOSPHERES))
def test_atmosphere_matches_jax(case):
    from lucille_tpu.shading.pipeline import apply_atmosphere as japply
    from lucille_tpu_torch.shading.pipeline import Atmosphere, apply_atmosphere

    name, params = case.split("-")[0], ATMOSPHERES[case]
    ci, ray_len, P, hit, dirn = _wavefront()
    args = [torch.from_numpy(a) for a in (ci, ray_len, P, hit, dirn)]
    got = apply_atmosphere(*args[:4], name, params, dirn=args[4]).numpy()
    want = np.asarray(japply(*(jnp.asarray(a) for a in (ci, ray_len, P, hit)),
                             name, params, dirn=jnp.asarray(dirn)))
    assert _close(got, want, 1e-5).all()
    np.testing.assert_array_equal(got[~hit], ci[~hit])  # escaped rays
    if case != "MOSAICfog-off":
        assert np.abs(want[hit] - ci[hit]).max() > 0.05
    # the Renderer's: the same answer
    atm = Atmosphere(name, params, None, "cpu")
    np.testing.assert_array_equal(atm(*args).numpy(), got)


def test_miefog_needs_the_eye_directions():
    """Without dirn lucille_tpu does not apply miefog (it looks for a
    miefog.sl instead, not found: ignored); nor does the port."""
    from lucille_tpu_torch.shading.pipeline import apply_atmosphere

    ci, ray_len, P, hit, _ = _wavefront(16)
    out = apply_atmosphere(torch.from_numpy(ci), torch.from_numpy(ray_len),
                           torch.from_numpy(P), torch.from_numpy(hit),
                           "miefog", {})
    np.testing.assert_array_equal(out.numpy(), ci)


def test_miefog_phase_table_is_built_once():
    """The Renderer's miefog holds its phase table and colours on the
    device from its construction: a call copies nothing from the host
    and builds no table."""
    from unittest import mock

    from lucille_tpu_torch.ops import mie
    from lucille_tpu_torch.shading.pipeline import Atmosphere

    atm = Atmosphere("miefog", ATMOSPHERES["miefog"], None, "cpu")
    assert atm.table.dtype == torch.float32 and atm.table.shape == (1024,)
    args = [torch.from_numpy(a) for a in _wavefront(64)]
    with mock.patch.object(mie, "phase_table", side_effect=AssertionError), \
            mock.patch("torch.tensor", side_effect=AssertionError):
        atm(*args)


@pytest.mark.parametrize("name", ["background", "MOSAICbackground"])
def test_imager_matches_jax(name):
    from lucille_tpu.shading.pipeline import apply_imager as japply
    from lucille_tpu_torch.shading.pipeline import apply_imager

    rng = np.random.default_rng(5)
    frame = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    alpha = rng.choice([0.0, 0.25, 1.0], (12, 16)).astype(np.float32)
    for params in ({}, {"color bgcolor": [0.1, 0.7, 0.2]}):
        got = apply_imager(frame, alpha, name, params)
        want = np.asarray(japply(frame, alpha, name, params))
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frame)


def test_unknown_stages_without_a_source_are_ignored(tmp_path):
    """A stage naming no built-in whose .sl is not on the search path
    warns once and is ignored, as in lucille_tpu: the imager leaves the
    frame, the atmosphere the radiance, the displacement the vertices."""
    from lucille_tpu_torch.shading.pipeline import (
        apply_atmosphere,
        apply_imager,
        displace_scene,
    )

    frame = np.ones((2, 3, 3), np.float32)
    sp = [str(tmp_path)]
    assert apply_imager(frame, np.zeros((2, 3), np.float32), "NoSuch", {},
                        sp) is frame
    ci, ray_len, P, hit, dirn = (torch.from_numpy(a) for a in _wavefront(8))
    assert apply_atmosphere(ci, ray_len, P, hit, "nosuchfog", {}, sp,
                            dirn) is ci
    desc = _quad_state("torch", tmp_path, 'Displacement "lift"\n').scene
    P0 = desc.geoms[0].positions.copy()
    compiled = {}
    displace_scene(desc, compiled)
    np.testing.assert_array_equal(desc.geoms[0].positions, P0)
    assert compiled == {("lift", "displacement"): None}  # looked up once


STAGE_SOURCES = {
    "Displacement": "displacement custom(float amp = 0.2) "
                    "{ P += amp * normalize(N); }\n",
    "Atmosphere": "volume custom() { Ci = Ci * 0.5 + (0, 0.25, 0); }\n",
    "Imager": "imager custom() { Ci = Ci + (1 - alpha) * (0.5, 0, 0); }\n",
}


@pytest.mark.parametrize("stage", ["Displacement", "Atmosphere", "Imager"])
def test_sl_stages_are_refused_naming_the_roadmap(stage, tmp_path):
    """A stage whose .sl is on the search path was refused until the RSL
    compiler was ported (ROADMAP Queue 1, item 6); now the Renderer
    compiles it once (its `shaders`) and applies it: the displacement
    lifts the quad, the atmosphere and the imager change the frame."""
    from lucille_tpu_torch.render.renderer import Renderer

    (tmp_path / "custom.sl").write_text(STAGE_SOURCES[stage])
    plain = Renderer(_quad_state("torch", tmp_path, "").scene,
                     tile_size=16, device="cpu").render_frame()
    desc = _quad_state("torch", tmp_path, f'{stage} "custom"\n').scene
    P0 = desc.geoms[0].positions.copy()
    r = Renderer(desc, tile_size=16, device="cpu")
    kind = {"Displacement": "displacement", "Atmosphere": "volume",
            "Imager": "imager"}[stage]
    img = r.render_frame()
    assert r.shaders[("custom", kind)].shader_kind == kind
    moved = np.abs(desc.geoms[0].positions - P0).max()
    assert moved == (pytest.approx(0.2) if stage == "Displacement" else 0)
    assert np.isfinite(img).all() and np.abs(img - plain).max() > 0.05


# -- the displacement stage ------------------------------------------------

def _quad_state(pkg, tmp_path, lines, n=8):
    """lucille_tpu's displacement test quad: an n x n grid in the xz
    plane with st, the search paths at tmp_path, `lines` bound before
    it, seen by a camera above it (a little off the grid's axis, so that
    no eye ray runs exactly along the quad's edges, where the two
    packages' f32 hits may flip)."""
    RiState, parse_rib = front_end(pkg)
    xs = np.linspace(-1, 1, n)
    P = [(x, 0.0, z) for z in xs for x in xs]
    st = [((x + 1) / 2, (z + 1) / 2) for z in xs for x in xs]
    quads = [(j * n + i, j * n + i + 1, j * n + i + n + 1, j * n + i + n)
             for j in range(n - 1) for i in range(n - 1)]
    fmt = lambda a: " ".join(f"{v:g}" for v in np.ravel(a))  # noqa: E731
    s = RiState()
    parse_rib(
        f'Option "searchpath" "shader" ["{tmp_path}"] '
        f'"texture" ["{tmp_path}"]\n'
        'Format 16 16 1\nPixelSamples 2 2\nProjection "perspective" '
        '"fov" [50]\nConcatTransform [1 0 0 0  0 0 -1 0  0 1 0 0  '
        '0.0137 0.0291 2.7 1]\n'
        "WorldBegin\n" + lines +
        f"PointsPolygons [{fmt([4] * len(quads))}] [{fmt(quads)}] "
        f'"P" [{fmt(P)}] "st" [{fmt(st)}]\nWorldEnd\n', s)
    s.options.gather_nsamples = 4
    s.options.accel_method = "pallas"  # lucille_tpu's Pallas dense tiles
    return s


def _dispmap(tmp_path):
    from lucille_tpu_torch.imageio.rgbe import write_hdr

    y, x = np.mgrid[0:16, 0:16] / 15.0
    img = (0.5 + 0.4 * np.sin(6 * x) * np.cos(5 * y))[..., None]
    write_hdr(tmp_path / "bumps.hdr", np.repeat(img, 3, -1).astype(
        np.float32))


DISPLACE = ('Displacement "MOSAICdisplace" "DispMap" ["bumps.hdr"] '
            '"Disp" [0.6] "Mid" [0.5]\n')


def test_displace_scene_matches_jax(tmp_path):
    """MOSAICdisplace: positions and rebuilt normals equal lucille_tpu's;
    a second call leaves them (idempotent); an empty DispMap or one not
    found is a no-op."""
    from lucille_tpu.shading.pipeline import displace_scene as jdisplace
    from lucille_tpu_torch.shading.pipeline import displace_scene

    _dispmap(tmp_path)
    got = _quad_state("torch", tmp_path, DISPLACE).scene
    want = _quad_state("jax", tmp_path, DISPLACE).scene
    P0 = got.geoms[0].positions.copy()
    displace_scene(got)
    jdisplace(want)
    g, w = got.geoms[0], want.geoms[0]
    np.testing.assert_array_equal(g.positions, w.positions)
    np.testing.assert_array_equal(g.normals, w.normals)
    assert np.abs(g.positions - P0).max() > 0.1
    assert (np.abs(g.normals[:, 0]) + np.abs(g.normals[:, 2])).max() > 0.05
    P1 = g.positions.copy()
    displace_scene(got)
    np.testing.assert_array_equal(g.positions, P1)
    for lines in ('Displacement "MOSAICdisplace"\n',
                  'Displacement "MOSAICdisplace" "DispMap" ["nope.hdr"]\n'):
        desc = _quad_state("torch", tmp_path, lines).scene
        displace_scene(desc)
        np.testing.assert_array_equal(desc.geoms[0].positions, P0)


# -- frames against lucille_tpu's Renderer ---------------------------------

def _frame_pair(make_state, tile=16):
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    jr = JaxRenderer(make_state("jax").scene, tile_size=tile)
    ref = jr.render_frame()
    r = Renderer(make_state("torch").scene, tile_size=tile, device="cpu",
                 sampler=JaxSampler())
    got = r.render_frame()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert r.stats.nrays == jr.stats.nrays
    assert _close(got.reshape(-1, 3), ref.reshape(-1, 3), 1e-4).mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * max(ref.mean(), 1.0)
    return r, got, ref


def _bundled(pkg, lines, head="", size=(32, 24)):
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    text = bundled_rib_text().replace("WorldBegin\n",
                                      head + "WorldBegin\n" + lines, 1)
    parse_rib(text, s)
    s.Format(*size)
    s.PixelSamples(2, 2)
    s.options.gather_nsamples = 16
    s.options.accel_method = "pallas"  # lucille_tpu's Pallas dense tiles
    return s


@pytest.mark.parametrize("atm", ["fog", "miefog"])
def test_fog_and_imager_frame_matches_jax(atm):
    """The bundled scene's AO frame under an atmosphere and the
    background imager: the fog on the hit pixels, the imager's colour on
    the escaped ones (alpha from the subsamples' coverage)."""
    line = ('Atmosphere "fog" "distance" [12.0] "background" [0.2 0.3 0.6]\n'
            if atm == "fog" else 'Atmosphere "miefog" "density" [0.05]\n')
    head = 'Imager "background" "bgcolor" [0.9 0.6 0.1]\n'
    r, got, ref = _frame_pair(lambda pkg: _bundled(pkg, line, head))
    assert r.atmosphere is not None and r.atmosphere.name == atm
    plain = _frame_pair(lambda pkg: _bundled(pkg, ""))[1]
    lum = plain.sum(-1)
    miss = lum == 0  # escaped in every subsample: the imager's colour
    assert miss.any() and (~miss).any()
    np.testing.assert_allclose(got[miss], np.broadcast_to(
        [0.9, 0.6, 0.1], got[miss].shape), rtol=1e-6)
    assert np.abs(got[~miss] - plain[~miss]).max() > 0.01  # fogged


def test_displaced_frame_matches_jax(tmp_path):
    """MOSAICdisplace before the compile: the displaced quad's AO frame."""
    _dispmap(tmp_path)
    r, got, ref = _frame_pair(lambda pkg: _quad_state(pkg, tmp_path,
                                                      DISPLACE))
    assert r.desc.geoms[0]._displaced
    flat = _frame_pair(lambda pkg: _quad_state(pkg, tmp_path, ""))[1]
    assert np.abs(got - flat).max() > 0.05


def test_imager_frame_written_by_the_cli(tmp_path):
    """The CLI writes the imager's frame to its display: the escaped
    pixels carry the background colour in the file (the post-pass frame
    is written again after the last tile, as lucille_tpu's CLI does)."""
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.imageio.loader import load_image

    rib = tmp_path / "s.rib"
    rib.write_text(bundled_rib_text().replace(
        "WorldBegin", 'Imager "MOSAICbackground" "bgcolor" [0 1 0]\n'
        "WorldBegin", 1))
    assert main([str(rib), "-o", str(tmp_path / "x.pfm"), "--device", "cpu",
                 "--width", "16", "--height", "12", "--pixelsamples", "1",
                 "--gather-rays", "4", "--tile", "16"]) == 0
    img = load_image(tmp_path / "x.pfm")
    green = (img == np.float32([0, 1, 0])).all(-1)
    assert 0.05 < green.mean() < 0.95


# -- .sl stages against lucille_tpu's pipeline -----------------------------
# (each source declares a name used nowhere else: lucille_tpu caches its
# compiled stages process-wide by (name, kind))

SL_VOLUME = ("volume {name}(float d = 6; color bg = (0.2, 0.3, 0.5)) {{\n"
             "  float f = 1 - exp(-length(I) / d);\n"
             "  Ci = mix(Ci, bg, f) + 0.01 * ycomp(P);\n"
             "  if (zcomp(I) > 15) Ci = Ci * 0.5;\n"
             "}}\n")
# lucille_tpu compiles an atmosphere's .sl inside its jitted tile kernel,
# where evaluating a parameter's default fails (np.asarray of a tracer)
# and the stage is dropped with a warning (ROADMAP Queue 3, faults of the
# reference); its frames are held against a shader without parameters
SL_VOLUME_FRAME = ("volume {name}() {{\n"
                   "  float f = 1 - exp(-length(I) / 20);\n"
                   "  Ci = mix(Ci, (0.2, 0.3, 0.5), f) + 0.01 * ycomp(P);\n"
                   "}}\n")
SL_IMAGER = ("imager {name}(color bg = (0.1, 0.2, 0.3)) {{\n"
             "  Ci = Ci + (1 - alpha) * bg + 0.05 * s - 0.02 * t;\n"
             "}}\n")
SL_LIFT = ("displacement {name}(float amp = 0.25;) {{\n"
           "  P += amp * normalize(N) * (1 + 0.5 * noise(P * 3));\n"
           "  N = calculatenormal(P);\n"
           "}}\n")


def test_sl_atmosphere_matches_jax(tmp_path):
    """An .sl volume shader reading I (along z, the ray's length) and P,
    with a varying if: Ci within 1e-5 of max(|value|, 1), escaped rays
    unchanged; bound once in the Renderer's Atmosphere, the same."""
    from lucille_tpu.shading.pipeline import apply_atmosphere as japply
    from lucille_tpu_torch.shading.pipeline import Atmosphere, apply_atmosphere

    (tmp_path / "ppslfog.sl").write_text(SL_VOLUME.format(name="ppslfog"))
    sp = [str(tmp_path)]
    ci, ray_len, P, hit, dirn = _wavefront()
    args = [torch.from_numpy(a) for a in (ci, ray_len, P, hit, dirn)]
    for params in ({}, {"d": [3.0], "bg": [0.9, 0.1, 0.1]}):
        got = apply_atmosphere(*args[:4], "ppslfog", params, sp,
                               args[4]).numpy()
        want = np.asarray(japply(
            *(jnp.asarray(a) for a in (ci, ray_len, P, hit)), "ppslfog",
            params, sp, dirn=jnp.asarray(dirn)))
        assert _close(got, want, 1e-5).all()
        np.testing.assert_array_equal(got[~hit], ci[~hit])
        assert np.abs(want[hit] - ci[hit]).max() > 0.05
        compiled = {}
        atm = Atmosphere("ppslfog", params, sp, "cpu", compiled)
        assert compiled[("ppslfog", "volume")] is atm.fn
        np.testing.assert_array_equal(atm(*args).numpy(), got)


def test_sl_imager_matches_jax(tmp_path):
    from lucille_tpu.shading.pipeline import apply_imager as japply
    from lucille_tpu_torch.shading.pipeline import apply_imager

    (tmp_path / "ppslimg.sl").write_text(SL_IMAGER.format(name="ppslimg"))
    rng = np.random.default_rng(6)
    frame = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    alpha = rng.choice([0.0, 0.25, 1.0], (12, 16)).astype(np.float32)
    for params in ({}, {"bg": [0.5, 0.0, 0.25]}):
        got = apply_imager(frame, alpha, "ppslimg", params, [str(tmp_path)])
        want = np.asarray(japply(frame, alpha, "ppslimg", params,
                                 [str(tmp_path)]))
        assert got.shape == frame.shape and got.dtype == np.float32
        assert _close(got.reshape(-1, 3), want.reshape(-1, 3), 1e-6).all()
        assert np.abs(got - frame).max() > 0.1


def test_sl_displacement_matches_jax(tmp_path):
    """tests/test_pipeline.py's lift.sl (with noise): positions and the
    rebuilt normals equal lucille_tpu's within f32 rounding (the shader
    runs in f32 on both sides); idempotent."""
    from lucille_tpu.shading.pipeline import displace_scene as jdisplace
    from lucille_tpu_torch.shading.pipeline import displace_scene

    (tmp_path / "ppsllift.sl").write_text(SL_LIFT.format(name="ppsllift"))
    line = 'Displacement "ppsllift" "amp" [0.3]\n'
    got = _quad_state("torch", tmp_path, line).scene
    want = _quad_state("jax", tmp_path, line).scene
    P0 = got.geoms[0].positions.copy()
    compiled = {}
    displace_scene(got, compiled)
    jdisplace(want)
    g, w = got.geoms[0], want.geoms[0]
    assert g.positions.dtype == np.float64
    np.testing.assert_allclose(g.positions, w.positions, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.normals, w.normals, rtol=0, atol=1e-5)
    lift = np.abs(g.positions - P0).max(axis=1)
    assert lift.min() > 0.1 and lift.max() - lift.min() > 0.05
    P1 = g.positions.copy()
    displace_scene(got, compiled)
    np.testing.assert_array_equal(g.positions, P1)


def test_sl_stage_of_another_kind_or_malformed(tmp_path):
    """A stage whose source declares another kind is used anyway (with a
    warning), as in lucille_tpu; one that does not compile is ignored,
    and the cache remembers both answers."""
    from lucille_tpu.shading.pipeline import apply_imager as japply
    from lucille_tpu_torch.shading.pipeline import apply_imager
    from lucille_tpu_torch.shading.sl import find_sl

    (tmp_path / "ppslsurf.sl").write_text(
        "surface ppslsurf() { Ci = Ci * 2; }")
    (tmp_path / "ppslbad.sl").write_text("imager ppslbad( { Ci = ; }")
    sp = [str(tmp_path)]
    compiled = {}
    assert find_sl("ppslsurf", "imager", sp, compiled).shader_kind \
        == "surface"
    assert find_sl("ppslbad", "imager", sp, compiled) is None
    assert set(compiled) == {("ppslsurf", "imager"), ("ppslbad", "imager")}
    frame = np.full((4, 6, 3), 0.25, np.float32)
    alpha = np.ones((4, 6), np.float32)
    for name in ("ppslsurf", "ppslbad"):
        got = apply_imager(frame, alpha, name, {}, sp)
        want = np.asarray(japply(frame, alpha, name, {}, sp))
        np.testing.assert_array_equal(got, want)
    assert apply_imager(frame, alpha, "ppslbad", {}, sp) is frame


@pytest.mark.parametrize("stage", ["atmosphere-imager", "displacement"])
def test_sl_stage_frames_match_jax(stage, tmp_path):
    """The bundled scene's AO frame under an .sl atmosphere and an .sl
    imager, and the test quad under an .sl displacement, against
    lucille_tpu's Renderer (the module's frame bounds)."""
    if stage == "displacement":
        (tmp_path / "ppslliftf.sl").write_text(
            SL_LIFT.format(name="ppslliftf"))

        def make(pkg):
            return _quad_state(pkg, tmp_path,
                               'Displacement "ppslliftf" "amp" [0.2]\n')
        r, got, ref = _frame_pair(make)
        assert r.desc.geoms[0]._displaced
        flat = _frame_pair(lambda pkg: _quad_state(pkg, tmp_path, ""))[1]
        assert np.abs(got - flat).max() > 0.05
        return
    (tmp_path / "ppslfogf.sl").write_text(
        SL_VOLUME_FRAME.format(name="ppslfogf"))
    (tmp_path / "ppslimgf.sl").write_text(SL_IMAGER.format(name="ppslimgf"))
    sp = f'Option "searchpath" "shader" ["{tmp_path}"]\n'
    r, got, ref = _frame_pair(lambda pkg: _bundled(
        pkg, 'Atmosphere "ppslfogf"\n',
        sp + 'Imager "ppslimgf"\n'))
    assert r.atmosphere.fn is r.shaders[("ppslfogf", "volume")]
    assert r.shaders[("ppslimgf", "imager")].shader_kind == "imager"
    plain = _frame_pair(lambda pkg: _bundled(pkg, ""))[1]
    assert np.abs(got - plain).max() > 0.05
