"""Environment maps (lights/envmap.py, lights/ibl.py's table,
lights/sisgen.py, lights/tables._load_env) against lucille_tpu's on the
same NumPy-seeded maps and directions.

Tolerances:

- `fetch`: within 1e-5 of max(|value|, 1) on all but 1% of the lanes.
  torch's f32 arccos and arctan2 may differ from XLA's by an ulp, which
  can move a direction on the lat-long seam (phi = +-pi) or the angular
  map's rim one texel over; the cases put 16 of their 512 directions on
  the seam and 4 on the poles and axes;
- `angular_to_latlong`, the importance table (f32 casts of the same f64
  build), `generate_sis_samples` (the same NumPy code and seed) and
  `load_sis` (both formats): exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_scene import one_torch_thread  # noqa: F401


def _map(h, w, seed=0):
    """A (h, w, 3) f32 map: random sky texels with one texel ~1000x
    brighter (a sun), the dynamic range of a real probe."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.05, 2.0, (h, w, 3)).astype(np.float32)
    img[h // 4, w // 3] = (900.0, 850.0, 700.0)
    return img


def _dirs(n=512, seed=1):
    """n unit directions: random, 16 on the lat-long seam (x < 0, z = 0
    or +-1e-7), and +-y, +-z."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v[:16] = np.stack([-np.ones(16), rng.uniform(-0.9, 0.9, 16),
                       rng.choice([-1e-7, 0.0, 1e-7], 16)], axis=-1)
    v[16:20] = [[0, 1, 0], [0, -1, 0], [0, 0, -1], [0, 0, 1]]
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape,mapping,want", [
    ((32, 64), None, "latlong"),        # 2:1: lat-long by its aspect
    ((48, 48), None, "angular"),        # square: a Debevec angular map
    ((40, 60), None, "angular"),        # narrower than 2:1
    ((48, 48), "latlong", "latlong"),   # the "mapping" token wins
    ((32, 64), "angular", "angular"),
])
def test_fetch_matches_jax(shape, mapping, want):
    from lucille_tpu.lights.envmap import EnvMap as JaxEnvMap
    from lucille_tpu_torch.lights.envmap import EnvMap

    img = _map(*shape)
    env, ref = EnvMap(img, mapping), JaxEnvMap(img, mapping)
    assert env.mapping == ref.mapping == want
    assert env.texels.dtype == torch.float32 and env.texels.device.type == "cpu"
    d = _dirs()
    got = env.fetch(torch.from_numpy(d)).numpy()
    exp = np.asarray(ref.fetch(jnp.asarray(d)))
    assert got.shape == (512, 3) and np.isfinite(got).all()
    err = np.abs(got - exp).max(-1) / np.maximum(np.abs(exp).max(-1), 1.0)
    assert (err <= 1e-5).mean() >= 0.99, err.max()
    assert exp.max() > 2.0 or want == "angular"  # texels, not a constant


def test_angular_to_latlong_matches_jax():
    from lucille_tpu.lights.envmap import angular_to_latlong as jax_a2l
    from lucille_tpu_torch.lights.envmap import EnvMap, angular_to_latlong

    img = _map(48, 48)
    got = angular_to_latlong(img)
    np.testing.assert_array_equal(got, jax_a2l(img))
    assert got.shape == (24, 48, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(angular_to_latlong(img, 8, 20),
                                  jax_a2l(img, 8, 20))
    np.testing.assert_array_equal(EnvMap(img).latlong_image(), got)


@pytest.mark.parametrize("shape", [(32, 64), (48, 48)])
def test_importance_table_matches_jax(shape):
    """The table of a lat-long map, and of an angular map through its
    lat-long resampling: every array equal to lucille_tpu's as f32."""
    from lucille_tpu.lights.envmap import EnvMap as JaxEnvMap
    from lucille_tpu_torch.lights.envmap import EnvMap

    img = _map(*shape)
    got = EnvMap(img).prepare("importance").importance_table
    want = JaxEnvMap(img).importance_table
    assert (got.h, got.w, got.total) == (want.h, want.w, want.total)
    for k in ("cdf", "dirs", "radiance", "solid", "pdf"):
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.dtype == torch.float32 and w.dtype == np.float32, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    assert float(got.cdf[-1]) == 1.0


def test_generate_sis_samples_matches_tools():
    """lights/sisgen.py is tools_tpu/sisgen.py's generator: the same
    samples, bit for bit, for several sizes, seeds and layer counts."""
    from lucille_tpu_torch.lights.sisgen import generate_sis_samples
    from tools_tpu.sisgen import generate_sis_samples as tools_sis

    for (h, w), kw in (((16, 32), {}), ((24, 48), {"nsamples": 16}),
                       ((16, 32), {"seed": 3, "nlayers": 3})):
        img = _map(h, w, seed=h)
        got, want = generate_sis_samples(img, **kw), tools_sis(img, **kw)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype == np.float32
            np.testing.assert_array_equal(g, x)
        assert len(got[0]) >= 4
    zero = generate_sis_samples(np.zeros((4, 8, 3), np.float32))
    assert zero[0].shape == (0, 3)


def _sis_files(tmp_path):
    rng = np.random.default_rng(7)
    npz = tmp_path / "sis.npz"
    dirs = rng.normal(size=(5, 3)).astype(np.float32)
    np.savez(npz, dirs=dirs, rgb=rng.uniform(0, 3, (5, 3)).astype(np.float32))
    dat = tmp_path / "gensamples.dat"
    rows = [f"{x} {y} {r:.4f} {g:.4f} {b:.4f}" for x, y, r, g, b in zip(
        rng.integers(0, 64, 6), rng.integers(0, 64, 6),
        *rng.uniform(0, 2, (3, 6)))]
    dat.write_text("6\n64 64\n" + "\n".join(rows) + "\n")
    return npz, dat


@pytest.mark.parametrize("fmt", ["npz", "dat"])
def test_load_sis_matches_jax(fmt, tmp_path):
    """Both sisfile formats: the repo's .npz and the reference sisgen's
    gensamples.dat text (tools/sis/sis.c:96-101)."""
    from lucille_tpu.lights.envmap import EnvMap as JaxEnvMap
    from lucille_tpu_torch.lights.envmap import EnvMap

    path = _sis_files(tmp_path)[fmt == "dat"]
    img = _map(16, 32)
    env, ref = EnvMap(img), JaxEnvMap(img)
    env.load_sis(path)
    ref.load_sis(path)
    for g, w in zip(env.file_sis, ref.file_sis):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert len(env.file_sis[0]) == (5 if fmt == "npz" else 6)
    env.prepare("structured")  # the bound file wins over generated ones
    for t, a in zip(env.structured, env.file_sis):
        np.testing.assert_array_equal(t.numpy(), a)


def test_load_sis_rejects_an_npz_without_its_arrays(tmp_path):
    from lucille_tpu_torch.lights.envmap import EnvMap

    np.savez(tmp_path / "bad.npz", directions=np.zeros((2, 3)))
    with pytest.raises(ValueError, match="'dirs'"):
        EnvMap(_map(4, 8)).load_sis(tmp_path / "bad.npz")


def _ibl_desc(pkg, tmp_path, sampler, texture="env.hdr", sisfile=None,
              kind="ibl"):
    from test_torch_scene import front_end

    RiState, parse_rib = front_end(pkg)
    s = RiState()
    sis = f' "sisfile" ["{sisfile}"]' if sisfile else ""
    parse_rib(
        f'Option "searchpath" "texture" ["{tmp_path}"]\nWorldBegin\n'
        f'LightSource "{kind}" 1 "texture" ["{texture}"] '
        f'"sampling" ["{sampler}"]{sis}\n'
        'Polygon "P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]\nWorldEnd\n', s)
    return s.scene


@pytest.mark.parametrize("sampler", ["cosweight", "importance", "stratified",
                                     "structured", "bruteforce"])
def test_light_tables_build_the_samplers_tables_once(sampler, tmp_path):
    """_load_env finds the map through the search path, puts it on the
    device, and builds what the light's sampler reads there, and nothing
    else: the luminance table for importance and bruteforce, the 64 SIS
    samples (lucille_tpu's for the same map) for structured."""
    from lucille_tpu.imageio.rgbe import write_hdr
    from lucille_tpu.lights.tables import build_light_tables as jax_tables
    from lucille_tpu_torch.lights.tables import build_light_tables

    write_hdr(tmp_path / "env.hdr", _map(8, 16))
    light = build_light_tables(_ibl_desc("torch", tmp_path, sampler),
                               device="cpu").lights[0]
    ref = jax_tables(_ibl_desc("jax", tmp_path, sampler)).lights[0]
    env = light.env
    assert light.ibl_sampler == ref.ibl_sampler == sampler
    np.testing.assert_array_equal(env.image, ref.env.image)
    assert env.mapping == ref.env.mapping == "latlong"
    table = sampler in ("importance", "bruteforce")
    assert (env.importance_table is not None) == table
    assert (env.structured is not None) == (sampler == "structured")
    if table:
        np.testing.assert_array_equal(env.importance_table.cdf.numpy(),
                                      np.asarray(ref.env.importance_table.cdf))
    if sampler == "structured":
        dirs, rgb = ref.env.sis_samples(64)
        np.testing.assert_array_equal(env.structured[0].numpy(), dirs)
        np.testing.assert_array_equal(env.structured[1].numpy(), rgb)


def test_light_tables_bind_the_sisfile(tmp_path):
    from lucille_tpu.imageio.rgbe import write_hdr
    from lucille_tpu_torch.lights.tables import build_light_tables

    write_hdr(tmp_path / "env.hdr", _map(8, 16))
    npz, _dat = _sis_files(tmp_path)
    env = build_light_tables(_ibl_desc("torch", tmp_path, "structured",
                                       sisfile=npz.name),
                             device="cpu").lights[0].env
    np.testing.assert_array_equal(env.structured[0].numpy(),
                                  np.load(npz)["dirs"])
    # a sisfile not found: SIS samples generated from the map instead
    env = build_light_tables(_ibl_desc("torch", tmp_path, "structured",
                                       sisfile="nope.npz"),
                             device="cpu").lights[0].env
    assert env.file_sis is None and len(env.structured[0]) > 0


@pytest.mark.parametrize("what", ["missing", "unreadable"])
def test_light_keeps_its_flat_colour_without_a_map(what, tmp_path):
    """A map not found on the search path, or one that cannot be read, is
    logged and the light falls back to its flat colour, as in
    lucille_tpu."""
    from lucille_tpu.lights.tables import build_light_tables as jax_tables
    from lucille_tpu_torch.lights.tables import build_light_tables

    if what == "unreadable":
        (tmp_path / "env.hdr").write_bytes(b"not an image")
    for kind in ("ibl", "dome"):
        light = build_light_tables(_ibl_desc("torch", tmp_path, "importance",
                                             kind=kind), device="cpu").lights[0]
        ref = jax_tables(_ibl_desc("jax", tmp_path, "importance",
                                   kind=kind)).lights[0]
        assert light.type == kind and light.env is None and ref.env is None
