"""Material textures: the .tex and .exr codecs, the texture atlas and its
fetches, the compiled texture ids, a textured frame and the OpenEXR
display driver, each against lucille_tpu's.

Tolerances: the codecs are the same NumPy code, so files are equal byte
for byte; fetches within 1e-6 (the same f32 bilinear weights, which
XLA:CPU may contract into FMAs).  The textured frame is lucille_tpu's
texcoord regression scene (tests/test_texture.py:88-115) at 48x48 in one
tile of 48, both packages on the dense tiles with the same AO jitter
(`JaxSampler`): test_torch_render.py's bundled bounds, mean |diff| <=
1e-3 and at most 0.1% of the pixels off by more than 0.07.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_render import JaxSampler
from test_torch_scene import front_end
from test_torch_scene import one_torch_thread  # noqa: F401


def _checker(n=32, cell=4):
    """lucille_tpu's tests/test_texture.py checker: cell x cell squares of
    1 and 0."""
    y, x = np.mgrid[0:n, 0:n]
    on = ((x // cell + y // cell) % 2) == 0
    return np.repeat(on[..., None], 3, axis=-1).astype(np.float32)


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 4, (h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("fmt", ["tex", "exr-half-none", "exr-float-zip",
                                 "exr-half-zips", "exr-float-rle"])
def test_codecs_match_jax(fmt, tmp_path):
    """The same image written by both packages gives the same bytes, and
    each package reads the other's file to the same pixels."""
    from lucille_tpu.imageio import exr as jexr, tex as jtex
    from lucille_tpu_torch.imageio import exr, tex

    img = _image(70, 131, seed=2)  # not a multiple of a block or a mip
    a, b = tmp_path / f"port.{fmt[:3]}", tmp_path / f"jax.{fmt[:3]}"
    if fmt == "tex":
        tex.write_tex(a, img)
        jtex.write_tex(b, img)
        read, jread = tex.read_tex, jtex.read_tex
    else:
        _ext, ptype, comp = fmt.split("-")
        exr.write_exr(a, img, ptype, comp)
        jexr.write_exr(b, img, ptype, comp)
        read, jread = exr.read_exr, jexr.read_exr
    if fmt == "tex":  # gzip stamps the file name and time in its header
        import gzip

        assert gzip.decompress(a.read_bytes()) == gzip.decompress(
            b.read_bytes())
    else:
        assert a.read_bytes() == b.read_bytes()
    got, ref = read(b), jread(a)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (70, 131, 3)
    tol = 4e-3 if "half" in fmt else 0.0  # binary16 keeps 11 bits
    np.testing.assert_allclose(got, img, rtol=tol, atol=0)
    if fmt == "tex":
        np.testing.assert_array_equal(read(b, level=1), jread(a, level=1))


def test_loader_dispatches_to_the_codecs(tmp_path):
    """imageio.loader's load_image / save_image reach both codecs (the
    port's loader refused .tex and .exr before it had them)."""
    from lucille_tpu.imageio.loader import load_image as jload
    from lucille_tpu_torch.imageio.loader import load_image, save_image

    img = _image(9, 12, seed=3)
    for ext in ("tex", "exr"):
        path = tmp_path / f"x.{ext}"
        save_image(path, img)
        np.testing.assert_array_equal(load_image(path), jload(path))


def _atlases():
    from lucille_tpu.texture.texture import TextureAtlas as JaxAtlas
    from lucille_tpu_torch.texture.texture import TextureAtlas

    images = {"checker.hdr": _checker(16, 4), "noise.tex": _image(7, 11, 5),
              "wide.exr": _image(3, 20, 6)}
    return TextureAtlas.build(images, "cpu"), JaxAtlas.build(images)


def test_atlas_build_matches_jax():
    atlas, ref = _atlases()
    assert atlas.names == ref.names
    np.testing.assert_array_equal(atlas.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(atlas.sizes.numpy(), np.asarray(ref.sizes))
    assert atlas.data.dtype == torch.float32
    assert atlas.sizes.dtype == torch.int32
    assert atlas.id_of("wide.exr") == ref.id_of("wide.exr") == 2
    assert atlas.id_of("missing") == -1


@pytest.mark.parametrize("where", ["corners", "midpoints", "clamped",
                                   "random", "per_lane_ids"])
def test_fetch_matches_jax(where):
    atlas, ref = _atlases()
    rng = np.random.default_rng(9)
    if where == "corners":
        s = np.array([0, 1, 0, 1], np.float32)
        t = np.array([0, 0, 1, 1], np.float32)
    elif where == "midpoints":  # half a texel: the bilinear average
        s = np.array([0.5 / 15, 7.5 / 15, 14.5 / 15], np.float32)
        t = np.array([0.5 / 15, 3.5 / 15, 0.5 / 15], np.float32)
    elif where == "clamped":
        s = np.array([-3.0, 2.0, 0.5, 1.5], np.float32)
        t = np.array([0.5, -1.0, 7.0, 1.5], np.float32)
    else:
        s = rng.uniform(-0.2, 1.2, 500).astype(np.float32)
        t = rng.uniform(-0.2, 1.2, 500).astype(np.float32)
    ids = ([0] if where != "per_lane_ids"
           else [rng.integers(0, 3, s.shape).astype(np.int32)])
    for tid in ids + [1, 2]:
        jt = jnp.asarray(tid) if isinstance(tid, np.ndarray) else tid
        pt = torch.from_numpy(tid) if isinstance(tid, np.ndarray) else tid
        want = np.asarray(ref.fetch(jt, jnp.asarray(s), jnp.asarray(t)))
        got = atlas.fetch(pt, torch.from_numpy(s), torch.from_numpy(t))
        assert got.shape == (len(s), 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if where == "midpoints":  # the mean of the four texels around each
        got = atlas.fetch(0, torch.from_numpy(s), torch.from_numpy(t))
        np.testing.assert_allclose(got[:, 0].numpy(), [1.0, 0.5, 0.0],
                                   atol=1e-6)


@pytest.mark.parametrize("proj", ["latlong", "angular"])
def test_ibl_fetch_matches_jax(proj):
    from lucille_tpu.texture import texture as jtexture
    from lucille_tpu_torch.texture import texture

    atlas, ref = _atlases()
    rng = np.random.default_rng(4)
    d = rng.normal(size=(400, 3))
    d = np.concatenate([d, [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    name = f"ibl_fetch_{proj}"
    want = np.asarray(getattr(jtexture, name)(ref, 1, jnp.asarray(d)))
    got = getattr(texture, name)(atlas, 1, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _textured_state(pkg, tmp_path, tex="checker.hdr", size=48):
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib(
        'Projection "perspective" "fov" [45]\n'
        f'Option "searchpath" "texture" ["{tmp_path}"]\n'
        "WorldBegin\n"
        "AttributeBegin\n"
        f'Surface "matte" "texturename" ["{tex}"]\n'
        'Polygon "P" [ 1 1 3  1 -1 3  -1 -1 3  -1 1 3 ]\n'
        '  "facevertex float s" [0 0 1 1] "facevertex float t" [0 1 1 0]\n'
        "AttributeEnd\n"
        'Polygon "P" [ 3 1 4  3 -1 4  1 -1 4  1 1 4 ]\n'
        "WorldEnd\n", s)
    s.Format(size, size)
    s.options.gather_nsamples = 4
    s.options.accel_method = "pallas"
    return s


def test_compiled_texture_ids_match_jax(tmp_path):
    """The textured quad's material gets the atlas id, the plain one -1, as
    lucille_tpu compiles them."""
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.imageio.loader import save_image
    from lucille_tpu_torch.render.renderer import Renderer

    save_image(tmp_path / "checker.hdr", _checker(64, 8))
    jr = JaxRenderer(_textured_state("jax", tmp_path).scene, tile_size=48)
    r = Renderer(_textured_state("torch", tmp_path).scene, tile_size=48,
                 device="cpu")
    np.testing.assert_array_equal(r.scene.mat_texture.numpy(),
                                  np.asarray(jr.scene.mat_texture))
    assert r.scene.mat_texture.tolist() == [0, -1]
    assert r.textures.names == jr.textures.names == {"checker.hdr": 0}
    # a texture that is not on the search path is ignored: id -1
    r = Renderer(_textured_state("torch", tmp_path, "gone.tex").scene,
                 tile_size=48, device="cpu")
    assert r.textures.data is None
    assert r.scene.mat_texture.tolist() == [-1, -1]


@pytest.mark.parametrize("ext", ["hdr", "tex", "exr"])
def test_textured_frame_matches_jax(ext, tmp_path):
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.imageio.loader import save_image
    from lucille_tpu_torch.render.renderer import Renderer

    name = f"checker.{ext}"
    save_image(tmp_path / name, _checker(64, 8))
    jr = JaxRenderer(_textured_state("jax", tmp_path, name).scene,
                     tile_size=48)
    ref = jr.render_frame()
    r = Renderer(_textured_state("torch", tmp_path, name).scene,
                 tile_size=48, device="cpu", sampler=JaxSampler())
    got = r.render_frame()
    assert got.shape == ref.shape and np.isfinite(got).all()
    lum = got.mean(-1)
    assert (lum > 0.5).mean() > 0.1  # bright squares
    assert ((lum < 0.2) & (lum >= 0.0)).mean() > 0.1  # dark squares
    diff = np.abs(got - ref)
    assert diff.mean() <= 1e-3
    assert (diff.max(axis=-1) > 0.07).mean() <= 1e-3


def test_openexr_driver_writes_an_exr(tmp_path):
    from lucille_tpu.imageio.exr import read_exr
    from lucille_tpu_torch.display.drivers import get_display_driver

    for name in ("openexr", "exr"):
        drv = get_display_driver(name)
        assert type(drv).__name__ == "OpenEXRDriver"
        drv.open(str(tmp_path / f"{name}.hdr"), 4, 2)  # extension forced
        tile = np.arange(24, dtype=np.float32).reshape(2, 4, 3) / 24
        drv.write(0, 0, tile)
        drv.close()
        img = read_exr(tmp_path / f"{name}.exr")
        assert img.shape == (2, 4, 3)
        np.testing.assert_allclose(img, tile[::-1], atol=1e-3)  # rows flip
