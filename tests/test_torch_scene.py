"""The port's scene compile and host layers against lucille_tpu.

Also home of the scene helpers the other test_torch_* files import: the
bundled scene (tests/golden/sunsky_scene.rib, the reference's
ambient_occlusion.rib, 322 triangles; without its sunsky light unless
asked) and bench_large's procedural heightfield, each parsed by the
port's own front end (pkg="torch") or by lucille_tpu's (pkg="jax"): the
JAX package's functions get lucille_tpu's scene description, the port's
get its own.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BUNDLED_RIB = REPO / "tests" / "golden" / "sunsky_scene.rib"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread for the module (every test_torch_* module
    imports this fixture).  The plain twins run many small ops; with an
    intra-op thread pool in each of the suite's parallel workers the
    cores are oversubscribed and those ops slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh_loaders(monkeypatch):
    """Both packages' native loaders with nothing loaded or tried yet,
    restored after the test."""
    import lucille_tpu.native.loader as jax_loader
    import lucille_tpu_torch.native.loader as port_loader

    for mod in (jax_loader, port_loader):
        monkeypatch.setattr(mod, "_libs", {})
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_tried", False)
    return jax_loader, port_loader


@pytest.fixture(autouse=True)
def native_builders(monkeypatch, tmp_path_factory):
    """Both packages build their BVHs with the C++ builder, or, where g++
    is absent, both with NumPy (the two give different triangle orders).
    lucille_tpu compiles its library straight into its cache directory,
    so a parallel worker can find it half written and fall back to NumPy
    for good; here each worker compiles into a directory of its own.
    Autouse in every test_torch_* module that builds a tile BVH through
    both packages (each imports this fixture)."""
    monkeypatch.setenv("LUCILLE_NATIVE_CACHE",
                       str(tmp_path_factory.getbasetemp() / "native"))
    loaders = _fresh_loaders(monkeypatch)
    have_gxx = shutil.which("g++") is not None
    assert [m.get_bvh_lib() is not None for m in loaders] == [have_gxx] * 2


@pytest.fixture
def numpy_builders(native_builders, monkeypatch):
    """Both packages build their BVHs with NumPy: neither has a library."""
    loaders = _fresh_loaders(monkeypatch)
    for mod in loaders:
        monkeypatch.setattr(mod, "_lib_tried", True)
    assert all(m.get_bvh_lib() is None for m in loaders)


def bundled_rib_text(sunsky: bool = False) -> str:
    text = BUNDLED_RIB.read_text()
    if sunsky:
        return text
    return "".join(l for l in text.splitlines(keepends=True)
                   if 'AreaLightSource "sunsky"' not in l)


def front_end(pkg: str):
    """(RiState, parse_rib) of the port ("torch") or of lucille_tpu
    ("jax")."""
    if pkg == "jax":
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.rib.parser import parse_rib
    else:
        assert pkg == "torch", pkg
        from lucille_tpu_torch.ri.api import RiState
        from lucille_tpu_torch.rib.parser import parse_rib
    return RiState, parse_rib


def _finish_state(s, width, height, pixelsamples, gather, accel):
    if width is not None:
        s.Format(width, height)
    if pixelsamples is not None:
        s.PixelSamples(pixelsamples, pixelsamples)
    if gather is not None:
        s.options.gather_nsamples = gather
    s.options.accel_method = accel
    return s


def bundled_state(width=None, height=None, pixelsamples=None, gather=None,
                  accel="pallas", sunsky=False, pkg="torch"):
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib(bundled_rib_text(sunsky), s)
    return _finish_state(s, width, height, pixelsamples, gather, accel)


def heightfield_state(n, width=None, height=None, pixelsamples=None,
                      gather=None, accel="pallas", sunsky=False, pkg="torch"):
    """bench_large's terrain through chip_smoke's copy of it (tests below
    hold the copy equal to bench_large.heightfield_scene)."""
    from chip_smoke import heightfield_state as hf

    s = hf(n, sunsky=sunsky, api=front_end(pkg))
    return _finish_state(s, width, height, pixelsamples, gather, accel)


SCENES = {
    "bundled": lambda pkg: bundled_state(pkg=pkg),
    "heightfield35": lambda pkg: heightfield_state(35, pkg=pkg),
    "heightfield35_bvh": lambda pkg: heightfield_state(35, accel="bvh",
                                                       pkg=pkg),
}


@pytest.mark.parametrize("name,builder", [
    *(pytest.param(name, "native", id=name) for name in sorted(SCENES)),
    pytest.param("heightfield35_bvh", "numpy", id="heightfield35_bvh-numpy"),
])
def test_compile_matches_jax_exactly(name, builder, request):
    """Every array equal, bit for bit (after lucille_tpu's own device_put
    cast to f32/i32), on the dense tiles and on the tile BVH: triangle
    ids compare exactly.  from_numpy of lucille_tpu's pbvh SceneArrays
    gives the port's own compile, node pack and tree depth included.  The
    tile BVH once with both packages' C++ builders, once with both
    NumPy builds."""
    if builder == "numpy":
        request.getfixturevalue("numpy_builders")
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.scene.compile import compile_scene
    from lucille_tpu_torch.scene.types import (
        ARRAY_FIELDS,
        STATIC_FIELDS,
        from_numpy,
    )

    ref = jax_compile(SCENES[name]("jax").scene)
    bvh = name.endswith("_bvh")
    assert ref.accel == ("pbvh" if bvh else "pallas")
    got = compile_scene(SCENES[name]("torch").scene, "cpu")
    want = from_numpy(ref, "cpu")
    assert got.accel == want.accel == ("pbvh" if bvh else "dense")
    for f in ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    for f in STATIC_FIELDS:
        assert getattr(got, f) == getattr(ref, f) == getattr(want, f), f
    expect = {"bundled": (322, 512, 0), "heightfield35": (2312, 2560, 0),
              # leaves padded to whole tiles: 24 tiles of 128
              "heightfield35_bvh": (2312, 3072, 47)}[name]
    assert (got.n_tris, got.n_pad, got.n_nodes) == expect
    if bvh:
        assert torch.equal(got.nodes.view(torch.int32),
                           want.nodes.view(torch.int32))
        assert got.tree_depth == want.tree_depth > 0
    else:
        assert got.nodes is None and want.nodes is None


def test_from_numpy_round_trips():
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.scene.types import ARRAY_FIELDS, from_numpy, to_numpy

    ref = jax_compile(bundled_state(pkg="jax").scene)
    back = to_numpy(from_numpy(ref, "cpu"))
    assert set(back) == set(ARRAY_FIELDS)
    for f in ARRAY_FIELDS:
        a = np.asarray(getattr(ref, f))
        a = a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
        np.testing.assert_array_equal(back[f], a, err_msg=f)


def test_accel_choice_by_count_and_refusals():
    """auto: dense tiles up to 16384 triangles, the tile BVH above (by
    count alone, on any device); bvh and pbvh ask for the tile BVH; the
    grid, brute-force and MXU accels, refused until they were ported, ask
    for the grid and for the dense tiles in input order."""
    from lucille_tpu_torch.scene.compile import compile_arrays, compile_scene

    auto = compile_scene(bundled_state(accel="auto").scene, "cpu")
    dense = compile_scene(bundled_state().scene, "cpu")
    assert torch.equal(auto.tri_v0, dense.tri_v0)
    assert auto.accel == "dense"
    # 90^2 * 2 = 16200 triangles: the dense accel's upper range;
    # 91^2 * 2 = 16562: above it
    assert compile_arrays(heightfield_state(91, accel="auto").scene
                          ).accel == "dense"
    big = compile_arrays(heightfield_state(92, accel="auto").scene)
    assert (big.accel, big.n_tris) == ("pbvh", 16562)
    for accel in ("bvh", "pbvh"):
        assert compile_scene(bundled_state(accel=accel).scene,
                             "cpu").accel == "pbvh"
    for accel, layout in (("grid", "ugrid"), ("bruteforce", "dense"),
                          ("mxu", "dense")):
        sc = compile_scene(bundled_state(accel=accel).scene, "cpu")
        assert (sc.accel, sc.intersector) == (layout, accel.replace(
            "grid", "ugrid"))
        assert not torch.equal(sc.tri_v0, dense.tri_v0)  # not Morton-sorted


@pytest.mark.parametrize("xs,ys", [(1, 1), (2, 2), (3, 3), (4, 2), (5, 3)])
def test_subpixel_samples_exact(xs, ys):
    from lucille_tpu.sampling.hammersley import subpixel_samples as ref
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples

    for a, b in zip(subpixel_samples(xs, ys), ref(xs, ys)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "name", ["box", "triangle", "gaussian", "catmull-rom", "sinc", "nope"])
def test_filter_table_exact(name):
    from lucille_tpu.render.film import subsample_filter_table as ref
    from lucille_tpu_torch.render.film import subsample_filter_table
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples

    jit, _ = subpixel_samples(3, 3)
    for widths in ((2.0, 2.0), (1.0, 3.0)):
        np.testing.assert_array_equal(
            subsample_filter_table(name, jit, *widths),
            ref(name, jit, *widths))


@pytest.mark.parametrize("order", ["spiral", "scanline", "zorder", "hilbert"])
def test_tile_list_exact(order):
    from lucille_tpu.render.tiles import tile_list as ref
    from lucille_tpu_torch.render.tiles import tile_list

    for w, h, t in ((640, 480, 240), (48, 32, 16), (100, 37, 16), (7, 300, 64)):
        assert tile_list(w, h, t, order) == ref(w, h, t, order)


def _ortho_camera(pkg):
    if pkg == "jax":
        from lucille_tpu.ri.camera import ORTHOGRAPHIC, Camera
    else:
        from lucille_tpu_torch.ri.camera import ORTHOGRAPHIC, Camera

    cam = Camera(horizontal_resolution=64, vertical_resolution=48)
    cam.camera_projection = ORTHOGRAPHIC
    rng = np.random.default_rng(11)
    w2c = np.eye(4)
    w2c[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    w2c[3, :3] = rng.normal(size=3)
    cam.setup(w2c, "lh")
    return cam


@pytest.mark.parametrize("proj", ["perspective", "orthographic"])
def test_generate_rays_close(proj):
    """f32 rays within 1e-6 of the JAX version on the same raster
    positions (the operation order is the same; XLA may still round a
    reduction differently).  Each package sets up its own camera from the
    same scene."""
    import jax.numpy as jnp

    from lucille_tpu_torch.ri.camera import generate_rays

    def camera(pkg):
        if proj == "perspective":
            return bundled_state(64, 48, pkg=pkg).camera
        return _ortho_camera(pkg)

    cam, ref_cam = camera("torch"), camera("jax")
    assert cam.camera_projection == ref_cam.camera_projection == proj
    for a, b in zip(cam.ray_constants(), ref_cam.ray_constants()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    px = rng.uniform(0, 64, 999).astype(np.float32)
    py = rng.uniform(0, 48, 999).astype(np.float32)
    o_ref, d_ref = ref_cam.generate_rays(jnp.asarray(px), jnp.asarray(py))
    o, d = generate_rays(cam, torch.from_numpy(px), torch.from_numpy(py))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=1e-6)


def test_generate_rays_refuses_depth_of_field():
    """A depth-of-field camera needs its lens samples: called without
    them, generate_rays refuses rather than tracing pinhole rays (the
    renderer always draws them; tests/test_torch_camera_dof.py holds the
    thin lens against lucille_tpu's)."""
    from lucille_tpu_torch.ri.camera import generate_rays

    cam = bundled_state(64, 48).camera
    cam.fstop, cam.focal_length, cam.focal_distance = 2.8, 0.05, 10.0
    with pytest.raises(ValueError, match="lens samples"):
        generate_rays(cam, torch.zeros(4), torch.zeros(4))


@pytest.mark.parametrize("n,accel", [(35, "pallas"), (35, "bvh"), (92, "auto")])
def test_heightfield_copy_equals_bench_large(n, accel):
    """chip_smoke's copy of bench_large's terrain and camera gives
    lucille_tpu the same compiled scene and camera as bench_large's own
    heightfield_scene."""
    from bench_large import heightfield_scene
    from lucille_tpu.scene.compile import compile_scene as jax_compile

    want = heightfield_scene(n)
    want.options.accel_method = accel
    got = heightfield_state(n, accel=accel, pkg="jax")
    a, b = jax_compile(got.scene), jax_compile(want.scene)
    for f in ("tri_v0", "tri_e1", "tri_e2", "n0", "n1", "n2", "node_skip",
              "node_bbmin"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for x, y in zip(got.camera.ray_constants(), want.camera.ray_constants()):
        np.testing.assert_array_equal(x, y)
    assert (got.options.width, got.options.height) == (160, 120)
    assert got.options.current_display().sampling_rates[0] == 2
