"""The port's own host front end against lucille_tpu's, the rule that
the port imports nothing of the JAX package, and the port's layering.

Every RIB the port's tests render goes through both packages' parsers:
the bundled scene as shipped (its sunsky light and the sun beside it),
bench_large's heightfield, and small scenes with a sphere, a subdivision
mesh, curves, and point, distant and area lights.  The scene
descriptions must be equal: every geometry array, attribute and
material, light record (the sky model's parameters included), the
camera's ray constants and the options.  The copies are the same code,
so equal means exactly equal.
"""

import ast
import dataclasses
import importlib
import importlib.util

import numpy as np
import pytest

from test_torch_nojax import _heightfield_rib
from test_torch_scene import REPO, bundled_rib_text, front_end
from test_torch_scene import one_torch_thread  # noqa: F401

_CAMERA = (
    'Display "out.hdr" "file" "rgb"\n'
    "Format 64 48 1\n"
    "PixelSamples 2 3\n"
    'Projection "perspective" "fov" [40]\n'
    'Orientation "rh"\n'
    "ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -6 1]\n"
)

SMALL = {
    "sphere_point_light": _CAMERA + (
        "WorldBegin\n"
        'LightSource "pointlight" 1 "from" [1 4 2] "intensity" [30]\n'
        "AttributeBegin\n"
        "Translate 0 1 0\n"
        'Color [0.8 0.5 0.2]\n'
        "Sphere 1 -1 1 360\n"
        "AttributeEnd\n"
        'Polygon "P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]\n'
        "WorldEnd\n"),
    "subdivision_distant_light": _CAMERA + (
        "WorldBegin\n"
        'LightSource "distantlight" 1 "from" [0 5 0] "to" [1 0 1] '
        '"lightcolor" [1 0.9 0.8]\n'
        "AttributeBegin\n"
        "Rotate 30 0 1 0\n"
        'SubdivisionMesh "catmull-clark" [4 4 4 4 4 4] '
        "[0 1 2 3  4 5 6 7  0 1 5 4  1 2 6 5  2 3 7 6  3 0 4 7] "
        '"P" [ -1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1  -1 -1 1  1 -1 1  1 1 1  '
        "-1 1 1 ]\n"
        "AttributeEnd\n"
        "WorldEnd\n"),
    "curves_area_light": _CAMERA + (
        "WorldBegin\n"
        "AttributeBegin\n"
        'AreaLightSource "arealight" 1 "intensity" [4] "lightcolor" [1 1 1]\n'
        'Polygon "P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]\n'
        "AttributeEnd\n"
        'PointsPolygons [4] [0 3 2 1] "P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]\n'
        'Curves "cubic" [4 4] "nonperiodic" "P" [0 0 0  0.1 0.3 0  '
        "0.2 0.6 0.1  0.2 0.9 0.2  1 0 0  1.1 0.3 0  1.2 0.6 0.1  "
        '1.2 0.9 0.2] "constantwidth" [0.06]\n'
        "WorldEnd\n"),
}


def _rib(name: str) -> str:
    if name == "bundled_sunsky":
        return bundled_rib_text(sunsky=True)
    if name == "heightfield":
        return _heightfield_rib(9)
    return SMALL[name]


def _parse(pkg: str, text: str):
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib(text, s)
    return s


def assert_same(a, b, where="desc"):
    """Equal field for field, across the two packages' classes: arrays
    exactly, floats exactly, objects by their fields."""
    if dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, where
        da = {k: v for k, v in vars(a).items() if not k.startswith("__")}
        db = {k: v for k, v in vars(b).items() if not k.startswith("__")}
        assert sorted(da) == sorted(db), where
        for k in da:
            assert_same(da[k], db[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


CASES = ["bundled_sunsky", "heightfield", *SMALL]


@pytest.mark.parametrize("name", CASES)
def test_front_end_parity(name):
    """The same RIB text through each package's parser and RiState: the
    same scene description, the same camera ray constants."""
    text = _rib(name)
    got, want = _parse("torch", text), _parse("jax", text)
    assert got.world_block == want.world_block == 1
    desc, ref = got.scene, want.scene
    assert len(desc.geoms) == len(ref.geoms) > 0
    assert_same(desc.geoms, ref.geoms, "geoms")
    assert_same(desc.lights, ref.lights, "lights")
    assert_same(desc.options, ref.options, "options")
    assert_same(desc.camera, ref.camera, "camera")
    for x, y in zip(desc.camera.ray_constants(), ref.camera.ray_constants()):
        np.testing.assert_array_equal(x, y)
    kinds = {g.kind for g in desc.geoms}
    types = [li.type for li in desc.lights]
    expect = {"bundled_sunsky": ({"polygon"}, ["sunsky", "sun"]),
              "heightfield": ({"polygon"}, []),
              "sphere_point_light": ({"sphere", "polygon"}, ["point"]),
              "subdivision_distant_light": ({"subdiv"}, ["distant"]),
              "curves_area_light": ({"polygon", "curves"}, ["area"])}[name]
    assert (kinds, types) == expect


def test_sunsky_light_records_match():
    """The sunsky light's sky model and the sun light beside it: the
    solar position, Perez coefficients, the sun's direction (with the
    reference's y/z swap) and colour, from the port's own copy of the
    model."""
    sky, sun = _parse("torch", _rib("bundled_sunsky")).scene.lights
    ref_sky, ref_sun = _parse("jax", _rib("bundled_sunsky")).scene.lights
    assert type(sky.sunsky).__module__ == "lucille_tpu_torch.lights.sunsky"
    assert sky.sunsky.turbidity == ref_sky.sunsky.turbidity == 2.2
    assert_same(sky.sunsky, ref_sky.sunsky, "sunsky")
    np.testing.assert_array_equal(sun.direction, ref_sun.direction)
    np.testing.assert_array_equal(sun.color, ref_sun.color)
    np.testing.assert_array_equal(sky.sunsky.sunlight_rgb(turbidity=0.0),
                                  ref_sky.sunsky.sunlight_rgb(turbidity=0.0))


def _imports(path):
    """(enclosing function or None, module, name or None) of every import
    statement in the file, at any depth (function-level imports
    included): ``import a.b`` gives (fn, "a.b", None), ``from a.b import
    c`` gives (fn, "a.b", "c")."""
    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
            elif isinstance(child, ast.Import):
                yield from ((fn, a.name, None) for a in child.names)
            elif (isinstance(child, ast.ImportFrom) and child.module
                    and not child.level):
                yield from ((fn, child.module, a.name) for a in child.names)
            else:
                yield from walk(child, fn)

    yield from walk(ast.parse(path.read_text(), str(path)), None)


def test_port_imports_nothing_of_the_jax_package():
    """No module under lucille_tpu_torch/, nor chip_smoke.py or the
    profile_*.py scripts beside it, imports jax, lucille_tpu, tools_tpu
    (whose modules import lucille_tpu) or bench_large, at any depth of
    the file (function-level imports included)."""
    files = sorted((REPO / "lucille_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "profile_frame.py",
              REPO / "profile_gather.py", REPO / "profile_lanes.py"]
    assert len(files) > 40
    bad = [(str(p.relative_to(REPO)), m) for p in files
           for _fn, m, _name in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "lucille_tpu", "tools_tpu",
                                  "bench_large")]
    assert not bad, bad


PORT = REPO / "lucille_tpu_torch"
# The port's layers run ops < accel < lights < shading < transport <
# render, with parallel/ under render: what each layer may not import.
ABOVE = {
    "ops": ("accel", "lights", "shading", "transport", "render"),
    "accel": ("lights", "shading", "transport", "render"),
    "lights": ("shading", "transport", "render"),
    "shading": ("transport", "render"),
    "parallel": ("render",),
}
# The one import that points up: lucille_tpu's own API renders a sharded
# frame through a Renderer, imported inside that function.
UPWARD = {("parallel/mesh.py", "render_frame_sharded",
           "lucille_tpu_torch.render.renderer")}


def _layering_faults(case):
    """What breaks the layering `case` names: an import of a layer above
    (ABOVE), gather_kind named outside accel/gather.py, or a name that a
    card-only script imports from the port and its module lacks."""
    if case in ABOVE:
        return [(str(p.relative_to(PORT)), fn, m)
                for p in sorted((PORT / case).rglob("*.py"))
                for fn, m, name in _imports(p)
                if (m if name is None else f"{m}.{name}").split(".")[:2]
                in (["lucille_tpu_torch", up] for up in ABOVE[case])
                and (str(p.relative_to(PORT)), fn, m) not in UPWARD]
    if case == "gather_kind":
        def named(node):
            return ((isinstance(node, ast.Name) and node.id == "gather_kind")
                    or (isinstance(node, ast.Attribute)
                        and node.attr == "gather_kind")
                    or (isinstance(node, ast.alias)
                        and node.name == "gather_kind")
                    or (isinstance(node, ast.FunctionDef)
                        and node.name == "gather_kind"))
        return [str(p.relative_to(PORT)) for p in sorted(PORT.rglob("*.py"))
                if p != PORT / "accel" / "gather.py"
                and any(named(n) for n in ast.walk(ast.parse(p.read_text())))]
    bad = []
    for p in [REPO / "chip_smoke.py", *sorted(REPO.glob("profile_*.py"))]:
        for _fn, m, name in _imports(p):
            if m.split(".")[0] != "lucille_tpu_torch":
                continue
            found = _module_found(m) and (
                name is None or hasattr(importlib.import_module(m), name)
                or _module_found(f"{m}.{name}"))
            if not found:
                bad.append((p.name, m, name))
    return bad


def _module_found(name) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # a parent package is missing
        return False


@pytest.mark.parametrize("case", [*ABOVE, "gather_kind", "card_scripts"])
def test_port_imports_point_down(case):
    """The port's imports point down its layers (ABOVE), the one named
    exception aside (UPWARD); which hemisphere gather serves a scene is
    read in accel/gather.py alone (gather_kind named in no other module of
    the package); and every name chip_smoke.py and the profile_*.py
    scripts import from the port inside their functions, which only the
    card runs, is there on the CPU."""
    assert not _layering_faults(case)


def test_port_logs_under_its_own_name():
    """The two packages keep two loggers: a level set on one leaves the
    other as it was, and the port's lines carry the port's name."""
    import logging

    from lucille_tpu.base.log import get_logger as jax_logger
    from lucille_tpu_torch.base.log import get_logger

    port, ref = get_logger(), jax_logger()
    assert port is not ref and port.name == "lucille_tpu_torch"
    before = ref.level
    port.setLevel(logging.ERROR)
    try:
        assert ref.level == before
    finally:
        port.setLevel(logging.INFO)
    assert "[lucille_tpu_torch]" in port.handlers[0].formatter._fmt


@pytest.mark.parametrize("what", ["socket", "socket-display-line",
                                  "socket-shell", "socket-cli-flag"])
def test_unported_image_formats_and_drivers_raise(what, tmp_path, capsys,
                                                  monkeypatch):
    """No image format or display driver is left unported: the socket
    driver, the last one refused, is the port's own copy now
    (display/sockdrv.py), and every way to reach it (the registry, a
    Display line, the shell, --display socket) streams the frame to the
    viewer on LUCILLE_SOCKET_PORT, never a refusal or a fallback that
    writes a file (the .tex and .exr codecs and the OpenEXR driver:
    tests/test_torch_texture.py)."""
    from chip_smoke import SocketListener
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.display.drivers import get_display_driver
    from lucille_tpu_torch.display.sockdrv import SocketDriver
    from lucille_tpu_torch.shell import Shell

    lis = SocketListener()
    monkeypatch.setenv("LUCILLE_SOCKET_PORT", str(lis.port))
    monkeypatch.setenv("LUCILLE_NO_SPAWN_VIEWER", "1")
    rib = tmp_path / "s.rib"
    rib.write_text('Display "s.hdr" "socket" "rgb"\nFormat 8 6 1\n'
                   'PixelSamples 1 1\nWorldBegin\nWorldEnd\n')
    if what == "socket":
        drv = get_display_driver(what)
        assert isinstance(drv, SocketDriver)
        assert drv.open("s.hdr", 8, 6)
        drv.write(0, 0, np.ones((6, 8, 3), np.float32))
        drv.close()
    elif what == "socket-shell":
        sh = Shell(device="cpu")
        assert sh.one(f"file {rib}") and sh.one("render")
        assert "not ported" not in capsys.readouterr().out
    else:
        argv = ["--display", "socket"] if what == "socket-cli-flag" else []
        assert main([str(rib), "--device", "cpu", "--tile", "8", *argv]) == 0
    lis.join()
    assert lis.finished and lis.frame.shape == (6, 8, 3)
    if what == "socket":
        assert (lis.frame == 1).all()
    assert not (tmp_path / "s.hdr").exists()


def test_framebuffer_falls_back_to_the_file_driver(tmp_path, monkeypatch):
    """No viewer listens and none may be spawned: the framebuffer route
    falls back to the file driver (tests/test_torch_sockdrv.py holds the
    route to a viewer)."""
    import socket

    from lucille_tpu_torch.display.drivers import get_display_driver

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    monkeypatch.setenv("LUCILLE_SOCKET_PORT", str(s.getsockname()[1]))
    s.close()
    monkeypatch.setenv("LUCILLE_NO_SPAWN_VIEWER", "1")
    from lucille_tpu_torch.imageio.rgbe import read_hdr

    drv = get_display_driver("framebuffer")
    drv.open(str(tmp_path / "fb.hdr"), 4, 2)
    drv.write(0, 0, np.ones((2, 4, 3), np.float32))
    drv.close()
    np.testing.assert_allclose(read_hdr(tmp_path / "fb.hdr"), 1.0)
