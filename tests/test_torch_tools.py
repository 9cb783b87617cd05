"""The port's entry points outside the package core, against lucille_tpu's
repo-level scripts on the same inputs (NumPy-seeded):

- tools/rockenfield.py, the progressive viewer, against
  tools_tpu/rockenfield.py: a frame streamed by the port's SocketDriver
  to each (--out --quiet, each in its own interpreter) gives byte-equal
  .hdr files; the terminal preview is byte-equal; the port's viewer runs
  and writes its --out where jax, lucille_tpu and tools_tpu cannot be
  imported (test_torch_nojax's rule, carried over to a subprocess);
- tools/sisgen.py against tools_tpu/sisgen.py: equal .npz arrays and an
  identical text dump, both .npz files bound by EnvMap.load_sis;
- tools/obj2rib.py against tools_tpu/obj2rib.py: identical RIB text but
  for the first comment; the RIB, and tools_tpu/dcc_export.emit_rib's,
  render through the port's CLI on the CPU;
- examples/fur.py against examples_tpu/fur.py: identical RIB text, and a
  small frame against lucille_tpu's Renderer on the dense tiles and on
  the tile BVH, within test_torch_render's bounds (its JaxSampler
  streams: the frames differ only where f32 rounding flips a stratum).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import REPO

CUBE_OBJ = """
v -1 0 -1
v 1 0 -1
v 1 2 -1
v -1 2 -1
v -1 0 1
v 1 0 1
v 1 2 1
v -1 2 1
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 4 8 5 1
"""
NEGATIVE_OBJ = ("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                "vn 0 0 1\n"
                "f -3//-1 -2//-1 -1//-1\n")


def _tools_tpu(name):
    """tools_tpu/<name>.py (or examples_tpu's, name "examples_tpu/x"), as
    a module imported from its directory."""
    import importlib

    folder, _, mod = name.rpartition("/")
    path = str(REPO / (folder or "tools_tpu"))
    sys.path.insert(0, path)
    try:
        sys.modules.pop(mod, None)
        return importlib.import_module(mod)
    finally:
        sys.path.remove(path)
        sys.modules.pop(mod, None)


# ---------------------------------------------------------------- viewer

# the port's viewer in an interpreter where jax, lucille_tpu, tools_tpu
# and bench_large cannot be imported (test_torch_nojax._SCRIPT's rule)
_VIEWER = textwrap.dedent("""
    import sys
    before = {k for k, v in sys.modules.items() if v is not None}
    for blocked in ("jax", "lucille_tpu", "tools_tpu", "bench_large"):
        if blocked not in before:
            sys.modules[blocked] = None
    from lucille_tpu_torch.tools.rockenfield import main
    rc = main(sys.argv[1:])
    added = {k for k, v in sys.modules.items() if v is not None} - before
    bad = sorted(k for k in added if k.split(".")[0] in (
        "jax", "lucille_tpu", "tools_tpu", "bench_large"))
    assert not bad, bad
    print("VIEWER-OK", rc)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_viewer(argv, out, cwd):
    """A viewer process (python -u argv... --port P --out out --quiet),
    returned once it listens: (process, port)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", *argv, "--port", str(port), "--out", str(out),
         "--quiet"], cwd=str(cwd), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert line == f"[rockenfield] listening on 127.0.0.1:{port}\n", (
        line, proc.stderr.read() if proc.poll() is not None else "")
    return proc, port


def _frame(w=40, h=36, seed=0):
    """A seeded (h, w, 3) frame and the tiles covering it: one past the
    1024-pixel batch, some partial."""
    rng = np.random.default_rng(seed)
    frame = rng.uniform(0, 5, (h, w, 3)).astype(np.float32)
    cuts = [(0, 0, 33, 32), (33, 0, w, 32), (0, 32, w, h)]
    return frame, [(x0, y0, frame[y0:y1, x0:x1]) for x0, y0, x1, y1 in cuts]


def _stream(port, frame, tiles):
    """The port's SocketDriver streams the tiles to a viewer on port,
    then one PIXEL batch whose coordinates lie off the frame (the viewer
    clips them onto its edges) and the frame's first pixel again."""
    import struct

    from lucille_tpu_torch.display.sockdrv import COMMAND_PIXEL, SocketDriver

    h, w = frame.shape[:2]
    drv = SocketDriver(port=port)
    assert drv.open("live", w, h)
    for x0, y0, tile in tiles:
        drv.write(x0, y0, tile)
    off = np.float32([[-3, 2, 9, 8, 7], [w + 5, h + 9, 1, 2, 3],
                      [0, 0, *frame[0, 0]]])
    drv.sock.sendall(struct.pack("<ii", COMMAND_PIXEL, len(off))
                     + off.tobytes())
    drv.close()


def _viewer_out(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def test_viewer_writes_the_hdr_tools_tpu_writes(tmp_path, monkeypatch):
    """One frame streamed by the port's SocketDriver to the port's viewer
    (python -m lucille_tpu_torch.tools.rockenfield, started from another
    directory) and to tools_tpu/rockenfield.py (from the repo root, which
    its --out branch needs): the two .hdr files are byte-equal, and the
    viewers print the same lines (beside them, a package may log that it
    built its native RGBE codec)."""
    from lucille_tpu_torch.imageio.rgbe import read_hdr

    monkeypatch.setenv("LUCILLE_NO_SPAWN_VIEWER", "1")
    frame, tiles = _frame()
    lines = {}
    for name, argv, cwd in (
            ("port", ["-m", "lucille_tpu_torch.tools.rockenfield"], tmp_path),
            ("jax", [str(REPO / "tools_tpu" / "rockenfield.py")], REPO)):
        out = tmp_path / f"{name}.hdr"
        proc, port = _start_viewer(argv, out, cwd)
        _stream(port, frame, tiles)
        lines[name] = [line.replace(str(out), "OUT").split(" from ")[0]
                       for line in _viewer_out(proc).splitlines()
                       if line.startswith("[rockenfield]")]
    got, want = tmp_path / "port.hdr", tmp_path / "jax.hdr"
    assert got.read_bytes() == want.read_bytes()
    assert lines["port"] == lines["jax"]
    assert lines["port"][-2:] == [
        f"[rockenfield] frame complete ({40 * 36 + 3} pixels)",
        "[rockenfield] wrote OUT"]
    img = read_hdr(got)
    want_img = frame.copy()
    want_img[2, 0] = (9, 8, 7)  # (-3, 2) clipped onto the left edge
    want_img[35, 39] = (1, 2, 3)  # (w + 5, h + 9) onto the far corner
    # RGBE: one exponent a pixel, 8 bits of mantissa against its largest
    assert (np.abs(img - want_img)
            <= 1e-2 * want_img.max(-1, keepdims=True)).all()


def test_terminal_preview_is_tools_tpus():
    from lucille_tpu_torch.tools.rockenfield import _terminal_preview

    ref = _tools_tpu("rockenfield")
    rng = np.random.default_rng(3)
    for shape, cols in (((24, 32, 3), 16), ((37, 53, 3), 100),
                        ((9, 200, 3), 100)):
        img = rng.uniform(0, 2, shape).astype(np.float32)
        got = _terminal_preview(img, max_cols=cols)
        assert got == ref._terminal_preview(img, max_cols=cols)
        assert "\x1b[38;2;" in got
    assert _terminal_preview(img) == ref._terminal_preview(img)


def test_viewer_runs_without_jax(tmp_path, monkeypatch):
    """The port's viewer, in an interpreter where jax, lucille_tpu and
    tools_tpu are blocked, from a directory outside the repo: it listens,
    reassembles the frame and writes its --out through the port's RGBE
    codec (the bytes write_hdr gives for that frame)."""
    from lucille_tpu_torch.imageio.rgbe import write_hdr

    monkeypatch.setenv("LUCILLE_NO_SPAWN_VIEWER", "1")
    frame, tiles = _frame(seed=1)
    out = tmp_path / "v.hdr"
    proc, port = _start_viewer(["-c", _VIEWER], out, tmp_path)
    _stream(port, frame, tiles)
    assert "VIEWER-OK 0" in _viewer_out(proc)
    frame[2, 0] = (9, 8, 7)
    frame[35, 39] = (1, 2, 3)
    write_hdr(tmp_path / "want.hdr", frame)
    assert out.read_bytes() == (tmp_path / "want.hdr").read_bytes()


# ---------------------------------------------------------------- sisgen

def test_sisgen_cli_matches_tools_tpu(tmp_path, monkeypatch, capsys):
    """The port's sisgen command and tools_tpu's on a seeded 64x32 map:
    equal .npz arrays, identical text dumps and printed lines; the port's
    EnvMap binds both .npz files as a sisfile."""
    from lucille_tpu_torch.imageio.rgbe import write_hdr
    from lucille_tpu_torch.lights.envmap import EnvMap
    from lucille_tpu_torch.tools import sisgen

    rng = np.random.default_rng(4)
    img = rng.uniform(0.05, 2.0, (32, 64, 3)).astype(np.float32)
    img[6, 20] = (900.0, 850.0, 700.0)
    write_hdr(tmp_path / "sky.hdr", img)
    ref = _tools_tpu("sisgen")
    printed = {}
    for name, run in (("port", sisgen.main), ("jax", ref.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        argv = ["../sky.hdr", "-n", "24", "--text", "samples.txt"]
        monkeypatch.setattr(sys, "argv", ["sisgen", *argv])
        assert (run(argv) if name == "port" else run()) == 0
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    got, want = (np.load(tmp_path / n / "gensamples.npz")
                 for n in ("port", "jax"))
    assert sorted(got.files) == sorted(want.files) == ["dirs", "rgb"]
    for k in ("dirs", "rgb"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert 10 <= len(got["dirs"]) <= 30
    text = (tmp_path / "port" / "samples.txt").read_text()
    assert text == (tmp_path / "jax" / "samples.txt").read_text()
    assert len(text.splitlines()) == len(got["dirs"])
    for name in ("port", "jax"):
        env = EnvMap(img)
        env.load_sis(tmp_path / name / "gensamples.npz")
        for a, b in zip(env.file_sis, (got["dirs"], got["rgb"])):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- obj2rib

@pytest.mark.parametrize("obj", ["cube", "negative"])
def test_obj2rib_matches_tools_tpu(obj, tmp_path, capsys):
    """The same RIB text as tools_tpu's, line for line but for the first
    comment (which names the port), at the defaults and with every flag;
    main writes it to stdout or to -o."""
    from lucille_tpu_torch.tools import obj2rib

    ref = _tools_tpu("obj2rib")
    p = tmp_path / f"{obj}.obj"
    p.write_text(CUBE_OBJ if obj == "cube" else NEGATIVE_OBJ)
    for args in ((), (40.0, 1, 4, "whitted")):
        got = obj2rib.obj_to_rib(p, *args).splitlines()
        want = ref.obj_to_rib(p, *args).splitlines()
        assert got[0] == "# generated by lucille_tpu_torch obj2rib"
        assert want[0] == "# generated by lucille_tpu obj2rib"
        assert got[1:] == want[1:] and len(got) > 10
    assert obj2rib.main([str(p)]) == 0
    assert capsys.readouterr().out == obj2rib.obj_to_rib(p)
    assert obj2rib.main([str(p), "-o", str(tmp_path / "o.rib"), "--fov",
                         "40"]) == 0
    assert (tmp_path / "o.rib").read_text() == obj2rib.obj_to_rib(p, 40.0)


def _render_cli(tmp_path, rib_text, *argv):
    """rib_text through the port's CLI on the CPU, 32x24, tile 16: the
    image read back."""
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.imageio.rgbe import read_hdr

    rib = tmp_path / "scene.rib"
    rib.write_text(rib_text)
    out = tmp_path / "out.hdr"
    assert main([str(rib), "-o", str(out), "--device", "cpu", "--width",
                 "32", "--height", "24", "--tile", "16", *argv]) == 0
    img = read_hdr(out)
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    return img


def test_obj2rib_renders_through_the_cli(tmp_path):
    """The cube's RIB (1 sample, 4 gather rays) renders through the port's
    CLI on the CPU: the cube and its ground plane, 14 triangles, lit (as
    tests/test_tools.py renders tools_tpu's through lucille_tpu)."""
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib
    from lucille_tpu_torch.tools.obj2rib import obj_to_rib

    p = tmp_path / "c.obj"
    p.write_text(CUBE_OBJ)
    rib = obj_to_rib(p, samples=1, gather=4)
    s = RiState()
    parse_rib(rib, s)
    assert s.scene.ntriangles == 12 + 2  # cube + ground plane
    assert _render_cli(tmp_path, rib).mean() > 0.05


def test_dcc_export_rib_renders_through_the_cli(tmp_path):
    """tools_tpu/dcc_export.emit_rib's RIB (its emitter imports nothing of
    lucille_tpu, so both packages read it as it is; tests/test_tools.py
    renders it through lucille_tpu) renders through the port's CLI: the
    triangle and the floor, the triangle's colour."""
    from tools_tpu.dcc_export import emit_rib

    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib

    meshes = [
        dict(positions=np.array([[-1, 0, -1], [1, 0, -1], [0, 2, 0]], float),
             indices=np.array([[0, 1, 2]]), name="tri",
             color=(1.0, 0.5, 0.25), surface="matte",
             surface_params={"Kd": [0.8]}),
        dict(positions=np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5],
                                 [-5, 0, 5]], float),
             indices=np.array([[0, 1, 2], [0, 2, 3]]), name="floor"),
    ]
    rib = emit_rib(meshes, width=32, height=24, samples=1)
    s = RiState()
    parse_rib(rib, s)
    assert [g.ntriangles for g in s.scene.geoms] == [1, 2]
    np.testing.assert_allclose(s.scene.geoms[0].attrs.color, (1.0, 0.5, 0.25))
    img = _render_cli(tmp_path, rib, "--gather-rays", "4")
    assert img.max() > 0.0


# ---------------------------------------------------------------- fur

@pytest.mark.parametrize("nstrands,seed", [(400, 7), (40, 7), (9, 3)])
def test_fur_rib_is_examples_tpus(nstrands, seed):
    from lucille_tpu_torch.examples import fur

    ref = _tools_tpu("examples_tpu/fur")
    got = fur.make_rib("/x/fur.hdr", nstrands, seed)
    assert got == ref.make_rib("/x/fur.hdr", nstrands, seed)
    assert got.count("\n") == 9


def _fur_state(pkg, nstrands, accel):
    """The fur scene at 32x24, 1 sample, 16 gather rays, through the
    port's front end ("torch") or lucille_tpu's ("jax")."""
    from test_torch_scene import _finish_state, front_end

    from lucille_tpu_torch.examples.fur import make_rib

    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib(make_rib("fur.hdr", nstrands), s)
    return _finish_state(s, 32, 24, 1, 16, accel)


@pytest.mark.parametrize("accel", ["pallas", "bvh"])
def test_fur_frame_matches_jax(accel, monkeypatch):
    """10 strands (642 triangles: 6 dense tiles) on the dense tiles, and
    the same scene with the accel set to "bvh" on both states, against
    lucille_tpu's frame: test_torch_render's bounds (fewer than 8 dense
    tiles, or the tile BVH, keep each lane's jitter: per pixel)."""
    import test_torch_render as tr

    make_state = lambda pkg: _fur_state(pkg, 10, accel)  # noqa: E731
    desc = make_state("torch")
    assert desc.scene.ntriangles == 2 + 10 * 64
    case = "fur" + ("_bvh" if accel == "bvh" else "")
    if accel == "pallas":
        n_tiles = 6
    else:
        from lucille_tpu_torch.scene.compile import compile_scene

        n_tiles = compile_scene(desc.scene, "cpu").n_pad // 128
    monkeypatch.setitem(tr.CASES, case, (make_state, 16, n_tiles))
    tr.check_frame_against_jax(case, *tr._render_pair(make_state, 16))
