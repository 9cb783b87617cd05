"""The port's CLI flags and interactive shell, against lucille_tpu's
(lucille_tpu/cli.py, lucille_tpu/shell.py): each flag reaches the
option lucille_tpu's sets, the shell runs when no RIB is given, the
shells' commands move the camera the same way, and what the port once
refused naming ROADMAP is accepted now, nothing naming it.  Frames render on
the CPU at 16x16 or 32x24 (the port's default random streams, so a frame
rendered twice is the same frame)."""

import io
import logging

import numpy as np
import pytest

from test_torch_scene import bundled_rib_text
from test_torch_scene import one_torch_thread  # noqa: F401

SMALL = ["--device", "cpu", "--width", "16", "--height", "16",
         "--pixelsamples", "1", "--gather-rays", "4", "--tile", "16"]


def _rib(tmp_path, text, name="scene.rib"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _render(rib, out, *argv):
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.imageio.loader import load_image

    assert main([rib, "-o", str(out), *SMALL, *argv]) == 0
    return load_image(out)


def test_maxraydepth_reaches_the_option(tmp_path):
    """--maxraydepth 1 renders the Whitted frame of a RIB that sets
    Option "raytrace" "max_ray_depth" [1] (lucille_tpu/cli.py:147); the
    materials scene's mirrors make depth 8 another frame."""
    from test_torch_whitted import material_rib

    text = material_rib()
    opt = 'Option "raytrace" "integer max_ray_depth" [1]\nWorldBegin'
    flag = _render(_rib(tmp_path, text), tmp_path / "flag.hdr",
                   "--method", "whitted", "--maxraydepth", "1")
    in_rib = _render(_rib(tmp_path, text.replace("WorldBegin", opt, 1),
                          "opt.rib"),
                     tmp_path / "rib.hdr", "--method", "whitted")
    deep = _render(_rib(tmp_path, text), tmp_path / "deep.hdr",
                   "--method", "whitted")
    np.testing.assert_array_equal(flag, in_rib)
    assert np.abs(deep - flag).max() > 1e-3


def test_display_flag_selects_the_driver(tmp_path):
    """--display null writes no file; --display openexr writes the frame
    as an .exr (the extension forced, as lucille_tpu's driver does)."""
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.imageio.loader import load_image

    rib = _rib(tmp_path, bundled_rib_text())
    assert main([rib, "-o", str(tmp_path / "none.hdr"), *SMALL,
                 "--display", "null"]) == 0
    assert list(tmp_path.glob("none*")) == []
    assert main([rib, "-o", str(tmp_path / "x.hdr"), *SMALL,
                 "--display", "openexr"]) == 0
    exr = load_image(tmp_path / "x.exr")
    hdr = _render(rib, tmp_path / "y.hdr")
    assert exr.shape == hdr.shape == (16, 16, 3)
    np.testing.assert_allclose(exr, hdr, rtol=2e-2, atol=1e-3)


def test_debug_and_nthreads(tmp_path, monkeypatch):
    """--debug sets the port's logger to DEBUG (base/log.set_debug);
    --nthreads is accepted and changes nothing."""
    from lucille_tpu_torch.base.log import get_logger

    logger = get_logger()
    monkeypatch.setattr(logger, "level", logger.level)
    rib = _rib(tmp_path, bundled_rib_text())
    a = _render(rib, tmp_path / "a.hdr", "--nthreads", "4", "--debug")
    assert logger.level == logging.DEBUG
    b = _render(rib, tmp_path / "b.hdr")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["ao", "whitted", "pathtrace", "dirtmap",
                                    "shader", "bogus"])
def test_method_choices(method, tmp_path, capsys):
    """lucille_tpu's choices (cli.py:56-60) render (shader: each
    geometry's surface shader, matte on the bundled scene); any other
    name is an argparse error."""
    from lucille_tpu_torch.cli import main

    rib = _rib(tmp_path, bundled_rib_text())
    if method == "bogus":
        with pytest.raises(SystemExit) as e:
            main([rib, *SMALL, "--method", method])
        assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err
        return
    img = _render(rib, tmp_path / "m.hdr", "--method", method)
    assert np.isfinite(img).all() and img.mean() > 0.05


def test_recover_end_to_end(tmp_path, monkeypatch):
    """--recover: a render whose display dies after two tiles leaves
    <display name>.ckpt.npz; the next --recover run resumes from it, gives
    the uninterrupted frame and removes the file."""
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.display.drivers import FileDriver
    from lucille_tpu_torch.render.renderer import Renderer

    rib = _rib(tmp_path, bundled_rib_text())
    argv = ["--width", "32", "--height", "32", "--recover"]
    full = _render(rib, tmp_path / "full.hdr", *argv)
    out = tmp_path / "frame.hdr"
    ckpt = tmp_path / "frame.hdr.ckpt.npz"
    write = FileDriver.write
    calls = []

    def dying_write(self, x0, y0, tile):
        calls.append((x0, y0))
        if len(calls) == 2:
            raise KeyboardInterrupt
        write(self, x0, y0, tile)

    monkeypatch.setattr(FileDriver, "write", dying_write)
    with pytest.raises(KeyboardInterrupt):
        main([rib, "-o", str(out), *SMALL, *argv])
    monkeypatch.setattr(FileDriver, "write", write)
    with np.load(ckpt) as data:
        assert int(data["done"].sum()) == 2 and data["done"].size == 4
    tiles = []
    tile = Renderer._tile
    monkeypatch.setattr(Renderer, "_tile", lambda self, *a: (
        tiles.append(a[:2]), tile(self, *a))[1])
    got = _render(rib, out, *argv)
    np.testing.assert_array_equal(got, full)
    assert len(tiles) == 2  # only the tiles the checkpoint lacked
    assert not ckpt.exists()


def test_no_rib_enters_the_shell(monkeypatch, capsys):
    from lucille_tpu_torch.cli import main

    monkeypatch.setattr("sys.stdin", io.StringIO("help\nquit\n"))
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "interactive shell" in out and "view orbit" in out


def test_shell_commands_match_jax(tmp_path):
    """The same commands to both shells leave the same camera; the port's
    shell renders, saves and restores a view, and refuses what is not
    ported with the refusal's message."""
    from lucille_tpu.shell import Shell as JaxShell
    from lucille_tpu_torch.imageio.loader import load_image
    from lucille_tpu_torch.shell import Shell

    rib = _rib(tmp_path, bundled_rib_text())
    view = str(tmp_path / "view")
    shells = (JaxShell(), Shell(device="cpu"))
    for line in (f"file {rib}", "format 24 16", "nsamples 4",
                 "maxdepth 3", "method whitted", "set tile_size 8",
                 f"view save {view}", "view orbit 35 10", "view dolly 0.5",
                 "view pan 0.2 -0.1", "matrix", "stat", "bogus"):
        for sh in shells:
            assert sh.one(line) is True
    jax_state, state = (sh.state for sh in shells)
    np.testing.assert_array_equal(state.camera.camera_to_world,
                                  jax_state.camera.camera_to_world)
    opt, jopt = state.options, jax_state.options
    assert (opt.width, opt.height, opt.gather_nsamples, opt.max_ray_depth,
            opt.render_method, opt.tile_size) == (
        jopt.width, jopt.height, jopt.gather_nsamples, jopt.max_ray_depth,
        jopt.render_method, jopt.tile_size) == (24, 16, 4, 3, "whitted", 8)

    sh = shells[1]
    out = tmp_path / "a.hdr"
    assert sh.one(f"render {out}") is True
    moved = load_image(out)
    assert moved.shape == (16, 24, 3) and np.isfinite(moved).all()
    assert sh.one(f"view load {view}") is True
    assert sh.one(f"g {tmp_path / 'b.hdr'}") is True
    assert np.abs(load_image(tmp_path / "b.hdr") - moved).mean() > 1e-3


@pytest.mark.parametrize("line,refusal", [
    ("accel grid", None), ("method shader", None)])
def test_shell_refusals(line, refusal, tmp_path, capsys):
    """accel grid, refused until the uniform grid was ported, and method
    shader, refused until the RSL compiler was ported, now render: the
    image is written, and nothing names ROADMAP."""
    from lucille_tpu_torch.imageio.loader import load_image
    from lucille_tpu_torch.shell import Shell

    sh = Shell(device="cpu")
    assert sh.one(f"file {_rib(tmp_path, bundled_rib_text())}") is True
    assert sh.one("format 16 12") is True
    assert sh.one(line) is True
    assert sh.one(f"render {tmp_path / 'x.hdr'}") is True
    out = capsys.readouterr().out
    if refusal is None:
        img = load_image(tmp_path / "x.hdr")
        assert img.shape == (12, 16, 3) and 0 < img.mean() < 10
        assert "ROADMAP" not in out
    else:
        assert refusal in out and "Queue 1, item 8" in out
    if line == "accel grid":
        assert sh.renderer.scene.accel == "ugrid"


@pytest.mark.parametrize("argv", [
    ["--accel", "bruteforce"], ["--num-processes", "2"], ["--mesh", "4"],
    ["--process-id", "1"], ["--accel", "grid"]])
def test_refusals_name_the_roadmap(argv, capsys, tmp_path):
    """What the port refused until it was ported now works, and nothing
    names ROADMAP: the accels grid and bruteforce render; --mesh 4 on
    the CPU (four replicas) renders the frame without a mesh;
    --process-id 1 alone is lucille_tpu's single-process no-op, the same
    frame; --num-processes 2 without a coordinator exits naming the
    missing --coordinator."""
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.imageio.loader import load_image

    rib = str(_rib(tmp_path, bundled_rib_text()))
    small = ["--device", "cpu", "--width", "16", "--height", "12",
             "--pixelsamples", "1", "--gather-rays", "4", "--tile", "8"]
    if argv[0] == "--num-processes":
        with pytest.raises(SystemExit) as e:
            main([rib, *argv, *small])
        assert e.value.code != 0
        err = capsys.readouterr().err
        assert "--coordinator" in err and "ROADMAP" not in err
        return
    out = tmp_path / "x.hdr"
    assert main([rib, *argv, "-o", str(out), *small]) == 0
    img = load_image(out)
    assert img.shape == (12, 16, 3) and 0 < img.mean() < 1
    assert "ROADMAP" not in capsys.readouterr().err
    if argv[0] in ("--mesh", "--process-id"):
        assert main([rib, "-o", str(tmp_path / "one.hdr"), *small]) == 0
        np.testing.assert_array_equal(img, load_image(tmp_path / "one.hdr"))


def test_each_refusal_names_its_roadmap_item(monkeypatch, capsys,
                                             tmp_path):
    """No refusal is left, and none names ROADMAP: item 8's multi-device
    flags are accepted (--coordinator and --num-processes each exit
    naming the other, which they need).  What item 7 lifted is accepted
    now: the compile's grid, bruteforce and mxu requests, lucille_tpu's
    grid arrays carried over, the CLI's --accel, the re-binned tile-BVH
    gather."""
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.accel.bvh_ao import gather_mode
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.scene.compile import resolve_accel
    from lucille_tpu_torch.scene.types import from_numpy
    from test_torch_scene import bundled_state

    assert [resolve_accel(a, 10) for a in ("grid", "bruteforce", "mxu")] == [
        ("ugrid", "ugrid"), ("dense", "bruteforce"), ("dense", "mxu")]
    scene = from_numpy(jax_compile(bundled_state(accel="grid",
                                                 pkg="jax").scene), "cpu")
    assert scene.accel == "ugrid" and scene.grid_res > 1
    monkeypatch.setenv("LUCILLE_BVH_AO", "rebinned")
    assert gather_mode() == "rebinned"
    rib = _rib(tmp_path, bundled_rib_text())
    assert main([str(rib), "--accel", "mxu", "-o", str(tmp_path / "m.hdr"),
                 "--device", "cpu", "--width", "8", "--height", "8",
                 "--pixelsamples", "1", "--gather-rays", "4"]) == 0
    assert "ROADMAP" not in capsys.readouterr().err
    # item 8's flags: accepted, and an incomplete set names what it lacks
    assert main([str(rib), "--mesh", "2", "-o", str(tmp_path / "d.hdr"),
                 "--device", "cpu", "--width", "8", "--height", "8",
                 "--pixelsamples", "1", "--gather-rays", "4"]) == 0
    for argv, lacks in ((["--coordinator", "h:1"], "--num-processes"),
                        (["--num-processes", "2"], "--coordinator")):
        with pytest.raises(SystemExit):
            main(["scene.rib", *argv])
        err = capsys.readouterr().err
        assert lacks in err and "ROADMAP" not in err
        assert "not ported" not in err
