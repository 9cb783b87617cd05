"""The socket display (display/sockdrv.py) and the framebuffer route,
against lucille_tpu's (lucille_tpu/display/sockdrv.py, drivers.py).

A `chip_smoke.SocketListener` on a free localhost port stands in for the
viewer: it records every byte the driver sends and reassembles the frame.
The two packages' drivers must send the same bytes for the same tiles
(exactly); the CLI's socket display must stream the frame its file
display writes (exactly: the file is a .pfm, f32 like the wire).  Every
test sets LUCILLE_NO_SPAWN_VIEWER=1 but the one that spawns the port's
viewer, `python -m lucille_tpu_torch.tools.rockenfield`.
"""

import socket

import numpy as np
import pytest

from chip_smoke import SocketListener
from test_torch_scene import bundled_rib_text
from test_torch_scene import one_torch_thread  # noqa: F401


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(autouse=True)
def no_viewer(monkeypatch):
    monkeypatch.setenv("LUCILLE_NO_SPAWN_VIEWER", "1")


def _tiles(w=40, h=36):
    """Tiles covering a (h, w) frame, one past the 1024-pixel batch
    (32x32, sockdrv_defs.h:7-19) and some partial: [(x0, y0, tile)]."""
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 5, (h, w, 3)).astype(np.float32)
    cuts = [(0, 0, 33, 32), (33, 0, w, 32), (0, 32, w, h)]
    return frame, [(x0, y0, frame[y0:y1, x0:x1])
                   for x0, y0, x1, y1 in cuts]


def _stream(driver_cls, tiles, w, h):
    lis = SocketListener()
    drv = driver_cls(port=lis.port)
    assert drv.open("live", w, h)
    for x0, y0, tile in tiles:
        drv.write(x0, y0, tile)
    drv.close()
    return lis.join()


def test_socket_wire_bytes_match_jax():
    from lucille_tpu.display.sockdrv import SocketDriver as JaxDriver
    from lucille_tpu_torch.display.sockdrv import SocketDriver

    frame, tiles = _tiles()
    got = _stream(SocketDriver, tiles, 40, 36)
    want = _stream(JaxDriver, tiles, 40, 36)
    assert got.finished and want.finished
    assert got.raw == want.raw
    # NEW (12 bytes), PIXEL batches of 1024 + 32, 224 and 160 pixels (8
    # bytes of header, 20 a pixel), FINISH
    assert len(got.raw) == 12 + 4 * 8 + 40 * 36 * 20 + 4
    np.testing.assert_array_equal(got.frame, frame)


def test_socket_driver_without_a_viewer():
    """Nothing listening and no viewer to spawn: open fails at once (no
    5 s retry), no viewer runs, writes and close do nothing; as
    lucille_tpu's."""
    import time

    from lucille_tpu.display.sockdrv import SocketDriver as JaxDriver
    from lucille_tpu_torch.display.sockdrv import SocketDriver

    for cls in (SocketDriver, JaxDriver):
        drv = cls(port=_free_port())
        t0 = time.perf_counter()
        assert drv.open("none", 4, 4) is False
        assert time.perf_counter() - t0 < 3.0
        assert drv.sock is None and drv._viewer is None
        drv.write(0, 0, np.ones((4, 4, 3), np.float32))
        drv.close()


def test_socket_port_from_the_environment(monkeypatch):
    from lucille_tpu_torch.display.drivers import get_display_driver
    from lucille_tpu_torch.display.sockdrv import DEFAULT_PORT, SocketDriver

    monkeypatch.delenv("LUCILLE_SOCKET_PORT", raising=False)
    assert SocketDriver().port == DEFAULT_PORT == 12346
    monkeypatch.setenv("LUCILLE_SOCKET_PORT", "23456")
    drv = get_display_driver("socket")
    assert isinstance(drv, SocketDriver) and drv.port == 23456
    assert drv.spawn_wait == 30.0


def test_framebuffer_routes_to_the_socket(monkeypatch, tmp_path):
    """Display "framebuffer" streams to the viewer on LUCILLE_SOCKET_PORT
    with a 6 s spawn wait, and writes no file."""
    from lucille_tpu_torch.display.drivers import get_display_driver

    frame, tiles = _tiles(24, 20)
    lis = SocketListener()
    monkeypatch.setenv("LUCILLE_SOCKET_PORT", str(lis.port))
    monkeypatch.chdir(tmp_path)
    drv = get_display_driver("framebuffer")
    assert drv.open("framebuffer", 24, 20)
    assert drv._sock is not None and drv._sock.spawn_wait == 6.0
    for x0, y0, tile in [(0, 0, frame[:, :16]), (16, 0, frame[:, 16:])]:
        drv.write(x0, y0, tile)
    drv.progress(1.0)
    drv.close()
    lis.join()
    assert lis.finished
    np.testing.assert_array_equal(lis.frame, frame)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["fb.hdr", "framebuffer"])
def test_framebuffer_falls_back_to_a_file(monkeypatch, tmp_path, name):
    """No viewer: the frame lands in the file it names, or in
    framebuffer_out.hdr for the bare "framebuffer" (render.c:430-513's
    fallback to "file"), as lucille_tpu's does."""
    from lucille_tpu.display.drivers import get_display_driver as jax_get
    from lucille_tpu_torch.display.drivers import get_display_driver
    from lucille_tpu_torch.imageio.rgbe import read_hdr

    monkeypatch.setenv("LUCILLE_SOCKET_PORT", str(_free_port()))
    tile = np.linspace(0.1, 2.0, 4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    files = {}
    for pkg, get in (("torch", get_display_driver), ("jax", jax_get)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        drv = get("framebuffer")
        assert drv.open(name, 6, 4)
        assert drv._sock is None
        drv.write(0, 0, tile)
        drv.close()
        files[pkg] = d / ("fb.hdr" if name == "fb.hdr"
                          else "framebuffer_out.hdr")
    assert files["torch"].read_bytes() == files["jax"].read_bytes()
    np.testing.assert_allclose(read_hdr(files["torch"])[::-1], tile,
                               rtol=1e-2)


def test_cli_socket_display_streams_the_file_displays_frame(monkeypatch,
                                                            tmp_path):
    """--display socket: the CLI streams its frame to the viewer; the
    frame equals the one --display file writes with the same command
    (a .pfm, exact)."""
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.imageio.loader import load_image

    rib = tmp_path / "scene.rib"
    rib.write_text(bundled_rib_text())
    argv = [str(rib), "--device", "cpu", "--width", "32", "--height", "24",
            "--pixelsamples", "1", "--gather-rays", "4", "--tile", "16"]
    lis = SocketListener()
    monkeypatch.setenv("LUCILLE_SOCKET_PORT", str(lis.port))
    assert main([*argv, "-o", str(tmp_path / "live.pfm"),
                 "--display", "socket"]) == 0
    lis.join()
    assert main([*argv, "-o", str(tmp_path / "f.pfm"),
                 "--display", "file"]) == 0
    want = load_image(tmp_path / "f.pfm")[::-1]  # the file driver flips
    assert lis.finished and lis.frame.shape == (24, 32, 3)
    assert 0.1 < want.mean() < 1.0
    np.testing.assert_array_equal(lis.frame, want)
    assert not (tmp_path / "live.pfm").exists()


def test_socket_driver_spawns_the_ports_viewer(monkeypatch, tmp_path):
    """Nothing listening: the driver spawns the port's viewer (python -m
    lucille_tpu_torch.tools.rockenfield, nothing under tools_tpu) with
    --port alone, from a working directory outside the repo, connects to
    it, streams, and the viewer exits cleanly on FINISH."""
    from lucille_tpu_torch.display.sockdrv import SocketDriver

    monkeypatch.delenv("LUCILLE_NO_SPAWN_VIEWER")
    monkeypatch.chdir(tmp_path)
    port = _free_port()
    drv = SocketDriver(port=port)
    try:
        assert drv.open("spawned", 8, 8)
        viewer = drv._viewer
        assert viewer is not None and drv.sock is not None
        assert viewer.args[1:] == ["-m", "lucille_tpu_torch.tools.rockenfield",
                                   "--port", str(port)]
        assert not any("tools_tpu" in str(a) for a in viewer.args)
        drv.write(0, 0, np.full((8, 8, 3), 0.5, np.float32))
    finally:
        viewer = drv._viewer
        drv.close()
    assert viewer.poll() == 0
