"""Display driver implementations + registry.

Interface mirrors ri_display_drv_t (src/render/render.c:224-279):
``open(name, width, height)``, ``write(x0, y0, tile)``, ``close()``,
``progress()``.  Tiles arrive as (th, tw, 3) float32 host arrays — the
bucket_write equivalent (render.c:919-983).

The port's copy of lucille_tpu/display/drivers.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules (the socket
driver is the port's display/sockdrv.py).
"""

from __future__ import annotations

import numpy as np

from lucille_tpu_torch.base.log import LOG_INFO, LOG_WARN, log, log_once
from lucille_tpu_torch.base.registry import Registry


class DisplayDriver:
    name = "null"

    def open(self, fname: str, width: int, height: int) -> bool:
        self.fname = fname
        self.width = width
        self.height = height
        return True

    def write(self, x0: int, y0: int, tile: np.ndarray) -> None:
        pass

    def close(self) -> None:
        pass

    def progress(self, fraction: float) -> None:
        pass


class NullDriver(DisplayDriver):
    """Discard pixels (benchmark runs)."""


class FileDriver(DisplayDriver):
    """Accumulate the frame and write a Radiance .hdr on close.

    Equivalent to hdrdrv.c:24-95 ("file" is an alias for "hdr",
    render.c:259-268).  Float/HDR output is vertically flipped exactly as
    the reference's bucket_write does (``screenheight - y - 1``,
    render.c:944-946), so our .hdr matches lucille's byte layout.
    Non-.hdr extensions dispatch through imageio.save_image (PNG/PFM).
    """

    name = "file"

    def open(self, fname, width, height):
        super().open(fname, width, height)
        self.buffer = np.zeros((height, width, 3), dtype=np.float32)
        return True

    def write(self, x0, y0, tile):
        th, tw = tile.shape[:2]
        # raster row y lands at file row (height - y - 1)
        y1 = self.height - y0
        self.buffer[y1 - th : y1, x0 : x0 + tw] = tile[::-1]

    def close(self):
        from lucille_tpu_torch.imageio.loader import save_image

        fname = self.fname
        if "." not in fname:
            fname += ".hdr"
        save_image(fname, self.buffer)
        log(LOG_INFO, "wrote %s (%dx%d)", fname, self.width, self.height)


class FramebufferDriver(FileDriver):
    """Live preview driver (the reference's framebufferdrv.c GL window).

    A headless container has no window system, but the socket driver
    auto-spawns the port's progressive viewer (tools/rockenfield.py, a
    terminal viewer run as `python -m lucille_tpu_torch.tools.rockenfield`) — so
    ``Display "framebuffer"`` routes THERE first: live tiles appear as
    they finish, exactly the framebufferdrv experience.  When the socket
    path cannot come up (viewer spawn disabled or connect fails), the
    reference's fallback chain applies (render.c:430-513: unavailable
    driver -> "file") and the frame lands in a .hdr instead.
    """

    name = "framebuffer"

    def __init__(self):
        self._sock = None  # live SocketDriver when the viewer came up

    def open(self, fname, width, height):
        from lucille_tpu_torch.display.sockdrv import SocketDriver

        sock = SocketDriver()
        # bounded wait on the framebuffer route: if the spawned viewer
        # never listens, fall back to file output in seconds, not 30
        sock.spawn_wait = 6.0
        if sock.open(fname or "framebuffer", width, height):
            self._sock = sock
            return True
        log_once(
            LOG_WARN,
            "framebuffer display: viewer unavailable; falling back to file output",
        )
        if not fname or fname == "framebuffer":
            fname = "framebuffer_out.hdr"
        return super().open(fname, width, height)

    def write(self, x0, y0, tile):
        if self._sock is not None:
            self._sock.write(x0, y0, tile)
        else:
            super().write(x0, y0, tile)

    def close(self):
        if self._sock is not None:
            self._sock.close()
        else:
            super().close()

    def progress(self, fraction):
        if self._sock is not None:
            self._sock.progress(fraction)


class OpenEXRDriver(FileDriver):
    """OpenEXR output (openexrdrv.c, registered under HAVE_OPENEXR at
    render.c:166-234).  Uses the built-in scanline codec (imageio/exr.py);
    forces an .exr extension so save_image dispatches to it."""

    name = "openexr"

    def open(self, fname, width, height):
        if "." not in fname:
            fname += ".exr"
        elif not fname.lower().endswith(".exr"):
            fname = fname.rsplit(".", 1)[0] + ".exr"
        return super().open(fname, width, height)


_registry: Registry = Registry("display")


def register_display_driver(name: str, factory) -> None:
    _registry.register(name, factory)


def get_display_driver(name: str) -> DisplayDriver:
    """Lookup with the reference's fallback chain: unknown -> file."""
    factory = _registry.lookup(name, fallback="file")
    return factory()


def _socket_factory():
    from lucille_tpu_torch.display.sockdrv import SocketDriver

    return SocketDriver()


# default registrations (ri_render_init, render.c:224-279)
register_display_driver("file", FileDriver)
register_display_driver("hdr", FileDriver)
register_display_driver("openexr", OpenEXRDriver)
register_display_driver("exr", OpenEXRDriver)
register_display_driver("framebuffer", FramebufferDriver)
register_display_driver("fb", FramebufferDriver)
register_display_driver("null", NullDriver)
register_display_driver("socket", _socket_factory)
