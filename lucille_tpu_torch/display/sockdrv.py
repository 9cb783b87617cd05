"""Socket display driver: stream tiles to a live viewer over TCP.

Implements the reference's sockdrv protocol (src/display/sockdrv.c,
sockdrv_defs.h): connect to localhost:12346 with retry, send COMMAND_NEW
with {width, height}, stream COMMAND_PIXEL batches, finish with
COMMAND_FINISH; the server may push COMMAND_CANCEL.  The companion viewer
is the port's tools/rockenfield.py (the reference's FLTK viewer
re-imagined as a dependency-free terminal viewer), a separate program
that speaks the protocol: it is spawned as a module
(`python -m lucille_tpu_torch.tools.rockenfield`), never imported.

Wire format (little-endian int32s, matching sockdrv_defs.h:6-19):
    NEW    = 0, followed by width, height
    PIXEL  = 1, followed by count, then count * {x, y, r, g, b} (f32 rgb)
    FINISH = 2
    CANCEL = 3 (server -> renderer)

The port's copy of lucille_tpu/display/sockdrv.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules, and the port's
own viewer spawned in place of lucille_tpu's tools_tpu/rockenfield.py.
The spawned viewer gets --port alone, as lucille_tpu's does.
"""

from __future__ import annotations

import socket
import struct
import time

import numpy as np

from lucille_tpu_torch.base.log import LOG_INFO, LOG_WARN, log
from lucille_tpu_torch.display.drivers import DisplayDriver

COMMAND_NEW = 0
COMMAND_PIXEL = 1
COMMAND_FINISH = 2
COMMAND_CANCEL = 3

DEFAULT_PORT = 12346  # sockdrv_defs.h:6
BATCH = 32 * 32  # 32x32-pixel batches (sockdrv_defs.h:7-19)


class SocketDriver(DisplayDriver):
    name = "socket"

    def __init__(self, host: str = "127.0.0.1", port: int | None = None):
        import os

        self.host = host
        # LUCILLE_SOCKET_PORT overrides (framebuffer routing + tests)
        self.port = (
            port
            if port is not None
            else int(os.environ.get("LUCILLE_SOCKET_PORT", DEFAULT_PORT))
        )
        self.sock: socket.socket | None = None
        self._viewer = None  # auto-spawned rockenfield process
        # how long open() waits for a freshly-spawned viewer to listen.
        # Explicit Display "socket" keeps the generous window (a slow
        # interpreter start under full CPU contention measured >5 s);
        # the framebuffer ROUTE lowers it so headless/batch runs fall
        # back to file output without a 30 s stall (ADVICE r4)
        self.spawn_wait = 30.0

    def _spawn_viewer(self) -> bool:
        """Launch the port's viewer, `python -m
        lucille_tpu_torch.tools.rockenfield`, as the progressive viewer
        (the reference's viewer-fork, sockdrv.c:154-190), with the
        directory holding this package first on the child's PYTHONPATH,
        so it starts from any working directory.  Disable with
        LUCILLE_NO_SPAWN_VIEWER=1 (tests, headless batch jobs)."""
        import os
        import subprocess
        import sys
        from pathlib import Path

        if os.environ.get("LUCILLE_NO_SPAWN_VIEWER") == "1":
            return False
        root = str(Path(__file__).resolve().parents[2])
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ,
                   PYTHONPATH=root if not path else root + os.pathsep + path)
        try:
            self._viewer = subprocess.Popen(
                [sys.executable, "-m", "lucille_tpu_torch.tools.rockenfield",
                 "--port", str(self.port)],
                stdin=subprocess.DEVNULL, env=env,
            )
        except OSError as e:
            log(LOG_WARN, "cannot spawn viewer: %s", e)
            return False
        log(LOG_INFO, "spawned rockenfield viewer (pid %d) on port %d",
            self._viewer.pid, self.port)
        return True

    def open(self, fname, width, height):
        super().open(fname, width, height)
        # connect-with-retry; when nothing listens locally, auto-spawn the
        # rockenfield viewer first, exactly like the reference forks its
        # viewer and retries (sockdrv.c:154-190)
        spawned = False
        deadline = time.time() + 5.0
        while time.time() < deadline:
            try:
                self.sock = socket.create_connection(
                    (self.host, self.port), timeout=1.0
                )
                break
            except OSError:
                if not spawned and self.host in ("127.0.0.1", "localhost"):
                    spawned = True
                    if self._spawn_viewer():
                        # we KNOW a viewer is coming: allow for a slow
                        # interpreter start on a loaded host (measured
                        # >5 s under full CPU contention)
                        deadline = time.time() + self.spawn_wait
                    else:
                        # nothing listening and no viewer to wait for:
                        # fail fast so callers (framebuffer fallback
                        # chain) don't stall 5 s per render
                        break
                time.sleep(0.2)
        if self.sock is None:
            log(LOG_WARN, "socket display: no viewer on %s:%d", self.host, self.port)
            return False
        self.sock.sendall(struct.pack("<iii", COMMAND_NEW, width, height))
        log(LOG_INFO, "socket display connected to %s:%d", self.host, self.port)
        return True

    def write(self, x0, y0, tile):
        if self.sock is None:
            return
        th, tw = tile.shape[:2]
        ys, xs = np.mgrid[0:th, 0:tw]
        flat = np.concatenate(
            [
                (xs + x0).reshape(-1, 1).astype(np.float32),
                (ys + y0).reshape(-1, 1).astype(np.float32),
                tile.reshape(-1, 3).astype(np.float32),
            ],
            axis=1,
        )
        for i in range(0, len(flat), BATCH):
            chunk = flat[i : i + BATCH]
            try:
                self.sock.sendall(
                    struct.pack("<ii", COMMAND_PIXEL, len(chunk)) + chunk.tobytes()
                )
            except OSError:
                self.sock = None
                return

    def close(self):
        if self.sock is not None:
            try:
                self.sock.sendall(struct.pack("<i", COMMAND_FINISH))
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        if self._viewer is not None:
            try:  # let the spawned viewer finish its final frame dump
                self._viewer.wait(timeout=5)
            except Exception:
                self._viewer.terminate()
            self._viewer = None
