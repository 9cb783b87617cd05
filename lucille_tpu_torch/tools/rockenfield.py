"""rockenfield: live progressive render viewer over TCP.

The port's counterpart of tools_tpu/rockenfield.py (the successor of the
reference's tools/rockenfield/rockenfield.cpp, an FLTK+OpenGL socket
viewer): a dependency-free server that speaks the sockdrv protocol
(display/sockdrv.py; reference sockdrv_defs.h:6-19) and shows progress
either as a terminal preview (ANSI half-block rendering, updated every
32 * 32 * 8 pixels) or headlessly, writing the accumulated frame to an
.hdr through the port's imageio/rgbe when the renderer sends
COMMAND_FINISH.  The same protocol, flags, printed lines and preview as
the original; it imports numpy and, for --out, the port's RGBE codec,
and nothing else of the repository.  Pixels are received into a buffer
in place (recv_into); the bytes on the wire are the original's.

Usage:
    python -m lucille_tpu_torch.tools.rockenfield [--port 12346]
        [--out out.hdr] [--quiet] [--serve-forever]
then render with a socket display:
    python -m lucille_tpu_torch.cli scene.rib --display socket
    (or Display "x" "socket" "rgb" in the RIB)
The socket display spawns this module itself (with --port alone) when
nothing listens on its port.
"""

from __future__ import annotations

import argparse
import socket
import struct
import sys

import numpy as np

COMMAND_NEW = 0
COMMAND_PIXEL = 1
COMMAND_FINISH = 2
COMMAND_CANCEL = 3

PREVIEW_EVERY = 32 * 32 * 8  # pixels between terminal previews


def _recv_exact(conn, n: int, buf: bytearray) -> memoryview:
    """n bytes from conn, received in place into buf (or into a new
    buffer where buf is too small)."""
    if len(buf) < n:
        buf = bytearray(n)
    view = memoryview(buf)[:n]
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("client closed")
        got += k
    return view


def _terminal_preview(img, max_cols=100):
    """ANSI truecolor half-block preview of the accumulation buffer."""
    h, w = img.shape[:2]
    cols = min(max_cols, w)
    rows = max(2, int(cols * h / w / 1.0)) & ~1
    ys = np.linspace(0, h - 1, rows).astype(int)
    xs = np.linspace(0, w - 1, cols).astype(int)
    small = np.clip(img[np.ix_(ys, xs)] ** (1 / 2.2) * 255, 0, 255).astype(int)
    out = []
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(cols):
            tr, tg, tb = small[r, c]
            br, bg, bb = small[r + 1, c]
            line.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def serve(port=12346, out=None, quiet=False, once=True):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(1)
    print(f"[rockenfield] listening on 127.0.0.1:{port}", flush=True)
    buf = bytearray(8 + 1024 * 5 * 4)  # a header, or a 32x32 batch
    while True:
        conn, addr = srv.accept()
        print(f"[rockenfield] renderer connected from {addr}")
        img = None
        npixels = 0
        try:
            while True:
                (cmd,) = struct.unpack("<i", _recv_exact(conn, 4, buf))
                if cmd == COMMAND_NEW:
                    w, h = struct.unpack("<ii", _recv_exact(conn, 8, buf))
                    img = np.zeros((h, w, 3), dtype=np.float32)
                    print(f"[rockenfield] new frame {w}x{h}")
                elif cmd == COMMAND_PIXEL:
                    (count,) = struct.unpack("<i", _recv_exact(conn, 4, buf))
                    data = np.frombuffer(
                        _recv_exact(conn, count * 5 * 4, buf), dtype="<f4"
                    ).reshape(count, 5)
                    if img is not None:
                        xs = data[:, 0].astype(int).clip(0, img.shape[1] - 1)
                        ys = data[:, 1].astype(int).clip(0, img.shape[0] - 1)
                        img[ys, xs] = data[:, 2:5]
                        npixels += count
                        if not quiet and npixels % PREVIEW_EVERY == 0:
                            sys.stdout.write(
                                "\x1b[H\x1b[2J" + _terminal_preview(img) + "\n"
                            )
                            sys.stdout.flush()
                elif cmd == COMMAND_FINISH:
                    print(f"[rockenfield] frame complete ({npixels} pixels)")
                    if img is not None:
                        if not quiet:
                            print(_terminal_preview(img))
                        if out:
                            from lucille_tpu_torch.imageio.rgbe import write_hdr

                            write_hdr(out, img)
                            print(f"[rockenfield] wrote {out}")
                    break
                else:
                    print(f"[rockenfield] unknown command {cmd}")
                    break
        except ConnectionError as e:
            print(f"[rockenfield] {e}")
        finally:
            conn.close()
        if once:
            srv.close()
            return img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=12346)
    ap.add_argument("--out", help="write accumulated frame to .hdr on finish")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--serve-forever", action="store_true")
    a = ap.parse_args(argv)
    serve(a.port, a.out, a.quiet, once=not a.serve_forever)
    return 0


if __name__ == "__main__":
    sys.exit(main())
