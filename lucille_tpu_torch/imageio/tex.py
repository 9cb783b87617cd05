"""Blocked, mipmapped `.tex` texture format (reader + writer).

The reference defines this format in src/render/texture_loader.c:8-90 and
write_blockedmipmap (texture_loader.c:703-744): a zlib(gzip) stream with an
int32 header [nmiplevels, width, height, nxblocks, nyblocks] followed, per
miplevel i, by (nxblocks>>i) * (nyblocks>>i) row-major texture blocks of
TEXBLOCKSIZE x TEXBLOCKSIZE texels.  Texels are 4-float RGBA vectors
(texblock_t.image is ri_vector_t*, texture_loader.c:66-73); blocks tile the
level-i image, edge blocks zero-padded.

NB the reference's own generator/writer sits inside `#if 0 // TODO`
(texture_loader.c:666, 703) — lucille never actually shipped files in this
format.  This module implements BOTH directions of the documented layout so
the capability is complete here: `write_tex` produces the file the
reference *specified*, `read_tex` (and `load_image` dispatch) consumes it.

Little-endian float32 (the reference writes raw ri_float_t; the build
default `use_double` would make that float64 — we store float32, the
render-time texel type of ri_texture_t, and accept either on read by
sniffing the stream size).

The port's copy of lucille_tpu/imageio/tex.py: the same code (NumPy and the
standard library only).
"""

from __future__ import annotations

import gzip

import numpy as np

TEXBLOCKSIZE = 64  # block edge in texels (texture_loader.c:61)
MAXMIPLEVEL = 16  # texture_loader.c:62


def _mip_levels(w: int, h: int) -> int:
    n = 1
    while (w >> n) >= 1 and (h >> n) >= 1 and n < MAXMIPLEVEL:
        n += 1
    return n


def write_tex(path, image: np.ndarray) -> None:
    """Write (H, W, 3|4) float image as a blocked mipmap `.tex`."""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim != 3:
        raise ValueError("write_tex expects (H, W, C)")
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=-1)
    ts = TEXBLOCKSIZE
    nxblocks = -(-w // ts)
    nyblocks = -(-h // ts)
    nmip = _mip_levels(nxblocks, nyblocks) if min(nxblocks, nyblocks) > 0 else 1

    with gzip.open(path, "wb") as f:
        f.write(
            np.asarray([nmip, w, h, nxblocks, nyblocks], "<i4").tobytes()
        )
        level = img
        for i in range(nmip):
            lh, lw = level.shape[:2]
            # block grid per level: ceil((dim>>i)/ts) — identical to the
            # reference's nxblocks>>i for power-of-two dims, and robust
            # for the general sizes its TODO writer never handled
            xb = max(-(-lw // ts), 1)
            yb = max(-(-lh // ts), 1)
            # zero-pad the level to the block grid, then emit blocks
            # row-major (write_blockedmipmap's v-then-u order)
            padded = np.zeros((yb * ts, xb * ts, 4), np.float32)
            padded[:lh, :lw] = level
            blocks = padded.reshape(yb, ts, xb, ts, 4).transpose(0, 2, 1, 3, 4)
            f.write(np.ascontiguousarray(blocks, "<f4").tobytes())
            # next mip level: 2x2 box filter (texture_loader.c:368-403
            # capability)
            nh, nw = max(lh // 2, 1), max(lw // 2, 1)
            lvl = level[: nh * 2, : nw * 2]
            if lh >= 2 and lw >= 2:
                level = 0.25 * (
                    lvl[0::2, 0::2] + lvl[1::2, 0::2]
                    + lvl[0::2, 1::2] + lvl[1::2, 1::2]
                )
            else:
                level = level[:nh, :nw]


def read_tex(path, level: int = 0) -> np.ndarray:
    """Read one mip level of a `.tex` blocked mipmap as (H, W, 3) f32."""
    with gzip.open(path, "rb") as f:
        head = np.frombuffer(f.read(20), "<i4")
        if head.size != 5:
            raise ValueError("truncated .tex header")
        nmip, w, h, nxblocks, nyblocks = (int(x) for x in head)
        if not (0 < nmip <= MAXMIPLEVEL) or w <= 0 or h <= 0:
            raise ValueError("not a lucille .tex blocked mipmap")
        payload = f.read()
    ts = TEXBLOCKSIZE
    def _grid(i):
        lw = max(w >> i, 1)
        lh = max(h >> i, 1)
        return max(-(-lw // ts), 1), max(-(-lh // ts), 1)

    nblocks_total = sum(
        _grid(i)[0] * _grid(i)[1] for i in range(nmip)
    )
    f32_size = nblocks_total * ts * ts * 4 * 4
    if len(payload) >= f32_size * 2:
        texels = np.frombuffer(payload, "<f8").astype(np.float32)
    else:
        texels = np.frombuffer(payload[:f32_size], "<f4")
    if level >= nmip:
        raise ValueError(f"mip level {level} >= nmiplevels {nmip}")
    off = 0
    for i in range(level):
        gx, gy = _grid(i)
        off += gx * gy * ts * ts * 4
    xb, yb = _grid(level)
    blocks = texels[off : off + yb * xb * ts * ts * 4].reshape(
        yb, xb, ts, ts, 4
    )
    img = blocks.transpose(0, 2, 1, 3, 4).reshape(yb * ts, xb * ts, 4)
    lh = max(h >> level, 1)
    lw = max(w >> level, 1)
    return np.ascontiguousarray(img[:lh, :lw, :3])
