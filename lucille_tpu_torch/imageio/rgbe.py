"""Radiance RGBE (.hdr) reader/writer with RLE scanlines.

Equivalent capability to the reference's rgbe codec (src/imageio/rgbe.c,
Bruce Walter's classic implementation of Greg Ward's format): shared
8-bit exponent per pixel, new-style RLE scanline encoding, minimal
header.  This is a fresh NumPy-vectorized implementation of the published
format (header "#?RADIANCE", FORMAT=32-bit_rle_rgbe, "-Y H +X W"
scanline order: row 0 is the top of the image).

The port's copy of lucille_tpu/imageio/rgbe.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

import numpy as np


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float -> (..., 4) uint8 RGBE (shared-exponent encode).

    The scale factor is m*256/v = exactly 2^(8-e) (the mantissa cancels),
    so the frexp exponent is read straight from the float32 bit pattern —
    16x faster than the float64 frexp/divide formulation and verified
    byte-identical (denormals fall under the 1e-32 zero threshold)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.float32)
    out = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    v = rgb.max(axis=-1)
    pos = v >= 1e-32
    vs = np.where(pos, v, 1.0).astype(np.float32)
    bits = vs.view(np.uint32)
    e = ((bits >> 23) & 0xFF).astype(np.int32) - 126  # frexp exponent
    scale = np.ldexp(np.float64(1.0), 8 - e)  # exact power of two
    enc = np.clip(
        rgb.astype(np.float64) * scale[..., None], 0.0, 255.0
    ).astype(np.uint8)
    out[..., :3] = np.where(pos[..., None], enc, 0)
    out[..., 3] = np.where(pos, (e + 128).astype(np.uint8), 0)
    return out


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = np.asarray(rgbe, dtype=np.uint8)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32))


def _rle_encode_component(comp: np.ndarray) -> bytes:
    """New-style RLE for one scanline component (uint8 vector)."""
    out = bytearray()
    n = len(comp)
    i = 0
    while i < n:
        # find a run of >= 4 identical bytes
        run_start = i
        run_len = 1
        while run_start + run_len < n and run_len < 127 and comp[run_start + run_len] == comp[run_start]:
            run_len += 1
        if run_len >= 4:
            out.append(128 + run_len)
            out.append(int(comp[run_start]))
            i += run_len
        else:
            # literal: scan forward until a >=4 run starts or 128 bytes
            j = i
            while j < n and j - i < 128:
                # does a run of 4 start at j?
                if j + 3 < n and comp[j] == comp[j + 1] == comp[j + 2] == comp[j + 3]:
                    break
                j += 1
            cnt = j - i
            if cnt == 0:
                cnt = 1
                j = i + 1
            out.append(cnt)
            out.extend(comp[i:j].tobytes())
            i = j
    return bytes(out)


def _native_encode(rgbe: np.ndarray, w: int, h: int):
    """RLE-encode scanlines with the C++ codec (native/rgbe_codec.cpp);
    byte-identical to the Python path, ~2 orders of magnitude faster.
    None -> caller falls back to Python."""
    from lucille_tpu_torch.native.loader import get_rgbe_lib

    lib = get_rgbe_lib()
    if lib is None:
        return None
    import ctypes

    src = np.ascontiguousarray(rgbe, dtype=np.uint8)
    cap = h * (4 * (w + w // 128 + 2) + 8) + 64
    out = np.empty(cap, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.rgbe_encode_scanlines(
        src.ctypes.data_as(u8p), w, h, out.ctypes.data_as(u8p), cap
    )
    if n <= 0:
        return None
    return out[:n].tobytes()


def _native_decode(buf: np.ndarray, w: int, h: int):
    """Decode RLE/flat scanlines with the C++ codec.  Returns (h, w, 4)
    uint8 or None to fall back to Python."""
    from lucille_tpu_torch.native.loader import get_rgbe_lib

    lib = get_rgbe_lib()
    if lib is None:
        return None
    import ctypes

    src = np.ascontiguousarray(buf, dtype=np.uint8)
    img = np.empty((h, w, 4), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.rgbe_decode_scanlines(
        src.ctypes.data_as(u8p), len(src), w, h, img.ctypes.data_as(u8p)
    )
    if n < 0:
        return None
    return img


def write_hdr(path, image: np.ndarray, software: str = "lucille_tpu") -> None:
    """Write (H, W, 3) float image as RLE RGBE .hdr.

    Row 0 is written as the TOP scanline ("-Y H +X W"), matching the
    reference hdr driver's raster order (hdrdrv.c buffers pixels at
    y*width+x and streams rows in order).
    """
    image = np.asarray(image)
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(f"SOFTWARE={software}\n".encode())
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        rgbe = float_to_rgbe(image[..., :3])
        if w < 8 or w > 0x7FFF:
            f.write(rgbe.tobytes())  # flat format for unencodable widths
            return
        enc = _native_encode(rgbe, w, h)
        if enc is not None:
            f.write(enc)
            return
        for y in range(h):
            f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
            for c in range(4):
                f.write(_rle_encode_component(rgbe[y, :, c]))


def read_hdr(path) -> np.ndarray:
    """Read a Radiance .hdr into (H, W, 3) float32 (top row first)."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; the next line is the resolution
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        lines.append(line)
    if not lines or not lines[0].startswith(b"#?"):
        raise ValueError("not a Radiance file")
    res = data[pos : data.index(b"\n", pos)]
    pos = data.index(b"\n", pos) + 1
    parts = res.split()
    if len(parts) != 4 or parts[0] != b"-Y" or parts[2] != b"+X":
        raise ValueError(f"unsupported resolution line: {res!r}")
    h, w = int(parts[1]), int(parts[3])

    buf = np.frombuffer(data, dtype=np.uint8, offset=pos)
    native = _native_decode(buf, w, h)
    if native is not None:
        return rgbe_to_float(native)
    img = np.zeros((h, w, 4), dtype=np.uint8)
    bi = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[bi] != 2 or buf[bi + 1] != 2:
            # flat (possibly old-style RLE, not produced by us or lucille)
            row = buf[bi : bi + w * 4].reshape(w, 4)
            img[y] = row
            bi += w * 4
            continue
        assert (int(buf[bi + 2]) << 8 | int(buf[bi + 3])) == w, "scanline width mismatch"
        bi += 4
        for c in range(4):
            x = 0
            while x < w:
                code = int(buf[bi])
                bi += 1
                if code > 128:  # run
                    cnt = code - 128
                    img[y, x : x + cnt, c] = buf[bi]
                    bi += 1
                    x += cnt
                else:  # literal
                    img[y, x : x + code, c] = buf[bi : bi + code]
                    bi += code
                    x += code
    return rgbe_to_float(img)
