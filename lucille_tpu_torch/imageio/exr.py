"""Minimal OpenEXR scanline codec (pure numpy).

The reference ships an OpenEXR display driver behind ``HAVE_OPENEXR``
(src/display/openexrdrv.c, registered at src/render/render.c:166-234).
This environment has no OpenEXR library, so the codec is implemented
directly: single-part scanline images, HALF or FLOAT channels.  Writing
emits NO_COMPRESSION (universally readable) or ZIP; reading also
accepts ZIP (16-line blocks), ZIPS (1-line) and RLE — the compressions
a DCC most commonly saves — so externally-produced EXRs load as
textures/IBL maps.  numpy's float16 is IEEE 754 binary16, i.e. exactly
EXR's HALF.

Layout (OpenEXR 2.0 file format):
  magic int32 20000630 | version int32 2 | header attributes
  (name\\0 type\\0 size data)* \\0 | scanline offset table (uint64 per
  block) | blocks of (y int32, bytesize int32, channel-planar pixels).

The port's copy of lucille_tpu/imageio/exr.py: the same code (NumPy and the
standard library only).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXELTYPE = {"half": 1, "float": 2}
_DTYPE = {1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


_COMPRESSION_IDS = {"none": 0, "rle": 1, "zips": 2, "zip": 3}


def _rle_encode(data: bytes) -> bytes:
    """OpenEXR RLE encoder (ImfRle.cpp): repeat runs of >= 3 as
    (count-1, byte); everything else as (-(count), literals)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(data[i])
            i += run
        else:
            j = i
            # literal run: stop at the next >= 3 repeat or 127 bytes
            while (
                j < n
                and j - i < 127
                and not (
                    j + 2 < n and data[j] == data[j + 1] == data[j + 2]
                )
            ):
                j += 1
            out.append(256 - (j - i))
            out += data[i:j]
            i = j
    return bytes(out)


def write_exr(path, img: np.ndarray, pixel_type: str = "half",
              compression: str = "none") -> None:
    """Write (H, W, 3) float RGB as a scanline EXR.

    compression: "none" (default — universally readable), "zip"
    (16-line zlib blocks), "zips" (per-line zlib) or "rle", matching
    what full OpenEXR writes (openexrdrv.c links the real library)."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
    H, W, _ = img.shape
    ptype = _PIXELTYPE[pixel_type]
    dt = _DTYPE[ptype]
    comp_id = _COMPRESSION_IDS[compression]

    # channel list, alphabetical as the format requires: B, G, R
    ch = b""
    for name in (b"B", b"G", b"R"):
        ch += name + b"\0" + struct.pack("<i", ptype) + b"\x01\0\0\0" + struct.pack("<ii", 1, 1)
    ch += b"\0"

    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = b"".join(
        [
            _attr(b"channels", b"chlist", ch),
            _attr(b"compression", b"compression", bytes([comp_id])),
            _attr(b"dataWindow", b"box2i", box),
            _attr(b"displayWindow", b"box2i", box),
            _attr(b"lineOrder", b"lineOrder", b"\0"),  # INCREASING_Y
            _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
            _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
            _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    # channel-planar scanlines in B, G, R order
    planar = np.ascontiguousarray(img[:, :, ::-1].transpose(0, 2, 1)).astype(dt)

    lines = 16 if comp_id == 3 else 1
    nchunks = -(-H // lines)
    chunks = []
    for c in range(nchunks):
        y0 = c * lines
        nl = min(lines, H - y0)
        payload = planar[y0 : y0 + nl].tobytes()
        if comp_id:
            filt = _exr_filter(payload)
            enc = (
                _rle_encode(filt) if comp_id == 1 else zlib.compress(filt)
            )
            if len(enc) >= len(payload):
                enc = payload  # incompressible chunk stored raw
        else:
            enc = payload
        chunks.append((y0, enc))

    pre = 4 + 4 + len(header)
    table_size = 8 * nchunks
    offsets = []
    off = pre + table_size
    for _y0, enc in chunks:
        offsets.append(off)
        off += 8 + len(enc)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(np.asarray(offsets, dtype="<u8").tobytes())
        for y0, enc in chunks:
            f.write(struct.pack("<ii", y0, len(enc)))
            f.write(enc)


def _exr_unfilter(raw: bytes) -> bytes:
    """OpenEXR ZIP/RLE post-decode transform (ImfZip.cpp uncompress):
    byte-delta reconstruction (d[i] += d[i-1] - 128) followed by
    re-interleaving the two buffer halves into even/odd positions."""
    d = np.frombuffer(raw, np.uint8)
    # d'[i] = d'[i-1] + d[i] - 128  ==  cumsum(d) - 128*i  (mod 256)
    acc = (np.cumsum(d, dtype=np.int64) - 128 * np.arange(len(d))) & 0xFF
    b = acc.astype(np.uint8)
    out = np.empty_like(b)
    half = (len(b) + 1) // 2
    out[0::2] = b[:half]
    out[1::2] = b[half:]
    return out.tobytes()


def _exr_filter(data: bytes) -> bytes:
    """Inverse of _exr_unfilter (ImfZip.cpp compress): de-interleave
    even/odd bytes into halves, then byte-delta encode."""
    b = np.frombuffer(data, np.uint8)
    half = (len(b) + 1) // 2
    q = np.empty_like(b)
    q[:half] = b[0::2]
    q[half:] = b[1::2]
    d = q.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _rle_decode(data: bytes) -> bytes:
    """OpenEXR RLE (ImfRle.cpp): signed count byte, < 0 copies -n
    literal bytes, >= 0 repeats the next byte n+1 times."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        c = data[i]
        i += 1
        if c > 127:  # negative int8: literal run
            run = 256 - c
            out += data[i : i + run]
            i += run
        else:
            out += data[i : i + 1] * (c + 1)
            i += 1
    return bytes(out)


def read_exr(path) -> np.ndarray:
    """Read a single-part NO_COMPRESSION scanline EXR -> (H, W, 3) f32."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    if version & 0x200:
        raise ValueError(f"{path}: multi-part EXR not supported")
    pos = 8

    channels = []
    compression = None
    dw = None
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        nul = buf.index(b"\0", pos)
        name = buf[pos:nul].decode()
        pos = nul + 1
        nul = buf.index(b"\0", pos)
        typ = buf[pos:nul].decode()
        pos = nul + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        data = buf[pos : pos + size]
        pos += size
        if name == "channels":
            p = 0
            while data[p] != 0:
                cn = data.index(b"\0", p)
                cname = data[p:cn].decode()
                (ptype,) = struct.unpack_from("<i", data, cn + 1)
                channels.append((cname, ptype))
                p = cn + 1 + 16
        elif name == "compression":
            compression = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", data)
    if compression not in (0, 1, 2, 3):  # none / RLE / ZIPS / ZIP
        raise ValueError(
            f"{path}: compression {compression} not supported "
            "(NO_COMPRESSION, RLE, ZIPS, ZIP only)"
        )
    W = dw[2] - dw[0] + 1
    H = dw[3] - dw[1] + 1
    lines = 16 if compression == 3 else 1
    nchunks = -(-H // lines)
    bytes_per_line = sum(W * _DTYPE[pt].itemsize for _cn, pt in channels)

    offsets = np.frombuffer(buf, dtype="<u8", count=nchunks, offset=pos)

    planes = {}
    for block in offsets:
        y, size = struct.unpack_from("<ii", buf, int(block))
        nl = min(lines, dw[3] - y + 1)
        expect = nl * bytes_per_line
        raw = buf[int(block) + 8 : int(block) + 8 + size]
        if compression and size < expect:
            # (a chunk the codec could not shrink is stored raw)
            if compression == 1:
                raw = _exr_unfilter(_rle_decode(raw))
            else:
                raw = _exr_unfilter(zlib.decompress(raw))
        off = 0
        for line in range(nl):
            for cname, ptype in channels:  # header (alphabetical) order
                dt = _DTYPE[ptype]
                planes.setdefault(cname, [None] * H)[
                    y - dw[1] + line
                ] = np.frombuffer(raw, dtype=dt, count=W, offset=off)
                off += W * dt.itemsize

    def plane(cname):
        rows = planes.get(cname)
        if rows is None:
            return np.zeros((H, W), np.float32)
        return np.stack(rows).astype(np.float32)

    return np.stack([plane("R"), plane("G"), plane("B")], axis=-1)
