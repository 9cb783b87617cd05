"""Image load/save dispatch by extension.

Equivalent capability to the reference's image_loader.c:37-48 (extension
dispatch over .hdr/.tex/.jpg): .hdr/.rgbe/.pic via the RGBE codec, .tex
via the blocked-mipmap codec (imageio/tex.py), .exr and .pfm built-in.
JPEG/PNG go through PIL when available (the reference links libjpeg).

The port's copy of lucille_tpu/imageio/loader.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lucille_tpu_torch.imageio.rgbe import read_hdr, write_hdr


def find_file(name, searchpaths=None):
    """Resolve a file name against option searchpaths
    (ri_option_find_file, option.c capability).  Returns a Path or None."""
    for sp in searchpaths or ["."]:
        cand = Path(sp) / name
        if cand.exists():
            return cand
    p = Path(name)
    return p if p.exists() else None


def _read_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        ch = 3 if header == b"PF" else 1
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, ch)[::-1]  # PFM rows are bottom-up
        return np.ascontiguousarray(img.astype(np.float32))


def _write_pfm(path, image: np.ndarray) -> None:
    image = np.asarray(image, dtype=np.float32)
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if image.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(image[::-1].astype("<f4").tobytes())


def load_image(path) -> np.ndarray:
    """Load an image as (H, W, 3) float32 linear-ish RGB."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext in (".hdr", ".rgbe", ".pic"):
        return read_hdr(path)
    if ext == ".pfm":
        return _read_pfm(path)
    if ext == ".tex":
        from lucille_tpu_torch.imageio.tex import read_tex

        return read_tex(path)
    if ext == ".exr":
        from lucille_tpu_torch.imageio.exr import read_exr

        return read_exr(path)
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
        return (img / 255.0) ** 2.2  # sRGB-ish -> linear
    except ImportError as e:
        raise ValueError(f"unsupported image format: {ext}") from e


def save_image(path, image: np.ndarray) -> None:
    path = Path(path)
    ext = path.suffix.lower()
    if ext in (".hdr", ".rgbe", ".pic"):
        write_hdr(path, image)
    elif ext == ".pfm":
        _write_pfm(path, image)
    elif ext == ".tex":
        from lucille_tpu_torch.imageio.tex import write_tex

        write_tex(path, image)
    elif ext == ".exr":
        from lucille_tpu_torch.imageio.exr import write_exr

        write_exr(path, image)
    else:
        try:
            from PIL import Image

            u8 = np.clip(np.asarray(image) ** (1 / 2.2) * 255.0, 0, 255).astype(
                np.uint8
            )
            Image.fromarray(u8).save(path)
        except ImportError as e:
            raise ValueError(f"unsupported image format: {ext}") from e
