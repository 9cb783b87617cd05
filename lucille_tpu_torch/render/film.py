"""Pixel reconstruction filters as per-subsample weights (host).

A host copy of lucille_tpu/render/film.py:19-87: the deterministic
subpixel positions make the filter a constant weight per subsample.
"""

from __future__ import annotations

import numpy as np


def _box(x, y, xw, yw):
    return np.where((np.abs(x) <= xw / 2) & (np.abs(y) <= yw / 2), 1.0, 0.0)


def _triangle(x, y, xw, yw):
    return np.maximum(0.0, 1.0 - np.abs(2 * x / xw)) * np.maximum(
        0.0, 1.0 - np.abs(2 * y / yw)
    )


def _gaussian(x, y, xw, yw):
    a = 2.0
    ex = np.exp(-a * x * x) - np.exp(-a * (xw / 2) ** 2)
    ey = np.exp(-a * y * y) - np.exp(-a * (yw / 2) ** 2)
    return np.maximum(ex, 0.0) * np.maximum(ey, 0.0)


def _catmull_rom_1d(x):
    ax = np.abs(x)
    return np.where(
        ax < 1.0,
        1.5 * ax**3 - 2.5 * ax**2 + 1.0,
        np.where(ax < 2.0, -0.5 * ax**3 + 2.5 * ax**2 - 4 * ax + 2.0, 0.0),
    )


def _catmull_rom(x, y, xw, yw):
    del xw, yw
    return _catmull_rom_1d(x) * _catmull_rom_1d(y)


def _sinc(x, y, xw, yw):
    def s(v, w):
        v = np.where(np.abs(v) < 1e-9, 1e-9, v)
        return np.where(
            np.abs(v) <= w / 2, np.sin(np.pi * v) / (np.pi * v), 0.0
        )

    return s(x, xw) * s(y, yw)


FILTERS = {
    "box": _box,
    "triangle": _triangle,
    "gaussian": _gaussian,
    "catmull-rom": _catmull_rom,
    "sinc": _sinc,
}


def filter_weight(name: str, x, y, xwidth: float = 2.0, ywidth: float = 2.0):
    """Filter kernel value at offset (x, y) from the pixel center."""
    fn = FILTERS.get(name, _box)
    return fn(np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64),
              xwidth, ywidth)


def subsample_filter_table(name: str, jitter: np.ndarray,
                           xwidth: float = 2.0, ywidth: float = 2.0):
    """Normalized per-subsample weights for the deterministic jitter
    table (S, 2) — offsets are measured from the pixel center (0.5, 0.5)."""
    x = jitter[:, 0] - 0.5
    y = jitter[:, 1] - 0.5
    w = filter_weight(name, x, y, xwidth, ywidth)
    total = w.sum()
    if total <= 1e-12:  # degenerate widths: fall back to box
        w = np.ones_like(w)
        total = w.sum()
    return (w / total).astype(np.float32)
