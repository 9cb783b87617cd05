"""Spectral curves and CIE colorimetry.

The port's copy of lucille_tpu/ops/spectrum.py (NumPy, the same code):
regular and irregular spectral curves (the reference's spectrum.c:102,
118) and John Walker's public-domain spectrum -> XYZ -> RGB pipeline
(specrend.c), from the published CIE 1931 data at 10 nm.
"""

from __future__ import annotations

import numpy as np

# CIE 1931 standard observer color matching functions, 380..780nm @ 10nm
CIE_LAMBDA = np.arange(380.0, 781.0, 10.0)
CIE_X = np.array([
    0.0014, 0.0042, 0.0143, 0.0435, 0.1344, 0.2839, 0.3483, 0.3362, 0.2908,
    0.1954, 0.0956, 0.0320, 0.0049, 0.0093, 0.0633, 0.1655, 0.2904, 0.4334,
    0.5945, 0.7621, 0.9163, 1.0263, 1.0622, 1.0026, 0.8544, 0.6424, 0.4479,
    0.2835, 0.1649, 0.0874, 0.0468, 0.0227, 0.0114, 0.0058, 0.0029, 0.0014,
    0.0007, 0.0003, 0.0002, 0.0001, 0.0000])
CIE_Y = np.array([
    0.0000, 0.0001, 0.0004, 0.0012, 0.0040, 0.0116, 0.0230, 0.0380, 0.0600,
    0.0910, 0.1390, 0.2080, 0.3230, 0.5030, 0.7100, 0.8620, 0.9540, 0.9950,
    0.9950, 0.9520, 0.8700, 0.7570, 0.6310, 0.5030, 0.3810, 0.2650, 0.1750,
    0.1070, 0.0610, 0.0320, 0.0170, 0.0082, 0.0041, 0.0021, 0.0010, 0.0005,
    0.0003, 0.0001, 0.0001, 0.0000, 0.0000])
CIE_Z = np.array([
    0.0065, 0.0201, 0.0679, 0.2074, 0.6456, 1.3856, 1.7471, 1.7721, 1.6692,
    1.2876, 0.8130, 0.4652, 0.2720, 0.1582, 0.0782, 0.0422, 0.0203, 0.0087,
    0.0039, 0.0021, 0.0017, 0.0011, 0.0008, 0.0003, 0.0002, 0.0000, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000])

# sRGB D65 XYZ->RGB (row-vector convention: rgb = xyz @ M)
XYZ2RGB = np.array(
    [
        [3.2404542, -0.9692660, 0.0556434],
        [-1.5371385, 1.8760108, -0.2040259],
        [-0.4985314, 0.0415560, 1.0572252],
    ]
)


class RegularSpectrum:
    """Regularly-sampled spectral curve (ri_spectrum capability,
    spectrum.c:102)."""

    def __init__(self, lambda_min: float, lambda_max: float, values):
        self.lmin = float(lambda_min)
        self.lmax = float(lambda_max)
        self.values = np.asarray(values, dtype=np.float64)

    def sample(self, wavelengths):
        wl = np.asarray(wavelengths, dtype=np.float64)
        x = (wl - self.lmin) / (self.lmax - self.lmin) * (len(self.values) - 1)
        return np.interp(
            x, np.arange(len(self.values)), self.values, left=0.0, right=0.0
        )


class IrregularSpectrum:
    """Irregularly-sampled spectral curve (spectrum.c:118)."""

    def __init__(self, wavelengths, values):
        self.wl = np.asarray(wavelengths, dtype=np.float64)
        self.values = np.asarray(values, dtype=np.float64)

    def sample(self, wavelengths):
        return np.interp(np.asarray(wavelengths), self.wl, self.values, 0.0, 0.0)


def spectrum_to_xyz(sample_fn) -> np.ndarray:
    """Integrate an emission spectrum against the CIE observer
    (specrend.c spectrum_to_xyz): sample_fn(wavelength_nm) -> power."""
    power = np.asarray([sample_fn(wl) for wl in CIE_LAMBDA])
    X = float((power * CIE_X).sum())
    Y = float((power * CIE_Y).sum())
    Z = float((power * CIE_Z).sum())
    s = X + Y + Z
    if s <= 0:
        return np.zeros(3)
    return np.array([X, Y, Z]) / s


def xyz_to_rgb(xyz) -> np.ndarray:
    """CIE XYZ -> linear sRGB (specrend.c xyz_to_rgb capability)."""
    rgb = np.asarray(xyz, dtype=np.float64) @ XYZ2RGB
    return rgb


def constrain_rgb(rgb) -> np.ndarray:
    """Desaturate out-of-gamut colors toward white (specrend.c
    constrain_rgb): add enough white to make all components >= 0."""
    rgb = np.asarray(rgb, dtype=np.float64)
    w = -min(0.0, float(rgb.min()))
    return rgb + w


def spectrum_to_rgb(sample_fn, luminance: float = 1.0) -> np.ndarray:
    xyz = spectrum_to_xyz(sample_fn)
    return np.maximum(constrain_rgb(xyz_to_rgb(xyz)) * luminance, 0.0)
