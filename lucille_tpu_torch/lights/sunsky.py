"""Preetham analytic sun & sky model.

Equivalent capability to lucille's src/render/sunsky.c (spectral sun
attenuation sunsky.c:78, sky spectrum→RGB sunsky.c:330-418, lat/long/
time-of-day solar position sunsky.c:184), after:

    A. J. Preetham, P. Shirley, B. Smits,
    "A Practical Analytic Model for Daylight", SIGGRAPH 1999.

The port's copy of lucille_tpu/lights/sunsky.py.  The NumPy parts (solar
position, Perez coefficients, the attenuated sun spectrum and
`sunlight_rgb`) are the same code and run on the host.  `sky_rgb` is the
torch counterpart of the original's jnp branch (lucille_tpu/lights/
sunsky.py:178-239), in f32 on the directions' device, with one change
of form: the daylight spectrum S0 + M1 S1 + M2 S2 is not built per
direction (a (..., 41) tensor, 3.3 GB for the 20M gather directions of
a 240x240x9 tile) before it meets the CIE weights; the three basis
spectra are folded into the weights once, S_k @ W (3,) each, and
xyz0 = S0W + M1 S1W + M2 S2W.  The sum is linear, so only the rounding
differs from the JAX package's (tests/test_torch_sunsky.py holds it).

The sky owns its frame and its kernel's constants: callers hand
`sky_rgb_world` world directions, and `kernel_params` packs the
constants csrc/ao.cu's sky_gather_kernel reads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


# CIE xyY -> linear sRGB-ish primaries (D65), rows are row-vector matrices.
_XYZ2RGB = np.array(
    [
        [3.2404542, -0.9692660, 0.0556434],
        [-1.5371385, 1.8760108, -0.2040259],
        [-0.4985314, 0.0415560, 1.0572252],
    ]
)


def _cie_system_matrix() -> np.ndarray:
    """XYZ -> RGB matrix of the reference's CIEsystem color system
    (specrend.c:79: wide-gamut CIE primaries, equal-energy white),
    derived exactly like xyz_to_rgb (specrend.c:127-173)."""
    xr, yr = 0.7355, 0.2645
    xg, yg = 0.2658, 0.7243
    xb, yb = 0.1669, 0.0085
    xw, yw = 1.0 / 3.0, 1.0 / 3.0
    zr, zg, zb, zw = 1 - xr - yr, 1 - xg - yg, 1 - xb - yb, 1 - xw - yw
    m = np.array(
        [
            [yg * zb - yb * zg, xb * zg - xg * zb, xg * yb - xb * yg],
            [yb * zr - yr * zb, xr * zb - xb * zr, xb * yr - xr * yb],
            [yr * zg - yg * zr, xg * zr - xr * zg, xr * yg - xg * yr],
        ]
    )
    white = m @ np.array([xw, yw, zw]) / yw
    return m / white[:, None]


_XYZ2RGB_CIE = _cie_system_matrix()


def _xyz_to_rgb_cie(xyz: np.ndarray) -> np.ndarray:
    return _XYZ2RGB_CIE @ np.asarray(xyz)


@lru_cache(maxsize=None)
def _folded_basis() -> tuple:
    """The daylight basis spectra S0, S1, S2 against the CIE weights:
    three (3,) XYZ rows, rounded to f32 as Python floats."""
    from lucille_tpu_torch.lights.sunsky_data import CIE10_W, S0, S1, S2

    return tuple(tuple(float(np.float32(v)) for v in s @ CIE10_W)
                 for s in (S0, S1, S2))



def sky_frame(d: torch.Tensor) -> torch.Tensor:
    """Directions (..., 3) in the sky's z-up frame: y and z swapped (the
    reference's lightsource.c:152-155).  Sliced on the device: a list
    index would copy itself to the card and make the host wait."""
    return torch.stack([d[..., 0], d[..., 2], d[..., 1]], dim=-1)

@dataclass
class PreethamSunSky:
    """Sun + sky parameter block (reference ri_sunsky_t).

    Default site parameters mirror the reference's defaults
    (sunsky.c:184 ff): turbidity 2.0; lat/long in degrees; `hour` is local
    solar time; `standard_meridian` in degrees.
    """

    # defaults = the reference's (Tokyo, Jan 20, 10:30;
    # lightsource.c:293-300); standard_meridian in DEGREES (= the RIB
    # token's timezone x 15, ri_sunsky_init sunsky.c:207)
    latitude: float = 35.39
    longitude: float = 139.44
    standard_meridian: float = 135.0
    month: float = 1.0
    day: float = 20.0
    hour: float = 10.5
    turbidity: float = 2.0
    julian_day: float | None = None  # overrides month/day when given
    overcast: float = 0.0
    sun_scale: float = 1.0

    def __post_init__(self):
        self._compute_sun_position()
        self._compute_distribution()

    # -- solar position (init_sun_theta_phi, sunsky.c:40-75) -------------

    def _compute_sun_position(self):
        jd = (
            float(self.julian_day)
            if self.julian_day is not None
            else (self.month - 1.0) * 30.4 + self.day
        )
        solar_time = (
            self.hour
            + 0.170 * math.sin(4.0 * math.pi * (jd - 80.0) / 373.0)
            - 0.129 * math.sin(2.0 * math.pi * (jd - 8.0) / 355.0)
            + (self.standard_meridian - self.longitude) / 15.0
        )
        declination = 0.4093 * math.sin(2.0 * math.pi * (jd - 81.0) / 368.0)
        lat = math.radians(self.latitude)
        h = math.pi * solar_time / 12.0
        theta_s = math.pi / 2.0 - math.asin(
            math.sin(lat) * math.sin(declination)
            - math.cos(lat) * math.cos(declination) * math.cos(h)
        )
        # azimuth exactly as the reference computes it (sunsky.c:66-73)
        opp = -math.cos(declination) * math.sin(h)
        adj = -(
            math.cos(lat) * math.sin(declination)
            + math.sin(lat) * math.cos(declination) * math.cos(h)
        )
        phi_s = -math.atan2(opp, adj)
        self.theta_s = theta_s
        self.phi_s = phi_s

    def sun_direction(self) -> np.ndarray:
        """Unit vector toward the sun, z-up frame (as ri_sunsky_t.sun_dir)."""
        st, ct = math.sin(self.theta_s), math.cos(self.theta_s)
        sp, cp = math.sin(self.phi_s), math.cos(self.phi_s)
        return np.array([st * cp, st * sp, ct])

    # -- Perez distribution coefficients ---------------------------------

    def _compute_distribution(self):
        T = self.turbidity
        th = self.theta_s
        # zenith luminance (Kcd/m^2) and chromaticities (Preetham A.2)
        chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2.0 * th)
        self.Yz = (4.0453 * T - 4.9710) * math.tan(chi) - 0.2155 * T + 2.4192
        t2, t1 = T * T, T
        v = np.array([th**3, th**2, th, 1.0])
        self.xz = float(
            np.array([t2, t1, 1.0])
            @ np.array(
                [
                    [0.00166, -0.00375, 0.00209, 0.0],
                    [-0.02903, 0.06377, -0.03202, 0.00394],
                    [0.11693, -0.21196, 0.06052, 0.25886],
                ]
            )
            @ v
        )
        self.yz = float(
            np.array([t2, t1, 1.0])
            @ np.array(
                [
                    [0.00275, -0.00610, 0.00317, 0.0],
                    [-0.04214, 0.08970, -0.04153, 0.00516],
                    [0.15346, -0.26756, 0.06670, 0.26688],
                ]
            )
            @ v
        )
        # Perez coefficients for Y, x, y (Preetham A.2)
        self.AY, self.BY = 0.1787 * T - 1.4630, -0.3554 * T + 0.4275
        self.CY, self.DY = -0.0227 * T + 5.3251, 0.1206 * T - 2.5771
        self.EY = -0.0670 * T + 0.3703
        self.Ax, self.Bx = -0.0193 * T - 0.2592, -0.0665 * T + 0.0008
        self.Cx, self.Dx = -0.0004 * T + 0.2125, -0.0641 * T - 0.8989
        self.Ex = -0.0033 * T + 0.0452
        self.Ay, self.By = -0.0167 * T - 0.2608, -0.0950 * T + 0.0092
        self.Cy, self.Dy = -0.0079 * T + 0.2102, -0.0441 * T - 1.6537
        self.Ey = -0.0109 * T + 0.0529

    # -- sky radiance ----------------------------------------------------

    def sky_rgb(self, directions: torch.Tensor) -> torch.Tensor:
        """Linear-RGB sky radiance (..., 3) f32 for unit directions
        (..., 3) f32, z-up frame; directions below the horizon return
        black.  The jnp branch of lucille_tpu's sky_rgb in torch, with the
        spectral basis folded into the CIE weights (module docstring)."""
        d = directions
        cz = d[..., 2]
        theta = torch.arccos(torch.clamp(cz, -1.0, 1.0))
        sdir = self.sun_direction()
        cgamma = torch.clamp(
            d[..., 0] * float(sdir[0]) + d[..., 1] * float(sdir[1])
            + d[..., 2] * float(sdir[2]),
            -1.0,
            1.0,
        )
        gamma = torch.arccos(cgamma)
        # the Perez function's cosines, shared by the three channels
        cos_t = torch.clamp_min(torch.cos(theta), 1e-4)
        cg = torch.cos(gamma)
        # its value at the zenith (theta 0, gamma theta_s), in f32 as well
        zero = torch.zeros((), dtype=torch.float32, device=d.device)
        ths = torch.full((), self.theta_s, dtype=torch.float32,
                         device=d.device)
        cos_z = torch.clamp_min(torch.cos(zero), 1e-4)
        cs = torch.cos(ths)

        def ratio(A, B, C, D, E):
            num = (1.0 + A * torch.exp(B / cos_t)) * (
                1.0 + C * torch.exp(D * gamma) + E * cg * cg)
            den = (1.0 + A * torch.exp(B / cos_z)) * (
                1.0 + C * torch.exp(D * ths) + E * cs * cs)
            return num / den

        Y = self.Yz * ratio(self.AY, self.BY, self.CY, self.DY, self.EY)
        x = self.xz * ratio(self.Ax, self.Bx, self.Cx, self.Dx, self.Ex)
        y = self.yz * ratio(self.Ay, self.By, self.Cy, self.Dy, self.Ey)

        # (x, y, Y) -> RGB through the reference's spectral pipeline
        # (ri_sunsky_get_sky_spectrum + get_sky_rgb, sunsky.c:310-418), as
        # in lucille_tpu: a CIE-daylight spectrum from the Perez
        # chromaticity, scaled so its Y is the Perez luminance (kcd ->
        # cd/m^2), against the CIE observer, then the CIEsystem primaries.
        den = 0.0241 + 0.2562 * x - 0.7341 * y
        den = torch.where(torch.abs(den) > 1e-9, den, 1e-9)
        M1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / den
        M2 = (0.03 - 31.4424 * x + 30.0717 * y) / den
        s0w, s1w, s2w = _folded_basis()
        xyz0 = [s0w[c] + M1 * s1w[c] + M2 * s2w[c] for c in range(3)]
        ly = torch.where(torch.abs(xyz0[1]) > 1e-9, xyz0[1], 1.0)
        scale = Y * 1000.0 / ly
        X, Yv, Z = (c * scale for c in xyz0)
        m = _XYZ2RGB_CIE
        rgb = torch.stack(
            [X * float(m[c, 0]) + Yv * float(m[c, 1]) + Z * float(m[c, 2])
             for c in range(3)], dim=-1)
        rgb = torch.clamp_min(rgb, 0.0)
        return torch.where((cz > 0.0)[..., None], rgb, 0.0)

    def sky_rgb_world(self, directions: torch.Tensor) -> torch.Tensor:
        """`sky_rgb` of world directions (..., 3), turned into the sky's
        z-up frame first (`sky_frame`, lightsource.c:152-155)."""
        return self.sky_rgb(sky_frame(directions))

    def kernel_params(self) -> np.ndarray:
        """The sky's constants as csrc/ao.cu's SkyParams holds them, in
        its order: (40,) f32, each the f32 rounding of a field, as torch
        rounds a Python float against an f32 tensor: the sun's direction,
        Yz, xz, yz, the Perez A..E of Y, of x and of y, theta_s, the folded
        basis rows S0, S1, S2 (`_folded_basis`) and the CIEsystem matrix by
        rows."""
        perez = [getattr(self, f"{c}{k}") for k in "Yxy" for c in "ABCDE"]
        vals = [*self.sun_direction(), self.Yz, self.xz, self.yz, *perez,
                self.theta_s, *(v for row in _folded_basis() for v in row),
                *_XYZ2RGB_CIE.ravel()]
        return np.array(vals, dtype=np.float32)

    def sun_spectrum(self, turbidity: float | None = None) -> np.ndarray:
        """Attenuated direct-beam solar spectrum, 380..780 nm at 10 nm
        (compute_attenuated_sunlight, sunsky.c:78-137): extraterrestrial
        irradiance through Rayleigh scattering, aerosol (beta from
        turbidity), ozone, mixed-gas and water-vapor absorption along the
        relative optical air mass of the sun's zenith angle."""
        from lucille_tpu_torch.lights.sunsky_data import K_G, K_O, K_WA, SOL

        th = self.theta_s
        if turbidity is None:
            turbidity = self.turbidity
        alpha, lozone, w = 1.3, 0.35, 2.0
        beta = 0.04608365822050 * turbidity - 0.04586025928522
        m = 1.0 / (
            math.cos(th) + 0.15 * (93.885 - math.degrees(th)) ** -1.253
        )
        lam = np.arange(380.0, 781.0, 10.0) / 1000.0  # um
        tau_r = np.exp(-m * 0.008735 * lam**-4.08)
        tau_a = np.exp(-m * beta * lam**-alpha)
        tau_o = np.exp(-m * K_O * lozone)
        tau_g = np.exp(
            -1.41 * K_G * m / (1.0 + 118.93 * K_G * m) ** 0.45
        )
        tau_wa = np.exp(
            -0.2385 * K_WA * w * m / (1.0 + 20.07 * K_WA * w * m) ** 0.45
        )
        # 100.0: solAmplitudes unit fix, sunsky.c:131
        return 100.0 * SOL * tau_r * tau_a * tau_o * tau_g * tau_wa

    def sunlight_rgb(self, turbidity: float | None = None) -> np.ndarray:
        """Sun disc radiance as RGB via the FULL spectral pipeline
        (sunsky.c:225-237): compute_attenuated_sunlight ->
        spectrum_to_xyz (unnormalized, 5 nm double-count semantics,
        specrend.c:366-431) -> xyz_to_rgb with the reference's CIEsystem
        primaries and equal-energy white (specrend.c:79,127-173); zero
        below the horizon.

        turbidity: override for REFERENCE-BUG parity only.  The
        reference's sun light color comes from ri_sunsky_get_sunlight_rgb
        (lightsource.c:165), which reads sunsky->turbidity — a field
        ri_sunsky_init NEVER STORES (sunsky.c:184-240), so CPU-lucille
        shades the sun with uninitialized memory (0.0 on a fresh heap:
        beta goes negative and the sun comes out ~1.6x brighter and
        gray).  Passing turbidity=0.0 reproduces that frame bit-for-bit
        (verified: ours(T=0) = [484332, 524340, 483849] vs the
        reference render's light->col [484332, 524340, 483850]); the
        default path uses the REAL turbidity, i.e. what sunsky.c clearly
        intended."""
        from lucille_tpu_torch.lights.sunsky_data import CIE10_W

        if self.theta_s >= 0.5 * math.pi:
            return np.zeros(3)
        xyz = self.sun_spectrum(turbidity) @ CIE10_W  # (3,)
        return np.maximum(_xyz_to_rgb_cie(xyz), 0.0) * self.sun_scale
