"""Environment maps for IBL lights, on the render device.

Counterpart of lucille_tpu/lights/envmap.py.  The reference keeps the IBL
texture on the light (``light->texture``, light.h:47) and fetches it per
gathered direction with the angular-map projection (texture.c:238
``ri_texture_ibl_fetch``); lat-long maps go through the angular->latlong
converter (texture.h:100-105).

Mapping selection: the RIB token ``"mapping"`` ("angular" | "latlong")
wins; otherwise an image at least twice as wide as tall is lat-long and
anything else a Debevec angular map.

`_np_bilinear`, `angular_to_latlong` and `load_sis` are lucille_tpu's
NumPy code; `fetch` is lucille_tpu's fetch in torch (lat-long wraps in x,
angular clamps).  Unlike lucille_tpu nothing is built lazily inside a
tile: the image goes to the device when the map is made, and
`prepare(sampler)` builds what the light's sampler reads, once, on that
device (the luminance table for "importance" and "bruteforce", the SIS
samples for "structured"), where lucille_tpu builds them at trace time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lucille_tpu_torch.lights.ibl import EnvImportanceTable, latlong_directions
from lucille_tpu_torch.lights.sisgen import generate_sis_samples

SIS_SAMPLES = 64  # structured samples generated when no sisfile is bound


def _np_bilinear(img: np.ndarray, s: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Host-side bilinear fetch, clamp addressing (texture.c:86)."""
    h, w = img.shape[:2]
    x = np.clip(s, 0.0, 1.0) * (w - 1)
    y = np.clip(t, 0.0, 1.0) * (h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def angular_to_latlong(img: np.ndarray, h: int = 0, w: int = 0) -> np.ndarray:
    """Resample a Debevec angular map onto a lat-long grid
    (texture.h:100-105 ``ri_texture_make_longlat_from_angularmap``)."""
    if not h:
        h = img.shape[0] // 2 or 1
    if not w:
        w = 2 * h
    dirs, _ = latlong_directions(h, w)
    d = dirs.reshape(-1, 3)
    # angular map convention: view axis -z, image plane x/y
    denom = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    r = np.where(
        denom > 1e-9,
        np.arccos(np.clip(-d[:, 2], -1.0, 1.0)) / (np.pi * np.maximum(denom, 1e-9)),
        0.0,
    )
    s = 0.5 + 0.5 * d[:, 0] * r
    t = 0.5 - 0.5 * d[:, 1] * r
    return _np_bilinear(img, s, t).reshape(h, w, 3).astype(np.float32)


class EnvMap:
    """One light's environment texture and its sampler's tables, on
    `device` (module docstring)."""

    def __init__(self, image: np.ndarray, mapping: str | None = None,
                 name: str = "", device="cpu"):
        self.image = np.asarray(image, dtype=np.float32)[..., :3]
        h, w = self.image.shape[:2]
        if mapping not in ("angular", "latlong"):
            mapping = "latlong" if w >= 2 * h else "angular"
        self.mapping = mapping
        self.name = name
        self.device = torch.device(device)
        self.texels = torch.from_numpy(
            np.ascontiguousarray(self.image)).to(self.device)
        self._latlong = None
        self._sis = {}
        self.importance_table = None  # EnvImportanceTable, by prepare()
        self.structured = None  # (dirs (S, 3), rgb (S, 3)), by prepare()

    def prepare(self, sampler: str) -> "EnvMap":
        """Build what `sampler` reads, on the map's device: the luminance
        table ("importance", "bruteforce") or the SIS samples, the bound
        sisfile's or SIS_SAMPLES generated from the map ("structured")."""
        if sampler in ("importance", "bruteforce"):
            self.importance_table = EnvImportanceTable(self.latlong_image(),
                                                       self.device)
        elif sampler == "structured":
            dirs, rgb = self.file_sis or self.sis_samples(SIS_SAMPLES)
            self.structured = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                    self.device) for a in (dirs, rgb))
        return self

    # -- device fetch ---------------------------------------------------

    def fetch(self, dirs: torch.Tensor) -> torch.Tensor:
        """(B, 3) unit directions on the map's device -> (B, 3) radiance
        (texture.c:238), bilinear; lat-long wraps in x, angular clamps."""
        h, w = self.image.shape[:2]
        d = dirs
        if self.mapping == "latlong":
            theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
            phi = torch.arctan2(d[..., 2], d[..., 0])
            s = (phi + math.pi) / (2.0 * math.pi)
            t = theta / math.pi
            wrap_x = True
        else:
            denom = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
            r = torch.where(
                denom > 1e-9,
                torch.arccos(torch.clamp(-d[..., 2], -1.0, 1.0))
                / (math.pi * torch.clamp_min(denom, 1e-9)),
                0.0,
            )
            s = 0.5 + 0.5 * d[..., 0] * r
            t = 0.5 - 0.5 * d[..., 1] * r
            wrap_x = False
        x = torch.clamp(s, 0.0, 1.0) * (w - 1.0)
        y = torch.clamp(t, 0.0, 1.0) * (h - 1.0)
        # a NaN direction clamps to texel 0 (a gather out of range would
        # fault on the card), its radiance stays NaN as lucille_tpu's does
        x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 1)
        y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 1)
        x1 = torch.where(x0 + 1 > w - 1, 0 if wrap_x else w - 1, x0 + 1)
        y1 = torch.clamp_max(y0 + 1, h - 1)
        fx = (x - x0.to(torch.float32))[..., None]
        fy = (y - y0.to(torch.float32))[..., None]
        flat = self.texels.reshape(-1, 3)
        r0, r1 = (y0 * w).long(), (y1 * w).long()
        x0, x1 = x0.long(), x1.long()
        return (
            flat[r0 + x0] * (1 - fx) * (1 - fy)
            + flat[r0 + x1] * fx * (1 - fy)
            + flat[r1 + x0] * (1 - fx) * fy
            + flat[r1 + x1] * fx * fy
        )

    # -- sampler support ------------------------------------------------

    def latlong_image(self) -> np.ndarray:
        """The map as a lat-long grid (importance tables and SIS assume
        lat-long texel/solid-angle bookkeeping)."""
        if self.mapping == "latlong":
            return self.image
        if self._latlong is None:
            self._latlong = angular_to_latlong(self.image)
        return self._latlong

    def sis_samples(self, nsamples: int = SIS_SAMPLES):
        """Structured-importance-sampling directions/weights (NumPy),
        generated from the map (lights/sisgen.py) and kept."""
        if nsamples not in self._sis:
            self._sis[nsamples] = generate_sis_samples(
                self.latlong_image(), nsamples=nsamples
            )
        return self._sis[nsamples]

    def load_sis(self, path) -> None:
        """Bind precomputed SIS samples (light->sisfile, light.h:51-52).

        Accepts BOTH the repo's .npz (dirs + rgb) and the reference
        sisgen's text format (tools/sis/sis.c:96-101 writes
        ``N\\nW H\\nx y r g b`` with integer pixel coordinates into the
        angular-map input) — a gensamples.dat produced by the reference
        toolchain loads unchanged.  Pixel coords invert the Debevec
        angular-map parametrization this module fetches with
        (s = .5 + .5*dx*r, view axis -z)."""
        try:
            data = np.load(path)
        except (ValueError, OSError):
            data = None  # not an npz: fall through to gensamples.dat text
        if data is not None:
            try:
                self._sis["file"] = (
                    np.asarray(data["dirs"], np.float32),
                    np.asarray(data["rgb"], np.float32),
                )
            except KeyError as e:
                # a valid npz missing the expected arrays is a caller
                # error, not a text sisfile: name the missing key
                raise ValueError(
                    f"{path}: npz sisfile is missing array {e}; expected "
                    "'dirs' (N,3) and 'rgb' (N,3)"
                ) from e
            return
        with open(path) as f:
            tokens = f.read().split()
        n = int(tokens[0])
        w, h = int(tokens[1]), int(tokens[2])
        rows = np.asarray(tokens[3 : 3 + 5 * n], np.float64).reshape(n, 5)
        u = 2.0 * (rows[:, 0] + 0.5) / w - 1.0
        v = 1.0 - 2.0 * (rows[:, 1] + 0.5) / h
        rho = np.sqrt(u * u + v * v)
        theta = np.pi * np.minimum(rho, 1.0)
        s = np.where(rho > 1e-9, np.sin(theta) / np.maximum(rho, 1e-9), 0.0)
        dirs = np.stack(
            [u * s, v * s, -np.cos(theta)], axis=-1
        ).astype(np.float32)
        self._sis["file"] = (dirs, rows[:, 2:5].astype(np.float32))

    @property
    def file_sis(self):
        return self._sis.get("file")
