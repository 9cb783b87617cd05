"""The plain ambient-occlusion reference: sampled pixels of lucille's AO
frame, in torch, from the scene's raw triangles and the frame's seed.

It follows lucille's AO integrator as the port states it (eye ray ->
closest hit -> interpolated shading normal, Frisvad frame, origin moved
eps along the normal -> S = ntheta x nphi stratified cosine directions
-> pixel = sum over the subsamples of filter weight x (S - occluded) / S,
background 0 on a miss), and draws the same random numbers the port's
default tile streams draw (`streams.py`).  It shares no code and no data
with the program: the triangles come from the RIB text or from the
terrain's vertex grid, the camera from the RIB's numbers, and every
table it needs is worked out here.

Precision: every geometric quantity is computed in `dtype` (float32 for
the reference, bfloat16 for its control) in the operation order the
program states for its kernels (Moller-Trumbore for eye rays, the
signed-volume test for occlusion), so that a float32 run lands on the
same side of each test as the program does.

Acceleration: a scene of at most `DENSE_MAX_TRIS` triangles is tested
brute force; the terrain walks its own 2D grid of cells (`GridScene`),
each cell holding its quad's two triangles.

Which jitter column a lane reads (the port's rule, worked out again
here, `jitter_columns`): on a dense scene the fused gather compacts the
tile's hit lanes to the front and lane j reads the column of its slot;
on the tile BVH a lane reads its own raster column.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from reference.streams import tile_uniform

DET_EPS = 1.0e-14  # the |det| floor of every test
EPS_SCALE = 1.0e-4  # the shading point's offset, of the scene's diagonal
DENSE_MAX_TRIS = 16384  # the port's switch from dense tiles to the tile BVH
R2_A1 = 0.7548776662466927  # the strata's R2 Cranley-Patterson offsets
R2_A2 = 0.5698402909980532


# -- the frame's fixed tables ------------------------------------------------


def _radical_inverse_perm(period: int) -> np.ndarray:
    sigma = np.zeros(period, dtype=np.uint32)
    for i in range(period):
        digit, inverse, bits = period, 0, i
        while bits:
            digit >>= 1
            if bits & 1:
                inverse += digit
            bits >>= 1
        sigma[i] = inverse
    return sigma


def subpixel_offsets(xs: int, ys: int) -> np.ndarray:
    """lucille's sigma-permuted Hammersley subpixel offsets (render.c:
    830-870), (ys * xs, 2) float64, ys-major, with its quirks: the y
    lookup masks with xs - 1, and half a stratum squared is added."""
    sx, sy = _radical_inverse_perm(xs), _radical_inverse_perm(ys)
    out = np.zeros((ys * xs, 2))
    k = 0
    for y in range(ys):
        for x in range(xs):
            j, m = x & (xs - 1), y & (xs - 1)
            out[k, 0] = (x + sx[m % xs] / xs) / xs + 0.5 / (xs * xs)
            out[k, 1] = (y + sy[j % ys] / ys) / ys + 0.5 / (ys * ys)
            k += 1
    return out


def box_weights(offsets: np.ndarray, width=(2.0, 2.0)) -> np.ndarray:
    """The box filter's normalized weight of each subsample, float32."""
    x, y = offsets[:, 0] - 0.5, offsets[:, 1] - 0.5
    w = ((np.abs(x) <= width[0] / 2) & (np.abs(y) <= width[1] / 2)).astype(
        np.float64)
    if w.sum() <= 1e-12:
        w = np.ones_like(w)
    return (w / w.sum()).astype(np.float32)


@dataclass
class Camera:
    """A perspective camera's float32 ray constants."""

    origin: np.ndarray
    rot: np.ndarray
    trans: np.ndarray
    zview: float
    width: int
    height: int

    @staticmethod
    def make(fov: float, rh: bool, world_to_camera, width: int, height: int):
        flength = 1.0 / math.tan((fov * math.pi / 180.0) * 0.5)
        ori = np.eye(4)
        if rh:
            ori[2, 2] = -1.0
        c2w = np.linalg.inv(world_to_camera) @ ori
        sign = -1.0 if rh else 1.0
        origin = np.zeros(3) @ c2w[:3, :3] + c2w[3, :3]
        return Camera(origin.astype(np.float32), c2w[:3, :3].astype(np.float32),
                      c2w[3, :3].astype(np.float32),
                      float(np.float32(sign * flength)), width, height)

    def rays(self, px: torch.Tensor, py: torch.Tensor, dtype):
        """Eye rays through raster positions px, py: (org, dir) (n, 3)."""
        px, py = px.to(dtype), py.to(dtype)
        w, h = float(self.width), float(self.height)
        vx = (2.0 * px - w) / w
        vy = (2.0 * py - h) / h
        z = torch.full_like(vx, self.zview)
        r = [[float(self.rot[i, j]) for j in range(3)] for i in range(3)]
        org = [torch.full_like(vx, float(self.origin[k])) for k in range(3)]
        d = [vx * r[0][k] + vy * r[1][k] + z * r[2][k] + float(self.trans[k])
             - org[k] for k in range(3)]
        n = torch.clamp_min(torch.sqrt(d[0] * d[0] + d[1] * d[1]
                                       + d[2] * d[2]), 1e-20)
        return torch.stack(org, dim=-1), torch.stack([c / n for c in d], -1)


# -- the scene ------------------------------------------------------------


class Scene:
    """The triangles (a, b, c each (N, 3) float32), their face normals
    and the scene's epsilon, as lucille derives them from the input."""

    def __init__(self, a, b, c):
        self.a, self.b, self.c = a, b, c
        ng = np.cross(b - a, c - a)
        nrm = np.linalg.norm(ng, axis=-1, keepdims=True)
        self.normal = ng / np.maximum(nrm, 1e-20)
        allv = np.concatenate([a, b, c])
        self.bbmin, self.bbmax = allv.min(axis=0), allv.max(axis=0)
        self.eps = float(np.float32(max(float(np.linalg.norm(
            self.bbmax - self.bbmin)), 1.0) * EPS_SCALE))
        # the port's accel "auto": dense tiles, whose gather compacts the
        # hit lanes, up to DENSE_MAX_TRIS; the tile BVH above
        self.compacted = len(a) <= DENSE_MAX_TRIS

    def on(self, device, dtype):
        """The per-triangle tensors (v0, e1, e2, v1, v2, sv normal, face
        normal) on device in dtype."""
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(  # noqa
            device=device, dtype=dtype)
        e1, e2 = self.b - self.a, self.c - self.a
        v0, e1t, e2t = t(self.a), t(e1), t(e2)
        nrm = torch.stack([
            e1t[:, 1] * e2t[:, 2] - e1t[:, 2] * e2t[:, 1],
            e1t[:, 2] * e2t[:, 0] - e1t[:, 0] * e2t[:, 2],
            e1t[:, 0] * e2t[:, 1] - e1t[:, 1] * e2t[:, 0]], dim=-1)
        return {"v0": v0, "e1": e1t, "e2": e2t, "v1": t(self.b),
                "v2": t(self.c), "sv_n": nrm, "normal": t(self.normal)}


class GridScene(Scene):
    """The terrain: an n x n vertex grid over [-5, 5]^2 in (x, -z) (the
    vertex grid's z axis, mirrored by Orientation "rh"), quad (i, j)
    holding triangles 2q and 2q + 1, q = j (n - 1) + i."""

    def __init__(self, a, b, c, n: int):
        super().__init__(a, b, c)
        self.n = n


# -- intersection ---------------------------------------------------------


def _mt(tri, k, org, dirn):
    """Moller-Trumbore of rays (m, 3) against triangles k (m, K) in the
    kernels' operation order: (valid, u, v, t) normalized, each (m, K)."""
    v0, e1, e2 = tri["v0"][k], tri["e1"][k], tri["e2"][k]
    ox, oy, oz = (org[:, c : c + 1] for c in range(3))
    dx, dy, dz = (dirn[:, c : c + 1] for c in range(3))
    px = dy * e2[..., 2] - dz * e2[..., 1]
    py = dz * e2[..., 0] - dx * e2[..., 2]
    pz = dx * e2[..., 1] - dy * e2[..., 0]
    a = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    valid = a.abs() > DET_EPS
    inva = torch.where(valid, 1.0 / torch.where(valid, a, 1.0), 0.0)
    sx, sy, sz = ox - v0[..., 0], oy - v0[..., 1], oz - v0[..., 2]
    qx = sy * e1[..., 2] - sz * e1[..., 1]
    qy = sz * e1[..., 0] - sx * e1[..., 2]
    qz = sx * e1[..., 1] - sy * e1[..., 0]
    u = (sx * px + sy * py + sz * pz) * inva
    v = (qx * dx + qy * dy + qz * dz) * inva
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inva
    hit = (valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0))
    return hit, u, v, t


def _occludes(tri, k, org, dirn):
    """The signed-volume test of rays (m, 3) against triangles k (m, K):
    the ray meets the triangle at some t > 0.  (m, K) bool."""
    va, vb, vc, nn = tri["v0"][k], tri["v1"][k], tri["v2"][k], tri["sv_n"][k]
    ox, oy, oz = (org[:, c : c + 1] for c in range(3))
    dx, dy, dz = (dirn[:, c : c + 1] for c in range(3))
    pax, pay, paz = va[..., 0] - ox, va[..., 1] - oy, va[..., 2] - oz
    pbx, pby, pbz = vb[..., 0] - ox, vb[..., 1] - oy, vb[..., 2] - oz
    pcx, pcy, pcz = vc[..., 0] - ox, vc[..., 1] - oy, vc[..., 2] - oz
    nx, ny, nz = nn[..., 0], nn[..., 1], nn[..., 2]
    U = (dx * (pby * pcz - pbz * pcy) + dy * (pbz * pcx - pbx * pcz)
         + dz * (pbx * pcy - pby * pcx))
    V = (dx * (pcy * paz - pcz * pay) + dy * (pcz * pax - pcx * paz)
         + dz * (pcx * pay - pcy * pax))
    dn = dx * nx + dy * ny + dz * nz
    W = dn - U - V
    s_n = pax * nx + pay * ny + paz * nz
    inside = ((torch.minimum(torch.minimum(U, V), W) >= 0.0)
              | (torch.maximum(torch.maximum(U, V), W) <= 0.0))
    return inside & (s_n * dn > 0.0) & (dn.abs() > DET_EPS)


def closest_brute(tri, org, dirn, chunk=1 << 22):
    """Nearest hit of each ray over every triangle: (hit, t, u, v, tri)."""
    N, m = tri["v0"].shape[0], org.shape[0]
    step = max(1, chunk // max(N, 1))
    k = torch.arange(N, device=org.device)[None]
    out = []
    for lo in range(0, m, step):
        o, d = org[lo : lo + step], dirn[lo : lo + step]
        hit, u, v, t = _mt(tri, k, o, d)
        tm = torch.where(hit, t, float("inf"))
        tb, j = tm.min(dim=1)  # the lowest index among equal t
        rows = torch.arange(o.shape[0], device=o.device)
        out.append((hit.any(dim=1), tb, u[rows, j], v[rows, j], j))
    return [torch.cat(x) for x in zip(*out)]


def occluded_brute(tri, org, dirn, chunk=1 << 22):
    """Whether each ray meets any triangle: (m,) bool."""
    N, m = tri["v0"].shape[0], org.shape[0]
    step = max(1, chunk // max(N, 1))
    k = torch.arange(N, device=org.device)[None]
    if m == 0:
        return torch.zeros(0, dtype=torch.bool, device=org.device)
    return torch.cat([_occludes(tri, k, org[lo : lo + step],
                                dirn[lo : lo + step]).any(dim=1)
                      for lo in range(0, m, step)])


def _grid_walk(scene: GridScene, tri, org, dirn, closest: bool):
    """2D DDA over the terrain's cells, in float64, testing each visited
    cell's two triangles in dtype.  closest: (hit, t, u, v, tri) of the
    nearest hit; else (m,) bool, some triangle met."""
    dev, m, n = org.device, org.shape[0], scene.n
    cells = n - 1
    h = 10.0 / cells
    o = org.to(torch.float64) * torch.tensor([1.0, 1.0, -1.0], device=dev,
                                             dtype=torch.float64)
    d = dirn.to(torch.float64) * torch.tensor([1.0, 1.0, -1.0], device=dev,
                                              dtype=torch.float64)
    pad = 1e-4
    lo = torch.tensor([-5.0 - pad, float(scene.bbmin[1]) - pad, -5.0 - pad],
                      device=dev, dtype=torch.float64)
    hi = torch.tensor([5.0 + pad, float(scene.bbmax[1]) + pad, 5.0 + pad],
                      device=dev, dtype=torch.float64)
    inv = 1.0 / torch.where(d.abs() > 1e-300, d, torch.full_like(d, 1e-300))
    t_a, t_b = (lo - o) * inv, (hi - o) * inv
    t_in = torch.clamp_min(torch.minimum(t_a, t_b).amax(dim=1), 0.0)
    t_out = torch.maximum(t_a, t_b).amin(dim=1)
    p = o + d * t_in[:, None]
    cx = torch.clamp(torch.floor((p[:, 0] + 5.0) / h), 0, cells - 1).long()
    cz = torch.clamp(torch.floor((p[:, 2] + 5.0) / h), 0, cells - 1).long()
    sx = torch.where(d[:, 0] >= 0, 1, -1)
    sz = torch.where(d[:, 2] >= 0, 1, -1)
    inf = float("inf")

    def first_boundary(c, s, oc, dc):
        b = -5.0 + (c + (s > 0).long()).to(torch.float64) * h
        return torch.where(dc.abs() > 1e-300, (b - oc) / dc, inf)

    tx = first_boundary(cx, sx, o[:, 0], d[:, 0])
    tz = first_boundary(cz, sz, o[:, 2], d[:, 2])
    dtx = torch.where(d[:, 0].abs() > 1e-300, h / d[:, 0].abs(), inf)
    dtz = torch.where(d[:, 2].abs() > 1e-300, h / d[:, 2].abs(), inf)
    found = torch.zeros(m, dtype=torch.bool, device=dev)
    best_t = torch.full((m,), inf, dtype=org.dtype, device=dev)
    best_u = torch.zeros(m, dtype=org.dtype, device=dev)
    best_v = torch.zeros(m, dtype=org.dtype, device=dev)
    best_k = torch.full((m,), -1, dtype=torch.long, device=dev)
    act = torch.nonzero(t_in <= t_out)[:, 0]
    pair = torch.arange(2, device=dev)[None]
    while act.numel():
        k = 2 * (cz[act] * cells + cx[act])[:, None] + pair  # (a, 2)
        if closest:
            hit, u, v, t = _mt(tri, k, org[act], dirn[act])
            tm = torch.where(hit & (t < best_t[act, None]), t, inf)
            tb, j = tm.min(dim=1)
            better = tb < best_t[act]
            rows = torch.arange(act.numel(), device=dev)
            ab = act[better]
            best_t[ab] = tb[better]
            best_u[ab] = u[rows, j][better]
            best_v[ab] = v[rows, j][better]
            best_k[ab] = k[rows, j][better]
        else:
            found[act] |= _occludes(tri, k, org[act], dirn[act]).any(dim=1)
        t_next = torch.minimum(tx[act], tz[act])
        step_x = tx[act] < tz[act]
        ax, az = act[step_x], act[~step_x]
        cx[ax] += sx[ax]
        tx[ax] += dtx[ax]
        cz[az] += sz[az]
        tz[az] += dtz[az]
        done = ((t_next > t_out[act]) | (cx[act] < 0) | (cx[act] >= cells)
                | (cz[act] < 0) | (cz[act] >= cells))
        if closest:
            done |= best_t[act].to(torch.float64) <= t_next
        else:
            done |= found[act]
        act = act[~done]
    if closest:
        return best_k >= 0, best_t, best_u, best_v, best_k
    return found


def closest_hit(scene, tri, org, dirn):
    if isinstance(scene, GridScene):
        return _grid_walk(scene, tri, org, dirn, closest=True)
    return closest_brute(tri, org, dirn)


def occluded(scene, tri, org, dirn):
    if isinstance(scene, GridScene):
        return _grid_walk(scene, tri, org, dirn, closest=False)
    return occluded_brute(tri, org, dirn)


# -- shading ----------------------------------------------------------------


def _norm(x):
    return torch.sqrt(x[..., 0:1] * x[..., 0:1] + x[..., 1:2] * x[..., 1:2]
                      + x[..., 2:3] * x[..., 2:3])


def ortho_basis(n):
    """The branchless Frisvad/Duff frame (b0, b1, n) of unit normals."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = torch.clamp(-1.0 / (s + nz), -1e3, 1e3)
    b = nx * ny * a
    b0 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    b1 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    b0 = b0 / torch.clamp_min(_norm(b0), 1e-20)
    b1 = b1 / torch.clamp_min(_norm(b1), 1e-20)
    return b0, b1, n


def stratum_directions(b0, b1, b2, u01, ntheta: int, nphi: int):
    """(S, n, 3) stratified cosine directions: stratum s shifts the lane's
    pair by (frac(s a1), frac(s a2)) and maps it into cell (s % ntheta,
    s // ntheta): cos_t = sqrt(z0), phi = 2 pi z1, lz = sqrt(1 - z0)."""
    S, dev, dt = ntheta * nphi, b0.device, b0.dtype
    s = torch.arange(S, dtype=dt, device=dev)
    sh0 = s * R2_A1
    sh0 = sh0 - torch.floor(sh0)
    sh1 = s * R2_A2
    sh1 = sh1 - torch.floor(sh1)
    u0 = u01[0][None, :] + sh0[:, None]
    u0 = u0 - torch.floor(u0)
    u1 = u01[1][None, :] + sh1[:, None]
    u1 = u1 - torch.floor(u1)
    si = torch.arange(S, dtype=torch.int32, device=dev)
    fi = (si % ntheta).to(dt)
    fj = (si // ntheta).to(dt)
    z0 = (fi[:, None] + u0) * (1.0 / ntheta)
    z1 = (fj[:, None] + u1) * (1.0 / nphi)
    cos_t = torch.sqrt(z0)
    phi = (2.0 * np.pi) * z1
    lx = torch.cos(phi) * cos_t
    ly = torch.sin(phi) * cos_t
    lz = torch.sqrt(torch.clamp_min(1.0 - z0, 0.0))
    return (lx[..., None] * b0[None] + ly[..., None] * b1[None]
            + lz[..., None] * b2[None])


# -- the frame -------------------------------------------------------------


@dataclass
class Frame:
    """One frame's settings: image size, subsamples, strata, tile, the
    sunsky light's model (reference.sunsky.PreethamSunSky) or None and
    the render method (the module of this package that renders it)."""

    camera: Camera
    xs: int
    ys: int
    ntheta: int
    nphi: int
    tile: int
    background: float = 0.0
    sky: object = None
    method: str = "ao"

    @property
    def width(self):
        return self.camera.width

    @property
    def height(self):
        return self.camera.height


def lane_positions(frame: Frame, x0: int, y0: int, lanes, device):
    """Raster positions of a tile's lanes (tile_h, tile_w, S raster-major),
    pixel corner + subpixel offset, added in float32."""
    T, S = frame.tile, frame.xs * frame.ys
    off = torch.tensor(subpixel_offsets(frame.xs, frame.ys),
                       dtype=torch.float32, device=device)
    s = lanes % S
    px = (lanes // S) % T
    py = lanes // (S * T)
    fx = (px.to(torch.float32) + float(x0)) + off[s, 0]
    fy = (py.to(torch.float32) + float(y0)) + off[s, 1]
    return fx, fy


def _spread3(x):
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def jitter_columns(scene: Scene, hit, P_off, b2):
    """Which jitter column each lane of a dense tile reads: its slot when
    the hit lanes are compacted to the front, stably, in lane order on a
    scene of fewer than 8 tiles of 128 (padded) triangles, else sorted by
    (shading normal's octant, Morton cell of the shading point in the
    scene's box)."""
    n_pad = max(256, -(-len(scene.a) // 256) * 256)
    if n_pad // 128 < 8:
        return torch.cumsum(hit.to(torch.int64), 0) - 1
    dev = P_off.device
    bbmin = torch.from_numpy(scene.bbmin).to(dev, P_off.dtype)
    bbmax = torch.from_numpy(scene.bbmax).to(dev, P_off.dtype)
    ext = torch.clamp_min(bbmax - bbmin, 1e-12)
    q = ((P_off - bbmin) / ext * 256.0).to(torch.int32).clamp(0, 255)
    morton = ((_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1)
              | _spread3(q[:, 2]))
    octant = ((b2[:, 0] > 0).to(torch.int32) * 4
              + (b2[:, 1] > 0).to(torch.int32) * 2
              + (b2[:, 2] > 0).to(torch.int32))
    key = torch.where(hit, octant * (1 << 24) + morton,
                      torch.full_like(morton, 1 << 29))
    order = torch.sort(key, stable=True).indices
    col = torch.empty_like(order)
    col[order] = torch.arange(order.numel(), device=dev)
    return col


def shading(scene: Scene, tri, org, dirn, res):
    """The gather's inputs at the eye hits: (P_off, b0, b1, b2)."""
    hit, t, u, v, k = res
    t = torch.where(hit, t, torch.zeros_like(t))
    P = org + t[:, None] * dirn
    kk = torch.clamp_min(k, 0)
    uu, vv = u[:, None], v[:, None]
    n = ((1.0 - uu - vv) * tri["normal"][kk] + uu * tri["normal"][kk]
         + vv * tri["normal"][kk])
    Ns = n / torch.clamp_min(_norm(n), 1e-20)
    b0, b1, b2 = ortho_basis(Ns)
    return P + Ns * scene.eps, b0, b1, b2


def sunsky_gather(scene, tri, P_off, dirs, vis, sky):
    """lucille's sunsky AO (ambientocclusion.c:154-332) over the gather's
    open strata: the sky's radiance along each open direction (in its z-up
    frame, y and z swapped), plus the sun's colour where one unbounded
    shadow ray toward the sun is open; (n, 3), before the 1 / (pi S)."""
    from reference.sunsky import sky_frame

    col = (vis[..., None] * sky.sky_rgb(sky_frame(dirs))).sum(dim=0)
    d = sky.sun_direction()
    wi = torch.tensor([d[0], d[2], d[1]], dtype=torch.float32,
                      device=P_off.device)
    wi = (wi / torch.clamp_min(torch.sqrt(torch.sum(wi * wi)), 1e-20)).to(
        P_off.dtype)
    sun_open = ~occluded(scene, tri, P_off, wi.expand_as(P_off))
    suncol = torch.tensor([float(c) for c in sky.sunlight_rgb()],
                          dtype=torch.float32, device=P_off.device)
    return col + sun_open.to(col.dtype)[:, None] * suncol.to(col.dtype)


def render_pixels(scene: Scene, frame: Frame, frame_seed: int, pixels,
                  device, dtype=torch.float32, cache=None) -> np.ndarray:
    """The RGB value of each raster pixel (x, y) in `pixels` ((P, 2) ints)
    of the frame drawn with frame_seed: (P, 3) float64; lucille's sunsky
    AO where the frame has a sky.  cache: a dict kept across frames of
    one scene (eye hits do not depend on the seed)."""
    sky = frame.sky
    cache = {} if cache is None else cache
    key = ("tri", str(device), dtype)
    if key not in cache:
        cache[key] = scene.on(device, dtype)
    tri = cache[key]
    T, S = frame.tile, frame.xs * frame.ys
    B = T * T * S
    pixels = np.asarray(pixels, np.int64).reshape(-1, 2)
    weights = torch.from_numpy(box_weights(
        subpixel_offsets(frame.xs, frame.ys))).to(device=device, dtype=dtype)
    x0s, y0s = pixels[:, 0] // T * T, pixels[:, 1] // T * T
    order, hits, frames, jit = [], [], [], []
    for x0, y0 in sorted(set(zip(x0s.tolist(), y0s.tolist()))):
        sel = np.nonzero((x0s == x0) & (y0s == y0))[0]
        px = torch.from_numpy(pixels[sel, 0] - x0).to(device)
        py = torch.from_numpy(pixels[sel, 1] - y0).to(device)
        lanes = ((py * T + px)[:, None] * S
                 + torch.arange(S, device=device)[None]).reshape(-1)
        if scene.compacted:  # every lane's hit and frame, for the columns
            hkey = ("tile", str(device), dtype, x0, y0)
            if hkey not in cache:
                all_lanes = torch.arange(B, device=device)
                org, dirn = frame.camera.rays(
                    *lane_positions(frame, x0, y0, all_lanes, device), dtype)
                res = closest_hit(scene, tri, org, dirn)
                inputs = shading(scene, tri, org, dirn, res)
                cols = jitter_columns(scene, res[0], inputs[0], inputs[3])
                cache[hkey] = (res[0], inputs, cols)
            hit_all, inputs, cols = cache[hkey]
            hit = hit_all[lanes]
            inputs = [x[lanes] for x in inputs]
            col = cols[lanes]
        else:
            org, dirn = frame.camera.rays(
                *lane_positions(frame, x0, y0, lanes, device), dtype)
            res = closest_hit(scene, tri, org, dirn)
            hit = res[0]
            inputs = shading(scene, tri, org, dirn, res)
            col = lanes
        u01 = tile_uniform(frame_seed, x0, y0, (), (2, B), device).to(dtype)
        order.append(torch.from_numpy(sel).to(device))
        hits.append(hit)
        frames.append(torch.stack(inputs))  # (4, lanes, 3)
        jit.append(u01[:, col])
    hit = torch.cat(hits)
    P_off, b0, b1, b2 = torch.cat(frames, dim=1)
    u01 = torch.cat(jit, dim=1)
    # every drawn lane's strata in one walk
    ns = float(frame.ntheta * frame.nphi)
    rad = torch.full((hit.numel(), 3), frame.background, dtype=dtype,
                     device=device)
    hi = torch.nonzero(hit)[:, 0]
    if hi.numel():
        dirs = stratum_directions(b0[hi], b1[hi], b2[hi], u01[:, hi],
                                  frame.ntheta, frame.nphi)
        S_g = dirs.shape[0]
        blocked = occluded(scene, tri, P_off[hi].repeat(S_g, 1),
                           dirs.reshape(-1, 3)).reshape(S_g, -1)
        if sky is None:
            occ = blocked.sum(dim=0).to(dtype)
            rad[hi] = ((ns - occ) / ns)[:, None].expand(-1, 3)
        else:
            col = sunsky_gather(scene, tri, P_off[hi], dirs, ~blocked, sky)
            rad[hi] = (col / (math.pi * ns)).to(dtype)
    val = (rad.reshape(-1, S, 3) * weights[None, :, None]).sum(dim=1)
    out = np.zeros((len(pixels), 3))
    out[torch.cat(order).cpu().numpy()] = val.to(torch.float64).cpu().numpy()
    return out
