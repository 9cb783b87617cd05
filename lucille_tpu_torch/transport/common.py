"""Shared wavefront helpers of the integrators, in torch.

Counterpart of lucille_tpu/transport/common.py:

- `interp_hit` gathers the shading data at the hits
  (ri_intersection_state_build, intersection_state.c:100-240): every
  per-triangle attribute rides one packed (B, 25) row gather and every
  per-geometry material field one (B, 11) row gather, as lucille_tpu
  packs them;
- `face_forward` flips a normal against the incoming ray;
- `background_radiance` is what an escaped ray sees: the option's
  bgcolor plus the sky of a sunsky light (lights/sunsky's
  `sky_rgb_world`), the colour of a constant dome, and a dome or IBL
  light's environment map along the ray (lights/envmap.EnvMap.fetch)
  times its colour;
- `apply_texture` modulates an albedo by the material's texture at the
  hit's st (texture.c ri_texture_fetch path): the renderer's texture
  atlas (texture/texture.py), the geometry's `mat_texture` id, -1 for
  none.
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.device import const_vec
from lucille_tpu_torch.ops.frame import dot
from lucille_tpu_torch.shading.reflection import normalize


def interp_hit(scene, res, org: torch.Tensor, dirn: torch.Tensor) -> dict:
    """Shading data at the hits of a closest-hit result `res`: dict(P,
    Ns (normalized), Ng, st (B, 2), cs (B, 3), geom (B,) i64, kd, ks, kt,
    ior, roughness (B,), mat_color, emission (B, 3))."""
    tri = torch.clamp_min(res["tri"], 0).long()
    u = res["u"][..., None]
    v = res["v"][..., None]
    w = 1.0 - u - v
    t = torch.where(res["hit"], res["t"], 0.0)
    P = org + t[..., None] * dirn

    tattr = torch.cat([
        scene.n0, scene.n1, scene.n2,              # 0:9
        scene.st0, scene.st1, scene.st2,           # 9:15
        scene.c0, scene.c1, scene.c2,              # 15:24
        scene.geom_id[:, None].to(torch.float32),  # 24
    ], dim=1)
    rows = tattr[tri]  # (B, 25)
    n = w * rows[:, 0:3] + u * rows[:, 3:6] + v * rows[:, 6:9]
    e1, e2 = scene.tri_e1[tri], scene.tri_e2[tri]
    ng = torch.stack([
        e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
        e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
        e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
    ], dim=-1)
    st = w * rows[:, 9:11] + u * rows[:, 11:13] + v * rows[:, 13:15]
    cs = w * rows[:, 15:18] + u * rows[:, 18:21] + v * rows[:, 21:24]
    geom = rows[:, 24].to(torch.int64)
    mattr = torch.cat([
        scene.mat_kd[:, None], scene.mat_ks[:, None],
        scene.mat_kt[:, None], scene.mat_ior[:, None],
        scene.mat_roughness[:, None],              # 0:5
        scene.mat_color, scene.mat_emission,       # 5:11
    ], dim=1)
    # index_select, not mattr[geom]: the same rows, and a backward that
    # adds each lane's gradient into its row (index_add_); the indexing
    # backward serializes the lanes of one row, and a scene has few rows
    # (diff/render.py's material gradients)
    mrows = torch.index_select(mattr, 0, geom)  # (B, 11)
    return {
        "P": P, "Ns": normalize(n), "Ng": normalize(ng), "st": st, "cs": cs,
        "geom": geom, "kd": mrows[:, 0], "ks": mrows[:, 1],
        "kt": mrows[:, 2], "ior": mrows[:, 3], "roughness": mrows[:, 4],
        "mat_color": mrows[:, 5:8], "emission": mrows[:, 8:11],
    }


def apply_texture(scene, textures, h, albedo):
    """albedo (B, 3) times the texel at h["st"] where the hit geometry's
    material binds a texture (lucille_tpu/transport/common.py:77-90);
    unchanged without an atlas or a texture."""
    if textures is None or textures.data is None:
        return albedo
    tex_id = scene.mat_texture[h["geom"]]
    texcol = textures.fetch(torch.clamp_min(tex_id, 0), h["st"][..., 0],
                            h["st"][..., 1])
    return albedo * torch.where((tex_id >= 0)[..., None], texcol, 1.0)


def face_forward(N: torch.Tensor, dirn: torch.Tensor) -> torch.Tensor:
    """N flipped to the hemisphere facing against the ray direction."""
    return N * torch.where(dot(N, dirn) > 0.0, -1.0, 1.0)


def background_radiance(lights, dirn: torch.Tensor,
                        bgcolor=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Environment radiance (B, 3) along escaped directions dirn (B, 3):
    bgcolor, plus each sunsky light's sky, and each dome or IBL light's
    colour x intensity, times its environment map along dirn where it has
    one (pathtrace.c's IBL gather; texture.c:238)."""
    out = const_vec(bgcolor, dirn.device).expand(dirn.shape)
    for light in lights or ():
        if light.type == "sunsky" and light.sunsky is not None:
            out = out + light.sunsky.sky_rgb_world(dirn)
        elif light.type in ("dome", "ibl"):
            col = const_vec(light.color, dirn.device) * light.intensity
            if light.env is not None:
                out = out + light.env.fetch(dirn) * col[None, :]
            else:
                out = out + col
    return out
