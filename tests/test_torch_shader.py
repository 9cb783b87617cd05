"""The shader built-ins and the six built-in surfaces (shading/shader.py)
against lucille_tpu's on the same wavefront.

Each wavefront is shaded from the hits of 512 eye rays (both packages get
the port's shading globals): test_torch_whitted's materials scene on
the dense tiles (a distant, a point and an area light), and bench_large's
terrain at n = 35 on the tile BVH under a distant and a point light
(`hf_lit`).  lucille_tpu's Pallas kernels run in interpret mode; the
port's random numbers are lucille_tpu's own draws for the same fold-in
chains (test_torch_render.JaxStream), so the two compare lane for lane.

Tolerances: Ci, Oi, occlusion, diffuse and specular on the hit lanes
within 1e-5 of max(|value|, 1) on all but 1% of them (a shadow ray or a
stratum grazing an edge can flip: XLA:CPU contracts products into FMAs);
the built-ins that trace nothing (constant, mirror) on every lane.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import JaxStream
from test_torch_scene import front_end
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_whitted import LIGHT_CASES, close_rel, compiled, eye_rays, t

HF_LIGHTS = ('LightSource "distantlight" 1 "intensity" [0.9] '
             '"from" [2 6 3] "to" [0 0 0]\n'
             'LightSource "pointlight" 2 "intensity" [20.0] '
             '"from" [-1 4 1]\n')


def hf_lit(pkg):
    """(scene, light tables, camera): bench_large's terrain at n = 35 on
    the tile BVH under HF_LIGHTS, in package pkg."""
    from chip_smoke import heightfield_state

    s = heightfield_state(35, accel="bvh", light=HF_LIGHTS,
                          api=front_end(pkg))
    if pkg == "jax":
        from lucille_tpu.lights.tables import build_light_tables
        from lucille_tpu.scene.compile import compile_scene

        return (compile_scene(s.scene).device_put(),
                build_light_tables(s.scene), s.scene.camera)
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.scene.compile import compile_scene

    return (compile_scene(s.scene, "cpu"),
            build_light_tables(s.scene, device="cpu"),
            s.scene.camera)


def wavefront(kind, B=512, seed=3, key=21, light=None):
    """Both packages' shading globals and contexts on the hits of B eye
    rays of case `kind` ("hf_lit", or a test_torch_whitted case), with
    only light number `light` in the context where given: (port sg, port
    ctx, jax sg, jax ctx, hit (B,) bool)."""
    from lucille_tpu.shading.shader import ShaderContext as JCtx
    from lucille_tpu.shading.shader import ShaderGlobals as JSG
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.shading.shader import ShaderContext, ShaderGlobals
    from lucille_tpu_torch.ops.frame import ortho_basis
    from lucille_tpu_torch.transport.common import face_forward, interp_hit

    if kind == "hf_lit":
        (sj, lj, cam), (st, lt, _) = hf_lit("jax"), hf_lit("torch")
        size = (64, 48)
    else:
        (sj, lj, cam), (st, lt, _) = compiled(kind, "jax"), compiled(
            kind, "torch")
        size = (16, 16)
    if light is not None:
        lj, lt = [lj.lights[light]], [lt.lights[light]]
    o, d = eye_rays(cam, B, seed, size)
    res = closest_hit(st, t(o), t(d))
    h = interp_hit(st, res, t(o), t(d))
    N = face_forward(h["Ns"], t(d))
    b0, b1, _ = ortho_basis(N)
    fields = dict(P=h["P"], N=N, Ng=h["Ng"], I=t(d), E=t(o),
                  Cs=h["cs"] * h["mat_color"], Os=torch.ones((B, 3)),
                  s=h["st"][:, 0], t=h["st"][:, 1], u=res["u"], v=res["v"],
                  dPdu=b0, dPdv=b1)
    k = jax.random.key(key)
    sg = ShaderGlobals(**fields)
    ctx = ShaderContext(scene=st, key=StreamKey(JaxStream(k)), lights=lt)
    jsg = JSG(**{n: jnp.asarray(v.numpy()) for n, v in fields.items()})
    jctx = JCtx(scene=sj, key=k, lights=lj)
    return sg, ctx, jsg, jctx, res["hit"].numpy()


def check(got, want, hit, everywhere=False):
    got, want = np.asarray(got), np.asarray(want)
    want = np.broadcast_to(want, np.broadcast_shapes(want.shape, got.shape))
    got = np.broadcast_to(got, want.shape)
    assert np.isfinite(want[hit]).all()
    ok = close_rel(got[hit], want[hit], 1e-5)
    assert ok.mean() >= (1.0 if everywhere else 0.99), ok.mean()


# shader -> the parameters bound over the registry defaults
PARAMS = {
    "matte": {"Kd": 0.7},
    "constant": {},
    "plastic": {"Ks": [0.4], "roughness": [0.15],
                "specularcolor": [1.0, 0.5, 0.25]},
    "checker": {"frequency": 4.0, "darkcolor": [0.2, 0.1, 0.0]},
    "ambientocclusion": {"samples": 16},
    "mirror": {"Kr": [0.5]},
}


@pytest.mark.parametrize("kind", ["materials", "hf_lit"])
@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("bound", ["defaults", "params"])
def test_builtin_surfaces_match_jax(name, kind, bound):
    """Each built-in's (Ci, Oi) with its registry defaults, and with
    parameters as RIB binds them (one-value arrays, colours) over them,
    on both accels; trace() answers through a stand-in trace_fn in both
    packages (transport's own is test_torch_shaded.py's)."""
    from lucille_tpu.shading.shader import get_shader as jget
    from lucille_tpu_torch.shading.shader import bind_params, get_shader

    sg, ctx, jsg, jctx, hit = wavefront(kind)
    jctx.trace_fn = lambda o, d: o * 0.25 + d
    ctx.trace_fn = lambda o, d: o * 0.25 + d
    jctx.trace_depth_left = ctx.trace_depth_left = 1
    jfn, jdefaults = jget(name)
    fn, defaults = get_shader(name)
    assert defaults == jdefaults
    params = dict(defaults, **(PARAMS[name] if bound == "params" else {}))
    want = jfn(jsg, params, jctx)
    got = fn(sg, bind_params(fn, params, "cpu"), ctx)
    assert 0.3 < hit.mean() < 1.0
    for g, w in zip(got, want):
        check(g.numpy(), w, hit, everywhere=name in ("constant", "mirror"))
    if name != "constant":
        assert np.abs(np.asarray(want[0])[hit]).max() > 1e-3


@pytest.mark.parametrize("n", [4, 64])
@pytest.mark.parametrize("kind", ["materials", "hf_lit"])
def test_occlusion_matches_jax(n, kind):
    """ctx.occlusion at 4 (2x2 strata) and 64 samples (8x8): one any-hit
    wavefront a stratum, stratum si at key.fold(si)."""
    sg, ctx, jsg, jctx, hit = wavefront(kind)
    want = np.asarray(jctx.occlusion(jsg, n))
    got = ctx.occlusion(sg, n).numpy()
    assert got.shape == (512,)
    check(got, want, hit)
    assert 0.0 < want[hit].mean() < 1.0  # some strata blocked, not all


@pytest.mark.parametrize("light", sorted(LIGHT_CASES))
def test_diffuse_and_specular_match_jax(light):
    """ctx.diffuse and ctx.specular (a host roughness and a per-lane
    one) under each light type of test_torch_whitted.LIGHT_CASES, the
    light alone in the context: the same draws (the context's own key,
    folded i + 1000 per light inside direct_diffuse)."""
    kind, i = LIGHT_CASES[light]
    sg, ctx, jsg, jctx, hit = wavefront(kind, seed=1, light=i)
    check(ctx.diffuse(sg).numpy(), jctx.diffuse(jsg), hit)
    assert np.asarray(jctx.diffuse(jsg))[hit].max() > 0
    rough = np.linspace(0.05, 0.5, 512).astype(np.float32)
    for r_port, r_jax in ((0.2, 0.2), (torch.tensor(0.2), jnp.float32(0.2)),
                          (t(rough), jnp.asarray(rough))):
        check(ctx.specular(sg, r_port).numpy(), jctx.specular(jsg, r_jax),
              hit)
    if light.split("-")[0] in ("distant", "point", "sun"):
        assert np.asarray(jctx.specular(jsg, 0.2))[hit].max() > 0


def test_ambient_and_texture_without_an_atlas():
    """ambient() is zero; texture() with no atlas is white, as in
    lucille_tpu; a texture named in a shader against an atlas that holds
    textures is refused (lucille_tpu's fetch fails on the name)."""
    from lucille_tpu_torch.texture.texture import TextureAtlas

    sg, ctx, jsg, jctx, hit = wavefront("materials")
    assert float(ctx.ambient(sg).abs().sum()) == 0
    got = ctx.texture("any.tex", sg.s, sg.t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jctx.texture("any.tex", jsg.s, jsg.t)))
    ctx.textures = TextureAtlas()  # an atlas without textures: white
    assert torch.equal(ctx.texture("any.tex", sg.s, sg.t), got)
    ctx.textures = TextureAtlas.build({"a": np.ones((2, 2, 3))}, "cpu")
    with pytest.raises(NotImplementedError, match="not looked up"):
        ctx.texture("any.tex", sg.s, sg.t)


def test_unknown_name_falls_back_to_matte():
    from lucille_tpu_torch.shading.shader import BUILTINS, get_shader

    assert get_shader("NoSuchShader") is BUILTINS["matte"]
    assert get_shader(None) is BUILTINS["matte"]
    assert get_shader("PLASTIC") is BUILTINS["plastic"]


def test_bound_parameters_stay_put():
    """bind_params: numbers stay 0-d host tensors, arrays go to the
    device once (device.const_vec: a second binding of the same values
    copies nothing), a built-in's in-shader defaults are bound with
    them, ambientocclusion's count stays a host int."""
    from lucille_tpu_torch.device import _const_vec
    from lucille_tpu_torch.shading.shader import BUILTINS, bind_params

    plastic = BUILTINS["plastic"][0]
    b = bind_params(plastic, {"Ks": 0.25, "roughness": [0.2]}, "cpu")
    assert b["Ks"].dim() == 0 and b["Ks"].dtype == torch.float32
    assert b["roughness"].shape == (1,)
    assert torch.equal(b["specularcolor"], torch.ones(3))
    bind_params(plastic, {}, "meta")
    misses = _const_vec.cache_info().misses
    got = bind_params(plastic, {}, "meta")["specularcolor"]
    assert got.device.type == "meta" and got.shape == (3,)
    assert _const_vec.cache_info().misses == misses
    ao = bind_params(BUILTINS["ambientocclusion"][0], {"samples": [16.0]},
                     "cpu")
    assert ao["samples"] == 16 and isinstance(ao["samples"], int)
