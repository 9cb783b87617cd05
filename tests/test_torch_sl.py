"""The RSL-subset compiler (shading/sl.py) against lucille_tpu's.

The lexer and parser are copies: every source here lexes to the same
tokens and parses to the same AST (node for node), and malformed source
raises SLError in both.  The evaluator is a port: each of
tests/test_sl.py's TestExecute cases gives lucille_tpu's value in both
packages, and a corpus of shaders covering every statement and built-in
runs in both on one wavefront, shaded from the hits of 512 eye rays on
test_torch_whitted's materials scene (a distant, a point and an area
light), lucille_tpu's Pallas kernels in interpret mode, the port's
random numbers lucille_tpu's own draws (test_torch_render.JaxStream).

Tolerances: Ci and Oi within 1e-5 of max(|value|, 1) on every lane (f32
ulps of sin, pow, noise's fade), and on all but 1% of the lanes for the
shaders that trace shadow rays (a ray grazing an edge can flip).

Every shader's name is unique across the test files (lucille_tpu keeps
a process-wide registry, and a test worker runs several files).
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from test_torch_render import JaxStream
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_whitted import close_rel, compiled, eye_rays, t

WHITTED_SL = (
    "surface slwhitted(float eta = 1.5; float Kd = .8; float Kr = .8;"
    "  float Kt = .2; float Ks = .2; float Kss = 2) {\n"
    "  normal Nn = faceforward(normalize(N), I);\n"
    "  Ci = Kd * ambient();\n"
    "  illuminance(P, Nn, PI/2) { Ci += Kd * Cl * (L . Nn); }\n"
    "  Ci += Ks * trace(P, reflect(I, Nn));\n"
    "  vector T = refract(I, Nn, (N.I) < 0 ? eta : 1/eta);\n"
    "  if (length(T) != 0.0) Ci += Kt * trace(P, T);\n"
    "}\n"
)

# tests/test_sl.py's sources (TestParse, TestExecute), then the corpus's
PARSE = {
    "minimal": "surface s() { Ci = Cs; }",
    "params": "surface s(float Ka = 1; color C = (1, 0, 0);) { }",
    "dot": "surface s() { float d = I.N; }",
    "constant": "surface c() { Ci = Cs; Oi = Os; }",
    "override": "surface k(float K = 0.5) { Ci = K * Cs; }",
    "varying_if": "surface f() { float x = 0; if (s > 0.5) { x = 1; } "
                  "else { x = 2; } Ci = x; }",
    "for": "surface f() { float acc = 0; float i; "
           "for (i = 0; i < 5; i += 1) { acc += 2; } Ci = acc; }",
    "math": "surface f() { Ci = mix((0,0,0), (1,1,1), 0.25) "
            "+ clamp(2.0, 0, 1) - 1; }",
    "occlusion": "surface ao(float samples = 4) "
                 "{ Ci = Cs * (1 - occlusion(P, N, samples)); }",
    "whitted": WHITTED_SL,
    "kinds": "displacement d(float amp = 0.25;) { P += amp * normalize(N); "
             "N = calculatenormal(P); }\n",
    "casts": 'surface c(output varying color x = 0; uniform string m = "a") '
             '{ color a = color "rgb" (s, t, 0.5), b = color(s); '
             "float n = float noise(P); Ci = a + b + n; "
             "while (x < 1) { x += 1; } /* block */ // line\n }",
}
GARBAGE = ["this is not a shader", "surface s( { }", "surface s() { Ci = ; }",
           "surface s() { Ci = $; }", "surface s() { Ci = (1, 2; }"]


def _ast(node):
    """An AST as nested tuples of (class name, fields), comparable
    across the two packages' node classes."""
    if isinstance(node, list):
        return [_ast(n) for n in node]
    if isinstance(node, tuple):
        return tuple(_ast(n) for n in node)
    if hasattr(node, "__dataclass_fields__"):
        return (type(node).__name__,) + tuple(
            _ast(getattr(node, f)) for f in node.__dataclass_fields__)
    return node


@pytest.mark.parametrize("case", sorted(PARSE))
def test_parse_matches_jax(case):
    from lucille_tpu.shading import sl as jsl
    from lucille_tpu_torch.shading import sl

    src = PARSE[case]
    assert sl._lex(src) == jsl._lex(src)
    got, want = sl.parse_sl(src), jsl.parse_sl(src)
    assert _ast(got) == _ast(want)
    assert (got.kind, got.name) == (want.kind, want.name)


@pytest.mark.parametrize("src", GARBAGE)
def test_garbage_raises_in_both(src):
    from lucille_tpu.shading import sl as jsl
    from lucille_tpu_torch.shading import sl

    with pytest.raises(jsl.SLError):
        jsl.parse_sl(src)
    with pytest.raises(sl.SLError):
        sl.parse_sl(src)


def test_defaults_match_jax():
    """Parameter defaults are evaluated once at compile time, to the
    same NumPy values (an expression the minimal env cannot evaluate
    defaults to 0)."""
    from lucille_tpu.shading import sl as jsl
    from lucille_tpu_torch.shading import sl

    src = ('surface d(float a = 2 * 3; color c = (1, 0.5, 0.25); '
           'color g = color(0.5); point p = Cs; string n = "tex"; float z) '
           "{ }")
    got, want = sl.compile_sl(src)[1], jsl.compile_sl(src)[1]
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w))
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype


# -- tests/test_sl.py's TestExecute cases ----------------------------------

def _plane_ctx(pkg, B=256):
    """tests/test_sl.py's _sg_ctx in package pkg, at B lanes (a whole
    256-ray block, so that lucille_tpu takes its Pallas kernels)."""
    from test_torch_scene import front_end

    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib('WorldBegin\nPointsPolygons [4] [0 1 2 3] '
              '"P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]\nWorldEnd', s)
    z = np.zeros((B, 3), np.float32)
    up = np.broadcast_to(np.float32([0, 1, 0]), (B, 3))
    arrays = dict(P=z + np.float32([0, 0.5, 0]), N=up, Ng=up, I=-up, E=z,
                  Cs=z + np.float32(0.8), Os=z + 1,
                  s=np.linspace(0, 1, B, dtype=np.float32),
                  t=np.linspace(0, 1, B, dtype=np.float32),
                  u=np.zeros(B, np.float32), v=np.zeros(B, np.float32),
                  dPdu=z, dPdv=z)
    key = jax.random.key(0)
    if pkg == "jax":
        from lucille_tpu.lights.tables import build_light_tables
        from lucille_tpu.scene.compile import compile_scene
        from lucille_tpu.shading.shader import ShaderContext, ShaderGlobals

        sg = ShaderGlobals(**{k: jnp.asarray(v) for k, v in arrays.items()})
        return sg, ShaderContext(
            scene=compile_scene(s.scene).device_put(), key=key,
            lights=build_light_tables(s.scene))
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.scene.compile import compile_scene
    from lucille_tpu_torch.shading.shader import ShaderContext, ShaderGlobals

    sg = ShaderGlobals(**{k: torch.from_numpy(np.array(v))
                          for k, v in arrays.items()})
    return sg, ShaderContext(scene=compile_scene(s.scene, "cpu"),
                             key=StreamKey(JaxStream(key)),
                             lights=build_light_tables(s.scene,
                                                       device="cpu"))


# case -> (source, params or None for the defaults, expected Ci[:, 0])
S = np.linspace(0, 1, 256, dtype=np.float32)
EXECUTE = {
    "constant": (PARSE["constant"], None, 0.8),
    "param_override": (PARSE["override"], {"K": 0.25}, 0.2),
    "varying_if_merges": (PARSE["varying_if"], None,
                          np.where(S > 0.5, 1.0, 2.0)),
    "for_loop_unrolls": (PARSE["for"], None, 10.0),
    "builtin_math": (PARSE["math"], None, 0.25),
    "occlusion_shader": (PARSE["occlusion"], None, 0.8),
}


@pytest.mark.parametrize("case", sorted(EXECUTE))
def test_execute_cases_match_jax(case):
    """tests/test_sl.py's TestExecute: both packages give the value that
    test asks of lucille_tpu (the open plane occludes nothing), and the
    same Ci and Oi on every lane."""
    from lucille_tpu.shading import sl as jsl
    from lucille_tpu_torch.shading import sl

    src, params, want0 = EXECUTE[case]
    jfn, jd = jsl.compile_sl(src)
    fn, d = sl.compile_sl(src)
    jsg, jctx = _plane_ctx("jax")
    sg, ctx = _plane_ctx("torch")
    want = [np.asarray(x) for x in jfn(jsg, params or jd, jctx)]
    got = [x.numpy() for x in fn(sg, params or d, ctx)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.broadcast_to(got[0][:, 0], (256,)),
                               np.broadcast_to(want0, (256,)), atol=1e-5)


# -- the corpus on a lit wavefront -----------------------------------------

# name -> (body, traces shadow rays)
CORPUS = {
    "arith": ("Ci = (Cs + 0.5) * 2 - Cs / 3 - N * s;", False),
    "dot_op": ("Ci = N . I + (1, 2, 3) . (0.5, 0.25, 0.125);", False),
    "mod": ("Ci = mod(s * 7, 1.3) + (t * 5) % 0.7 + mod(P, 0.3);", False),
    "logic": ("Ci = (s > 0.3 && t < 0.6) || s > 0.9 ? 1 : 0.25;", False),
    "not": ("Ci = !(s > 0.5) ? Cs : (1, 0, 0);", False),
    "ternary": ("Ci = s > 0.5 ? N : 0.3; Oi = 2 > 1 ? Os : 0;", False),
    "compare": ("Ci = (s <= t) + (s >= 0.5) + (s == s) + (t != 0.25) "
                "+ (u < v) * 2;", False),
    "unary": ("Ci = -N + -(-s);", False),
    "math1": ("Ci = sqrt(s) + inversesqrt(t + 0.1) + pow(s, 2.5) "
              "+ exp(-t) + log(s + 0.5) + sin(s * 3) + cos(t) + tan(s) "
              "+ asin(s * 2 - 1) + acos(t) + atan(s) + atan(s, t - 0.5) "
              "+ floor(s * 4) + ceil(t * 3) + round(s * 5) + abs(N) "
              "+ sign(t - 0.5) + radians(45) + degrees(s);", False),
    "minmax": ("Ci = clamp(s * 2 - 0.5, 0.1, 0.9) + min(s, t) "
               "- max(s, 0.5) + clamp(N, -0.5, 0.5) + clamp(2.0, 0, 1);",
               False),
    "mix_step": ("Ci = mix(Cs, (0.2, 0.4, 0.6), t) * step(0.5, s) "
                 "+ smoothstep(0.2, 0.8, t) + mix(0, 1, 0.25);", False),
    "vectors": ("vector a = normalize(P); Ci = length(P) + distance(P, E) "
                "+ dot(N, I) + cross(N, a) + faceforward(N, I) "
                "+ reflect(I, N) + refract(I, N, 1.33) + xcomp(P) "
                "+ ycomp(N) + zcomp(I) + comp((0.5, 0.25, 0.125), 2) "
                "+ comp(N, floor(s * 2.99));", False),
    "noise": ("Ci = noise(P * 3) + noise(s * 10) + noise(s * 4, t * 4) "
              "+ noise(s, t, u) + float noise(P);", False),
    "uniform_if": ("float k = 2; if (k > 1) { Ci = Cs; } else { Ci = N; } "
                   "if (k < 1) Oi = 0;", False),
    "nested_if": ("color c = 0; float k = 1; if (s > 0.5) { c = Cs; "
                  "if (t > 0.75) c = (1, 1, 0); else k = 3; } "
                  "else { c = N; float only = 2; } Ci = c * k;", False),
    "loops": ("float acc = 0; float i; for (i = 0; i < 4; i += 1) "
              "{ acc += i * 0.25; } while (acc < 10) { acc *= 2; } "
              "Ci = acc * Cs;", False),
    "varying_loop": ("float i = s; while (i < 1) { i += 0.5; } "
                     "for (i = t; i < 1; i += 1) { Ci = 5; } Ci += i;",
                     False),
    "decls": ("color c; point p; float f; string nm; color a = 1, b = Cs;"
              " Ci = c + f + a * b + p;", False),
    "assign_ops": ("float a = 1; a += s; a -= t; a *= 2; a /= 3; "
                   "Ci = a; Ci *= Cs; Ci -= 0.1; Ci /= 2;", False),
    "casts": ('Ci = color(s) + color "rgb" (t, s, 0.5) + point(0.1) '
              "+ vector(N) + (s, t, 0.5) + (1, 0, 0.5);", False),
    "unknown": ("Ci = frobnicate(s) + Cs;", False),
    "calculatenormal": ("N = calculatenormal(P); Ci = N + PI;", False),
    "ambient_texture_trace": ('Ci = ambient() + texture("foo", s, t) '
                              "+ texture(\"bar\") + trace(P, reflect(I, N))"
                              " + 0.5;", False),
    "diffuse": ("Ci = Cs * diffuse(normalize(N)) + diffuse();", True),
    "specular": ("Ci = specular(N, -I, 0.2) + specular(N, I, s * 0.5);",
                 True),
    "illuminance": ("illuminance(P, N, PI/2) { Ci += Cl * max(L . N, 0); }",
                    True),
    "occlusion": ("Ci = 1 - occlusion(P, N, 64);", True),
    # uniform outputs (flatred with its parameter at its default), and a
    # uniform triple computed from a parameter and literals meeting a
    # varying value
    "uniform_ci": ("Ci = Kd * (1, 0.25, 0.1);", False),
    "constant_ci": ("Ci = (1, 0, 0); Oi = 0.5;", False),
    "computed_triple": ("color c = Kd * tint * (1, .25, .1); "
                        "Ci = c * Cs + tint + (2, 4, 8) / Kd;", False),
}


@pytest.fixture(scope="module")
def lit_wavefront():
    """Both packages' shading contexts on the hits of 512 eye rays on the
    materials scene: (port sg, port ctx, jax sg, jax ctx, hit mask)."""
    from lucille_tpu.shading.shader import ShaderContext as JCtx
    from lucille_tpu.shading.shader import ShaderGlobals as JSG
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.shading.shader import ShaderContext, ShaderGlobals
    from lucille_tpu_torch.ops.frame import ortho_basis
    from lucille_tpu_torch.transport.common import face_forward, interp_hit

    sj, lj, cam = compiled("materials", "jax")
    st, lt, _ = compiled("materials", "torch")
    o, d = eye_rays(cam, 512, seed=3)
    res = closest_hit(st, t(o), t(d))
    h = interp_hit(st, res, t(o), t(d))
    N = face_forward(h["Ns"], t(d))
    b0, b1, _ = ortho_basis(N)
    fields = dict(P=h["P"], N=N, Ng=h["Ng"], I=t(d), E=t(o),
                  Cs=h["cs"] * h["mat_color"], Os=torch.ones((512, 3)),
                  s=h["st"][:, 0], t=h["st"][:, 1], u=res["u"], v=res["v"],
                  dPdu=b0, dPdv=b1)
    key = jax.random.key(21)
    sg = ShaderGlobals(**fields)
    ctx = ShaderContext(scene=st, key=StreamKey(JaxStream(key)), lights=lt)
    jsg = JSG(**{k: jnp.asarray(v.numpy()) for k, v in fields.items()})
    jctx = JCtx(scene=sj, key=key, lights=lj)
    return sg, ctx, jsg, jctx, res["hit"].numpy()


def _corpus_src(name):
    return (f"surface sl_{name}(float Kd = 0.5; color tint = (1, 0.5, 0.25)) "
            "{ " + CORPUS[name][0] + " }")


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_matches_jax(name, lit_wavefront):
    from lucille_tpu.shading import sl as jsl
    from lucille_tpu_torch.shading import sl

    sg, ctx, jsg, jctx, hit = lit_wavefront
    src = _corpus_src(name)
    jfn, jd = jsl.compile_sl(src)
    fn, d = sl.compile_sl(src)
    want = [np.asarray(x) for x in jfn(jsg, jd, jctx)]
    got = [x.numpy() for x in fn(sg, d, ctx)]
    assert 0.3 < hit.mean() < 1.0
    for g, w in zip(got, want):
        w = np.broadcast_to(w, np.broadcast_shapes(w.shape, (512, 3)))
        g = np.broadcast_to(g, w.shape)
        assert np.isfinite(w[hit]).all()
        ok = close_rel(g[hit], w[hit], 1e-5)
        assert ok.mean() >= (0.99 if CORPUS[name][1] else 1.0), ok.mean()
    if CORPUS[name][1]:  # the lights reach the lanes
        assert np.abs(want[0][hit]).max() > 1e-3


def test_params_bind_as_lucille_reads_them(lit_wavefront):
    """Parameters as RIB hands them (one-value arrays, colours) and as
    numbers give lucille_tpu's values; `bind` makes a number a host
    scalar and an array a tensor of the wavefront's device."""
    from lucille_tpu.shading import sl as jsl
    from lucille_tpu_torch.shading import sl

    sg, ctx, jsg, jctx, hit = lit_wavefront
    src = ("surface sl_bound(float Kd = 0.5; color tint = (1, 0.5, 0.25); "
           'float n = 1; string nm = "x") { Ci = Kd * tint * Cs * n; '
           "if (Kd > 0.3) Ci += 0.25; }")
    jfn, jd = jsl.compile_sl(src)
    fn, d = sl.compile_sl(src)
    for params in ({}, {"Kd": [0.25], "tint": [0.1, 0.2, 0.3]},
                   {"Kd": 0.75, "n": 2.0}):
        want = np.asarray(jfn(jsg, {**jd, **params}, jctx)[0])
        bound = fn.bind({**d, **params}, "cpu")
        assert set(bound) == {"Kd", "tint", "n", "nm"}
        assert bound["nm"] == "x" and bound["tint"].shape == (3,)
        assert bound["n"].dim() == 0 or "n" in params
        got = fn(sg, bound, ctx)[0].numpy()
        np.testing.assert_allclose(np.broadcast_to(got, (512, 3)),
                                   np.broadcast_to(want, (512, 3)),
                                   rtol=0, atol=1e-6)


MATH_ONLY = sorted(n for n, (_b, lit) in CORPUS.items()
                   if not lit and n != "ambient_texture_trace")


class HostCopies(TorchDispatchMode):
    """Records each op that brings host data to another device: a copy
    whose source is on the host, or an op that takes a host tensor of
    more than one element and gives a tensor elsewhere."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if torch.is_tensor(a) and a.device.type == "cpu" and a.dim()]
        outs = [o for o in pytree.tree_leaves(out) if torch.is_tensor(o)]
        if ins and any(o.device.type != "cpu" for o in outs):
            self.seen.append(str(func))
        return out


@pytest.mark.parametrize("name", MATH_ONLY)
def test_uniform_values_never_reach_for_the_device(name, monkeypatch):
    """Every math-only shader of the corpus on a wavefront on torch's
    meta device: the evaluator keeps uniform values on the host and
    brings them to the wavefront's device without reading a device
    value (a meta tensor has none), mixing devices in one op or copying
    from the host in the shader's first run (a uniform Ci or Oi and a
    triple computed from literals and parameters are filled there); Ci
    and Oi come back on the wavefront's device."""
    from lucille_tpu_torch import device
    from lucille_tpu_torch.shading import sl
    from lucille_tpu_torch.shading.shader import ShaderContext, ShaderGlobals

    B = 64
    meta = torch.device("meta")
    sg = ShaderGlobals(**{
        k: torch.empty((B, 3) if k not in "stuv" else (B,), device=meta)
        for k in ("P", "N", "Ng", "I", "E", "Cs", "Os", "s", "t", "u", "v",
                  "dPdu", "dPdv")})
    fn, d = sl.compile_sl(_corpus_src(name))
    bound = fn.bind(d, meta)

    def no_copy(*args):
        raise AssertionError(f"device.const_vec{args} inside the run")

    monkeypatch.setattr(device, "_const_vec", no_copy)
    with HostCopies() as mode:
        ci, oi = fn(sg, bound, ShaderContext(scene=None, key=None))
    assert mode.seen == []
    assert ci.device == meta and oi.device == meta
    assert torch.broadcast_shapes(ci.shape, oi.shape, (B, 3)) == (B, 3)


def test_lifted_triples_are_kept_by_the_binding():
    """A host triple that meets a device value is filled on the device
    once per binding (kept in Bound.lifted) and reused by later runs."""
    from lucille_tpu_torch.shading import sl
    from lucille_tpu_torch.shading.shader import ShaderContext, ShaderGlobals

    B = 8
    meta = torch.device("meta")
    sg = ShaderGlobals(**{
        k: torch.empty((B, 3) if k not in "stuv" else (B,), device=meta)
        for k in ("P", "N", "Ng", "I", "E", "Cs", "Os", "s", "t", "u", "v",
                  "dPdu", "dPdv")})
    fn, d = sl.compile_sl(_corpus_src("computed_triple"))
    bound = fn.bind(d, meta)
    ctx = ShaderContext(scene=None, key=None)
    fn(sg, bound, ctx)
    lifted = dict(bound.lifted)
    assert lifted and all(v.device == meta for v in lifted.values())
    fn(sg, bound, ctx)
    assert bound.lifted.keys() == lifted.keys()
    assert all(bound.lifted[k] is v for k, v in lifted.items())
    other = fn.bind(d, meta)
    assert other.lifted == {}


def test_load_sl_file_registers_in_the_given_table(tmp_path):
    """load_sl_file compiles a file and registers nothing; find_sl
    compiles `<name>.sl` once per cache it is given, by (name, kind), and
    remembers a missing or malformed source too: nothing process-wide."""
    from lucille_tpu_torch.shading import sl
    from lucille_tpu_torch.shading.shader import get_shader

    (tmp_path / "file_name.sl").write_text(
        "surface sl_declared(float K = 2) { Ci = K * Cs; }")
    (tmp_path / "sl_broken.sl").write_text("surface sl_broken( { Ci = ; }")
    fn = sl.load_sl_file(tmp_path / "file_name.sl")
    assert fn.shader_kind == "surface" and fn.shader_name == "sl_declared"
    np.testing.assert_array_equal(fn.defaults["K"], 2.0)
    assert get_shader("sl_declared")[0] is get_shader("matte")[0]
    sp, cache = [str(tmp_path)], {}
    a = sl.find_sl("file_name", "surface", sp, cache)
    assert a is not fn and a.shader_name == "sl_declared"
    assert sl.find_sl("file_name", "surface", sp, cache) is a
    assert sl.find_sl("file_name", "surface", sp, {}) is not a
    assert sl.find_sl("sl_broken", "surface", sp, cache) is None
    assert sl.find_sl("sl_missing", "surface", sp, cache) is None
    assert set(cache) == {("file_name", "surface"), ("sl_broken", "surface"),
                          ("sl_missing", "surface")}
