"""RSL (RenderMan Shading Language) subset compiler to torch shaders.

Counterpart of lucille_tpu/shading/sl.py, the successor of the
reference's two shader compilers (sl2c, src/sl/, and the LLVM-JIT
engine, src/shader/).  RSL source -> AST (the lexer, AST and parser are
copied from lucille_tpu/shading/sl.py:40-445 unchanged; they are plain
Python) -> a Python closure that evaluates the AST over the wavefront's
tensors (`compile_sl`), the shader contract of shading/shader.py.

Supported subset (lucille_tpu's):
- ``surface name(type p = default; ...) { ... }`` and the displacement,
  volume and imager kinds;
- types float, color, point, vector, normal, string;
- declarations, assignment (=, +=, -=, *=), if/else, for, while,
  illuminance;
- expressions + - * / % . (dot), comparisons, && || !, the ternary;
- the globals Cs Os P N Ng I E s t u v dPdu dPdv L Cl PI, outputs Ci Oi;
- the built-ins ambient diffuse specular occlusion texture trace
  (render/shader.c:488-925) and normalize faceforward reflect refract mix
  clamp min max abs sign sqrt inversesqrt pow exp log sin cos tan asin
  acos atan mod floor ceil round step smoothstep length distance dot
  cross xcomp ycomp zcomp comp noise radians degrees calculatenormal.

Uniform and varying values.  A value that does not vary over the
wavefront (a literal, a number parameter, what is computed from them)
stays on the host as a CPU tensor of lucille_tpu's shape (a 0-d f32 for
a number, (3,) for a literal triple), so control flow on it reads no
device value; a varying value is a tensor on the wavefront's device.
Where the two meet, a host number enters the device op as a Python
scalar, and a host array is filled on the device, element by element,
so that nothing is copied from the host inside a tile (`_on`).  A
binding (`bind`, once per Renderer) keeps what its runs filled, by value
(`Bound.lifted`), so a tile fills each such array at most once for the
Renderer; its array parameters and noise()'s permutation table are
copied to the device when it is bound.  A shader's Ci and Oi reach the
caller on the wavefront's device, a uniform one as a (1, 3) there.
Control flow is lucille_tpu's:
- an `if` on a uniform condition runs one arm in Python; on a varying
  one both arms run and every variable in scope is merged with
  torch.where (a uniform variable merged this way becomes varying, as
  in lucille_tpu);
- `for` and `while` run in Python on uniform conditions, at most 1024
  steps; a varying loop condition warns once and stops the loop.

lucille_tpu's quirks are kept, so that frames compare:
- `occlusion(P, N, samples)` ignores its P and N and always takes 16
  samples (every value lucille_tpu's evaluator hands it is a JAX array,
  which its builtin reads as 16, lucille_tpu/shading/sl.py:539-541);
- `specular(N, V, roughness)` ignores its N and V (sg.N and -sg.I);
- `texture("name", s, t)` answers white without an atlas and fails with
  one (shading/shader.ShaderContext.texture);
- `calculatenormal(P)` is the shading normal: the displacement stage
  rebuilds the normals from the displaced mesh.

There is no process-wide registry: `find_sl` resolves `<name>.sl` on
the search path and compiles it once per cache its caller holds (a
Renderer's, by (name, kind)), for the surfaces and the other stages
alike.
"""

from __future__ import annotations

import dataclasses
import math
import operator
import re
from contextvars import ContextVar
from dataclasses import dataclass

import numpy as np
import torch

from lucille_tpu_torch.base.log import LOG_WARN, log_once
from lucille_tpu_torch.imageio.loader import find_file
from lucille_tpu_torch.lights.sampling import light_wi_cl
from lucille_tpu_torch.ops.frame import norm as _len3
from lucille_tpu_torch.ops.noise import _perm, perlin3
from lucille_tpu_torch.shading.reflection import reflect as _reflect
from lucille_tpu_torch.shading.reflection import refract as _refract
from lucille_tpu_torch.shading.shader import param_value

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOK = re.compile(
    r"""
    (?P<comment>/\*.*?\*/|//[^\n]*)
  | (?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
  | (?P<string>"[^"]*")
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|[-+*/%=<>!?:;,.(){}\[\]])
  | (?P<ws>\s+)
""",
    re.VERBOSE | re.DOTALL,
)

TYPES = {"float", "color", "point", "vector", "normal", "string", "void"}
SHADER_KINDS = {"surface", "displacement", "light", "volume", "imager"}


def _lex(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOK.match(src, pos)
        if not m:
            raise SLError(f"lex error at {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        toks.append((kind, m.group()))
    toks.append(("eof", ""))
    return toks


class SLError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Num:
    v: float


@dataclass
class Str:
    v: str


@dataclass
class Var:
    name: str


@dataclass
class Bin:
    op: str
    a: object
    b: object


@dataclass
class Un:
    op: str
    a: object


@dataclass
class Cond:
    c: object
    a: object
    b: object


@dataclass
class Call:
    name: str
    args: list


@dataclass
class Tuple3:
    items: list  # color/point literal (a, b, c)


@dataclass
class Assign:
    name: str
    op: str
    value: object


@dataclass
class Decl:
    type: str
    name: str
    value: object | None


@dataclass
class If:
    cond: object
    then: list
    els: list


@dataclass
class For:
    init: object
    cond: object
    step: object
    body: list


@dataclass
class While:
    cond: object
    body: list


@dataclass
class Illuminance:
    args: list  # (P[, axis, angle])
    body: list


@dataclass
class ShaderDef:
    kind: str
    name: str
    params: list  # [(type, name, default_expr)]
    body: list


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise SLError(f"expected {val!r}, got {v!r}")
        return v

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # -- toplevel -----------------------------------------------------

    def shader(self) -> ShaderDef:
        k, v = self.next()
        if v not in SHADER_KINDS:
            raise SLError(f"expected shader kind, got {v!r}")
        kind = v
        _, name = self.next()
        params = []
        self.expect("(")
        while not self.accept(")"):
            params.extend(self.param())
            self.accept(";")
        self.expect("{")
        body = self.block_body()
        return ShaderDef(kind, name, params, body)

    def param(self):
        # [output] [uniform|varying] type name [= default] {, name [= default]}
        k, v = self.peek()
        while v in ("output", "uniform", "varying"):
            self.next()
            k, v = self.peek()
        if v not in TYPES:
            raise SLError(f"expected type in params, got {v!r}")
        ptype = self.next()[1]
        out = []
        while True:
            _, pname = self.next()
            default = None
            if self.accept("="):
                default = self.expr()
            out.append((ptype, pname, default))
            if not self.accept(","):
                break
        return out

    def block_body(self):
        stmts = []
        while not self.accept("}"):
            stmts.append(self.statement())
        return stmts

    def statement(self):
        k, v = self.peek()
        if v in ("uniform", "varying"):
            self.next()
            k, v = self.peek()
        if v in TYPES:
            self.next()
            _, name = self.next()
            val = self.expr() if self.accept("=") else None
            decls = [Decl(v, name, val)]
            while self.accept(","):
                _, name2 = self.next()
                val2 = self.expr() if self.accept("=") else None
                decls.append(Decl(v, name2, val2))
            self.expect(";")
            return decls[0] if len(decls) == 1 else decls
        if v == "if":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            then = self._stmt_or_block()
            els = []
            if self.accept("else"):
                els = self._stmt_or_block()
            return If(cond, then, els)
        if v == "for":
            self.next()
            self.expect("(")
            init = self.statement_simple()
            self.expect(";")
            cond = self.expr()
            self.expect(";")
            step = self.statement_simple()
            self.expect(")")
            body = self._stmt_or_block()
            return For(init, cond, step, body)
        if v == "while":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            return While(cond, self._stmt_or_block())
        if v == "illuminance":
            self.next()
            self.expect("(")
            args = [self.expr()]
            while self.accept(","):
                args.append(self.expr())
            self.expect(")")
            return Illuminance(args, self._stmt_or_block())
        if v == "{":
            self.next()
            return self.block_body()
        s = self.statement_simple()
        self.expect(";")
        return s

    def _stmt_or_block(self):
        if self.accept("{"):
            return self.block_body()
        return [self.statement()]

    def statement_simple(self):
        # assignment or expression
        save = self.i
        k, v = self.next()
        if k == "id":
            op = self.peek()[1]
            if op in ("=", "+=", "-=", "*=", "/="):
                self.next()
                return Assign(v, op, self.expr())
        self.i = save
        return self.expr()

    # -- expressions (precedence climbing) ----------------------------

    def expr(self):
        return self.ternary()

    def ternary(self):
        c = self.or_()
        if self.accept("?"):
            a = self.expr()
            self.expect(":")
            b = self.expr()
            return Cond(c, a, b)
        return c

    def or_(self):
        a = self.and_()
        while self.peek()[1] == "||":
            self.next()
            a = Bin("||", a, self.and_())
        return a

    def and_(self):
        a = self.cmp()
        while self.peek()[1] == "&&":
            self.next()
            a = Bin("&&", a, self.cmp())
        return a

    def cmp(self):
        a = self.add()
        while self.peek()[1] in ("<", ">", "<=", ">=", "==", "!="):
            op = self.next()[1]
            a = Bin(op, a, self.add())
        return a

    def add(self):
        a = self.mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            a = Bin(op, a, self.mul())
        return a

    def mul(self):
        a = self.dotprod()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            a = Bin(op, a, self.dotprod())
        return a

    def dotprod(self):
        # RSL '.' is the vector dot product, binding tighter than '*'
        a = self.unary()
        while self.peek()[1] == ".":
            self.next()
            a = Bin(".", a, self.unary())
        return a

    def unary(self):
        k, v = self.peek()
        if v == "-":
            self.next()
            return Un("-", self.unary())
        if v == "!":
            self.next()
            return Un("!", self.unary())
        return self.primary()

    def primary(self):
        k, v = self.next()
        if k == "num":
            return Num(float(v))
        if k == "string":
            return Str(v[1:-1])
        if v == "(":
            first = self.expr()
            if self.accept(","):
                items = [first, self.expr()]
                self.expect(",")
                items.append(self.expr())
                self.expect(")")
                return Tuple3(items)
            self.expect(")")
            return first
        if v in TYPES:  # type cast / constructor: color(...), point "world" (...)
            if self.peek()[0] == "string":
                self.next()  # coordinate-system name: ignored (world only)
            if self.accept("("):
                items = [self.expr()]
                while self.accept(","):
                    items.append(self.expr())
                self.expect(")")
                if len(items) == 1:
                    return Call("_splat3", items)
                return Tuple3(items)
            # cast applied to a bare expression: `color texture(...)`,
            # `float noise(P)` — parse the operand at unary precedence
            operand = self.unary()
            if v in ("color", "point", "vector", "normal"):
                return Call("_splat3", [operand])
            return operand
        if k == "id":
            if self.peek()[1] == "(":
                self.next()
                args = []
                if not self.accept(")"):
                    args.append(self.expr())
                    while self.accept(","):
                        args.append(self.expr())
                    self.expect(")")
                return Call(v, args)
            return Var(v)
        raise SLError(f"unexpected token {v!r}")


def parse_sl(src: str) -> ShaderDef:
    return _Parser(_lex(src)).shader()



# ---------------------------------------------------------------------------
# Evaluator: the AST over torch tensors (module docstring)
# ---------------------------------------------------------------------------

_F32 = torch.float32
_CPU = torch.device("cpu")


def _f32(v) -> torch.Tensor:
    """A uniform f32 number on the host (lucille_tpu's jnp.float32(v))."""
    return torch.tensor(v, dtype=_F32)


def _t(x) -> torch.Tensor:
    """x as a tensor: a Python number as a host f32 (a bool as a bool)."""
    if torch.is_tensor(x):
        return x
    if isinstance(x, (bool, np.bool_)):
        return torch.tensor(bool(x))
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _device(*xs) -> torch.device:
    """The device of the first tensor of xs that is not on the host."""
    for x in xs:
        if torch.is_tensor(x) and x.device.type != "cpu":
            return x.device
    return _CPU


def _uniform_value(x: torch.Tensor):
    """The one value of every element of host tensor x, or None."""
    flat = x.reshape(-1)
    if flat.numel() and bool((flat == flat[0]).all()):
        return flat[0].item()
    return None


class Bound(dict):
    """A shader's parameters bound on a device (`bind`), with what its
    runs there lift from the host: `lifted`, the device arrays filled
    from host arrays, by value (`_on`); `perm`, noise()'s permutation
    table on the device."""

    def __init__(self, params=(), perm=None):
        super().__init__(params)
        self.lifted: dict = {}
        self.perm = perm


# the binding whose shader is running (`run_vars`): `_on` keeps the
# arrays it fills there
_RUNNING: ContextVar = ContextVar("sl_running", default=None)


def _on(x, dev: torch.device) -> torch.Tensor:
    """x on `dev`, with no copy from the host: filled there (one fill when
    its elements are all equal, else one for each), each host array kept
    by the running binding once filled (`Bound.lifted`)."""
    x = _t(x)
    if x.device == dev:
        return x
    v = _uniform_value(x)
    if v is not None:
        return torch.full(x.shape, v, dtype=x.dtype, device=dev)
    vals = x.reshape(-1).tolist()
    key = (tuple(vals), tuple(x.shape), x.dtype, dev)
    bound = _RUNNING.get()
    out = None if bound is None else bound.lifted.get(key)
    if out is None:
        out = torch.empty(len(vals), dtype=x.dtype, device=dev)
        for i, e in enumerate(vals):
            out[i].fill_(e)
        out = out.reshape(x.shape)
        if bound is not None:
            bound.lifted[key] = out
    return out


def _unify(*xs):
    """xs as tensors on one device (the first one not on the host)."""
    dev = _device(*xs)
    return [_on(x, dev) for x in xs]


def _lift(h: torch.Tensor, other: torch.Tensor):
    """Host tensor h as an operand of an elementwise op with `other` on
    the device: a Python scalar where that gives the same result, else a
    tensor there (`_on`)."""
    if h.dim() == 0:
        return h.item()
    v = _uniform_value(h)
    if v is not None and torch.broadcast_shapes(h.shape, other.shape) == \
            other.shape:
        return v
    return _on(h, other.device)


def _pair(a, b):
    """The operands of an elementwise op, a host one lifted (`_lift`)
    where the other is on the device."""
    a, b = _t(a), _t(b)
    if a.device == b.device:
        return a, b
    if a.device.type == "cpu":
        return _lift(a, b), b
    return a, _lift(b, a)


def _is3(x) -> bool:
    return torch.is_tensor(x) and x.dim() >= 1 and x.shape[-1] == 3


def _as3(x) -> torch.Tensor:
    """Promote a scalar (...) to a triple (..., 3) for colour and vector
    arithmetic, as f32 (a number to (1, 3), as lucille_tpu's)."""
    x = _t(x).to(_F32)
    if _is3(x):
        return x
    if x.device.type == "cpu":
        return x[..., None] * torch.ones((1, 3), dtype=_F32)
    if x.dim() == 0:
        return x.reshape(1, 1).expand(1, 3)
    return x[..., None].expand(*x.shape, 3)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis (size 3), summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(_len3(v), 1e-20)


def _binop(op, a, b):
    # promote mixed scalar / triple operands
    at, bt = _is3(a), _is3(b)
    if at != bt:
        a, b = _as3(a), _as3(b)
    if op == ".":
        return _dot3(*_unify(_as3(a), _as3(b)))
    a, b = _pair(a, b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        return torch.remainder(a, b)
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "&&":
        return a & b
    if op == "||":
        return a | b
    raise SLError(f"unknown operator {op}")


def _where(c, a, b) -> torch.Tensor:
    """jnp.where(c, a, b) over host and device operands."""
    c, a, b = _t(c), _t(a), _t(b)
    dev = _device(c, a, b)
    if dev.type == "cpu":
        return torch.where(c, a, b)
    c = _on(c, dev)
    a = a.item() if a.device.type == "cpu" and a.dim() == 0 else _on(a, dev)
    b = b.item() if b.device.type == "cpu" and b.dim() == 0 else _on(b, dev)
    return torch.where(c, a, b)


def _merge(c, a, b) -> torch.Tensor:
    """The varying if's merge of one variable: where(c, a, b), with no
    op where both arms left the same device tensor of the result's
    shape."""
    if a is b and torch.is_tensor(a) and a.device == _device(c, a) and \
            torch.broadcast_shapes(c.shape, a.shape) == a.shape:
        return a
    return _where(c, a, b)


def _clip(x, lo, hi):
    x, lo, hi = _unify(x, lo, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _make_builtins(sg, ctx, perm=None):
    dev = sg.P.device

    def smoothstep(lo, hi, x):
        lo, hi, x = _unify(lo, hi, x)
        t = torch.clamp((x - lo) / torch.clamp_min(hi - lo, 1e-20), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    def faceforward(v, i):
        i3, v3 = _unify(_as3(i), _as3(v))
        return v3 * torch.where(_dot3(i3, v3)[..., None] < 0, 1.0, -1.0)

    def comp(c, i):
        c3, idx = _unify(_as3(c), i)
        idx = idx.to(torch.int64)[..., None]
        if idx.dim() != c3.dim():  # jnp.take_along_axis refuses it too
            raise SLError("comp(): the index and the triple differ in rank")
        shape = torch.broadcast_shapes(c3.shape[:-1], idx.shape[:-1])
        return torch.take_along_dim(c3.expand(*shape, 3),
                                    idx.expand(*shape, 1), dim=-1)[..., 0]

    def noise3(p):
        return perlin3(p, perm if perm is not None and perm.device == p.device
                       else None)

    def noise_fn(*args):
        if len(args) == 1:
            a = _t(args[0])
            if _is3(a):
                return noise3(a)
            z = torch.zeros_like(a)
            return noise3(torch.stack([a, z, z], -1))
        if len(args) == 2:
            a, b = _unify(args[0], args[1])
            return noise3(torch.stack([a, b, torch.zeros_like(a)], -1))
        return noise3(torch.stack(_unify(*args[:3]), -1))

    def refract(i, n, eta):
        i3, n3 = _unify(_as3(i), _as3(n))
        return _refract(i3, n3, _pair(eta, i3)[0])[0]

    def trace(p, d):
        del p
        return ctx.trace(sg, _on(_normalize(_as3(d)), dev).expand(
            sg.P.shape))

    def unary(f):
        return lambda x: f(_t(x))

    def binary(f):
        return lambda a, b: f(*_unify(a, b))

    return {
        # handles for statement-level constructs (illuminance)
        "__ctx__": ctx,
        "__sg__": sg,
        # scene-access builtins (render/shader.c:488-925)
        "ambient": lambda: ctx.ambient(sg),
        "diffuse": lambda n=None: ctx.diffuse(
            sg if n is None else dataclasses.replace(
                sg, N=_on(_normalize(_as3(n)), dev))),
        "specular": lambda n, v, r: ctx.specular(sg, r),
        "occlusion": lambda p=None, n=None, samples=None: ctx.occlusion(
            sg, 16),
        "texture": lambda name, ss=None, tt=None: ctx.texture(
            name, sg.s if ss is None else ss, sg.t if tt is None else tt),
        "trace": trace,
        # math
        "normalize": lambda v: _normalize(_as3(v)),
        "faceforward": faceforward,
        "reflect": lambda i, n: _reflect(*_unify(_as3(i), _as3(n))),
        "refract": refract,
        "mix": lambda a, b, t: _binop("+", _binop("*", a, 1.0 - _t(t)),
                                      _binop("*", b, t)),
        "clamp": _clip,
        "min": binary(torch.minimum),
        "max": binary(torch.maximum),
        "abs": unary(torch.abs),
        "sign": unary(torch.sign),
        "sqrt": unary(lambda x: torch.sqrt(torch.clamp_min(x, 0.0))),
        "inversesqrt": unary(
            lambda x: 1.0 / torch.sqrt(torch.clamp_min(x, 1e-20))),
        "pow": lambda a, b: torch.pow(*_unify(torch.clamp_min(_t(a), 0.0),
                                              b)),
        "exp": unary(torch.exp),
        "log": unary(lambda x: torch.log(torch.clamp_min(x, 1e-30))),
        "sin": unary(torch.sin),
        "cos": unary(torch.cos),
        "tan": unary(torch.tan),
        "asin": unary(lambda x: torch.asin(torch.clamp(x, -1.0, 1.0))),
        "acos": unary(lambda x: torch.acos(torch.clamp(x, -1.0, 1.0))),
        "atan": lambda a, b=None: (torch.atan(_t(a)) if b is None
                                   else torch.atan2(*_unify(a, b))),
        "mod": binary(torch.remainder),
        "floor": unary(torch.floor),
        "ceil": unary(torch.ceil),
        "round": unary(torch.round),
        "step": lambda edge, x: operator.ge(*_pair(x, edge)).to(_F32),
        "smoothstep": smoothstep,
        "length": lambda v: _len3(_as3(v))[..., 0],
        "distance": lambda a, b: _len3(_binop("-", _as3(a), _as3(b)))[..., 0],
        "dot": lambda a, b: _dot3(*_unify(_as3(a), _as3(b))),
        "cross": lambda a, b: torch.linalg.cross(*_unify(_as3(a), _as3(b)),
                                                 dim=-1),
        "xcomp": lambda v: _as3(v)[..., 0],
        "ycomp": lambda v: _as3(v)[..., 1],
        "zcomp": lambda v: _as3(v)[..., 2],
        "comp": comp,
        "noise": noise_fn,
        "_splat3": _as3,
        "radians": unary(lambda x: x * (math.pi / 180.0)),
        "degrees": unary(lambda x: x * (180.0 / math.pi)),
        # displacement: the mesh pipeline rebuilds the normals from the
        # displaced vertices (shading/pipeline.py), so calculatenormal is
        # the shading normal here
        "calculatenormal": lambda p: _as3(sg.N),
    }


class _Env:
    def __init__(self, builtins):
        self.vars: dict = {}
        self.builtins = builtins

    def child_scope(self):
        e = _Env(self.builtins)
        e.vars = dict(self.vars)
        return e


def _eval(node, env):
    if isinstance(node, Num):
        return _f32(node.v)
    if isinstance(node, Str):
        return node.v
    if isinstance(node, Var):
        if node.name in env.vars:
            return env.vars[node.name]
        raise SLError(f"undefined variable {node.name}")
    if isinstance(node, Tuple3):
        items = _unify(*(_t(_eval(i, env)).to(_F32) for i in node.items))
        shape = torch.broadcast_shapes(*(i.shape for i in items))
        return torch.stack([i.expand(shape) for i in items], dim=-1)
    if isinstance(node, Bin):
        return _binop(node.op, _eval(node.a, env), _eval(node.b, env))
    if isinstance(node, Un):
        v = _eval(node.a, env)
        return ~v if node.op == "!" else -v
    if isinstance(node, Cond):
        c = _t(_eval(node.c, env))
        a = _eval(node.a, env)
        b = _eval(node.b, env)
        if _is3(a) or _is3(b):
            a, b = _as3(a), _as3(b)
            c = c[..., None] if c.dim() >= 1 else c
        return _where(c, a, b)
    if isinstance(node, Call):
        fn = env.builtins.get(node.name)
        if fn is None:
            log_once(LOG_WARN, "unknown SL function '%s'; returning 0",
                     node.name)
            return _f32(0.0)
        args = [_eval(a, env) for a in node.args]
        return fn(*args)
    raise SLError(f"cannot evaluate {node}")


def _default_for(tname, B):
    if tname in ("color", "point", "vector", "normal"):
        return torch.zeros((B, 3), dtype=_F32)
    if tname == "string":
        return ""
    return _f32(0.0)


def _uniform(cond) -> bool:
    """Whether a condition is decided on the host: lucille_tpu's 0-d
    values, apart from a 0-d device tensor (never made by the evaluator),
    whose read would wait for the device."""
    return not torch.is_tensor(cond) or (cond.dim() == 0
                                         and cond.device.type == "cpu")


def _exec_block(stmts, env):
    for s in stmts:
        _exec(s, env)


def _exec(stmt, env):
    if isinstance(stmt, list):
        _exec_block(stmt, env)
        return
    if isinstance(stmt, Decl):
        env.vars[stmt.name] = (
            _eval(stmt.value, env) if stmt.value is not None else None
        )
        if env.vars[stmt.name] is None:
            env.vars[stmt.name] = _default_for(stmt.type, 1)
        return
    if isinstance(stmt, Assign):
        val = _eval(stmt.value, env)
        if stmt.op != "=":
            cur = env.vars.get(stmt.name, _f32(0.0))
            val = _binop(stmt.op[0], cur, val)
        env.vars[stmt.name] = val
        return
    if isinstance(stmt, If):
        cond = _eval(stmt.cond, env)
        if _uniform(cond):
            # uniform condition: take one branch (python control flow)
            branch = stmt.then if bool(cond) else stmt.els
            _exec_block(branch, env)
            return
        # varying condition: run both arms, merge with where
        then_env = env.child_scope()
        else_env = env.child_scope()
        _exec_block(stmt.then, then_env)
        _exec_block(stmt.els, else_env)
        for name in set(then_env.vars) | set(else_env.vars):
            a = then_env.vars.get(name, env.vars.get(name))
            b = else_env.vars.get(name, env.vars.get(name))
            if a is None or b is None or isinstance(a, str):
                env.vars[name] = a if a is not None else b
                continue
            c = cond
            if _is3(a) or _is3(b):
                a, b = _as3(a), _as3(b)
                c = cond[..., None]
            env.vars[name] = _merge(c, a, b)
        return
    if isinstance(stmt, For):
        _exec(stmt.init, env)
        for _ in range(1024):  # bounded; uniform conditions only
            cond = _eval(stmt.cond, env)
            if not _uniform(cond):
                log_once(LOG_WARN,
                         "varying for-loop condition unsupported; stopping")
                break
            if not bool(cond):
                break
            _exec_block(stmt.body, env)
            _exec(stmt.step, env)
        return
    if isinstance(stmt, While):
        for _ in range(1024):
            cond = _eval(stmt.cond, env)
            if not _uniform(cond):
                log_once(LOG_WARN,
                         "varying while condition unsupported; stopping")
                break
            if not bool(cond):
                break
            _exec_block(stmt.body, env)
        return
    if isinstance(stmt, Illuminance):
        # illuminance(P[, axis, angle]) { ... }: the body once per light
        # with L (surface to light) and Cl (shadowed light colour) bound,
        # the statement-level twin of diffuse() (shader.c:504)
        ctx = env.builtins.get("__ctx__")
        sg = env.builtins.get("__sg__")
        if ctx is None or ctx.lights is None:
            return
        for li, light in enumerate(ctx.lights):
            wi, cl = light_wi_cl(ctx.scene, light, sg.P, sg.N, ctx.key, li)
            if wi is None:
                continue
            env.vars["L"] = wi
            env.vars["Cl"] = cl
            _exec_block(stmt.body, env)
        return
    # bare expression statement
    _eval(stmt, env)


def _walk(node):
    """Every AST node below node (node included), depth first."""
    yield node
    if isinstance(node, list):
        children = node
    elif hasattr(node, "__dataclass_fields__"):
        children = [getattr(node, f) for f in node.__dataclass_fields__]
    else:
        children = ()
    for c in children:
        if isinstance(c, (list, tuple)) or hasattr(c, "__dataclass_fields__"):
            yield from _walk(c)


def compile_sl(src: str):
    """Compile RSL source to (shader_fn, default_params).

    shader_fn(sg, params, ctx) -> (Ci, Oi), the shader contract of
    shading/shader.py, both on sg's device; shader_fn.run_vars(sg,
    params, ctx, extra_globals) runs it and returns the final variables
    (the displacement, atmosphere and imager stages read P, Ci and alpha
    there); shader_fn.bind(params, device) binds its parameters for a
    Renderer (a `Bound`; module docstring); shader_fn.defaults is
    default_params."""
    ast = parse_sl(src)

    # evaluate parameter defaults once with a minimal env
    def make_defaults():
        env = _Env({})
        env.builtins = {"_splat3": lambda x: _t(x)[..., None] * torch.ones(3)}
        out = {}
        for ptype, pname, default in ast.params:
            if default is None:
                out[pname] = 0.0
            else:
                try:
                    v = _eval(default, env)
                    out[pname] = v if isinstance(v, str) else np.asarray(v)
                except SLError:
                    out[pname] = 0.0
        return out

    defaults = make_defaults()
    uses_noise = any(isinstance(n, Call) and n.name == "noise"
                     for n in _walk(ast.body))

    def bind(params, device):
        dev = torch.device(device)
        return Bound({pname: param_value(params.get(pname, defaults.get(
            pname, 0.0)), dev) for _ty, pname, _d in ast.params},
            _perm(dev) if uses_noise else None)

    def run_vars(sg, params, ctx, extra_globals=None):
        """Run the shader and return the FINAL variables: displacement
        shaders are read back through P / N, imagers through Ci / alpha,
        volumes through Ci / Oi (render/shader.h ABI scope)."""
        bound = params if isinstance(params, Bound) else Bound()
        token = _RUNNING.set(bound)
        try:
            env = _Env(_make_builtins(sg, ctx, bound.perm))
            B = sg.P.shape[0]
            dev = sg.P.device
            env.vars.update({
                "Cs": sg.Cs, "Os": sg.Os, "P": sg.P, "N": sg.N, "Ng": sg.Ng,
                "I": sg.I, "E": sg.E, "s": sg.s, "t": sg.t, "u": sg.u,
                "v": sg.v, "dPdu": sg.dPdu, "dPdv": sg.dPdv,
                "PI": _f32(np.pi),
                "Ci": torch.zeros((B, 3), dtype=_F32, device=dev),
                "Oi": sg.Os,
            })
            if extra_globals:
                env.vars.update(extra_globals)
            for _ty, pname, _d in ast.params:
                val = params.get(pname, defaults.get(pname, 0.0))
                env.vars[pname] = param_value(val, dev)
            _exec_block(ast.body, env)
            # a uniform output on the wavefront's device, as a varying one
            for name in ("Ci", "Oi", "P", "N"):
                val = env.vars.get(name)
                if torch.is_tensor(val) and val.device != dev:
                    env.vars[name] = _on(_as3(val), dev)
            return env.vars
        finally:
            _RUNNING.reset(token)

    def shader_fn(sg, params, ctx):
        env_vars = run_vars(sg, params, ctx)
        return _as3(env_vars["Ci"]), _as3(env_vars["Oi"])

    shader_fn.__name__ = f"sl_{ast.name}"
    shader_fn.shader_name = ast.name
    shader_fn.shader_kind = ast.kind
    shader_fn.run_vars = run_vars
    shader_fn.bind = bind
    shader_fn.defaults = defaults
    return shader_fn, defaults


def load_sl_file(path):
    """Compile an .sl file (the replacement of the reference's dlopen of
    a shader DSO, attribute.c:372-428): its shader_fn (`compile_sl`)."""
    with open(path) as f:
        return compile_sl(f.read())[0]


def find_sl(name, kind, searchpaths, cache: dict | None = None):
    """The `kind` shader `name` compiled from `<name>.sl` on the search
    paths (imageio/loader.find_file), once per cache (a Renderer's dict,
    by (name, kind); None: compiled on each call); None, with a warning
    once, if there is no such file or it does not compile (the reference
    warns for each shader DSO it cannot load).  A source of another kind
    warns once and is used, as in lucille_tpu.  (find_file's last resort,
    the working directory, is lucille_tpu's stages' and not its
    surfaces'; a RIB's search paths start with it, ".", in both.)"""
    key = (name, kind)
    if cache is not None and key in cache:
        return cache[key]
    fn = None
    path = find_file(f"{name}.sl", searchpaths)
    if path is None:
        log_once(LOG_WARN, "%s shader '%s' not found on the search path",
                 kind, name)
    else:
        try:
            fn = load_sl_file(path)
        except Exception as e:  # noqa: BLE001 (a malformed .sl)
            log_once(LOG_WARN, "cannot compile %s shader '%s' (%s): %s",
                     kind, name, path, e)
        if fn is not None and fn.shader_kind != kind:
            log_once(LOG_WARN, "'%s.sl' is a %s shader, expected %s; using "
                     "it anyway", name, fn.shader_kind, kind)
    if cache is not None:
        cache[key] = fn
    return fn
