"""RIB parser: token stream → Ri state-machine calls.

Table-driven replacement for the bison grammar (src/lsh/parserib.y): each
RIB command consumes its positional arguments and a trailing parameter
list of ("declared token", value) pairs.  Unknown commands skip their
arguments and count toward the 30-strike abort (parserib.y:41-42,869-871).

ReadArchive is resolved against the option searchpaths (lexrib.l include
stack; main.c:77-102 adds the RIB's directory and cwd).

The port's copy of lucille_tpu/rib/parser.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

from pathlib import Path

from lucille_tpu_torch.base.log import LOG_WARN, log
from lucille_tpu_torch.rib.lexer import Token, TokenKind, read_rib_text, tokenize


class ParseError(RuntimeError):
    pass


class _Cursor:
    def __init__(self, tokens: list):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Token | None:
        t = self.peek()
        if t is not None:
            self.i += 1
        return t

    def collect_args(self) -> list:
        """Consume values (numbers/strings/arrays) until the next command ID."""
        args = []
        while True:
            t = self.peek()
            if t is None or t.kind == TokenKind.ID:
                return args
            if t.kind == TokenKind.LBRACKET:
                self.next()
                arr = []
                while True:
                    t2 = self.peek()
                    if t2 is None:
                        log(LOG_WARN, "unterminated array in RIB")
                        return args + [arr]
                    if t2.kind == TokenKind.RBRACKET:
                        self.next()
                        break
                    if t2.kind in (TokenKind.NUMBER, TokenKind.STRING):
                        arr.append(self.next().value)
                    else:
                        # stray ID inside array: abort array to resync
                        log(LOG_WARN, "malformed array near line %d", t2.line)
                        break
                args.append(arr)
            else:
                args.append(self.next().value)


def _split_params(args: list, npositional: int):
    """Split args into positional part and a {token: value} parameter dict.

    Parameter lists are (string token, value) pairs; a value may be an
    array or a single scalar/string (zero_string_param_20090212.rib has
    ``"uniform string ColMap" [ "" ]``).
    """
    pos = args[:npositional]
    rest = args[npositional:]
    params = {}
    i = 0
    # strict (token, value) alternation: the value may be an array, a bare
    # number, or a bare string ('"sampling" "cosweight"' is legal RIB).
    while i < len(rest):
        key = rest[i]
        if not isinstance(key, str):
            i += 1  # stray value with no token: skip
            continue
        if i + 1 < len(rest):
            params[key] = rest[i + 1]
            i += 2
        else:
            params[key] = None
            i += 1
    return pos, params


def _f(v):
    if isinstance(v, list):
        return float(v[0])
    return float(v)


def parse_rib(text: str, state, searchpaths=None, depth: int = 0) -> None:
    """Parse RIB text, driving `state` (a lucille_tpu.ri.api.RiState)."""
    tokens = list(tokenize(text))
    cur = _Cursor(tokens)
    searchpaths = list(searchpaths or ["."])

    while True:
        t = cur.next()
        if t is None:
            return
        if t.kind != TokenKind.ID:
            continue  # stray value at top level: skip (parser tolerance)
        name = t.value
        line = t.line
        args = cur.collect_args()
        try:
            _dispatch(state, name, args, line, searchpaths, depth)
        except Exception as e:  # noqa: BLE001 — tolerate per-command errors
            from lucille_tpu_torch.ri.api import TooManyUnknownCommands

            if isinstance(e, TooManyUnknownCommands):
                raise
            log(LOG_WARN, "error in RIB command %s at line %d: %s", name, line, e)


def parse_rib_file(path, state, extra_searchpaths=None) -> None:
    """Parse a RIB file; its directory and cwd join the searchpath
    (reference main.c:77-102,192-196).  Relative searchpath entries added
    later by Option "searchpath" resolve against the RIB's directory."""
    path = Path(path)
    state.options.impl["rib_dir"] = str(path.parent)
    sp = [str(path.parent), "."]
    for p in extra_searchpaths or []:
        if p not in sp:
            sp.append(p)
    for p in getattr(state.options, "searchpaths", []):
        if p not in sp:
            sp.append(p)
    state.options.searchpaths = sp
    parse_rib(read_rib_text(path), state, searchpaths=sp)


def _find_file(name: str, searchpaths, base_dir: str | None = None) -> Path | None:
    p = Path(name)
    if p.is_absolute() and p.exists():
        return p
    for sp in searchpaths:
        if sp == "@":  # RenderMan: '@' = the default search path
            continue
        cand = Path(sp) / name
        if cand.exists():
            return cand
        if base_dir is not None and not Path(sp).is_absolute():
            cand = Path(base_dir) / sp / name
            if cand.exists():
                return cand
    return None


def _dispatch(state, name, args, line, searchpaths, depth):
    s = state
    if name == "version":
        return
    if name == "ReadArchive":
        if depth > 16:
            log(LOG_WARN, "ReadArchive nesting too deep; skipping")
            return
        fname = args[0] if args else None
        if isinstance(fname, list):
            fname = fname[0] if fname else None
        if not fname:
            return
        f = _find_file(
            str(fname),
            searchpaths + list(s.options.searchpaths),
            base_dir=s.options.impl.get("rib_dir"),
        )
        if f is None:
            log(LOG_WARN, "ReadArchive: cannot find '%s'", fname)
            return
        parse_rib(read_rib_text(f), s, searchpaths=searchpaths, depth=depth + 1)
        return

    # -- zero-arg block commands --
    simple = {
        "WorldBegin": s.WorldBegin,
        "WorldEnd": s.WorldEnd,
        "AttributeBegin": s.AttributeBegin,
        "AttributeEnd": s.AttributeEnd,
        "TransformBegin": s.TransformBegin,
        "TransformEnd": s.TransformEnd,
        "FrameEnd": s.FrameEnd,
        "MotionEnd": s.MotionEnd,
        "Identity": s.Identity,
    }
    if name in simple:
        simple[name]()
        return

    if name == "FrameBegin":
        s.FrameBegin(int(_f(args[0])) if args else 0)
    elif name == "MotionBegin":
        s.MotionBegin(args[0] if args else [])
    elif name == "Transform":
        s.Transform(args[0])
    elif name == "ConcatTransform":
        s.ConcatTransform(args[0])
    elif name == "Translate":
        s.Translate(_f(args[0]), _f(args[1]), _f(args[2]))
    elif name == "Rotate":
        s.Rotate(_f(args[0]), _f(args[1]), _f(args[2]), _f(args[3]))
    elif name == "Scale":
        s.Scale(_f(args[0]), _f(args[1]), _f(args[2]))
    elif name == "Perspective":
        s.Perspective(_f(args[0]))
    elif name == "CoordinateSystem":
        s.CoordinateSystem(args[0])
    elif name == "Format":
        s.Format(int(_f(args[0])), int(_f(args[1])),
                 _f(args[2]) if len(args) > 2 else 1.0)
    elif name == "FrameAspectRatio":
        s.FrameAspectRatio(_f(args[0]))
    elif name == "ScreenWindow":
        s.ScreenWindow(_f(args[0]), _f(args[1]), _f(args[2]), _f(args[3]))
    elif name == "CropWindow":
        s.CropWindow(_f(args[0]), _f(args[1]), _f(args[2]), _f(args[3]))
    elif name == "Clipping":
        s.Clipping(_f(args[0]), _f(args[1]))
    elif name == "DepthOfField":
        s.DepthOfField(_f(args[0]), _f(args[1]), _f(args[2]))
    elif name == "Shutter":
        s.Shutter(_f(args[0]), _f(args[1]))
    elif name == "Projection":
        pos, params = _split_params(args, 1)
        s.Projection(pos[0] if pos else "orthographic", params)
    elif name == "Orientation":
        s.Orientation(args[0])
    elif name == "Display":
        pos, params = _split_params(args, 3)
        while len(pos) < 3:
            pos.append("rgb")
        s.Display(pos[0], pos[1], pos[2], params)
    elif name == "PixelSamples":
        s.PixelSamples(_f(args[0]), _f(args[1]))
    elif name == "PixelFilter":
        s.PixelFilter(args[0], _f(args[1]), _f(args[2]))
    elif name == "Exposure":
        s.Exposure(_f(args[0]), _f(args[1]))
    elif name == "Quantize":
        s.Quantize(args[0], _f(args[1]), _f(args[2]), _f(args[3]), _f(args[4]))
    elif name == "Hider":
        pos, params = _split_params(args, 1)
        s.Hider(pos[0] if pos else "hidden", params)
    elif name == "Declare":
        s.Declare(args[0], args[1] if len(args) > 1 else "")
    elif name == "Option":
        pos, params = _split_params(args, 1)
        s.Option(pos[0] if pos else "", params)
    elif name == "Attribute":
        pos, params = _split_params(args, 1)
        s.Attribute(pos[0] if pos else "", params)
    elif name == "Color":
        s.Color(args[0] if isinstance(args[0], list) else args[:3])
    elif name == "Opacity":
        s.Opacity(args[0] if isinstance(args[0], list) else args[:3])
    elif name == "Sides":
        s.Sides(int(_f(args[0])))
    elif name == "ShadingRate":
        s.ShadingRate(_f(args[0]))
    elif name == "ShadingInterpolation":
        s.ShadingInterpolation(args[0])
    elif name == "Surface":
        pos, params = _split_params(args, 1)
        s.Surface(pos[0] if pos else "", params)
    elif name == "Displacement":
        pos, params = _split_params(args, 1)
        s.Displacement(pos[0] if pos else "", params)
    elif name == "Atmosphere":
        pos, params = _split_params(args, 1)
        s.Atmosphere(pos[0] if pos else "", params)
    elif name == "Imager":
        pos, params = _split_params(args, 1)
        s.Imager(pos[0] if pos else "", params)
    elif name == "LightSource":
        pos, params = _split_params(args, 2)  # name + handle number
        s.LightSource(pos[0] if pos else "", params)
    elif name == "AreaLightSource":
        pos, params = _split_params(args, 2)
        s.AreaLightSource(pos[0] if pos else "", params)
    elif name == "Illuminate":
        s.Illuminate(int(_f(args[0])), bool(_f(args[1])) if len(args) > 1 else True)
    elif name == "Polygon":
        pos, params = _split_params(args, 0)
        s.Polygon(params)
    elif name == "PointsPolygons":
        pos, params = _split_params(args, 2)
        s.PointsPolygons(pos[0], pos[1], params)
    elif name == "PointsGeneralPolygons":
        pos, params = _split_params(args, 3)
        s.PointsGeneralPolygons(pos[0], pos[1], pos[2], params)
    elif name == "Sphere":
        pos, params = _split_params(args, 4)
        s.Sphere(_f(pos[0]), _f(pos[1]), _f(pos[2]), _f(pos[3]), params)
    elif name == "SubdivisionMesh":
        pos, params = _split_params(args, 3)
        s.SubdivisionMesh(pos[0], pos[1], pos[2], params)
    elif name == "Curves":
        pos, params = _split_params(args, 3)
        s.Curves(pos[0], pos[1], pos[2], params)
    else:
        s.unknown_command(name, line)
