"""Directive parser (counterpart of src/core/parser.cpp parse()).

Pulls the token stream, reads each directive's fixed arguments and trailing
`"type name" [values]` parameter lists, and dispatches into `SceneBuilder`.
`Include` splices files recursively with tolerant path resolution (the
reference scenes embed the thesis author's absolute paths)."""

from __future__ import annotations

import os
from typing import List, Optional

from tpupt_torch.scene.api import SceneBuilder, SceneDescription
from tpupt_torch.scene.params import ParamSet
from tpupt_torch.scene.tokenizer import Token, tokenize
from tpupt_torch.utils import logging as tlog


class _TokenStream:
    def __init__(self):
        self.stack: List[List[Token]] = []
        self.pos: List[int] = []

    def push_file(self, tokens: List[Token]):
        self.stack.append(tokens)
        self.pos.append(0)

    def peek(self) -> Optional[Token]:
        while self.stack:
            if self.pos[-1] < len(self.stack[-1]):
                return self.stack[-1][self.pos[-1]]
            self.stack.pop()
            self.pos.pop()
        return None

    def next(self) -> Optional[Token]:
        t = self.peek()
        if t is not None:
            self.pos[-1] += 1
        return t


def _is_quoted(t: Token) -> bool:
    return t.text.startswith('"')


def _unquote(t: Token) -> str:
    return t.text[1:-1]


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _resolve_include(path: str, current_dir: str, root_dir: str) -> Optional[str]:
    base = os.path.basename(path)
    candidates = [
        path if os.path.isabs(path) else os.path.join(current_dir, path),
        os.path.join(current_dir, base),
        os.path.join(current_dir, "geometry", base),
        os.path.join(root_dir, path),
        os.path.join(root_dir, base),
        os.path.join(root_dir, "geometry", base),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def _read_values(ts: _TokenStream, filename: str) -> list:
    """Read a single value or a bracketed list following a param decl."""
    t = ts.peek()
    values = []
    if t is not None and t.text == "[":
        ts.next()
        while True:
            t = ts.next()
            if t is None:
                raise SyntaxError(f"{filename}: unterminated [ list")
            if t.text == "]":
                break
            values.append(_unquote(t) if _is_quoted(t) else _coerce(t.text))
    else:
        t = ts.next()
        if t is None:
            raise SyntaxError(f"{filename}: missing parameter value")
        values.append(_unquote(t) if _is_quoted(t) else _coerce(t.text))
    return values


def _coerce(s: str):
    if s in ("true", "false"):
        return s
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def _read_params(ts: _TokenStream, filename: str) -> ParamSet:
    """Read trailing `"type name" [...]` declarations until the next directive."""
    ps = ParamSet()
    while True:
        t = ts.peek()
        if t is None or not _is_quoted(t):
            return ps
        decl = _unquote(t)
        parts = decl.split()
        if len(parts) != 2:
            # A lone quoted string belongs to the next directive.
            return ps
        from tpupt_torch.scene.params import KNOWN_TYPES

        if parts[0] not in KNOWN_TYPES:
            return ps
        ts.next()
        ps.add(decl, _read_values(ts, filename))


def _read_floats(ts: _TokenStream, n: int, directive: str) -> List[float]:
    out = []
    for _ in range(n):
        t = ts.next()
        if t is None or not _is_number(t.text):
            raise SyntaxError(
                f"{directive}: expected {n} numeric arguments"
                + (f", got {t.text!r}" if t else ", hit EOF")
            )
        out.append(float(t.text))
    return out


def _read_string(ts: _TokenStream, directive: str) -> str:
    t = ts.next()
    if t is None or not _is_quoted(t):
        raise SyntaxError(f"{directive}: expected quoted string argument")
    return _unquote(t)


DEFAULT_SUBST = {"$acc": '"bvh"', "$accnr": "3", "$splitalpha": "90",
                 # integer-typed in the reference (genericBSP.h:68)
                 "$alphatype": "0", "$axisselectiontype": "0",
                 "$axisselectionamount": "-1"}


def _substitute(text: str, subst) -> str:
    """Experiment templating: the thesis scenes carry `$acc`-style
    placeholders replaced by sed in render_simple.sh:24-29."""
    if subst is None:
        subst = {}
    merged = dict(DEFAULT_SUBST)
    merged.update(subst)
    for k, v in sorted(merged.items(), key=lambda kv: -len(kv[0])):
        text = text.replace(k, str(v))
    return text


def parse_string(text: str, filename: str = "<string>",
                 search_dir: str = ".", subst=None) -> SceneDescription:
    ts = _TokenStream()
    ts.push_file(list(tokenize(_substitute(text, subst), filename)))
    return _parse(ts, search_dir, search_dir)


def parse_file(path: str, subst=None) -> SceneDescription:
    """The scene file `path` parsed, in a `scene.parse` span."""
    with tlog.annotate("scene.parse"):
        ts = _TokenStream()
        with open(path, "r", errors="replace") as f:
            ts.push_file(list(tokenize(_substitute(f.read(), subst), path)))
        root = os.path.dirname(os.path.abspath(path))
        return _parse(ts, root, root)


def _parse(ts: _TokenStream, current_dir: str, root_dir: str) -> SceneDescription:
    b = SceneBuilder()
    while True:
        tok = ts.next()
        if tok is None:
            break
        d = tok.text
        fname = tok.filename
        if d == "Include":
            inc = _read_string(ts, d)
            resolved = _resolve_include(inc, current_dir, root_dir)
            if resolved is None:
                raise FileNotFoundError(f"{fname}:{tok.line}: Include {inc!r} not found")
            with open(resolved, "r", errors="replace") as f:
                ts.push_file(list(tokenize(f.read(), resolved)))
        elif d == "LookAt":
            b.look_at(*_read_floats(ts, 9, d))
        elif d == "Translate":
            b.translate(*_read_floats(ts, 3, d))
        elif d == "Scale":
            b.scale(*_read_floats(ts, 3, d))
        elif d == "Rotate":
            b.rotate(*_read_floats(ts, 4, d))
        elif d == "Identity":
            b.identity()
        elif d == "ConcatTransform":
            t = ts.next()
            vals = []
            if t is not None and t.text == "[":
                while True:
                    t = ts.next()
                    if t.text == "]":
                        break
                    vals.append(float(t.text))
            b.concat_transform(vals)
        elif d == "Transform":
            t = ts.next()
            vals = []
            if t is not None and t.text == "[":
                while True:
                    t = ts.next()
                    if t.text == "]":
                        break
                    vals.append(float(t.text))
            b.set_transform(vals)
        elif d == "CoordinateSystem":
            b.coordinate_system(_read_string(ts, d))
        elif d == "CoordSysTransform":
            b.coord_sys_transform(_read_string(ts, d))
        elif d == "ActiveTransform":
            t = ts.next()
            b.active_transform(t.text)
        elif d == "TransformTimes":
            b.transform_times(*_read_floats(ts, 2, d))
        elif d == "Camera":
            name = _read_string(ts, d)
            b.camera(name, _read_params(ts, fname))
        elif d == "Film":
            name = _read_string(ts, d)
            b.film(name, _read_params(ts, fname))
        elif d == "Sampler":
            name = _read_string(ts, d)
            b.sampler(name, _read_params(ts, fname))
        elif d == "Integrator":
            name = _read_string(ts, d)
            b.integrator(name, _read_params(ts, fname))
        elif d == "Accelerator":
            name = _read_string(ts, d)
            b.accelerator(name, _read_params(ts, fname))
        elif d == "PixelFilter":
            name = _read_string(ts, d)
            b.pixel_filter(name, _read_params(ts, fname))
        elif d == "MakeNamedMedium":
            name = _read_string(ts, d)
            b.make_named_medium(name, _read_params(ts, fname))
        elif d == "MediumInterface":
            inside = _read_string(ts, d)
            t = ts.peek()
            outside = _unquote(ts.next()) if t is not None and _is_quoted(t) and " " not in t.text else ""
            b.medium_interface(inside, outside)
        elif d == "WorldBegin":
            b.world_begin()
        elif d == "WorldEnd":
            pass  # build result returned after the loop
        elif d == "AttributeBegin":
            b.attribute_begin()
        elif d == "AttributeEnd":
            b.attribute_end()
        elif d == "TransformBegin":
            b.transform_begin()
        elif d == "TransformEnd":
            b.transform_end()
        elif d == "ReverseOrientation":
            b.reverse_orientation()
        elif d == "Material":
            name = _read_string(ts, d)
            b.material(name, _read_params(ts, fname))
        elif d == "MakeNamedMaterial":
            name = _read_string(ts, d)
            b.make_named_material(name, _read_params(ts, fname))
        elif d == "NamedMaterial":
            b.named_material(_read_string(ts, d))
        elif d == "Texture":
            name = _read_string(ts, d)
            kind = _read_string(ts, d)
            klass = _read_string(ts, d)
            b.texture(name, kind, klass, _read_params(ts, fname))
        elif d == "LightSource":
            name = _read_string(ts, d)
            b.light_source(name, _read_params(ts, fname))
        elif d == "AreaLightSource":
            name = _read_string(ts, d)
            b.area_light_source(name, _read_params(ts, fname))
        elif d == "Shape":
            name = _read_string(ts, d)
            b.shape(name, _read_params(ts, fname), filename=fname)
        elif d == "ObjectBegin":
            b.object_begin(_read_string(ts, d))
        elif d == "ObjectEnd":
            b.object_end()
        elif d == "ObjectInstance":
            b.object_instance(_read_string(ts, d))
        else:
            raise SyntaxError(f"{fname}:{tok.line}: unknown directive {d!r}")
    return b.world_end()
