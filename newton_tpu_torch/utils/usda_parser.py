"""Minimal USDA (text USD) parser (port of
``newton_tpu/utils/usda_parser.py``, which imports no JAX; the port keeps
its own copy so that it never imports the JAX package).

The upstream importer reads USD through the pxr C++ library; this module
parses the text ``.usda`` format directly — prim tree, attribute
values (scalars, vectors, arrays, tokens, relationships), metadata — enough
for the UsdPhysics/UsdGeom subset the importer consumes
(reference: newton/_src/utils/import_usd.py + usd/schema_resolver.py).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

__all__ = ["UsdaPrim", "parse_usda"]


class UsdaPrim:
    """A prim: type name, path, attributes, children, applied API schemas."""

    def __init__(self, name: str, type_name: str, path: str):
        self.name = name
        self.type_name = type_name
        self.path = path
        self.attrs: Dict[str, Any] = {}
        self.metadata: Dict[str, Any] = {}
        self.api_schemas: List[str] = []
        self.children: List["UsdaPrim"] = []

    def get(self, attr: str, default=None):
        return self.attrs.get(attr, default)

    def has_api(self, api: str) -> bool:
        return any(api in s for s in self.api_schemas)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):
        return f"UsdaPrim({self.type_name} {self.path})"


_TOKEN_RE = re.compile(r'''
    "(?:[^"\\]|\\.)*"            |  # string
    <[^>]*>                      |  # path ref
    \(|\)|\[|\]|\{|\}|=|,|;      |
    [^\s()\[\]{}=,;]+
''', re.VERBOSE)


def _tokenize(text: str) -> List[str]:
    # strip comments
    text = re.sub(r"#[^\n]*", "", text)
    return _TOKEN_RE.findall(text)


def _parse_value(toks: List[str], i: int) -> Tuple[Any, int]:
    t = toks[i]
    if t == "(":
        vals = []
        i += 1
        while toks[i] != ")":
            if toks[i] == ",":
                i += 1
                continue
            v, i = _parse_value(toks, i)
            vals.append(v)
        return tuple(vals), i + 1
    if t == "[":
        vals = []
        i += 1
        while toks[i] != "]":
            if toks[i] == ",":
                i += 1
                continue
            v, i = _parse_value(toks, i)
            vals.append(v)
        return vals, i + 1
    if t.startswith('"'):
        return t[1:-1], i + 1
    if t.startswith("<"):
        return t[1:-1], i + 1
    if t in ("true", "false"):
        return t == "true", i + 1
    if t == "None":
        return None, i + 1
    try:
        if "." in t or "e" in t or "E" in t or "inf" in t:
            return float(t), i + 1
        return int(t), i + 1
    except ValueError:
        return t, i + 1


_TYPE_WORDS = {
    "float", "double", "int", "bool", "token", "string", "asset", "rel",
    "float2", "float3", "float4", "double3", "quatf", "quatd", "point3f",
    "normal3f", "vector3f", "color3f", "matrix4d", "int2", "texCoord2f",
    "float3[]", "int[]", "point3f[]", "normal3f[]", "quatf[]", "double[]",
    "float[]", "texCoord2f[]", "color3f[]", "vector3f[]", "token[]",
    "string[]", "double3[]", "matrix4d[]", "uchar", "int64",
}


def parse_usda(text: str) -> UsdaPrim:
    """Parse .usda text into a prim tree rooted at a pseudo-root prim."""
    toks = _tokenize(text)
    root = UsdaPrim("/", "PseudoRoot", "/")
    i = 0
    n = len(toks)

    # skip the header metadata block '(...)' after #usda 1.0 if present
    # (tokenizer already dropped the '#usda' comment line)
    if i < n and toks[i] == "(":
        depth = 1
        i += 1
        while i < n and depth:
            if toks[i] == "(":
                depth += 1
            elif toks[i] == ")":
                depth -= 1
            i += 1

    def parse_prim_body(prim: UsdaPrim, i: int) -> int:
        assert toks[i] == "{", f"expected prim body at {toks[i-3:i+2]}"
        i += 1
        while i < n and toks[i] != "}":
            i = parse_statement(prim, i)
        return i + 1

    def parse_statement(prim: UsdaPrim, i: int) -> int:
        t = toks[i]
        if t in ("def", "over", "class"):
            i += 1
            type_name = ""
            if toks[i] not in ("{",) and not toks[i].startswith('"'):
                type_name = toks[i]
                i += 1
            name = toks[i][1:-1] if toks[i].startswith('"') else toks[i]
            i += 1
            child = UsdaPrim(name, type_name,
                             (prim.path.rstrip("/") + "/" + name))
            # optional metadata block
            if toks[i] == "(":
                depth = 1
                j = i + 1
                meta_start = j
                while depth:
                    if toks[j] == "(":
                        depth += 1
                    elif toks[j] == ")":
                        depth -= 1
                    j += 1
                meta = toks[meta_start:j - 1]
                # applied API schemas
                for k, mt in enumerate(meta):
                    if mt == "apiSchemas" and "=" in meta[k:k + 2]:
                        for q in meta[k:]:
                            if q.startswith('"'):
                                child.api_schemas.append(q[1:-1])
                i = j
            i = parse_prim_body(child, i)
            prim.children.append(child)
            return i
        # attribute / rel: [custom] [uniform] <type> name [= value] [(meta)]
        j = i
        while j < n and toks[j] in ("custom", "uniform", "prepend", "delete",
                                    "add", "varying"):
            j += 1
        if j < n and (toks[j] in _TYPE_WORDS or toks[j].endswith("[]")):
            type_word = toks[j]
            j += 1
            # array types tokenize as 'point3f' '[' ']'
            while j < n and toks[j] in ("[", "]"):
                j += 1
            name = toks[j]
            j += 1
            # connect/timeSamples suffixes: name.connect etc.
            value = None
            if j < n and toks[j] == "=":
                value, j = _parse_value(toks, j + 1)
            if j < n and toks[j] == "(":
                depth = 1
                j += 1
                while j < n and depth:
                    if toks[j] == "(":
                        depth += 1
                    elif toks[j] == ")":
                        depth -= 1
                    j += 1
            prim.attrs[name] = value
            return j
        # unknown token: skip
        return i + 1

    while i < n:
        if toks[i] in ("def", "over", "class"):
            i = parse_statement(root, i)
        else:
            i += 1
    return root
