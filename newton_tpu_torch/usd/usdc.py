"""Binary USD (usdc "crate") reader/writer — dependency-free (port of
``newton_tpu/usd/usdc.py``, which imports no JAX; the port keeps its own
copy so that it never imports the JAX package).

Reads the Pixar crate file format (magic ``PXR-USDC``) directly into the
same :class:`~newton_tpu_torch.utils.usda_parser.UsdaPrim` tree the text parser
produces, so ``import_usd`` handles .usda and .usdc files transparently
without pxr installed (reference: newton imports binary stages through
pxr.Usd; pxr/usd/usd/crateFile.cpp documents the layout implemented here).

Implements the version 0.8 structural layout: lz4-framed token pool,
integer-compressed FIELDS / FIELDSETS / PATHS / SPECS sections, inline and
offset ValueReps for the scalar/array types physics assets use (tokens,
specifiers, bools, ints, floats, doubles, vec2/3/4, quats, matrices,
asset paths, token vectors and typed arrays thereof).

A matching writer emits valid 0.8 crate files (used by the test
round-trip and by ViewerUSD's binary export). Both directions use the
same pure-python LZ4 block codec and the crate's delta/2-bit integer
code — no native lz4 dependency.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.usda_parser import UsdaPrim

__all__ = ["read_usdc", "write_usdc", "is_usdc"]

_MAGIC = b"PXR-USDC"

# crate value types (crateDataTypes.h)
T_BOOL, T_UCHAR, T_INT, T_UINT, T_INT64, T_UINT64 = 1, 2, 3, 4, 5, 6
T_HALF, T_FLOAT, T_DOUBLE, T_STRING, T_TOKEN, T_ASSET = 7, 8, 9, 10, 11, 12
T_QUATD, T_QUATF, T_QUATH = 13, 14, 15
T_VEC2D, T_VEC2F, T_VEC2H, T_VEC2I = 16, 17, 18, 19
T_VEC3D, T_VEC3F, T_VEC3H, T_VEC3I = 20, 21, 22, 23
T_VEC4D, T_VEC4F, T_VEC4H, T_VEC4I = 24, 25, 26, 27
T_MAT2D, T_MAT3D, T_MAT4D = 28, 29, 30
T_DICT, T_TOKEN_LISTOP = 31, 32
T_TOKEN_VECTOR, T_SPECIFIER, T_PERMISSION, T_VARIABILITY = 39, 40, 41, 42

_ARRAY_BIT = 1 << 63
_INLINE_BIT = 1 << 62
_COMPRESSED_BIT = 1 << 61

_SCALAR_FMT = {
    T_INT: ("<i", 4), T_UINT: ("<I", 4), T_INT64: ("<q", 8),
    T_UINT64: ("<Q", 8), T_FLOAT: ("<f", 4), T_DOUBLE: ("<d", 8),
}
_VEC_INFO = {
    T_VEC2F: ("<f", 2), T_VEC3F: ("<f", 3), T_VEC4F: ("<f", 4),
    T_VEC2D: ("<d", 2), T_VEC3D: ("<d", 3), T_VEC4D: ("<d", 4),
    T_VEC2I: ("<i", 2), T_VEC3I: ("<i", 3), T_VEC4I: ("<i", 4),
    T_QUATF: ("<f", 4), T_QUATD: ("<d", 4),
    T_MAT2D: ("<d", 4), T_MAT3D: ("<d", 9), T_MAT4D: ("<d", 16),
}
_SPECIFIERS = ["def", "over", "class"]


# ---------------------------------------------------------------------------
# LZ4 block codec (pure python; format per lz4 block spec)
# ---------------------------------------------------------------------------

def _lz4_decompress(src: bytes, max_out: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        out += src[i:i + lit_len]
        i += lit_len
        if i >= n:
            break
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = token & 0xF
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - off
        for k in range(mlen):
            out.append(out[start + k])
        if len(out) > max_out:
            raise ValueError("lz4: output overrun")
    return bytes(out)


def _lz4_compress(src: bytes) -> bytes:
    """Valid but simple LZ4 block: emit everything as literals.

    (The spec permits literal-only streams; compression ratio is traded
    for simplicity — structural sections are small.)
    """
    out = bytearray()
    n = len(src)
    i = 0
    while True:
        lit = n - i
        chunk = lit
        token_lit = 15 if chunk >= 15 else chunk
        out.append(token_lit << 4)
        if chunk >= 15:
            rem = chunk - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out += src[i:i + chunk]
        break
    return bytes(out)


def _fast_decompress(src: bytes, out_size: int) -> bytes:
    """TfFastCompression framing: leading chunk-count byte then lz4
    block(s) (pxr/base/tf/fastCompression.cpp)."""
    n_chunks = src[0]
    if n_chunks == 0:
        return _lz4_decompress(src[1:], out_size)
    out = bytearray()
    i = 1
    for _ in range(n_chunks):
        (csz,) = struct.unpack_from("<i", src, i)
        i += 4
        out += _lz4_decompress(src[i:i + csz], out_size - len(out))
        i += csz
    return bytes(out)


def _fast_compress(src: bytes) -> bytes:
    return bytes([0]) + _lz4_compress(src)


# ---------------------------------------------------------------------------
# crate integer codec (Usd_IntegerCompression, crateFile.cpp)
# ---------------------------------------------------------------------------

def _wrap32(v: int) -> int:
    """Wrap to signed int32 (the codec works in int32 bit-space; sentinels
    like 0xFFFFFFFF travel as -1)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _decode_ints(data: bytes, count: int) -> np.ndarray:
    """Decode `count` int32s: lz4-framed [common(int4) | 2-bit codes |
    variable payload], delta-coded with int32 wraparound. Returns signed
    int64 values (consumers reinterpret sign as needed)."""
    if count == 0:
        return np.zeros(0, np.int64)
    worst = count * 5 + 4 + 100
    raw = _fast_decompress(data, worst)
    (common,) = struct.unpack_from("<i", raw, 0)
    ncode = (count * 2 + 7) // 8
    codes = raw[4:4 + ncode]
    p = 4 + ncode
    vals = np.zeros(count, np.int64)
    prev = 0
    for i in range(count):
        c = (codes[i >> 2] >> ((i & 3) * 2)) & 3
        if c == 0:
            d = common
        elif c == 1:
            (d,) = struct.unpack_from("<b", raw, p)
            p += 1
        elif c == 2:
            (d,) = struct.unpack_from("<h", raw, p)
            p += 2
        else:
            (d,) = struct.unpack_from("<i", raw, p)
            p += 4
        prev = _wrap32(prev + d)
        vals[i] = prev
    return vals


def _encode_ints(vals) -> bytes:
    vals = [_wrap32(int(v)) for v in vals]
    count = len(vals)
    deltas = []
    prev = 0
    for v in vals:
        deltas.append(_wrap32(v - prev))
        prev = v
    if count:
        from collections import Counter
        common = Counter(deltas).most_common(1)[0][0]
    else:
        common = 0
    codes = bytearray((count * 2 + 7) // 8)
    payload = bytearray()
    for i, d in enumerate(deltas):
        if d == common:
            c = 0
        elif -128 <= d < 128:
            c = 1
            payload += struct.pack("<b", d)
        elif -32768 <= d < 32768:
            c = 2
            payload += struct.pack("<h", d)
        else:
            c = 3
            payload += struct.pack("<i", d)
        codes[i >> 2] |= c << ((i & 3) * 2)
    raw = struct.pack("<i", common) + bytes(codes) + bytes(payload)
    return _fast_compress(raw)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def is_usdc(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _MAGIC


class _Crate:
    def __init__(self, data: bytes):
        self.data = data
        if data[:8] != _MAGIC:
            raise ValueError("not a usdc (crate) file")
        self.version = tuple(data[8:11])
        if self.version[0] == 0 and self.version[1] < 7:
            raise ValueError(
                f"crate version {self.version} predates the 0.7 layout; "
                "re-export the asset or use the .usda text form")
        (toc_off,) = struct.unpack_from("<Q", data, 16)
        (nsec,) = struct.unpack_from("<Q", data, toc_off)
        self.sections: Dict[str, Tuple[int, int]] = {}
        p = toc_off + 8
        for _ in range(nsec):
            name = data[p:p + 16].split(b"\0")[0].decode()
            start, size = struct.unpack_from("<qq", data, p + 16)
            self.sections[name] = (start, size)
            p += 32
        self._read_tokens()
        self._read_strings()
        self._read_fields()
        self._read_fieldsets()
        self._read_paths()
        self._read_specs()

    def _sec(self, name):
        s = self.sections.get(name)
        if s is None:
            raise ValueError(f"crate missing section {name}")
        return self.data[s[0]:s[0] + s[1]]

    def _read_tokens(self):
        b = self._sec("TOKENS")
        n, uncompressed, compressed = struct.unpack_from("<QQQ", b, 0)
        blob = _fast_decompress(b[24:24 + compressed], uncompressed)
        self.tokens = blob.decode("utf-8", "replace").split("\0")[:n]

    def _read_strings(self):
        b = self.sections.get("STRINGS")
        if b is None:
            self.strings = []
            return
        b = self._sec("STRINGS")
        (n,) = struct.unpack_from("<Q", b, 0)
        idx = struct.unpack_from(f"<{n}I", b, 8)
        self.strings = [self.tokens[i] for i in idx]

    def _read_fields(self):
        b = self._sec("FIELDS")
        (n,) = struct.unpack_from("<Q", b, 0)
        (isz,) = struct.unpack_from("<Q", b, 8)
        tok_idx = _decode_ints(b[16:16 + isz], n)
        p = 16 + isz
        (rsz,) = struct.unpack_from("<Q", b, p)
        reps_raw = _fast_decompress(b[p + 8:p + 8 + rsz], n * 8)
        reps = struct.unpack_from(f"<{n}Q", reps_raw, 0)
        self.fields = [(self.tokens[tok_idx[i]], reps[i]) for i in range(n)]

    def _read_fieldsets(self):
        b = self._sec("FIELDSETS")
        (n,) = struct.unpack_from("<Q", b, 0)
        (isz,) = struct.unpack_from("<Q", b, 8)
        flat = _decode_ints(b[16:16 + isz], n)
        # runs terminated by the ~0 sentinel (travels as -1 in int32 space)
        sets: List[List[int]] = []
        cur: List[int] = []
        self.fieldset_start: Dict[int, int] = {}
        start = 0
        for pos, v in enumerate(flat):
            if v == -1:
                self.fieldset_start[start] = len(sets)
                sets.append(cur)
                cur = []
                start = pos + 1
            else:
                cur.append(int(v))
        self.fieldsets = sets

    def _read_paths(self):
        b = self._sec("PATHS")
        (n_total,) = struct.unpack_from("<Q", b, 0)
        (n,) = struct.unpack_from("<Q", b, 8)
        p = 16
        (sz,) = struct.unpack_from("<Q", b, p)
        path_idx = _decode_ints(b[p + 8:p + 8 + sz], n)
        p += 8 + sz
        (sz,) = struct.unpack_from("<Q", b, p)
        elem_idx = _decode_ints(b[p + 8:p + 8 + sz], n)
        p += 8 + sz
        (sz,) = struct.unpack_from("<Q", b, p)
        jumps = _decode_ints(b[p + 8:p + 8 + sz], n)
        # rebuild path strings (crateFile.cpp _BuildDecompressedPathsImpl);
        # jump encoding: j>0 child at i+1 + sibling subtree at i+j;
        # j==0 child only; j==-1 sibling only; j==-2 leaf
        self.paths: Dict[int, str] = {}
        stack: List[Tuple[int, Optional[str]]] = [(0, None)] if n else []
        while stack:
            i, parent = stack.pop()
            while True:
                this_idx = int(path_idx[i])
                if parent is None:
                    self.paths[this_idx] = "/"
                    this_path = "/"
                else:
                    e = int(elem_idx[i])
                    is_prop = e < 0
                    tok = self.tokens[abs(e)]
                    base = "" if parent == "/" else parent
                    this_path = base + ("." if is_prop else "/") + tok
                    self.paths[this_idx] = this_path
                j = int(jumps[i])
                if j >= 0:                 # has child at i+1
                    if j > 0:              # sibling subtree at i+j
                        stack.append((i + j, parent))
                    parent = this_path
                    i += 1
                elif j == -1:              # sibling only, at i+1
                    i += 1
                else:                      # leaf
                    break

    def _read_specs(self):
        b = self._sec("SPECS")
        (n,) = struct.unpack_from("<Q", b, 0)
        p = 8
        (sz,) = struct.unpack_from("<Q", b, p)
        path_idx = _decode_ints(b[p + 8:p + 8 + sz], n)
        p += 8 + sz
        (sz,) = struct.unpack_from("<Q", b, p)
        fset_idx = _decode_ints(b[p + 8:p + 8 + sz], n)
        p += 8 + sz
        (sz,) = struct.unpack_from("<Q", b, p)
        spec_types = _decode_ints(b[p + 8:p + 8 + sz], n)
        self.specs = [(int(path_idx[i]), int(fset_idx[i]),
                       int(spec_types[i])) for i in range(n)]

    # -- value unpacking -------------------------------------------------
    def value(self, rep: int) -> Any:
        ty = (rep >> 48) & 0xFF
        is_array = bool(rep & _ARRAY_BIT)
        inline = bool(rep & _INLINE_BIT)
        payload = rep & ((1 << 48) - 1)
        if is_array:
            return self._array_value(ty, payload, bool(rep & _COMPRESSED_BIT))
        if ty == T_TOKEN:
            return self.tokens[payload] if inline else \
                self.tokens[struct.unpack_from("<I", self.data, payload)[0]]
        if ty == T_STRING:
            return self.strings[payload]
        if ty == T_ASSET:
            return self.tokens[payload]
        if ty == T_SPECIFIER:
            return _SPECIFIERS[payload] if payload < 3 else "def"
        if ty == T_BOOL:
            return bool(payload)
        if ty in (T_INT, T_UINT):
            v = struct.unpack("<i", struct.pack("<I", payload & 0xFFFFFFFF))[0]
            return v
        if ty == T_FLOAT:
            if inline:
                return struct.unpack("<f",
                                     struct.pack("<I",
                                                 payload & 0xFFFFFFFF))[0]
            return struct.unpack_from("<f", self.data, payload)[0]
        if ty == T_DOUBLE:
            if inline:
                # inline doubles hold a float32 payload
                return float(struct.unpack(
                    "<f", struct.pack("<I", payload & 0xFFFFFFFF))[0])
            return struct.unpack_from("<d", self.data, payload)[0]
        if ty in _VEC_INFO:
            fmt, k = _VEC_INFO[ty]
            if inline:
                # inline vecs pack int8 components
                comps = struct.pack("<Q", payload)[:k]
                return np.asarray([struct.unpack("<b", comps[i:i + 1])[0]
                                   for i in range(k)], np.float64)
            return np.asarray(struct.unpack_from(f"<{k}{fmt[1]}",
                                                 self.data, payload))
        if ty == T_TOKEN_VECTOR:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            idx = struct.unpack_from(f"<{cnt}I", self.data, payload + 8)
            return [self.tokens[i] for i in idx]
        if ty == T_DICT:
            return {}
        return None

    def _array_value(self, ty, payload, compressed):
        if ty == T_TOKEN:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            idx = struct.unpack_from(f"<{cnt}I", self.data, payload + 8)
            return [self.tokens[i] for i in idx]
        if ty in _SCALAR_FMT:
            fmt, width = _SCALAR_FMT[ty]
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            if compressed and ty in (T_INT, T_UINT):
                (csz,) = struct.unpack_from("<Q", self.data, payload + 8)
                vals = _decode_ints(
                    self.data[payload + 16:payload + 16 + csz], cnt)
                return np.asarray(vals, np.int64)
            arr = np.frombuffer(self.data, dtype=fmt[1], count=cnt,
                                offset=payload + 8)
            return np.asarray(arr)
        if ty in _VEC_INFO:
            fmt, k = _VEC_INFO[ty]
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            arr = np.frombuffer(self.data, dtype=fmt[1], count=cnt * k,
                                offset=payload + 8)
            return np.asarray(arr).reshape(cnt, k)
        return None


def read_usdc(path: str) -> UsdaPrim:
    """Parse a binary usdc file into a UsdaPrim tree."""
    with open(path, "rb") as f:
        data = f.read()
    c = _Crate(data)
    root = UsdaPrim("", "", "/")
    prims: Dict[str, UsdaPrim] = {"/": root}

    # sort specs so parents precede children (path depth)
    def depth(p):
        return p.count("/") + p.count(".")

    spec_list = []
    for path_idx, fset, spec_type in c.specs:
        path = c.paths.get(path_idx)
        if path is None:
            continue
        fields = {}
        fs_index = c.fieldset_start.get(fset)
        if fs_index is None:
            # fset indexes the flattened stream; map by scanning
            continue
        for fi in c.fieldsets[fs_index]:
            name, rep = c.fields[fi]
            fields[name] = c.value(rep)
        spec_list.append((depth(path), path, spec_type, fields))
    spec_list.sort(key=lambda t: t[0])

    for _, path, spec_type, fields in spec_list:
        if path == "/":
            root.metadata.update({k: v for k, v in fields.items()})
            continue
        if "." in path.rsplit("/", 1)[-1]:
            # property spec: attach to owning prim
            prim_path, attr = path.rsplit(".", 1)
            prim = prims.get(prim_path)
            if prim is None:
                continue
            val = fields.get("default")
            if val is None and "timeSamples" in fields:
                val = fields["timeSamples"]
            prim.attrs[attr] = val
            if attr == "apiSchemas" or fields.get("apiSchemas"):
                pass
        else:
            parent_path = path.rsplit("/", 1)[0] or "/"
            name = path.rsplit("/", 1)[-1]
            prim = UsdaPrim(name, str(fields.get("typeName", "")), path)
            api = fields.get("apiSchemas")
            if isinstance(api, (list, tuple)):
                prim.api_schemas = list(api)
            prim.metadata.update(
                {k: v for k, v in fields.items()
                 if k not in ("typeName", "specifier")})
            parent = prims.get(parent_path)
            if parent is not None:
                parent.children.append(prim)
            prims[path] = prim
    return root


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.tokens: List[str] = []
        self._tok_idx: Dict[str, int] = {}
        self.fields: List[Tuple[int, int]] = []
        self._field_idx: Dict[Tuple[int, int], int] = {}
        self.fieldsets_flat: List[int] = []
        self.fieldset_starts: Dict[Tuple[int, ...], int] = {}
        self.paths: List[Tuple[int, int, int]] = []   # built later
        self.specs: List[Tuple[int, int, int]] = []
        self.blob = bytearray()                        # value payload area

    def tok(self, s: str) -> int:
        i = self._tok_idx.get(s)
        if i is None:
            i = self._tok_idx[s] = len(self.tokens)
            self.tokens.append(s)
        return i

    def field(self, name: str, rep: int) -> int:
        key = (self.tok(name), rep)
        i = self._field_idx.get(key)
        if i is None:
            i = self._field_idx[key] = len(self.fields)
            self.fields.append(key)
        return i

    def fieldset(self, field_ids: List[int]) -> int:
        key = tuple(field_ids)
        start = self.fieldset_starts.get(key)
        if start is None:
            start = len(self.fieldsets_flat)
            self.fieldset_starts[key] = start
            self.fieldsets_flat.extend(field_ids)
            self.fieldsets_flat.append(-1)     # sentinel
        return start

    # -- value encoding --------------------------------------------------
    def _defer(self, payload: bytes) -> int:
        # reserve space; offsets are fixed after the header (88 bytes)
        off = 88 + len(self.blob)
        self.blob += payload
        while len(self.blob) % 8:
            self.blob += b"\0"
        return off

    def rep(self, value: Any) -> int:
        if isinstance(value, bool):
            return (T_BOOL << 48) | _INLINE_BIT | int(value)
        if isinstance(value, (int, np.integer)):
            return ((T_INT << 48) | _INLINE_BIT
                    | (int(value) & 0xFFFFFFFF))
        if isinstance(value, (float, np.floating)):
            bits = struct.unpack("<I", struct.pack("<f", float(value)))[0]
            f32 = struct.unpack("<f", struct.pack("<I", bits))[0]
            if f32 == float(value):
                return (T_FLOAT << 48) | _INLINE_BIT | bits
            off = self._defer(struct.pack("<d", float(value)))
            return (T_DOUBLE << 48) | off
        if isinstance(value, str):
            if value in ("def", "over", "class"):
                pass
            return (T_TOKEN << 48) | _INLINE_BIT | self.tok(value)
        if isinstance(value, (list, tuple)) and all(
                isinstance(x, str) for x in value):
            idx = [self.tok(x) for x in value]
            payload = struct.pack("<Q", len(idx)) + struct.pack(
                f"<{len(idx)}I", *idx)
            return (T_TOKEN << 48) | _ARRAY_BIT | self._defer(payload)
        arr = np.asarray(value)
        if arr.ndim == 1 and arr.dtype.kind in "iu":
            payload = struct.pack("<Q", len(arr)) + \
                arr.astype("<i4").tobytes()
            return (T_INT << 48) | _ARRAY_BIT | self._defer(payload)
        if arr.ndim == 1 and arr.dtype.kind == "f":
            payload = struct.pack("<Q", len(arr)) + \
                arr.astype("<f4").tobytes()
            return (T_FLOAT << 48) | _ARRAY_BIT | self._defer(payload)
        if arr.ndim == 2 and arr.shape[1] in (2, 3, 4) \
                and arr.dtype.kind == "f":
            ty = {2: T_VEC2F, 3: T_VEC3F, 4: T_VEC4F}[arr.shape[1]]
            payload = struct.pack("<Q", arr.shape[0]) + \
                arr.astype("<f4").tobytes()
            return (ty << 48) | _ARRAY_BIT | self._defer(payload)
        if arr.ndim == 2 and arr.shape[1] == 3 and arr.dtype.kind in "iu":
            payload = struct.pack("<Q", arr.shape[0]) + \
                arr.astype("<i4").reshape(-1).tobytes()
            return (T_VEC3I << 48) | _ARRAY_BIT | self._defer(payload)
        if arr.shape == (16,) or arr.shape == (4, 4):
            payload = arr.astype("<f8").reshape(-1).tobytes()
            return (T_MAT4D << 48) | self._defer(payload)
        raise ValueError(f"usdc writer: unsupported value {type(value)}")

    def spec_token_rep(self, s: str) -> int:
        return (T_TOKEN << 48) | _INLINE_BIT | self.tok(s)


def write_usdc(root: UsdaPrim, path: str):
    """Write a UsdaPrim tree as a version-0.8 crate file."""
    w = _Writer()
    # paths table: index 0 = "/"; build (index, elem_token, parent) rows in
    # DFS order with the jump encoding expected by the reader
    rows: List[Dict] = []

    def visit(prim: UsdaPrim, elem: Optional[str], is_prop: bool):
        my = len(rows)
        rows.append(dict(elem=elem, prop=is_prop, children=[]))
        kids: List[int] = []
        if not is_prop:
            for a in prim.attrs:
                kids.append(visit_attr(a))
            for ch in prim.children:
                kids.append(visit(ch, ch.name, False))
        rows[my]["children"] = kids
        return my

    def visit_attr(name: str) -> int:
        my = len(rows)
        rows.append(dict(elem=name, prop=True, children=[]))
        return my

    # root prim occupies path index 0
    def build_tree(prim: UsdaPrim):
        rows.clear()
        visit(prim, None, False)
    build_tree(root)

    # linearize to (pathIndexes, elementTokenIndexes, jumps) in the same
    # preorder the reader's `build` walk expects
    path_indexes: List[int] = []
    elem_indexes: List[int] = []
    jumps: List[int] = []

    def emit(node_id: int, siblings_after: bool):
        r = rows[node_id]
        pos = len(path_indexes)
        path_indexes.append(node_id)
        if r["elem"] is None:
            elem_indexes.append(0)
        else:
            t = w.tok(r["elem"])
            elem_indexes.append(-t if r["prop"] else t)
        jumps.append(0)   # fixed up below
        kids = r["children"]
        for k, kid in enumerate(kids):
            emit(kid, siblings_after=(k < len(kids) - 1))
        if kids:
            jumps[pos] = (len(path_indexes) - pos) if siblings_after else 0
        else:
            jumps[pos] = -1 if siblings_after else -2

    w.tok("")    # token 0 reserved: -0 == 0 would alias property names
    emit(0, False)

    # map row id -> full path string + prim object for specs
    full_paths: Dict[int, Tuple[str, UsdaPrim, Optional[str]]] = {}

    def walk_paths(prim: UsdaPrim, node_id_iter, parent_path):
        nid = next(node_id_iter)
        my_path = "/" if parent_path is None else (
            (parent_path if parent_path != "/" else "") + "/" + prim.name
            if prim.name else "/")
        full_paths[nid] = (my_path, prim, None)
        for a in prim.attrs:
            anid = next(node_id_iter)
            full_paths[anid] = (my_path + "." + a, prim, a)
        for ch in prim.children:
            walk_paths(ch, node_id_iter, my_path)

    walk_paths(root, iter(range(len(rows))), None)

    # specs + fields
    for nid, (p, prim, attr) in sorted(full_paths.items()):
        if attr is None:
            fids = [w.field("specifier",
                            (T_SPECIFIER << 48) | _INLINE_BIT | 0)]
            if prim.type_name:
                fids.append(w.field("typeName",
                                    w.spec_token_rep(prim.type_name)))
            if prim.api_schemas:
                fids.append(w.field("apiSchemas",
                                    w.rep(list(prim.api_schemas))))
            spec_type = 2      # SdfSpecTypePrim... (value unused by reader)
        else:
            val = prim.attrs[attr]
            fids = []
            if val is not None:
                fids.append(w.field("default", w.rep(val)))
            spec_type = 1      # attribute
        fset = w.fieldset(fids)
        w.specs.append((nid, fset, spec_type))

    # ---- assemble sections ----
    blob_area = bytes(w.blob)
    out = bytearray()
    out += _MAGIC
    out += bytes([0, 8, 0]) + b"\0" * 5       # version 0.8.0
    out += b"\0" * 8                          # toc offset placeholder
    out += b"\0" * (88 - len(out))
    out += blob_area

    sections = []

    def add_section(name: str, payload: bytes):
        start = len(out)
        out.extend(payload)
        sections.append((name, start, len(payload)))

    tok_blob = ("\0".join(w.tokens)).encode() + b"\0"
    comp = _fast_compress(tok_blob)
    add_section("TOKENS", struct.pack("<QQQ", len(w.tokens), len(tok_blob),
                                      len(comp)) + comp)
    add_section("STRINGS", struct.pack("<Q", 0))

    nf = len(w.fields)
    fld_idx = _encode_ints([t for t, _ in w.fields])
    reps_raw = struct.pack(f"<{nf}Q", *[r for _, r in w.fields])
    reps_c = _fast_compress(reps_raw)
    add_section("FIELDS", struct.pack("<QQ", nf, len(fld_idx)) + fld_idx
                + struct.pack("<Q", len(reps_c)) + reps_c)

    flat = w.fieldsets_flat
    fs_idx = _encode_ints(flat)
    add_section("FIELDSETS", struct.pack("<QQ", len(flat), len(fs_idx))
                + fs_idx)

    pi = _encode_ints(path_indexes)
    ei = _encode_ints(elem_indexes)
    ji = _encode_ints(jumps)
    add_section("PATHS", struct.pack("<QQ", len(path_indexes),
                                     len(path_indexes))
                + struct.pack("<Q", len(pi)) + pi
                + struct.pack("<Q", len(ei)) + ei
                + struct.pack("<Q", len(ji)) + ji)

    si = _encode_ints([s[0] for s in w.specs])
    fi = _encode_ints([s[1] for s in w.specs])
    ti = _encode_ints([s[2] for s in w.specs])
    add_section("SPECS", struct.pack("<Q", len(w.specs))
                + struct.pack("<Q", len(si)) + si
                + struct.pack("<Q", len(fi)) + fi
                + struct.pack("<Q", len(ti)) + ti)

    toc_off = len(out)
    out += struct.pack("<Q", len(sections))
    for name, start, size in sections:
        out += name.encode().ljust(16, b"\0")
        out += struct.pack("<qq", start, size)
    struct.pack_into("<Q", out, 16, toc_off)
    with open(path, "wb") as f:
        f.write(bytes(out))
