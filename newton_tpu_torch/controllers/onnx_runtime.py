"""Self-contained ONNX policy executor: a protobuf decoder and a PyTorch
interpreter (port of ``newton_tpu/controllers/onnx_runtime.py``).

No onnx or onnxruntime dependency: the file's protobuf wire format is
walked directly (Model, Graph, Node, Tensor and Attribute protos), once,
in ``OnnxModule.__init__``, into buffers of an ``nn.Module`` on its
device; a call runs the graph's nodes in order as PyTorch operations (the
JAX package runs them as jnp operations outside any Pallas kernel, so
these are plain ``torch`` calls, products through ``torch.matmul``).

Supported operations (policy networks): Gemm, MatMul, Add, Sub, Mul, Div,
Neg, Relu, Tanh, Sigmoid, Elu, LeakyRelu, Softmax, Exp, Clip, Concat,
Identity, Cast (as Identity), Constant, Reshape, Flatten, Squeeze,
Unsqueeze, LSTM (one layer, forward); any other raises
``NotImplementedError``. Shapes and axes given as tensors (Reshape,
Squeeze, Unsqueeze) are read from the decoded initializers and constants
on the host, so a call reads nothing back from the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["OnnxModule", "encode_mlp"]


# ----------------------------------------------------------------------
# protobuf wire-format reader
# ----------------------------------------------------------------------

def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    val = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    value is int for varint/fixed, bytes for length-delimited."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


def _packed_varints(v) -> List[int]:
    if isinstance(v, int):
        return [v]
    out = []
    i = 0
    while i < len(v):
        x, i = _varint(v, i)
        out.append(x)
    return out


def _svarint(x: int, bits=64) -> int:
    """Two's-complement interpretation of a varint (int64 fields)."""
    if x >= 1 << (bits - 1):
        x -= 1 << bits
    return x


_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
           6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
           11: np.float64}


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = None
    floats: List[float] = []
    ints: List[int] = []
    doubles: List[float] = []
    for fno, wt, v in _fields(buf):
        if fno == 1:
            dims += _packed_varints(v)
        elif fno == 2:
            dtype = v
        elif fno == 4:
            floats += (np.frombuffer(v, np.float32).tolist()
                       if wt == 2 else [np.frombuffer(v, np.float32)[0]]
                       if wt == 5 else [])
        elif fno == 7:
            ints += [_svarint(x) for x in _packed_varints(v)]
        elif fno == 8:
            name = v.decode()
        elif fno == 9:
            raw = v
        elif fno == 10:
            doubles += (np.frombuffer(v, np.float64).tolist()
                        if wt == 2 else [])
    np_dt = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, np_dt)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif doubles:
        arr = np.asarray(doubles, np.float64)
    else:
        arr = np.asarray(ints, np.int64)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    name = ""
    val: Any = None
    for fno, wt, v in _fields(buf):
        if fno == 1:
            name = v.decode()
        elif fno == 2:                       # f (float)
            val = float(np.frombuffer(v, np.float32)[0])
        elif fno == 3:                       # i
            val = _svarint(v)
        elif fno == 4:                       # s
            val = v.decode()
        elif fno == 5:                       # t (tensor)
            val = _parse_tensor(v)[1]
        elif fno == 7:                       # floats
            cur = val if isinstance(val, list) else []
            cur.append(float(np.frombuffer(v, np.float32)[0])
                       if wt == 5 else None)
            val = cur
        elif fno == 8:                       # ints
            cur = val if isinstance(val, list) else []
            cur += [_svarint(x) for x in _packed_varints(v)]
            val = cur
    return name, val


def _parse_node(buf: bytes):
    inputs: List[str] = []
    outputs: List[str] = []
    op = ""
    attrs: Dict[str, Any] = {}
    for fno, wt, v in _fields(buf):
        if fno == 1:
            inputs.append(v.decode())
        elif fno == 2:
            outputs.append(v.decode())
        elif fno == 4:
            op = v.decode()
        elif fno == 5:
            k, a = _parse_attr(v)
            attrs[k] = a
    return op, inputs, outputs, attrs


def _value_info_name(buf: bytes) -> str:
    for fno, wt, v in _fields(buf):
        if fno == 1:
            return v.decode()
    return ""



# ----------------------------------------------------------------------
# interpreter
# ----------------------------------------------------------------------

def _clip(x, lo, hi):
    """max(min(x, hi), lo) with float or tensor bounds."""
    x = torch.clamp(x, max=hi) if not isinstance(hi, torch.Tensor) \
        else torch.minimum(x, hi)
    return torch.clamp(x, min=lo) if not isinstance(lo, torch.Tensor) \
        else torch.maximum(x, lo)


class OnnxModule(torch.nn.Module):
    """Executable ONNX graph: ``OnnxModule(path_or_bytes)(*inputs)`` ->
    outputs. Inputs map positionally onto the graph's non-initializer
    inputs; returns a single tensor if the graph has one output, else a
    tuple. The initializers and Constant values are buffers on
    ``device`` (default: the card)."""

    def __init__(self, source, device="cuda"):
        super().__init__()
        buf = source if isinstance(source, (bytes, bytearray)) \
            else open(source, "rb").read()
        graph = None
        for fno, wt, v in _fields(bytes(buf)):
            if fno == 7:
                graph = v
        if graph is None:
            raise ValueError("no GraphProto found (field 7) — not an ONNX "
                             "model file")
        self.nodes = []
        self.host_values: Dict[str, np.ndarray] = {}
        g_inputs: List[str] = []
        self.output_names: List[str] = []
        for fno, wt, v in _fields(graph):
            if fno == 1:
                self.nodes.append(_parse_node(v))
            elif fno == 5:
                name, arr = _parse_tensor(v)
                self.host_values[name] = arr
            elif fno == 11:
                g_inputs.append(_value_info_name(v))
            elif fno == 12:
                self.output_names.append(_value_info_name(v))
        self.input_names = [n for n in g_inputs
                            if n not in self.host_values]
        for op, ins, outs, attrs in self.nodes:
            if op == "Constant":
                self.host_values[outs[0]] = np.asarray(attrs["value"])
        # every decoded value once on the device, as a buffer
        self._slot: Dict[str, str] = {}
        for i, (name, arr) in enumerate(self.host_values.items()):
            self._slot[name] = f"value_{i}"
            self.register_buffer(f"value_{i}", torch.as_tensor(
                np.array(arr), device=device))

    def _host_ints(self, name, value) -> List[int]:
        """A shape or axes operand as host ints: from the decoded values
        when it is one, else read from the device."""
        arr = self.host_values.get(name)
        if arr is None:
            arr = value.cpu().numpy()
        return [int(d) for d in np.asarray(arr).reshape(-1)]

    @staticmethod
    def _gemm(a, b, c, attrs):
        alpha = attrs.get("alpha", 1.0)
        beta = attrs.get("beta", 1.0)
        if attrs.get("transA", 0):
            a = a.transpose(-1, -2)
        if attrs.get("transB", 0):
            b = b.transpose(-1, -2)
        out = alpha * torch.matmul(a, b)
        return out + beta * c if c is not None else out

    def forward(self, *args):
        env: Dict[str, Any] = {name: getattr(self, slot)
                               for name, slot in self._slot.items()}
        if len(args) != len(self.input_names):
            raise ValueError(f"expected {len(self.input_names)} inputs "
                             f"{self.input_names}, got {len(args)}")
        dev = next(iter(env.values())).device if env else None
        for name, a in zip(self.input_names, args):
            env[name] = torch.as_tensor(a, device=dev)

        for op, ins, outs, attrs in self.nodes:
            x = [env[i] if i else None for i in ins]
            if op == "Gemm":
                y = self._gemm(x[0], x[1], x[2] if len(x) > 2 else None,
                               attrs)
            elif op == "MatMul":
                y = torch.matmul(x[0], x[1])
            elif op == "Add":
                y = x[0] + x[1]
            elif op == "Sub":
                y = x[0] - x[1]
            elif op == "Mul":
                y = x[0] * x[1]
            elif op == "Div":
                y = x[0] / x[1]
            elif op == "Neg":
                y = -x[0]
            elif op == "Relu":
                y = torch.relu(x[0])
            elif op == "Tanh":
                y = torch.tanh(x[0])
            elif op == "Sigmoid":
                y = torch.sigmoid(x[0])
            elif op == "Elu":
                y = F.elu(x[0], alpha=attrs.get("alpha", 1.0))
            elif op == "LeakyRelu":
                y = F.leaky_relu(x[0], attrs.get("alpha", 0.01))
            elif op == "Softmax":
                y = torch.softmax(x[0], dim=attrs.get("axis", -1))
            elif op == "Exp":
                y = torch.exp(x[0])
            elif op == "Clip":
                lo = x[1] if len(x) > 2 and x[1] is not None \
                    else attrs.get("min", -np.inf)
                hi = x[2] if len(x) > 2 and x[2] is not None \
                    else attrs.get("max", np.inf)
                y = _clip(x[0], lo, hi)
            elif op == "Concat":
                y = torch.cat(x, dim=attrs.get("axis", 0))
            elif op in ("Identity", "Cast"):
                y = x[0]
            elif op == "Constant":
                continue                     # a buffer since __init__
            elif op == "Reshape":
                y = x[0].reshape(self._host_ints(ins[1], x[1]))
            elif op == "Flatten":
                ax = attrs.get("axis", 1)
                y = x[0].reshape(tuple(x[0].shape[:ax]) + (-1,))
            elif op == "Squeeze":
                axes = attrs.get("axes") or (
                    self._host_ints(ins[1], x[1]) if len(x) > 1 else None)
                y = x[0].squeeze(tuple(axes)) if axes else x[0].squeeze()
            elif op == "Unsqueeze":
                axes = attrs.get("axes") or self._host_ints(ins[1], x[1])
                y = x[0]
                for ax in sorted(axes):
                    y = y.unsqueeze(ax)
            elif op == "LSTM":
                # outputs Y (seq), Y_h, Y_c
                for name, val in zip(outs, self._lstm(x, attrs)):
                    if name:
                        env[name] = val
                continue
            else:
                raise NotImplementedError(
                    f"ONNX op {op!r} not in the supported policy subset")
            env[outs[0]] = y

        res = tuple(env[n] for n in self.output_names)
        return res[0] if len(res) == 1 else res

    @staticmethod
    def _lstm(x, attrs):
        """One forward LSTM layer (ONNX gate order i, o, f, c), a loop over
        the sequence axis."""
        X, W, R = x[0], x[1], x[2]
        B = x[3] if len(x) > 3 and x[3] is not None else None
        h0 = x[5] if len(x) > 5 and x[5] is not None else None
        c0 = x[6] if len(x) > 6 and x[6] is not None else None
        hidden = R.shape[-1]
        Wd, Rd = W[0], R[0]                  # (4H, I), (4H, H)
        bias = (B[0][:4 * hidden] + B[0][4 * hidden:]) if B is not None \
            else 0.0
        batch = X.shape[1]
        h = h0[0] if h0 is not None else X.new_zeros((batch, hidden))
        c = c0[0] if c0 is not None else X.new_zeros((batch, hidden))
        ys = []
        for t in range(X.shape[0]):
            z = torch.matmul(X[t], Wd.T) + torch.matmul(h, Rd.T) + bias
            i, o, f, g = torch.chunk(z, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys)[:, None], h[None], c[None]


# ----------------------------------------------------------------------
# encoder: policy MLPs as ONNX bytes (the same bytes as the JAX package's
# encoder), readable by OnnxModule and by standard ONNX tooling
# ----------------------------------------------------------------------

def _enc_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(fno: int, wt: int, payload) -> bytes:
    head = _enc_varint((fno << 3) | wt)
    if wt == 0:
        return head + _enc_varint(payload)
    return head + _enc_varint(len(payload)) + payload


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    out = b""
    for d in arr.shape:
        out += _enc_field(1, 0, d)
    out += _enc_field(2, 0, 1)                       # FLOAT
    out += _enc_field(8, 2, name.encode())
    out += _enc_field(9, 2, arr.tobytes())
    return out


def _enc_attr_i(name: str, val: int) -> bytes:
    return (_enc_field(1, 2, name.encode()) + _enc_field(3, 0, val)
            + _enc_field(20, 0, 2))                  # type=INT


def _enc_node(op: str, ins, outs, attrs=b"") -> bytes:
    out = b""
    for i in ins:
        out += _enc_field(1, 2, i.encode())
    for o in outs:
        out += _enc_field(2, 2, o.encode())
    out += _enc_field(4, 2, op.encode())
    if attrs:
        out += _enc_field(5, 2, attrs)
    return out


def _enc_value_info(name: str) -> bytes:
    return _enc_field(1, 2, name.encode())


def encode_mlp(layers, activation: str = "Tanh",
               output_activation: Optional[str] = None) -> bytes:
    """Serialize an MLP ``[(W (in, out), b (out,)), ...]`` as ONNX bytes
    (Gemm + activation nodes). Readable by OnnxModule and by standard
    ONNX tooling."""
    nodes = b""
    inits = b""
    cur = "obs"
    n = len(layers)
    for li, (W, b) in enumerate(layers):
        wn, bn = f"W{li}", f"b{li}"
        inits += _enc_field(5, 2, _enc_tensor(wn, np.asarray(W)))
        inits += _enc_field(5, 2, _enc_tensor(bn, np.asarray(b)))
        out = f"h{li}" if li < n - 1 or output_activation else "action"
        nodes += _enc_field(1, 2, _enc_node("Gemm", [cur, wn, bn], [out]))
        cur = out
        act = activation if li < n - 1 else output_activation
        if act:
            out = f"a{li}" if li < n - 1 else "action"
            nodes += _enc_field(1, 2, _enc_node(act, [cur], [out]))
            cur = out
    graph = (nodes + inits
             + _enc_field(11, 2, _enc_value_info("obs"))
             + _enc_field(12, 2, _enc_value_info(cur)))
    model = (_enc_field(1, 0, 8)                     # ir_version
             + _enc_field(7, 2, graph))
    return model
