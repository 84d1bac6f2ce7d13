"""ONNX model → torch module (port of
``birdnet_go_tpu/inference/onnx_import.py``).

The parser is the JAX module's, unchanged, over the minimal protobuf wire
reader (``protowire.py``, a copy). ``OnnxGraph`` is an ``nn.Module`` that
holds every initializer as a buffer (float16 and float64 as float32, as the
JAX importer sees them) and runs the nodes in ``forward`` through the op
table ``_ONNX_OPS``, the JAX table's keys, each op as plain torch (cuDNN,
cuBLAS and cuFFT on the card), in full float32 for convolutions and
products (``ops.precision.full_float32``). NCHW stays NCHW.

Shape-like inputs (reshape shapes, slice bounds, reduce axes) must be
initializers, as in the JAX importer. Nodes that compute a constant from
constants only (windows, ``MelWeightMatrix``, ``Range``) run once at
import, their results kept as buffers. ``Mod`` takes floor semantics
(``torch.remainder``) unless ``fmod=1``; integer results may be wider than
JAX's (which runs without x64), with the same values.

Field numbers follow the public onnx.proto3:
ModelProto{graph=7}; GraphProto{node=1, name=2, initializer=5, input=11,
output=12}; NodeProto{input=1, output=2, name=3, op_type=4, attribute=5};
TensorProto{dims=1, data_type=2, float_data=4, int32_data=5, string_data=6,
int64_data=7, name=8, raw_data=9, double_data=10}; AttributeProto{name=1,
f=2, i=3, s=4, t=5, floats=7, ints=8, type=20};
ValueInfoProto{name=1, type=2}.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from birdnet_go_tpu_torch.inference import protowire as pw
from birdnet_go_tpu_torch.inference.graph_ops import (
    Values,
    device_array,
    pad,
    pool,
    reduce,
    resize,
    same_pads,
    slice_axes,
    take,
    torch_dtype,
)
from birdnet_go_tpu_torch.ops.precision import full_float32

log = logging.getLogger("birdnet_tpu.onnx")

# TensorProto.DataType
_DT_FLOAT, _DT_UINT8, _DT_INT8, _DT_INT32, _DT_INT64 = 1, 2, 3, 6, 7
_DT_BOOL, _DT_FLOAT16, _DT_DOUBLE = 9, 10, 11
_NP = {
    _DT_FLOAT: np.float32, _DT_UINT8: np.uint8, _DT_INT8: np.int8,
    _DT_INT32: np.int32, _DT_INT64: np.int64, _DT_BOOL: np.bool_,
    _DT_FLOAT16: np.float16, _DT_DOUBLE: np.float64,
}


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any]
    name: str = ""


@dataclasses.dataclass
class OnnxGraphDef:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]                      # runtime inputs (non-initializer)
    outputs: list[str]
    name: str = ""
    # declared input shapes from ValueInfoProto (0 = symbolic dim);
    # absent for models that omit value_info shapes
    input_shapes: dict[str, tuple] = dataclasses.field(default_factory=dict)


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    f = pw.decode_message(buf)
    dims = [pw.signed(v) for v in f.get(1, [])]
    dtype_code = f.get(2, [_DT_FLOAT])[0]
    name = f.get(8, [b""])[0].decode()
    np_dtype = _NP.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor dtype {dtype_code}")
    if 9 in f:                                     # raw_data
        arr = np.frombuffer(f[9][0], dtype=np_dtype)
    elif 4 in f and dtype_code == _DT_FLOAT:       # float_data (packed)
        arr = np.asarray(pw.decode_packed_floats(f[4][0]), np.float32) \
            if isinstance(f[4][0], bytes) else np.asarray(f[4], np.float32)
    elif 7 in f:                                   # int64_data
        vals = (pw.decode_packed_varints(f[7][0])
                if isinstance(f[7][0], bytes) else f[7])
        arr = np.asarray([pw.signed(v) for v in vals], np.int64)
    elif 5 in f:                                   # int32_data
        vals = (pw.decode_packed_varints(f[5][0])
                if isinstance(f[5][0], bytes) else f[5])
        arr = np.asarray([pw.signed(v, 32) for v in vals], np.int32)
        if np_dtype is not np.int32:
            # TensorProto stores INT8/UINT8/INT16 values in int32_data —
            # keep the DECLARED dtype (QuantizeLinear reads signedness
            # off the zero-point's dtype)
            arr = arr.astype(np_dtype)
    elif 10 in f:                                  # double_data
        arr = np.asarray(pw.decode_packed_doubles(f[10][0]), np.float64) \
            if isinstance(f[10][0], bytes) else np.asarray(f[10], np.float64)
    else:
        arr = np.zeros(0, np_dtype)
    if dims:
        arr = arr.reshape(dims)
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    return name, arr


def _parse_attr(buf: bytes) -> tuple[str, Any]:
    f = pw.decode_message(buf)
    name = f.get(1, [b""])[0].decode()
    atype = f.get(20, [0])[0]
    if atype == 1:                                  # FLOAT
        raw = f.get(2, [0])[0]
        return name, struct.unpack("<f", struct.pack("<I", raw))[0]
    if atype == 2:                                  # INT
        return name, pw.signed(f.get(3, [0])[0])
    if atype == 3:                                  # STRING
        return name, f.get(4, [b""])[0].decode()
    if atype == 4:                                  # TENSOR
        return name, _parse_tensor(f.get(5, [b""])[0])[1]
    if atype == 6:                                  # FLOATS
        vals = f.get(7, [])
        if len(vals) == 1 and isinstance(vals[0], bytes):
            return name, pw.decode_packed_floats(vals[0])
        return name, [struct.unpack("<f", struct.pack("<I", v))[0]
                      for v in vals]
    if atype == 7:                                  # INTS
        vals = f.get(8, [])
        if len(vals) == 1 and isinstance(vals[0], bytes) and len(vals[0]) > 9:
            return name, [pw.signed(v)
                          for v in pw.decode_packed_varints(vals[0])]
        out = []
        for v in vals:
            if isinstance(v, bytes):
                out.extend(pw.signed(x)
                           for x in pw.decode_packed_varints(v))
            else:
                out.append(pw.signed(v))
        return name, out
    return name, None


def parse_onnx(buf: bytes) -> OnnxGraphDef:
    model = pw.decode_message(buf)
    graph_raw = model.get(7)
    if not graph_raw:
        raise ValueError("not an ONNX model (no graph)")
    g = pw.decode_message(graph_raw[0])
    initializers = {}
    for t in g.get(5, []):
        name, arr = _parse_tensor(t)
        initializers[name] = arr
    nodes = []
    for n in g.get(1, []):
        nf = pw.decode_message(n)
        attrs = dict(_parse_attr(a) for a in nf.get(5, []))
        nodes.append(OnnxNode(
            op_type=nf.get(4, [b""])[0].decode(),
            inputs=[x.decode() for x in nf.get(1, [])],
            outputs=[x.decode() for x in nf.get(2, [])],
            attrs=attrs, name=nf.get(3, [b""])[0].decode()))

    def _vi(field):
        """(name, shape|None) per ValueInfoProto: name=1, type=2 →
        TypeProto.tensor_type=1 → TensorTypeProto.shape=2 →
        TensorShapeProto.dim=1 → Dimension.dim_value=1 (0 / absent for
        symbolic dims)."""
        out = []
        for vi in g.get(field, []):
            vf = pw.decode_message(vi)
            name = vf.get(1, [b""])[0].decode()
            shape = None
            try:
                tt = pw.decode_message(
                    pw.decode_message(vf.get(2, [b""])[0]).get(1, [b""])[0])
                sh = tt.get(2)
                if sh is not None:
                    dims = []
                    for d in pw.decode_message(sh[0]).get(1, []):
                        df = pw.decode_message(d)
                        dims.append(int(pw.signed(df.get(1, [0])[0])))
                    shape = tuple(dims)
            except Exception:
                pass
            out.append((name, shape))
        return out

    in_vi = [(n, s) for n, s in _vi(11) if n not in initializers]
    inputs = [n for n, _ in in_vi]
    outputs = [n for n, _ in _vi(12)]
    return OnnxGraphDef(nodes=nodes, initializers=initializers,
                        inputs=inputs, outputs=outputs,
                        name=g.get(2, [b""])[0].decode(),
                        input_shapes={n: s for n, s in in_vi
                                      if s is not None})



# ---------------------------------------------------------------------------
# Graph → torch
# ---------------------------------------------------------------------------


def _auto_pad_to_str(attrs, default="NOTSET"):
    ap = attrs.get("auto_pad", default)
    return ap if isinstance(ap, str) else default


# constant generators: run once at import where every input is a constant
_FOLDED_OPS = frozenset({"HannWindow", "HammingWindow", "BlackmanWindow",
                         "MelWeightMatrix", "Range"})


class OnnxGraph(nn.Module):
    """The graph as a module: initializer ``k`` (in file order) is the
    buffer ``p{k}``, a folded constant node's output ``f{k}``;
    ``forward(*inputs)`` → the output tensors, on the buffers' device.
    NCHW stays NCHW."""

    def __init__(self, graph: OnnxGraphDef):
        super().__init__()
        self.graph = graph
        unsupported = sorted({n.op_type for n in graph.nodes
                              if n.op_type not in _ONNX_OPS})
        if unsupported:
            raise NotImplementedError(
                f"onnx ops not yet supported: {unsupported}")
        self._keys: dict[str, str] = {}
        for k, (name, arr) in enumerate(graph.initializers.items()):
            self._keys[name] = f"p{k}"
            self.register_buffer(f"p{k}", device_array(arr, "cpu"))
        self._folded: dict[str, np.ndarray] = {}
        self._nodes = []
        cpu = Values(torch.device("cpu"), lambda n: None, self._host_const,
                     self._undefined)
        cpu.const = self._const
        for node in graph.nodes:
            if node.op_type in _FOLDED_OPS and all(
                    self._host_const(i) is not None
                    for i in node.inputs if i):
                out = np.asarray(_ONNX_OPS[node.op_type](node, cpu))
                self._folded[node.outputs[0]] = out
                self._keys[node.outputs[0]] = f"f{len(self._folded) - 1}"
                self.register_buffer(f"f{len(self._folded) - 1}",
                                     device_array(out, "cpu"))
            else:
                self._nodes.append(node)

    def _host_const(self, name: str) -> np.ndarray | None:
        c = self.graph.initializers.get(name)
        return self._folded.get(name) if c is None else c

    # Static constants for shape-like inputs: reshape shapes, slice
    # indices, reduce axes come from the graph's initializers.
    def _const(self, name: str) -> np.ndarray:
        if name in self.graph.initializers:
            return self.graph.initializers[name]
        raise KeyError(
            f"{name!r} must be a constant initializer (shape-like "
            f"inputs cannot be runtime tensors)")

    @staticmethod
    def _undefined(name: str) -> str:
        return f"tensor {name!r} undefined"

    def param(self, name: str) -> torch.Tensor:
        """The buffer of initializer (or folded constant) `name`."""
        return self._buffers[self._keys[name]]

    def forward(self, *inputs) -> list[torch.Tensor]:
        """Run the graph; the output tensors. Inputs go to the buffers'
        device (the first input's, for a graph without constants)."""
        g = self.graph
        if len(inputs) != len(g.inputs):
            raise ValueError(
                f"expected {len(g.inputs)} inputs {g.inputs}, "
                f"got {len(inputs)}")
        bufs, keys = self._buffers, self._keys
        dev = next((b.device for b in bufs.values()), None)
        if dev is None:
            dev = next((x.device for x in inputs
                        if isinstance(x, torch.Tensor)), torch.device("cpu"))
        value = Values(dev, lambda n: bufs.get(keys.get(n, "")),
                       self._host_const, self._undefined)
        value.const = self._const
        for name, val in zip(g.inputs, inputs):
            value.env[name] = torch.as_tensor(val, device=dev)
        with full_float32():
            for node in self._nodes:
                outs = _ONNX_OPS[node.op_type](node, value)
                if not isinstance(outs, (tuple, list)):
                    outs = [outs]
                for oname, oval in zip(node.outputs, outs):
                    value.env[oname] = oval
        return [value(o) for o in g.outputs]


def _conv(node: OnnxNode, value):
    x = value(node.inputs[0])                     # NCHW
    w = value(node.inputs[1])                     # OIHW
    a = node.attrs
    spatial = x.ndim - 2
    strides = tuple(a.get("strides", [1] * spatial))
    dil = tuple(a.get("dilations", [1] * spatial))
    groups = int(a.get("group", 1))
    pads = a.get("pads")
    auto = _auto_pad_to_str(a)
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        padding = [same_pads(x.shape[2 + i], w.shape[2 + i], strides[i],
                             dil[i]) for i in range(spatial)]
    elif pads:
        padding = [(int(pads[i]), int(pads[i + spatial]))
                   for i in range(spatial)]
    else:
        padding = [(0, 0)] * spatial
    conv = {1: F.conv1d, 2: F.conv2d}[spatial]
    y = conv(pad(x, padding), w, None, strides, 0, dil, groups)
    if len(node.inputs) > 2:
        b = value(node.inputs[2])
        y = y + b.reshape((1, -1) + (1,) * spatial)
    return y


def _gemm(node: OnnxNode, value):
    a = value(node.inputs[0])
    b = value(node.inputs[1])
    attrs = node.attrs
    if int(attrs.get("transA", 0)):
        a = a.t()
    if int(attrs.get("transB", 0)):
        b = b.t()
    y = torch.matmul(a, b) * attrs.get("alpha", 1.0)
    if len(node.inputs) > 2:
        y = y + value(node.inputs[2]) * attrs.get("beta", 1.0)
    return y


def _batchnorm(node: OnnxNode, value):
    x = value(node.inputs[0])
    scale = value(node.inputs[1])
    bias = value(node.inputs[2])
    mean = value(node.inputs[3])
    var = value(node.inputs[4])
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    k = scale * torch.rsqrt(var + eps)
    return x * k.reshape(shape) + (bias - mean * k).reshape(shape)


def _pool(kind: str):
    def h(node: OnnxNode, value):
        x = value(node.inputs[0])
        a = node.attrs
        spatial = x.ndim - 2
        ks = tuple(a.get("kernel_shape", [1] * spatial))
        strides = tuple(a.get("strides", ks))
        pads = a.get("pads")
        if pads and any(pads):
            padding = [(int(pads[i]), int(pads[i + spatial]))
                       for i in range(spatial)]
        else:
            padding = [(0, 0)] * spatial
        return pool(x, kind, ks, strides, padding)

    return h


def _global_avg_pool(node: OnnxNode, value):
    x = value(node.inputs[0])
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


def _reshape(node: OnnxNode, value):
    shape = np.asarray(value.const(node.inputs[1])).ravel().tolist()
    x = value(node.inputs[0])
    # ONNX semantics: 0 = copy input dim
    shape = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
    return x.reshape(shape)


def _elementwise(fn):
    def h(node: OnnxNode, value):
        return fn(*[value(i) for i in node.inputs])

    return h


def _clip(node: OnnxNode, value):
    x = value(node.inputs[0])
    lo = (value(node.inputs[1]) if len(node.inputs) > 1 and node.inputs[1]
          else node.attrs.get("min", -np.inf))
    hi = (value(node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2]
          else node.attrs.get("max", np.inf))
    x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) \
        else torch.clamp(x, min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) \
        else torch.clamp(x, max=hi)


def _reduce(kind: str):
    """Shared Reduce* handler (axes attr or opset-18 axes input)."""
    def h(node: OnnxNode, value):
        x = value(node.inputs[0])
        axes = node.attrs.get("axes")
        if axes is None and len(node.inputs) > 1:
            axes = np.asarray(value.const(node.inputs[1])).ravel().tolist()
        keep = bool(node.attrs.get("keepdims", 1))
        dims = (tuple(int(a) % x.ndim for a in axes) if axes
                else tuple(range(x.ndim)))
        return reduce(kind, x, dims, keep)

    return h


def _layernorm(node: OnnxNode, value):
    """LayerNormalization (transformer graphs, e.g. ViT-style encoders)."""
    x = value(node.inputs[0])
    scale = value(node.inputs[1])
    bias = value(node.inputs[2]) if len(node.inputs) > 2 else None
    axis = int(node.attrs.get("axis", -1))
    eps = float(node.attrs.get("epsilon", 1e-5))
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps) * scale
    return y + bias if bias is not None else y


def _split(node: OnnxNode, value):
    x = value(node.inputs[0])
    axis = int(node.attrs.get("axis", 0))
    sizes = node.attrs.get("split")
    if sizes is None and len(node.inputs) > 1:
        sizes = np.asarray(value.const(node.inputs[1])).ravel().tolist()
    if sizes is None:
        n = int(node.attrs.get("num_outputs", len(node.outputs)))
        sizes = [x.shape[axis] // n] * n
    offs = np.cumsum([0] + list(sizes))
    return tuple(x.narrow(axis, int(offs[i]), int(offs[i + 1] - offs[i]))
                 for i in range(len(sizes)))


def _expand(node: OnnxNode, value):
    x = value(node.inputs[0])
    shape = [int(s) for s in
             np.asarray(value.const(node.inputs[1])).ravel()]
    # ONNX Expand is a TWO-WAY broadcast: output rank is the max of both
    # ranks, dims right-aligned; a shape dim of 1 (or -1) keeps the input
    # dim, and an input dim of 1 stretches to the shape dim.
    out_rank = max(x.ndim, len(shape))
    shp = [1] * (out_rank - len(shape)) + list(shape)
    xs = (1,) * (out_rank - x.ndim) + tuple(x.shape)
    target = [xi if s in (-1, 1) else max(s, xi)
              for s, xi in zip(shp, xs)]
    return torch.broadcast_to(x, tuple(target))


def _transpose(node: OnnxNode, value):
    x = value(node.inputs[0])
    perm = node.attrs.get("perm", list(range(x.ndim))[::-1])
    return x.permute(perm)


def _concat(node: OnnxNode, value):
    return torch.cat([value(i) for i in node.inputs],
                     dim=int(node.attrs.get("axis", 0)))


def _softmax(node: OnnxNode, value):
    return torch.softmax(value(node.inputs[0]),
                         dim=int(node.attrs.get("axis", -1)))


def _squeeze(node: OnnxNode, value):
    x = value(node.inputs[0])
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1:
        axes = np.asarray(value.const(node.inputs[1])).ravel().tolist()
    if not axes:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=tuple(int(a) % x.ndim for a in axes))


def _unsqueeze(node: OnnxNode, value):
    x = value(node.inputs[0])
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1:
        axes = np.asarray(value.const(node.inputs[1])).ravel().tolist()
    for a in sorted(int(a) for a in axes):
        x = torch.unsqueeze(x, a)
    return x


def _flatten(node: OnnxNode, value):
    x = value(node.inputs[0])
    axis = int(node.attrs.get("axis", 1))
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


def _gather(node: OnnxNode, value):
    return take(value(node.inputs[0]), value(node.inputs[1]),
                int(node.attrs.get("axis", 0)))


def _slice(node: OnnxNode, value):
    x = value(node.inputs[0])
    starts = np.asarray(value.const(node.inputs[1])).ravel()
    ends = np.asarray(value.const(node.inputs[2])).ravel()
    axes = (np.asarray(value.const(node.inputs[3])).ravel()
            if len(node.inputs) > 3 else np.arange(len(starts)))
    steps = (np.asarray(value.const(node.inputs[4])).ravel()
             if len(node.inputs) > 4 else np.ones(len(starts), np.int64))
    idx = {}
    for s, e, a, st in zip(starts, ends, axes, steps):
        idx[int(a) % x.ndim] = slice(int(s), int(np.clip(e, -2**31, 2**31)),
                                     int(st))
    return slice_axes(x, idx)


def _pad_op(node: OnnxNode, value):
    x = value(node.inputs[0])
    pads = (np.asarray(value.const(node.inputs[1])).ravel()
            if len(node.inputs) > 1 else np.asarray(node.attrs.get("pads")))
    n = x.ndim
    return pad(x, [(pads[i], pads[i + n]) for i in range(n)])


def _qdq_scale_zp(node: OnnxNode, value):
    """(scale, zero_point, broadcast shape fn) for Q/DQ ops. Per-axis when
    scale is a vector (axis attr, default 1 per ONNX spec)."""
    scale = value(node.inputs[1]).to(torch.float32)
    zp = (value(node.inputs[2]).to(torch.float32)
          if len(node.inputs) > 2
          else torch.zeros((), dtype=torch.float32, device=value.device))
    axis = int(node.attrs.get("axis", 1))

    def shaped(arr, x):
        if arr.ndim == 0 or arr.numel() == 1:
            return arr.reshape(())
        b = [1] * x.ndim
        b[axis] = arr.numel()
        return arr.reshape(b)

    return scale, zp, shaped


def _quantize_linear(node: OnnxNode, value):
    x = value(node.inputs[0]).to(torch.float32)
    scale, zp, shaped = _qdq_scale_zp(node, value)
    q = torch.round(x / shaped(scale, x)) + shaped(zp, x)
    # clamp range from the zero-point DTYPE; an OMITTED zero_point
    # defaults the output to uint8 per the ONNX spec
    zp_raw = value(node.inputs[2]) if len(node.inputs) > 2 else None
    signed = zp_raw is not None and zp_raw.dtype == torch.int8
    lo, hi = (-128.0, 127.0) if signed else (0.0, 255.0)
    return torch.clamp(q, lo, hi)       # keep float: consumer is always DQ


def _dequantize_linear(node: OnnxNode, value):
    x = value(node.inputs[0]).to(torch.float32)
    scale, zp, shaped = _qdq_scale_zp(node, value)
    return (x - shaped(zp, x)) * shaped(scale, x)


def _cval(value, name) -> np.ndarray:
    """Shape-like operand as host numpy: initializer, or an output already
    computed in the environment."""
    try:
        return np.asarray(value.const(name))
    except KeyError:
        return value.host(name)


def _arg(kind):
    def h(node: OnnxNode, value):
        x = value(node.inputs[0])
        axis = int(node.attrs.get("axis", 0))
        keep = bool(node.attrs.get("keepdims", 1))
        fn = torch.argmax if kind == "max" else torch.argmin
        y = fn(x, dim=axis)
        return torch.unsqueeze(y, axis) if keep else y

    return h


def _topk(node: OnnxNode, value):
    x = value(node.inputs[0])
    k = int(_cval(value, node.inputs[1]).ravel()[0])
    axis = int(node.attrs.get("axis", -1))
    largest = bool(node.attrs.get("largest", 1))
    vals, idx = torch.topk(torch.movedim(x, axis, -1), k, dim=-1,
                           largest=largest, sorted=True)
    return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)


def _tile(node: OnnxNode, value):
    reps = [int(r) for r in _cval(value, node.inputs[1]).ravel()]
    return torch.tile(value(node.inputs[0]), reps)


def _range_op(node: OnnxNode, value):
    start, limit, delta = (_cval(value, i).ravel()[0] for i in node.inputs)
    return np.arange(start, limit, delta)


def _constant_of_shape(node: OnnxNode, value):
    shape = [int(s) for s in _cval(value, node.inputs[0]).ravel()]
    fill = node.attrs.get("value")
    fill = np.asarray(fill).ravel()[0] if fill is not None else np.float32(0)
    return torch.full(shape, fill.item(), dtype=torch_dtype(fill.dtype),
                      device=value.device)


def _cumsum(node: OnnxNode, value):
    x = value(node.inputs[0])
    axis = int(_cval(value, node.inputs[1]).ravel()[0])
    if node.attrs.get("reverse"):
        x = torch.flip(x, (axis,))
    y = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if node.attrs.get("exclusive"):
        y = y - x
    if node.attrs.get("reverse"):
        y = torch.flip(y, (axis,))
    return y


def _mod(node: OnnxNode, value):
    a, b = value(node.inputs[0]), value(node.inputs[1])
    # floor semantics (jnp.mod), unless fmod=1
    return torch.fmod(a, b) if node.attrs.get("fmod") \
        else torch.remainder(a, b)


def _gather_elements(node: OnnxNode, value):
    x = value(node.inputs[0])
    idx = value(node.inputs[1]).to(torch.long)
    return torch.gather(x, int(node.attrs.get("axis", 0)), idx)


def _resize(node: OnnxNode, value):
    """Resize (NCHW image semantics): scales or sizes input, nearest or
    linear mode — the subset real vision/audio export graphs use."""
    x = value(node.inputs[0])
    mode = node.attrs.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    sizes = None
    if len(node.inputs) > 3 and node.inputs[3]:
        sizes = [int(s) for s in _cval(value, node.inputs[3]).ravel()]
    elif len(node.inputs) > 2 and node.inputs[2]:
        scales = _cval(value, node.inputs[2]).ravel()
        if len(scales):
            sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
    if sizes is None:
        return x
    return resize(x, sizes, linear=mode != "nearest")


# ---- opset-17 signal ops: the lowering real audio graphs (Perch-class
# models with in-graph mel front ends) use for tf.signal.stft ----------------


def _window(kind):
    def h(node: OnnxNode, value):
        size = int(_cval(value, node.inputs[0]).ravel()[0])
        periodic = int(node.attrs.get("periodic", 1))
        n = size if periodic else size - 1
        i = np.arange(size, dtype=np.float64)
        if kind == "hann":
            w = 0.5 - 0.5 * np.cos(2 * np.pi * i / max(1, n))
        elif kind == "hamming":
            w = 25 / 46 - (1 - 25 / 46) * np.cos(2 * np.pi * i / max(1, n))
        else:                                  # blackman
            w = (0.42 - 0.5 * np.cos(2 * np.pi * i / max(1, n))
                 + 0.08 * np.cos(4 * np.pi * i / max(1, n)))
        return w.astype(np.float32)

    return h


def _mel_weight_matrix(node: OnnxNode, value):
    """MelWeightMatrix (ONNX spec formula: HTK mels, triangular)."""
    nmel, dftlen, sr, lo, hi = (
        _cval(value, i).ravel()[0] for i in node.inputs)
    nmel, dftlen, sr = int(nmel), int(dftlen), int(sr)
    nbins = dftlen // 2 + 1

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    edges_hz = mel2hz(np.linspace(hz2mel(float(lo)), hz2mel(float(hi)),
                                  nmel + 2))
    bin_hz = np.arange(nbins) * sr / dftlen
    w = np.zeros((nbins, nmel), np.float32)
    for m in range(nmel):
        left, center, right = edges_hz[m], edges_hz[m + 1], edges_hz[m + 2]
        up = (bin_hz - left) / max(center - left, 1e-12)
        down = (right - bin_hz) / max(right - center, 1e-12)
        w[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return w


def _spectrum(x: torch.Tensor, onesided: int, axis: int) -> torch.Tensor:
    fft = (torch.fft.rfft if onesided else torch.fft.fft)(
        x.to(torch.float32), dim=axis)
    return torch.stack([fft.real, fft.imag], dim=-1).to(torch.float32)


def _dft(node: OnnxNode, value):
    x = value(node.inputs[0])
    if node.attrs.get("inverse"):
        raise NotImplementedError("inverse DFT")
    axis = int(node.attrs.get("axis", 1))
    onesided = int(node.attrs.get("onesided", 0))
    # input may carry a trailing [..., 1] real / [..., 2] complex axis
    if x.shape[-1] == 1:
        x = x[..., 0]
    return _spectrum(x, onesided, axis)


def _stft(node: OnnxNode, value):
    """STFT (opset 17): signal [B, L] or [B, L, 1], frame_step, optional
    window [W], optional frame_length; onesided attr. Output
    [B, frames, dft_size//2+1, 2] (real|imag)."""
    x = value(node.inputs[0])
    step = int(_cval(value, node.inputs[1]).ravel()[0])
    window = None
    if len(node.inputs) > 2 and node.inputs[2]:
        window = value(node.inputs[2])
    if len(node.inputs) > 3 and node.inputs[3]:
        frame_len = int(_cval(value, node.inputs[3]).ravel()[0])
    elif window is not None:
        frame_len = int(window.shape[0])
    else:
        raise ValueError("STFT needs window or frame_length")
    onesided = int(node.attrs.get("onesided", 1))
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    framed = x.unfold(-1, frame_len, step)       # [B, frames, frame_len]
    if window is not None:
        framed = framed * window.to(framed.dtype)
    return _spectrum(framed, onesided, -1)


def _where(c, a, b):
    return torch.where(c.to(torch.bool), a, b)


def _build_ops():
    return {
        "Conv": _conv,
        "Gemm": _gemm,
        "MatMul": _elementwise(torch.matmul),
        "Add": _elementwise(lambda a, b: a + b),
        "Sub": _elementwise(lambda a, b: a - b),
        "Mul": _elementwise(lambda a, b: a * b),
        "Div": _elementwise(torch.true_divide),
        "Pow": _elementwise(torch.pow),
        "Sqrt": _elementwise(torch.sqrt),
        "Exp": _elementwise(torch.exp),
        "Log": _elementwise(torch.log),
        "Neg": _elementwise(torch.neg),
        "Abs": _elementwise(torch.abs),
        "Erf": _elementwise(torch.erf),
        "Relu": _elementwise(lambda x: torch.clamp(x, min=0.0)),
        "LeakyRelu": lambda n, v: torch.where(
            v(n.inputs[0]) >= 0, v(n.inputs[0]),
            n.attrs.get("alpha", 0.01) * v(n.inputs[0])),
        "Sigmoid": _elementwise(torch.sigmoid),
        "Tanh": _elementwise(torch.tanh),
        "HardSwish": _elementwise(
            lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0),
        "HardSigmoid": lambda n, v: torch.clamp(
            n.attrs.get("alpha", 0.2) * v(n.inputs[0])
            + n.attrs.get("beta", 0.5), 0.0, 1.0),
        "Clip": _clip,
        "Softmax": _softmax,
        "BatchNormalization": _batchnorm,
        "Conv1d": _conv,
        "AveragePool": _pool("avg"),
        "MaxPool": _pool("max"),
        "GlobalAveragePool": _global_avg_pool,
        "ReduceMean": _reduce("mean"),
        "ReduceSum": _reduce("sum"),
        "ReduceMax": _reduce("max"),
        "ReduceMin": _reduce("min"),
        "LayerNormalization": _layernorm,
        "Split": _split,
        "Expand": _expand,
        "Where": _elementwise(_where),
        "Min": _elementwise(torch.minimum),
        "Max": _elementwise(torch.maximum),
        "Softplus": _elementwise(F.softplus),
        "Elu": lambda n, v: F.elu(v(n.inputs[0]),
                                  n.attrs.get("alpha", 1.0)),
        "PRelu": _elementwise(
            lambda x, a: torch.where(x >= 0, x, a * x)),
        "Floor": _elementwise(torch.floor),
        "Ceil": _elementwise(torch.ceil),
        "Round": _elementwise(torch.round),
        "Greater": _elementwise(torch.gt),
        "Less": _elementwise(torch.lt),
        "Equal": _elementwise(torch.eq),
        "Reshape": _reshape,
        "Flatten": _flatten,
        "Transpose": _transpose,
        "Concat": _concat,
        "Squeeze": _squeeze,
        "Unsqueeze": _unsqueeze,
        "Identity": _elementwise(lambda x: x),
        "Dropout": lambda n, v: v(n.inputs[0]),
        "Gather": _gather,
        "Slice": _slice,
        "Pad": _pad_op,
        "Shape": lambda n, v: np.asarray(v(n.inputs[0]).shape, np.int64),
        "Cast": lambda n, v: v(n.inputs[0]).to(
            torch_dtype(_NP.get(int(n.attrs.get("to", 1)), np.float32))),
        # QDQ quantization (the catalog's INT8-ONNX variants): the
        # QuantizeLinear→DequantizeLinear pairs reproduce the int8
        # rounding while the surrounding ops execute in float
        "QuantizeLinear": _quantize_linear,
        "DequantizeLinear": _dequantize_linear,
        "Sin": _elementwise(torch.sin),
        "Cos": _elementwise(torch.cos),
        "Not": _elementwise(torch.logical_not),
        "And": _elementwise(torch.logical_and),
        "Or": _elementwise(torch.logical_or),
        "Xor": _elementwise(torch.logical_xor),
        "GreaterOrEqual": _elementwise(torch.ge),
        "LessOrEqual": _elementwise(torch.le),
        "Mod": _mod,
        "CumSum": _cumsum,
        "ReduceProd": _reduce("prod"),
        "ArgMax": _arg("max"),
        "ArgMin": _arg("min"),
        "TopK": _topk,
        "Tile": _tile,
        "Range": _range_op,
        "ConstantOfShape": _constant_of_shape,
        "GatherElements": _gather_elements,
        "Resize": _resize,
        # opset-17 signal ops (real in-graph mel front ends)
        "HannWindow": _window("hann"),
        "HammingWindow": _window("hamming"),
        "BlackmanWindow": _window("blackman"),
        "MelWeightMatrix": _mel_weight_matrix,
        "DFT": _dft,
        "STFT": _stft,
    }


_ONNX_OPS: dict[str, Callable] = _build_ops()


def supported_ops() -> frozenset[str]:
    """ONNX op types the compiler handles — audit surface for
    `verify-artifact --audit`."""
    return frozenset(_build_ops())


def load_onnx(path_or_bytes) -> OnnxGraph:
    """Load a .onnx file → OnnxGraph (constants as CPU buffers; move it
    with ``.to(device)``)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    return OnnxGraph(parse_onnx(buf))
