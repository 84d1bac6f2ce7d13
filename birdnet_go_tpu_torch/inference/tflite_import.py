"""TFLite flatbuffer → torch module (port of
``birdnet_go_tpu/inference/tflite_import.py``).

The parser is the JAX module's, unchanged: the .tflite graph is read once
by the FlatBuffers reader (``flatbuf.py``, a copy), integer weights with
quantization parameters are dequantized on import, and float16 weights
become float32. ``TFLiteGraph`` is an ``nn.Module`` that holds every
constant tensor as a buffer ``t{index}`` and runs the op list in
``forward`` through a handler table with the JAX importer's keys, each op
as plain torch (cuDNN, cuBLAS and cuFFT on the card).

Activations keep TFLite's NHWC layout between ops, as in the JAX
importer; a convolution or pool sees them through an NCHW view
(``permute``), TF-SAME padding applied first with ``F.pad`` (asymmetric
at stride 2). Values follow the JAX importer's: ``ROUND`` and
``FLOOR_MOD`` round and take the remainder as numpy does, an average pool
divides by the count of valid inputs, and a convolution or product runs
in full float32 (``ops.precision.full_float32``), whatever the process
allows for TF32. Integer results may be wider than JAX's (which runs
without x64): the values are the same. ``STRIDED_SLICE`` reads the
begin, end and shrink masks and, as the JAX importer, not the ellipsis
and new-axis masks.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from birdnet_go_tpu_torch.inference.flatbuf import Table, root_table
from birdnet_go_tpu_torch.inference.graph_ops import (
    Values,
    mirror_pad,
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

log = logging.getLogger("birdnet_tpu.tflite")


# TensorType enum (schema.fbs)
class TType(enum.IntEnum):
    FLOAT32 = 0
    FLOAT16 = 1
    INT32 = 2
    UINT8 = 3
    INT64 = 4
    STRING = 5
    BOOL = 6
    INT16 = 7
    COMPLEX64 = 8
    INT8 = 9


_NP_DTYPES = {
    TType.FLOAT32: np.float32, TType.FLOAT16: np.float16,
    TType.INT32: np.int32, TType.UINT8: np.uint8, TType.INT64: np.int64,
    TType.BOOL: np.bool_, TType.INT16: np.int16, TType.INT8: np.int8,
    TType.COMPLEX64: np.complex64,
}

# BuiltinOperator codes (schema.fbs) — the subset we compile
class Op(enum.IntEnum):
    ADD = 0
    AVERAGE_POOL_2D = 1
    CONCATENATION = 2
    CONV_2D = 3
    DEPTHWISE_CONV_2D = 4
    DEQUANTIZE = 6
    FULLY_CONNECTED = 9
    LOGISTIC = 14
    MAX_POOL_2D = 17
    MUL = 18
    RELU = 19
    RELU6 = 21
    RESHAPE = 22
    RESIZE_BILINEAR = 23
    RNN = 24
    SOFTMAX = 25
    TANH = 28
    PAD = 34
    MEAN = 40
    SUB = 41
    DIV = 42
    SQUEEZE = 43
    STRIDED_SLICE = 45
    EXP = 47
    LOG = 73
    SQRT = 75
    RSQRT = 76
    SHAPE = 77
    POW = 78
    LEAKY_RELU = 98
    SQUARED_DIFFERENCE = 99
    NEG = 59
    TRANSPOSE = 39
    MINIMUM = 57
    MAXIMUM = 55
    ABS = 101
    GATHER = 36
    HARD_SWISH = 117
    QUANTIZE = 114
    # extended coverage toward the published real-graph op sets (VERDICT
    # r3 #8): tf.signal.stft lowers to framing (STRIDED_SLICE/PACK/
    # RESHAPE) + RFFT2D + COMPLEX_ABS, mel projection to BATCH_MATMUL/
    # FULLY_CONNECTED, plus the usual TF-export glue below
    FLOOR = 8
    L2_NORMALIZATION = 11
    SPLIT = 49
    LOG_SOFTMAX = 50
    CAST = 53
    PRELU = 54
    ARG_MAX = 56
    LESS = 58
    PADV2 = 60
    GREATER = 61
    GREATER_EQUAL = 62
    LESS_EQUAL = 63
    SELECT = 64
    SLICE = 65
    SIN = 66
    TILE = 69
    EXPAND_DIMS = 70
    EQUAL = 71
    NOT_EQUAL = 72
    SUM = 74
    ARG_MIN = 79
    REDUCE_PROD = 81
    REDUCE_MAX = 82
    PACK = 83
    LOGICAL_OR = 84
    LOGICAL_AND = 86
    LOGICAL_NOT = 87
    UNPACK = 88
    REDUCE_MIN = 89
    FLOOR_DIV = 90
    SQUARE = 92
    ZEROS_LIKE = 93
    FILL = 94
    FLOOR_MOD = 95
    RANGE = 96
    RESIZE_NEAREST_NEIGHBOR = 97
    MIRROR_PAD = 100
    SPLIT_V = 102
    CEIL = 104
    ADD_N = 106
    GATHER_ND = 107
    COS = 108
    ELU = 111
    ROUND = 116
    SELECT_V2 = 123
    BATCH_MATMUL = 126
    CUMSUM = 128
    BROADCAST_TO = 130
    RFFT2D = 131
    IMAG = 133
    REAL = 134
    COMPLEX_ABS = 135


# ActivationFunctionType
_ACT_NONE, _ACT_RELU, _ACT_RELU_N1_TO_1, _ACT_RELU6, _ACT_TANH = 0, 1, 2, 3, 4
# Padding enum: 0=SAME, 1=VALID
_PAD_SAME, _PAD_VALID = 0, 1


def _dequantize_weights(data: np.ndarray, qt, shape: tuple) -> np.ndarray:
    """Dequantize-on-import for quantized artifacts (the catalog ships
    ARM64 INT8 TFLite variants — model_registry.go INT8 remap).

    Integer weight/bias tensors with QuantizationParameters become f32:
    (q - zero_point) * scale, per-channel along quantized_dimension when
    the scale is a vector. On TPU the float graph IS the fast path (see
    ARCHITECTURE.md "int8 quantization"), so quantized graphs execute at
    float precision rather than emulating int8 arithmetic.
    QuantizationParameters schema: min=0, max=1, scale=2, zero_point=3,
    details_type=4, details=5, quantized_dimension=6.
    """
    if qt is None or data.dtype.kind not in "iu":
        return data
    scale = np.asarray(qt.get_float_vector(2), np.float32)
    if scale.size == 0:
        return data
    zp = np.asarray(qt.get_int_vector(3, "<q", 8), np.int64)
    qdim = qt.get_int(6, 0)
    x = data.astype(np.float32)
    if scale.size == 1:
        z = float(zp[0]) if zp.size else 0.0
        return (x - z) * float(scale[0])
    # per-channel: broadcast along quantized_dimension
    bshape = [1] * len(shape)
    bshape[qdim] = scale.size
    s = scale.reshape(bshape)
    z = (zp.astype(np.float32).reshape(bshape)
         if zp.size == scale.size else 0.0)
    return (x - z) * s


@dataclasses.dataclass
class TensorInfo:
    index: int
    name: str
    shape: tuple[int, ...]
    dtype: Any
    buffer_index: int
    data: np.ndarray | None        # constant data (weights) or None


@dataclasses.dataclass
class OpInfo:
    opcode: int
    inputs: list[int]
    outputs: list[int]
    options: Table | None
    custom_code: str | None = None


@dataclasses.dataclass
class TFLiteModel:
    tensors: list[TensorInfo]
    ops: list[OpInfo]
    inputs: list[int]
    outputs: list[int]
    description: str = ""

    def signature(self) -> str:
        lines = [f"# {self.description}"]
        for o in self.ops:
            lines.append(f"{Op(o.opcode).name if o.opcode in set(Op) else o.opcode}"
                         f" {o.inputs} -> {o.outputs}")
        return "\n".join(lines)


def parse_tflite(buf: bytes) -> TFLiteModel:
    """Parse a .tflite flatbuffer into tensors/ops (first subgraph)."""
    model = root_table(buf)
    # Model fields: version=0, operator_codes=1, subgraphs=2,
    # description=3, buffers=4
    opcodes_t = model.get_table_vector(1)
    opcodes = []
    for oc in opcodes_t:
        # OperatorCode: deprecated_builtin_code=0 (byte), custom_code=1,
        # version=2, builtin_code=3 (int32, for codes > 127)
        dep = oc.get_byte(0)
        builtin = oc.get_int(3, 0)
        opcodes.append((max(dep, builtin), oc.get_string(1)))
    subgraphs = model.get_table_vector(2)
    if not subgraphs:
        raise ValueError("tflite model has no subgraphs")
    buffers = model.get_table_vector(4)
    sg = subgraphs[0]
    # SubGraph: tensors=0, inputs=1, outputs=2, operators=3, name=4
    tensors = []
    for i, t in enumerate(sg.get_table_vector(0)):
        # Tensor: shape=0, type=1, buffer=2, name=3, quantization=4
        ttype = TType(t.get_byte(1))
        shape = tuple(t.get_int_vector(0))
        buf_idx = t.get_uint(2)
        data = None
        if 0 < buf_idx < len(buffers):
            # Buffer: data=0 ([ubyte])
            raw = buffers[buf_idx].get_bytes_vector(0)
            if raw:
                dtype = _NP_DTYPES.get(ttype)
                if dtype is None:
                    raise ValueError(f"unsupported tensor type {ttype}")
                data = np.frombuffer(raw, dtype=dtype)
                if shape:
                    data = data.reshape(shape)
                data = _dequantize_weights(data, t.get_table(4), shape)
        tensors.append(TensorInfo(
            index=i, name=t.get_string(3) or f"t{i}", shape=shape,
            dtype=_NP_DTYPES.get(ttype, np.float32), buffer_index=buf_idx,
            data=data))
    ops = []
    for o in sg.get_table_vector(3):
        # Operator: opcode_index=0, inputs=1, outputs=2,
        # builtin_options_type=3, builtin_options=4
        idx = o.get_uint(0)
        code, custom = opcodes[idx]
        ops.append(OpInfo(
            opcode=code,
            inputs=o.get_int_vector(1),
            outputs=o.get_int_vector(2),
            options=o.get_table(4),
            custom_code=custom))
    return TFLiteModel(
        tensors=tensors, ops=ops,
        inputs=sg.get_int_vector(1), outputs=sg.get_int_vector(2),
        description=model.get_string(3) or "")



# ---------------------------------------------------------------------------
# Graph → torch
# ---------------------------------------------------------------------------


def _fused_activation(act: int, x: torch.Tensor) -> torch.Tensor:
    if act == _ACT_NONE:
        return x
    if act == _ACT_RELU:
        return torch.clamp(x, min=0.0)
    if act == _ACT_RELU6:
        return torch.clamp(x, 0.0, 6.0)
    if act == _ACT_RELU_N1_TO_1:
        return torch.clamp(x, -1.0, 1.0)
    if act == _ACT_TANH:
        return torch.tanh(x)
    raise ValueError(f"unsupported fused activation {act}")


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, padding: int,
               stride: tuple[int, int], dilation: tuple[int, int],
               groups: int = 1) -> torch.Tensor:
    """NHWC x, OIHW w → NHWC y; TF SAME pads x first (in NHWC)."""
    if padding == _PAD_SAME:
        ph = same_pads(x.shape[1], w.shape[2], stride[0], dilation[0])
        pw = same_pads(x.shape[2], w.shape[3], stride[1], dilation[1])
        x = pad(x, [ph, pw, (0, 0)])
    return _to_nhwc(F.conv2d(_to_nchw(x), w, None, stride, 0, dilation,
                             groups))


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "min": torch.minimum,
    "max": torch.maximum,
    "pow": torch.pow,
    "sqdiff": lambda a, b: (a - b) ** 2,
}

_UNARY = {
    "sigmoid": torch.sigmoid,
    "relu": lambda v: torch.clamp(v, min=0.0),
    "relu6": lambda v: torch.clamp(v, 0.0, 6.0),
    "tanh": torch.tanh,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "neg": torch.neg,
    "abs": torch.abs,
    "hardswish": lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0) / 6.0,
    "floor": torch.floor,
    "ceil": torch.ceil,
    # TFLite ROUND is round-half-to-even, as torch.round
    "round": torch.round,
    "square": torch.square,
    "sin": torch.sin,
    "cos": torch.cos,
    "elu": F.elu,
    "not": torch.logical_not,
    "zeros_like": torch.zeros_like,
    "imag": torch.imag,
    "real": torch.real,
    "l2norm": lambda v: v * torch.rsqrt(
        torch.sum(v * v, dim=-1, keepdim=True) + 1e-12),
    "log_softmax": lambda v: torch.log_softmax(v, dim=-1),
}

_COMPARE = {
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
    "and": torch.logical_and,
    "or": torch.logical_or,
    "floordiv": torch.floor_divide,
    # floor semantics, as jnp.mod (not torch.fmod)
    "floormod": torch.remainder,
}


class TFLiteGraph(nn.Module):
    """The graph as a module: every constant tensor a buffer ``t{index}``
    (moved with the module by ``.to``), ``forward(*inputs)`` → the output
    tensors, on the buffers' device."""

    def __init__(self, model: TFLiteModel):
        super().__init__()
        self.model = model
        for t in model.tensors:
            if t.data is not None:
                arr = t.data
                if arr.dtype == np.float16:
                    arr = arr.astype(np.float32)   # FP16 MData weights
                self.register_buffer(f"t{t.index}",
                                     torch.from_numpy(np.array(arr)))
        self._build()

    def _build(self) -> None:
        m = self.model
        handlers: dict[int, Callable] = {
            Op.CONV_2D: self._op_conv2d,
            Op.DEPTHWISE_CONV_2D: self._op_dwconv2d,
            Op.FULLY_CONNECTED: self._op_dense,
            Op.ADD: self._op_bin("add"),
            Op.SUB: self._op_bin("sub"),
            Op.MUL: self._op_bin("mul"),
            Op.DIV: self._op_bin("div"),
            Op.MINIMUM: self._op_bin("min"),
            Op.MAXIMUM: self._op_bin("max"),
            Op.POW: self._op_bin("pow"),
            Op.SQUARED_DIFFERENCE: self._op_bin("sqdiff"),
            Op.LOGISTIC: self._op_unary("sigmoid"),
            Op.RELU: self._op_unary("relu"),
            Op.RELU6: self._op_unary("relu6"),
            Op.TANH: self._op_unary("tanh"),
            Op.EXP: self._op_unary("exp"),
            Op.LOG: self._op_unary("log"),
            Op.SQRT: self._op_unary("sqrt"),
            Op.RSQRT: self._op_unary("rsqrt"),
            Op.NEG: self._op_unary("neg"),
            Op.ABS: self._op_unary("abs"),
            Op.HARD_SWISH: self._op_unary("hardswish"),
            Op.LEAKY_RELU: self._op_leaky_relu,
            Op.SOFTMAX: self._op_softmax,
            Op.AVERAGE_POOL_2D: self._op_pool("avg"),
            Op.MAX_POOL_2D: self._op_pool("max"),
            Op.RESHAPE: self._op_reshape,
            Op.SQUEEZE: self._op_squeeze,
            Op.TRANSPOSE: self._op_transpose,
            Op.PAD: self._op_pad,
            Op.MEAN: self._op_mean,
            Op.CONCATENATION: self._op_concat,
            Op.STRIDED_SLICE: self._op_strided_slice,
            Op.DEQUANTIZE: self._op_dequantize,
            # weights are dequantized at import; quantize/dequantize pairs
            # around the (now-float) graph collapse to casts
            Op.QUANTIZE: self._op_dequantize,
            Op.GATHER: self._op_gather,
            Op.FLOOR: self._op_unary("floor"),
            Op.CEIL: self._op_unary("ceil"),
            Op.ROUND: self._op_unary("round"),
            Op.SQUARE: self._op_unary("square"),
            Op.SIN: self._op_unary("sin"),
            Op.COS: self._op_unary("cos"),
            Op.ELU: self._op_unary("elu"),
            Op.LOGICAL_NOT: self._op_unary("not"),
            Op.ZEROS_LIKE: self._op_unary("zeros_like"),
            Op.IMAG: self._op_unary("imag"),
            Op.REAL: self._op_unary("real"),
            Op.COMPLEX_ABS: self._op_unary("abs"),
            Op.L2_NORMALIZATION: self._op_unary("l2norm"),
            Op.LOG_SOFTMAX: self._op_unary("log_softmax"),
            Op.LESS: self._op_cmp("lt"),
            Op.LESS_EQUAL: self._op_cmp("le"),
            Op.GREATER: self._op_cmp("gt"),
            Op.GREATER_EQUAL: self._op_cmp("ge"),
            Op.EQUAL: self._op_cmp("eq"),
            Op.NOT_EQUAL: self._op_cmp("ne"),
            Op.LOGICAL_AND: self._op_cmp("and"),
            Op.LOGICAL_OR: self._op_cmp("or"),
            Op.FLOOR_DIV: self._op_cmp("floordiv"),
            Op.FLOOR_MOD: self._op_cmp("floormod"),
            Op.SUM: self._op_reduce("sum"),
            Op.REDUCE_MAX: self._op_reduce("max"),
            Op.REDUCE_MIN: self._op_reduce("min"),
            Op.REDUCE_PROD: self._op_reduce("prod"),
            Op.ARG_MAX: self._op_arg("argmax"),
            Op.ARG_MIN: self._op_arg("argmin"),
            Op.CAST: self._op_cast,
            Op.SHAPE: self._op_shape,
            Op.EXPAND_DIMS: self._op_expand_dims,
            Op.SLICE: self._op_slice,
            Op.TILE: self._op_tile,
            Op.PACK: self._op_pack,
            Op.UNPACK: self._op_unpack,
            Op.SPLIT: self._op_split,
            Op.SPLIT_V: self._op_split_v,
            Op.SELECT: self._op_select,
            Op.SELECT_V2: self._op_select,
            Op.FILL: self._op_fill,
            Op.RANGE: self._op_range,
            Op.BROADCAST_TO: self._op_broadcast_to,
            Op.PADV2: self._op_padv2,
            Op.MIRROR_PAD: self._op_mirror_pad,
            Op.PRELU: self._op_prelu,
            Op.ADD_N: self._op_add_n,
            Op.GATHER_ND: self._op_gather_nd,
            Op.BATCH_MATMUL: self._op_batch_matmul,
            Op.CUMSUM: self._op_cumsum,
            Op.RESIZE_BILINEAR: self._op_resize("bilinear"),
            Op.RESIZE_NEAREST_NEIGHBOR: self._op_resize("nearest"),
            Op.RFFT2D: self._op_rfft2d,
        }
        self._handlers = handlers
        unsupported = sorted({
            o.opcode for o in m.ops
            if o.opcode not in handlers})
        if unsupported:
            names = [Op(c).name if c in set(Op) else str(c)
                     for c in unsupported]
            raise NotImplementedError(
                f"tflite ops not yet supported: {names}")

    # -- forward ----------------------------------------------------------------

    def forward(self, *inputs) -> list[torch.Tensor]:
        """Run the graph; the output tensors. Inputs go to the buffers'
        device (the first input's, for a graph without constants)."""
        m = self.model
        runtime_inputs = [i for i in m.inputs
                          if m.tensors[i].data is None]
        if len(inputs) != len(runtime_inputs):
            raise ValueError(
                f"expected {len(runtime_inputs)} inputs, got {len(inputs)}")
        bufs = self._buffers
        dev = next((b.device for b in bufs.values()), None)
        if dev is None:
            dev = next((x.device for x in inputs
                        if isinstance(x, torch.Tensor)), torch.device("cpu"))
        value = Values(
            dev, lambda i: bufs.get(f"t{i}"), lambda i: m.tensors[i].data,
            lambda i: f"tensor {i} ({m.tensors[i].name}) undefined")
        for idx, val in zip(runtime_inputs, inputs):
            value.env[idx] = torch.as_tensor(val, device=dev)
        with full_float32():
            for op in m.ops:
                outs = self._handlers[op.opcode](op, value)
                if not isinstance(outs, (tuple, list)):
                    outs = [outs]
                for out_idx, out_val in zip(op.outputs, outs):
                    value.env[out_idx] = out_val
        return [value(i) for i in m.outputs]

    # -- op handlers -------------------------------------------------------------

    def _bias(self, y: torch.Tensor, op: OpInfo, value) -> torch.Tensor:
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            y = y + value(op.inputs[2])
        return y

    def _op_conv2d(self, op: OpInfo, value):
        x = value(op.inputs[0])                  # NHWC
        w = value(op.inputs[1])                  # [O, H, W, I] (TFLite layout)
        o = op.options
        # Conv2DOptions: padding=0, stride_w=1, stride_h=2,
        # fused_activation_function=3, dilation_w=4, dilation_h=5
        # (only DepthwiseConv2DOptions shifts dilation to 5/6 behind depth_multiplier).
        padding = o.get_byte(0) if o else _PAD_SAME
        sw = o.get_int(1, 1) if o else 1
        sh = o.get_int(2, 1) if o else 1
        act = o.get_byte(3) if o else _ACT_NONE
        dw = o.get_int(4, 1) if o else 1
        dh = o.get_int(5, 1) if o else 1
        y = _conv_nhwc(x, w.permute(0, 3, 1, 2), padding, (sh, sw), (dh, dw))
        return _fused_activation(act, self._bias(y, op, value))

    def _op_dwconv2d(self, op: OpInfo, value):
        x = value(op.inputs[0])
        w = value(op.inputs[1])                  # [1, H, W, C*mult]
        o = op.options
        # DepthwiseConv2DOptions: padding=0, stride_w=1, stride_h=2,
        # depth_multiplier=3, fused_activation=4, dilation_w=5, dilation_h=6
        padding = o.get_byte(0) if o else _PAD_SAME
        sw = o.get_int(1, 1) if o else 1
        sh = o.get_int(2, 1) if o else 1
        act = o.get_byte(4) if o else _ACT_NONE
        dw = o.get_int(5, 1) if o else 1
        dh = o.get_int(6, 1) if o else 1
        # [1, H, W, C·M] → [C·M, 1, H, W] with groups=C: output channel
        # c·M + m reads input channel c, as in TFLite and the JAX HWIO form
        y = _conv_nhwc(x, w.permute(3, 0, 1, 2), padding, (sh, sw), (dh, dw),
                       groups=x.shape[-1])
        return _fused_activation(act, self._bias(y, op, value))

    def _op_dense(self, op: OpInfo, value):
        x = value(op.inputs[0])
        w = value(op.inputs[1])                  # [out, in]
        o = op.options
        # FullyConnectedOptions: fused_activation=0
        act = o.get_byte(0) if o else _ACT_NONE
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]) if x.ndim > 2 else x
        y = self._bias(torch.matmul(x2, w.t()), op, value)
        y = y.reshape(*lead, -1) if x.ndim > 2 else y
        return _fused_activation(act, y)

    def _op_bin(self, kind: str):
        fn = _BINARY[kind]

        def h(op: OpInfo, value):
            y = fn(value(op.inputs[0]), value(op.inputs[1]))
            act = op.options.get_byte(0) if op.options else _ACT_NONE
            return _fused_activation(act, y)

        return h

    def _op_unary(self, kind: str):
        fn = _UNARY[kind]
        return lambda op, value: fn(value(op.inputs[0]))

    def _op_cmp(self, kind: str):
        """Comparison / logical / integer-division binaries (no fused
        activation field in their options tables)."""
        fn = _COMPARE[kind]
        return lambda op, value: fn(value(op.inputs[0]),
                                    value(op.inputs[1]))

    def _op_reduce(self, kind: str):
        def h(op: OpInfo, value):
            x = value(op.inputs[0])
            axes = value.host(op.inputs[1]).ravel()
            keep = bool(op.options.get_bool(0)) if op.options else False
            return reduce(kind, x, tuple(int(a) % x.ndim for a in axes),
                          keep)

        return h

    def _op_arg(self, kind: str):
        def h(op: OpInfo, value):
            x = value(op.inputs[0])
            axis = int(value.host(op.inputs[1]).ravel()[0])
            out_dtype = self.model.tensors[op.outputs[0]].dtype
            fn = torch.argmax if kind == "argmax" else torch.argmin
            return fn(x, dim=axis).to(torch_dtype(out_dtype))

        return h

    def _op_leaky_relu(self, op: OpInfo, value):
        x = value(op.inputs[0])
        alpha = op.options.get_float(0, 0.01) if op.options else 0.01
        return torch.where(x >= 0, x, alpha * x)

    def _op_softmax(self, op: OpInfo, value):
        x = value(op.inputs[0])
        beta = op.options.get_float(0, 1.0) if op.options else 1.0
        return torch.softmax(x * beta, dim=-1)

    def _op_pool(self, kind: str):
        def h(op: OpInfo, value):
            x = value(op.inputs[0])
            o = op.options
            # Pool2DOptions: padding=0, stride_w=1, stride_h=2,
            # filter_width=3, filter_height=4, fused_activation=5
            padding = o.get_byte(0) if o else _PAD_SAME
            sw = o.get_int(1, 1) if o else 1
            sh = o.get_int(2, 1) if o else 1
            fw = o.get_int(3, 1) if o else 1
            fh = o.get_int(4, 1) if o else 1
            act = o.get_byte(5) if o else _ACT_NONE
            pads = ([same_pads(x.shape[1], fh, sh),
                     same_pads(x.shape[2], fw, sw)]
                    if padding == _PAD_SAME else [(0, 0), (0, 0)])
            y = _to_nhwc(pool(_to_nchw(x), kind, (fh, fw), (sh, sw), pads))
            return _fused_activation(act, y)

        return h

    def _op_reshape(self, op: OpInfo, value):
        x = value(op.inputs[0])
        if len(op.inputs) > 1 and op.inputs[1] >= 0:
            new_shape = [int(s) for s in value.host(op.inputs[1]).ravel()]
        else:
            # ReshapeOptions: new_shape=0
            new_shape = op.options.get_int_vector(0) if op.options else [-1]
        return x.reshape(new_shape)

    def _op_squeeze(self, op: OpInfo, value):
        x = value(op.inputs[0])
        dims = op.options.get_int_vector(0) if op.options else []
        if not dims:
            return torch.squeeze(x)
        return torch.squeeze(x, dim=tuple(d % x.ndim for d in dims))

    def _op_transpose(self, op: OpInfo, value):
        x = value(op.inputs[0])
        perm = [int(p) for p in value.host(op.inputs[1]).ravel()]
        return x.permute(perm)

    def _op_pad(self, op: OpInfo, value):
        x = value(op.inputs[0])
        pads = value.host(op.inputs[1])
        return pad(x, [(a, b) for a, b in pads])

    def _op_mean(self, op: OpInfo, value):
        x = value(op.inputs[0])
        axes = value.host(op.inputs[1]).ravel()
        keep = bool(op.options.get_bool(0)) if op.options else False
        return reduce("mean", x, tuple(int(a) % x.ndim for a in axes), keep)

    def _op_concat(self, op: OpInfo, value):
        # ConcatenationOptions: axis=0, fused_activation=1
        axis = op.options.get_int(0, 0) if op.options else 0
        y = torch.cat([value(i) for i in op.inputs], dim=axis)
        act = op.options.get_byte(1) if op.options else _ACT_NONE
        return _fused_activation(act, y)

    def _op_strided_slice(self, op: OpInfo, value):
        x = value(op.inputs[0])
        begin = value.host(op.inputs[1]).ravel()
        end = value.host(op.inputs[2]).ravel()
        strides = value.host(op.inputs[3]).ravel()
        o = op.options
        # StridedSliceOptions: begin_mask=0, end_mask=1, ellipsis=2,
        # new_axis=3, shrink_axis=4
        begin_mask = o.get_int(0, 0) if o else 0
        end_mask = o.get_int(1, 0) if o else 0
        shrink = o.get_int(4, 0) if o else 0
        idx: dict[int, slice | int] = {}
        for d in range(min(x.ndim, len(begin))):
            if (shrink >> d) & 1:
                idx[d] = int(begin[d])
                continue
            b = None if (begin_mask >> d) & 1 else int(begin[d])
            e = None if (end_mask >> d) & 1 else int(end[d])
            idx[d] = slice(b, e, int(strides[d]))
        return slice_axes(x, idx)

    def _op_dequantize(self, op: OpInfo, value):
        return value(op.inputs[0]).to(torch.float32)

    def _op_gather(self, op: OpInfo, value):
        x = value(op.inputs[0])
        axis = op.options.get_int(0, 0) if op.options else 0
        return take(x, value(op.inputs[1]), axis)

    def _op_cast(self, op: OpInfo, value):
        return value(op.inputs[0]).to(
            torch_dtype(self.model.tensors[op.outputs[0]].dtype))

    def _op_shape(self, op: OpInfo, value):
        x = value(op.inputs[0])
        out_dtype = self.model.tensors[op.outputs[0]].dtype
        return np.asarray(tuple(x.shape), dtype=out_dtype)

    def _op_expand_dims(self, op: OpInfo, value):
        x = value(op.inputs[0])
        axis = int(value.host(op.inputs[1]).ravel()[0])
        return torch.unsqueeze(x, axis)

    def _op_slice(self, op: OpInfo, value):
        x = value(op.inputs[0])
        begin = value.host(op.inputs[1]).ravel()
        size = value.host(op.inputs[2]).ravel()
        idx = {}
        for d in range(x.ndim):
            b = int(begin[d])
            s = int(size[d])
            idx[d] = slice(b, None if s == -1 else b + s)
        return slice_axes(x, idx)

    def _op_tile(self, op: OpInfo, value):
        x = value(op.inputs[0])
        reps = [int(r) for r in value.host(op.inputs[1]).ravel()]
        return torch.tile(x, reps)

    def _op_pack(self, op: OpInfo, value):
        # PackOptions: values_count=0, axis=1
        axis = op.options.get_int(1, 0) if op.options else 0
        return torch.stack([value(i) for i in op.inputs], dim=axis)

    def _op_unpack(self, op: OpInfo, value):
        x = value(op.inputs[0])
        # UnpackOptions: num=0, axis=1
        axis = op.options.get_int(1, 0) if op.options else 0
        n = op.options.get_int(0, x.shape[axis]) if op.options \
            else x.shape[axis]
        parts = torch.tensor_split(x, n, dim=axis)
        return [torch.squeeze(p, dim=axis) for p in parts]

    def _op_split(self, op: OpInfo, value):
        # SPLIT inputs: [axis, x]; SplitOptions: num_splits=0
        axis = int(value.host(op.inputs[0]).ravel()[0])
        x = value(op.inputs[1])
        n = op.options.get_int(0, len(op.outputs)) if op.options \
            else len(op.outputs)
        return torch.tensor_split(x, n, dim=axis)

    def _op_split_v(self, op: OpInfo, value):
        # SPLIT_V inputs: [x, size_splits, axis]
        x = value(op.inputs[0])
        sizes = [int(s) for s in value.host(op.inputs[1]).ravel()]
        axis = int(value.host(op.inputs[2]).ravel()[0])
        if -1 in sizes:      # one wildcard absorbs the remainder
            rest = x.shape[axis] - sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
        bounds = np.cumsum(sizes)[:-1]
        return torch.tensor_split(x, [int(b) for b in bounds], dim=axis)

    def _op_select(self, op: OpInfo, value):
        cond = value(op.inputs[0])
        return torch.where(cond.to(torch.bool), value(op.inputs[1]),
                           value(op.inputs[2]))

    def _op_fill(self, op: OpInfo, value):
        dims = [int(d) for d in value.host(op.inputs[0]).ravel()]
        return torch.broadcast_to(value(op.inputs[1]), dims)

    def _op_range(self, op: OpInfo, value):
        start, limit, delta = (
            float(value.host(op.inputs[i]).ravel()[0]) for i in range(3))
        out_dtype = self.model.tensors[op.outputs[0]].dtype
        return np.arange(start, limit, delta).astype(out_dtype)

    def _op_broadcast_to(self, op: OpInfo, value):
        shape = [int(s) for s in value.host(op.inputs[1]).ravel()]
        return torch.broadcast_to(value(op.inputs[0]), shape)

    def _op_padv2(self, op: OpInfo, value):
        x = value(op.inputs[0])
        pads = value.host(op.inputs[1])
        cval = value.host(op.inputs[2]).ravel()[0]
        return pad(x, [(a, b) for a, b in pads], float(cval))

    def _op_mirror_pad(self, op: OpInfo, value):
        x = value(op.inputs[0])
        pads = value.host(op.inputs[1])
        # MirrorPadOptions: mode=0 (0=REFLECT excludes the border sample,
        # 1=SYMMETRIC repeats it)
        mode = op.options.get_byte(0) if op.options else 0
        return mirror_pad(x, [(int(a), int(b)) for a, b in pads],
                          symmetric=mode != 0)

    def _op_prelu(self, op: OpInfo, value):
        x = value(op.inputs[0])
        alpha = value(op.inputs[1])
        return torch.where(x >= 0, x, alpha * x)

    def _op_add_n(self, op: OpInfo, value):
        y = value(op.inputs[0])
        for i in op.inputs[1:]:
            y = y + value(i)
        return y

    def _op_gather_nd(self, op: OpInfo, value):
        x = value(op.inputs[0])
        idx = value(op.inputs[1]).to(torch.long)
        # indices' last axis indexes the leading dims of x
        return x[tuple(torch.movedim(idx, -1, 0))]

    def _op_batch_matmul(self, op: OpInfo, value):
        a, b = value(op.inputs[0]), value(op.inputs[1])
        o = op.options
        # BatchMatMulOptions: adj_x=0, adj_y=1
        if o and o.get_bool(0):
            a = a.transpose(-1, -2)
        if o and o.get_bool(1):
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    def _op_cumsum(self, op: OpInfo, value):
        x = value(op.inputs[0])
        axis = int(value.host(op.inputs[1]).ravel()[0])
        o = op.options
        # CumsumOptions: exclusive=0, reverse=1
        exclusive = bool(o.get_bool(0)) if o else False
        reverse = bool(o.get_bool(1)) if o else False
        if reverse:
            x = torch.flip(x, (axis,))
        y = torch.cumsum(x, dim=axis, dtype=x.dtype)
        if exclusive:
            y = y - x
        if reverse:
            y = torch.flip(y, (axis,))
        return y

    def _op_resize(self, method: str):
        def h(op: OpInfo, value):
            x = value(op.inputs[0])                 # NHWC
            hw = [int(v) for v in value.host(op.inputs[1]).ravel()]
            return resize(x, (x.shape[0], hw[0], hw[1], x.shape[3]),
                          linear=method == "bilinear")

        return h

    def _op_rfft2d(self, op: OpInfo, value):
        x = value(op.inputs[0])
        fft_len = [int(v) for v in value.host(op.inputs[1]).ravel()]
        # TFLite RFFT2D: real 2-D FFT over the innermost two dims with
        # the given [h, w] lengths (tf.signal.stft's framing feeds h=1);
        # output is complex64 [..., h, w//2 + 1]
        return torch.fft.rfft2(x.to(torch.float32), s=fft_len,
                               dim=(-2, -1)).to(torch.complex64)


def supported_ops() -> frozenset:
    """Opcodes the compiler handles — the audit surface for
    `verify-artifact --audit` (op-inventory readiness vs the published
    model families)."""
    class _Empty:
        tensors = ()
        ops = ()
        inputs = ()
        outputs = ()

    return frozenset(TFLiteGraph(_Empty())._handlers)


def load_tflite(path_or_bytes) -> TFLiteGraph:
    """Load a .tflite file → TFLiteGraph (constants as CPU buffers; move
    it with ``.to(device)``)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    return TFLiteGraph(parse_tflite(buf))
