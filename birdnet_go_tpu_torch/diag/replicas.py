"""Full-scale synthetic replicas of real model artifacts, written as
genuine .tflite and .onnx bytes with seeded weights, for checks on a
machine that has neither the real files nor a FlatBuffers or ONNX runtime:

- ``v24_tflite(rng, batch)``: BirdNET v2.4's shape as a TFLite graph, raw
  PCM [batch, 144000] in, its mel front end in the graph (a windowed DFT as
  ``CONV_2D`` → power → filterbank → log), the EfficientNet-B0 stage
  schedule with squeeze-excite, 6,522 logits out;
- ``mdata_tflite(rng)``: the MData range filter, float16 weights, 96
  features → 512×512×512 ReLU MLP → 6,522 sigmoid scores;
- ``perch_onnx(rng)``: a Perch v2-scale ONNX graph, mel [B, 1, 160, 128]
  → four Conv+BN+Relu stride-2 stages → global pool → 1,280-dim embedding
  → 14,795 logits.

Each draws its weights from `rng` in the order of the generators in
``tests/test_fullscale_parity.py`` (seeds 424, 77 and 99 there), so at
batch 1 they are the graphs whose outputs ``tests/golden/`` records. The
v2.4 replica takes the batch for its reshape and strided-slice constants
and its tensor shapes: its reshapes fix the batch, as a real export's do.
"""

from __future__ import annotations

import struct

import numpy as np

from birdnet_go_tpu_torch.inference import protowire as pw
from birdnet_go_tpu_torch.inference.tflite_import import Op

CLIP = 144000                                  # 3 s at 48 kHz
N_FFT, HOP, N_MELS = 2048, 512, 96
FRAMES = (CLIP - N_FFT) // HOP + 1             # 278
N_BINS = N_FFT // 2 + 1                        # 1025
NUM_SPECIES = 6522
LOG_OFFSET = 1e-6
PERCH_SPECIES, PERCH_EMB = 14795, 1280
PERCH_MEL = (1, 1, 160, 128)                   # the Perch replica's input

# B0 stage schedule (expand, cout, kernel, stride, repeats)
B0 = ((1, 16, 3, 1, 1), (6, 24, 3, 2, 2), (6, 40, 5, 2, 2),
      (6, 80, 3, 2, 3), (6, 112, 5, 1, 3), (6, 192, 5, 2, 4),
      (6, 320, 3, 1, 1))

_F32, _F16, _I32 = 0, 1, 2                     # TFLite TensorType


def two_tones() -> np.ndarray:
    """The v2.4 replica's probe: 2 kHz at 0.25 plus 5.5 kHz at 0.1, 3 s at
    48 kHz, float32 [144000]."""
    t = np.arange(CLIP) / 48000.0
    return (0.25 * np.sin(2 * np.pi * 2000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 5500.0 * t)).astype(np.float32)


# -- a minimal FlatBuffers writer ---------------------------------------------

class _Vec:
    """A vector of scalars (struct format `fmt`), or raw bytes (fmt None)."""

    def __init__(self, fmt: str | None, values):
        self.fmt, self.values = fmt, values


def _write_flatbuffer(root: dict, ident: bytes) -> bytes:
    """FlatBuffers bytes of the table `root`. A table is a dict field id →
    value: (fmt, scalar) inline, or a str, ``_Vec``, table or list of
    tables, written after the table that points at it (uoffsets point
    forward); each table's vtable precedes it."""
    buf = bytearray(8)
    buf[4:8] = ident

    def align(n: int, shift: int = 0) -> None:
        buf.extend(b"\0" * (-(len(buf) + shift) % n))

    def u32_at(pos: int, value: int) -> None:
        struct.pack_into("<I", buf, pos, value)

    def vector(v) -> int:
        if isinstance(v, str):
            data = v.encode() + b"\0"
            align(4)
            pos = len(buf)
            buf.extend(struct.pack("<I", len(data) - 1) + data)
            return pos
        if v.fmt is None:                      # bytes, data 16-aligned
            align(16, 4)
            pos = len(buf)
            buf.extend(struct.pack("<I", len(v.values)) + v.values)
            return pos
        size = struct.calcsize(v.fmt)
        align(max(size, 4), 4)
        pos = len(buf)
        buf.extend(struct.pack(f"<I{len(v.values)}{v.fmt[-1]}",
                               len(v.values), *v.values))
        return pos

    def table(t: dict) -> int:
        n = max(t, default=-1) + 1
        align(2)
        vt = len(buf)
        buf.extend(b"\0" * (4 + 2 * n))
        align(4)
        pos = len(buf)
        buf.extend(struct.pack("<i", pos - vt))
        slots, later = [0] * n, []
        for fid, v in t.items():
            if isinstance(v, tuple):
                fmt, x = v
                size = struct.calcsize(fmt)
                align(size)
                slots[fid] = len(buf) - pos
                buf.extend(struct.pack(fmt, x))
            else:
                align(4)
                slots[fid] = len(buf) - pos
                later.append((len(buf), v))
                buf.extend(b"\0\0\0\0")
        struct.pack_into(f"<HH{n}H", buf, vt, 4 + 2 * n, len(buf) - pos,
                         *slots)
        for at, v in later:
            if isinstance(v, dict):
                u32_at(at, table(v) - at)
            elif isinstance(v, list):           # vector of tables
                align(4)
                vp = len(buf)
                buf.extend(struct.pack("<I", len(v)) + b"\0" * (4 * len(v)))
                u32_at(at, vp - at)
                for k, sub in enumerate(v):
                    ep = vp + 4 + 4 * k
                    u32_at(ep, table(sub) - ep)
            else:
                u32_at(at, vector(v) - at)
        return pos

    u32_at(0, table(root))
    return bytes(buf)


class _TFLite:
    """Tensors, ops and buffers of one subgraph → .tflite bytes."""

    def __init__(self):
        self.buffers: list[bytes] = [b""]          # buffer 0 = empty
        self.tensors: list[dict] = []
        self.ops: list[dict] = []
        self.opcodes: list[int] = []
        self.inputs: list[int] = []
        self.outputs: list[int] = []

    def tensor(self, shape, name: str, data: np.ndarray | None = None,
               ttype: int = _F32) -> int:
        t = {0: _Vec("i", [int(s) for s in shape]), 1: ("b", ttype),
             3: name}
        if data is not None:
            self.buffers.append(np.ascontiguousarray(data).tobytes())
            t[2] = ("I", len(self.buffers) - 1)
        self.tensors.append(t)
        return len(self.tensors) - 1

    def const(self, name: str, data, dtype=np.float32, ttype=_F32) -> int:
        data = np.asarray(data, dtype)
        return self.tensor(data.shape, name, data, ttype)

    def op(self, code: int, inputs, outputs, options: dict | None = None):
        if code not in self.opcodes:
            self.opcodes.append(code)
        o = {0: ("I", self.opcodes.index(code)),
             1: _Vec("i", list(inputs)), 2: _Vec("i", list(outputs))}
        if options is not None:
            o[4] = options
        self.ops.append(o)

    def finish(self, description: str) -> bytes:
        codes = [{0: ("b", c if c <= 127 else 0), 2: ("i", 1), 3: ("i", c)}
                 for c in self.opcodes]
        subgraph = {0: self.tensors, 1: _Vec("i", self.inputs),
                    2: _Vec("i", self.outputs), 3: self.ops}
        buffers = [{0: _Vec(None, d)} if d else {} for d in self.buffers]
        return _write_flatbuffer(
            {0: ("I", 3), 1: codes, 2: [subgraph], 3: description,
             4: buffers}, b"TFL3")


# TFLite option tables (schema field ids)

def _conv(padding: int, stride_h: int = 1, stride_w: int = 1,
          act: int = 0) -> dict:
    # Conv2DOptions: padding=0, stride_w=1, stride_h=2, activation=3,
    # dilation_w=4, dilation_h=5
    return {0: ("b", padding), 1: ("i", stride_w), 2: ("i", stride_h),
            3: ("b", act), 4: ("i", 1), 5: ("i", 1)}


def _dwconv(stride: int, act: int) -> dict:
    # DepthwiseConv2DOptions: padding=0, stride_w=1, stride_h=2,
    # depth_multiplier=3, activation=4, dilation_w=5, dilation_h=6
    return {0: ("b", 0), 1: ("i", stride), 2: ("i", stride), 3: ("i", 1),
            4: ("b", act), 5: ("i", 1), 6: ("i", 1)}


def _dense(act: int = 0) -> dict:
    return {0: ("b", act)}                     # FullyConnectedOptions


def _mean(keep: bool) -> dict:
    return {0: ("B", int(keep))}               # ReducerOptions


def _dft_kernel() -> np.ndarray:
    """Windowed real-DFT basis as a conv kernel [2*bins, n_fft] f32:
    rows 0..1024 cosine, rows 1025..2049 sine."""
    n = np.arange(N_FFT)
    k = np.arange(N_BINS)[:, None]
    win = np.hanning(N_FFT).astype(np.float64)
    ang = 2.0 * np.pi * k * n / N_FFT
    return np.concatenate([np.cos(ang) * win,
                           -np.sin(ang) * win]).astype(np.float32)


def _mel_fb() -> np.ndarray:
    """[n_mels, n_bins] triangular filterbank (HTK mels, 0 to 15 kHz)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(15000.0), N_MELS + 2)
    bins = np.floor((N_FFT + 1) * mel_to_hz(mels) / 48000.0).astype(int)
    fb = np.zeros((N_MELS, N_BINS), np.float32)
    for m in range(1, N_MELS + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for i in range(lo, c):
            fb[m - 1, i] = (i - lo) / (c - lo)
        for i in range(c, hi):
            fb[m - 1, i] = (hi - i) / (hi - c)
    return fb


def v24_tflite(rng: np.random.Generator, batch: int = 1) -> bytes:
    """The BirdNET v2.4 replica at `batch` (see the module docstring)."""
    mb = _TFLite()

    def wtensor(shape, name, scale=None):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        s = scale if scale is not None else np.sqrt(2.0 / max(fan_in, 1))
        data = (rng.standard_normal(shape) * s).astype(np.float32)
        return mb.tensor(data.shape, name, data)

    def i32(name, values):
        return mb.const(name, values, np.int32, _I32)

    def strided_slice(name, begin, end):
        return [i32(f"{name}_b", begin), i32(f"{name}_e", end),
                i32(f"{name}_s", [1] * len(begin))]

    # tensors are numbered in the order of the test generator's
    x_in = mb.tensor([batch, CLIP], "pcm")
    r1 = i32("rs1", [batch, CLIP, 1, 1])
    t_4d = mb.tensor([batch, CLIP, 1, 1], "pcm4d")
    mb.op(Op.RESHAPE, [x_in, r1], [t_4d])

    # STFT: conv [2050, 2048, 1, 1] stride (512, 1) VALID — the windowed
    # DFT basis as convolution (how graph-embedded front ends express it)
    dft = _dft_kernel().reshape(2 * N_BINS, N_FFT, 1, 1)
    t_dftw = mb.const("dft_w", dft)
    t_dftb = mb.const("dft_b", np.zeros(2 * N_BINS))
    t_stft = mb.tensor([batch, FRAMES, 1, 2 * N_BINS], "stft")
    mb.op(Op.CONV_2D, [t_4d, t_dftw, t_dftb], [t_stft],
          _conv(padding=1, stride_h=HOP))                    # VALID
    t_sq = mb.tensor([batch, FRAMES, 1, 2 * N_BINS], "stft_sq")
    mb.op(Op.MUL, [t_stft, t_stft], [t_sq])
    t_cos = mb.tensor([batch, FRAMES, 1, N_BINS], "pow_cos")
    mb.op(Op.STRIDED_SLICE, [t_sq] + strided_slice(
        "sc", [0, 0, 0, 0], [batch, FRAMES, 1, N_BINS]), [t_cos])
    t_sin = mb.tensor([batch, FRAMES, 1, N_BINS], "pow_sin")
    mb.op(Op.STRIDED_SLICE, [t_sq] + strided_slice(
        "ss", [0, 0, 0, N_BINS], [batch, FRAMES, 1, 2 * N_BINS]), [t_sin])
    t_pow = mb.tensor([batch, FRAMES, 1, N_BINS], "power")
    mb.op(Op.ADD, [t_cos, t_sin], [t_pow])

    # mel projection + log
    r2 = i32("rs2", [batch * FRAMES, N_BINS])
    t_p2 = mb.tensor([batch * FRAMES, N_BINS], "power2d")
    mb.op(Op.RESHAPE, [t_pow, r2], [t_p2])
    t_fbw = mb.const("mel_fb", _mel_fb())
    t_fbb = mb.const("mel_b", np.zeros(N_MELS))
    t_mel = mb.tensor([batch * FRAMES, N_MELS], "mel")
    mb.op(Op.FULLY_CONNECTED, [t_p2, t_fbw, t_fbb], [t_mel], _dense())
    t_off = mb.const("log_off", [LOG_OFFSET])
    t_melo = mb.tensor([batch * FRAMES, N_MELS], "mel_off")
    mb.op(Op.ADD, [t_mel, t_off], [t_melo])
    t_logm = mb.tensor([batch * FRAMES, N_MELS], "logmel")
    mb.op(Op.LOG, [t_melo], [t_logm])
    r3 = i32("rs3", [batch, FRAMES, N_MELS, 1])
    feats = mb.tensor([batch, FRAMES, N_MELS, 1], "features")
    mb.op(Op.RESHAPE, [t_logm, r3], [feats])

    def out_hw(h, w, stride):
        return -(-h // stride), -(-w // stride)     # ceil (SAME)

    # stem 3x3 s2 relu6
    h, w = FRAMES, N_MELS
    t_sw = wtensor((32, 3, 3, 1), "stem_w")
    t_sb = wtensor((32,), "stem_b", scale=0.01)
    h, w = out_hw(h, w, 2)
    cur = mb.tensor([batch, h, w, 32], "stem_out")
    mb.op(Op.CONV_2D, [feats, t_sw, t_sb], [cur],
          _conv(padding=0, stride_h=2, stride_w=2, act=3))
    cin = 32
    bi = 0
    for (expand, cout, kernel, stride, repeats) in B0:
        for r in range(repeats):
            s = stride if r == 0 else 1
            n = f"b{bi}"
            cexp = cin * expand
            x_block = cur
            if expand != 1:
                we = wtensor((cexp, 1, 1, cin), f"{n}_exp_w")
                be = wtensor((cexp,), f"{n}_exp_b", scale=0.01)
                t = mb.tensor([batch, h, w, cexp], f"{n}_exp")
                mb.op(Op.CONV_2D, [cur, we, be], [t],
                      _conv(padding=0, act=3))
                cur = t
            wd = wtensor((1, kernel, kernel, cexp), f"{n}_dw_w")
            bd = wtensor((cexp,), f"{n}_dw_b", scale=0.01)
            h, w = out_hw(h, w, s)
            t = mb.tensor([batch, h, w, cexp], f"{n}_dw")
            mb.op(Op.DEPTHWISE_CONV_2D, [cur, wd, bd], [t], _dwconv(s, 3))
            cur = t
            # SE
            cse = max(1, cexp // 4)
            axes = i32(f"{n}_se_ax", [1, 2])
            t_m = mb.tensor([batch, 1, 1, cexp], f"{n}_se_m")
            mb.op(Op.MEAN, [cur, axes], [t_m], _mean(True))
            wr = wtensor((cse, cexp), f"{n}_se_rw")
            br = wtensor((cse,), f"{n}_se_rb", scale=0.01)
            t_r = mb.tensor([batch, 1, 1, cse], f"{n}_se_r")
            mb.op(Op.FULLY_CONNECTED, [t_m, wr, br], [t_r], _dense(1))
            wx = wtensor((cexp, cse), f"{n}_se_xw")
            bx = wtensor((cexp,), f"{n}_se_xb", scale=0.01)
            t_x = mb.tensor([batch, 1, 1, cexp], f"{n}_se_x")
            mb.op(Op.FULLY_CONNECTED, [t_r, wx, bx], [t_x], _dense())
            t_sg = mb.tensor([batch, 1, 1, cexp], f"{n}_se_s")
            mb.op(Op.LOGISTIC, [t_x], [t_sg])
            t_se = mb.tensor([batch, h, w, cexp], f"{n}_se")
            mb.op(Op.MUL, [cur, t_sg], [t_se])
            cur = t_se
            # project (linear)
            wp = wtensor((cout, 1, 1, cexp), f"{n}_proj_w")
            bp = wtensor((cout,), f"{n}_proj_b", scale=0.01)
            t = mb.tensor([batch, h, w, cout], f"{n}_proj")
            mb.op(Op.CONV_2D, [cur, wp, bp], [t], _conv(padding=0))
            cur = t
            if s == 1 and cin == cout:
                t = mb.tensor([batch, h, w, cout], f"{n}_res")
                mb.op(Op.ADD, [cur, x_block], [t])
                cur = t
            cin = cout
            bi += 1

    # head: 1x1 conv → 1280 relu6 → GAP → FC 6522
    wh = wtensor((1280, 1, 1, cin), "head_w")
    bh = wtensor((1280,), "head_b", scale=0.01)
    t = mb.tensor([batch, h, w, 1280], "head")
    mb.op(Op.CONV_2D, [cur, wh, bh], [t], _conv(padding=0, act=3))
    gax = i32("gap_ax", [1, 2])
    t_g = mb.tensor([batch, 1280], "gap")
    mb.op(Op.MEAN, [t, gax], [t_g], _mean(False))
    wc = wtensor((NUM_SPECIES, 1280), "cls_w", scale=0.02)
    bc = wtensor((NUM_SPECIES,), "cls_b", scale=0.01)
    t_l = mb.tensor([batch, NUM_SPECIES], "logits")
    mb.op(Op.FULLY_CONNECTED, [t_g, wc, bc], [t_l], _dense())
    mb.inputs = [x_in]
    mb.outputs = [t_l]
    return mb.finish(f"BirdNET v2.4 full-scale replica, batch {batch}")


def mdata_tflite(rng: np.random.Generator) -> bytes:
    """The float16 MData range-filter replica (see the module docstring)."""
    mb = _TFLite()
    dims = [96, 512, 512, 512, NUM_SPECIES]

    def wtensor(shape, name):
        data = (rng.standard_normal(shape)
                * np.sqrt(2.0 / shape[-1])).astype(np.float32)
        return mb.tensor(shape, name, data.astype(np.float16), _F16)

    cur = x_in = mb.tensor([1, 96], "features")
    for i in range(len(dims) - 1):
        w = wtensor((dims[i + 1], dims[i]), f"l{i}_w")
        b = wtensor((dims[i + 1],), f"l{i}_b")
        t = mb.tensor([1, dims[i + 1]], f"l{i}_out")
        act = 1 if i < len(dims) - 2 else 0           # RELU / linear
        mb.op(Op.FULLY_CONNECTED, [cur, w, b], [t], _dense(act))
        cur = t
    t_s = mb.tensor([1, NUM_SPECIES], "scores")
    mb.op(Op.LOGISTIC, [cur], [t_s])
    mb.inputs = [x_in]
    mb.outputs = [t_s]
    return mb.finish("MData range filter full-scale replica (float16)")


# -- ONNX ----------------------------------------------------------------------

_ONNX_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.int64): 7}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    out = b"".join(pw.encode_varint_field(1, d) for d in arr.shape)
    out += pw.encode_varint_field(2, _ONNX_DTYPES[arr.dtype])
    out += pw.encode_len_field(8, name.encode())
    return out + pw.encode_len_field(9, np.ascontiguousarray(arr).tobytes())


def _attr_int(name: str, v: int) -> bytes:
    return (pw.encode_len_field(1, name.encode())
            + pw.encode_varint_field(3, v) + pw.encode_varint_field(20, 2))


def _attr_ints(name: str, vals) -> bytes:
    out = pw.encode_len_field(1, name.encode())
    out += b"".join(pw.encode_varint_field(8, v) for v in vals)
    return out + pw.encode_varint_field(20, 7)


def _node(op_type: str, inputs, outputs, attrs=()) -> bytes:
    out = b"".join(pw.encode_len_field(1, i.encode()) for i in inputs)
    out += b"".join(pw.encode_len_field(2, o.encode()) for o in outputs)
    out += pw.encode_len_field(4, op_type.encode())
    return out + b"".join(pw.encode_len_field(5, a) for a in attrs)


def _onnx_model(nodes, initializers, inputs, outputs) -> bytes:
    g = b"".join(pw.encode_len_field(1, n) for n in nodes)
    g += pw.encode_len_field(2, b"testgraph")
    g += b"".join(pw.encode_len_field(5, t) for t in initializers)
    for field, names in ((11, inputs), (12, outputs)):
        g += b"".join(pw.encode_len_field(
            field, pw.encode_len_field(1, n.encode())) for n in names)
    return pw.encode_varint_field(1, 8) + pw.encode_len_field(7, g)


def perch_onnx(rng: np.random.Generator) -> bytes:
    """The Perch v2-scale ONNX replica (see the module docstring)."""
    inits, nodes = [], []

    def t(name, shape, scale=None):
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        s = scale if scale is not None else np.sqrt(2.0 / max(fan, 1))
        return (rng.standard_normal(shape) * s).astype(np.float32)

    chans = [1, 64, 128, 256, 512]
    cur = "mel"
    for i in range(4):
        cin, cout = chans[i], chans[i + 1]
        ws = [(f"c{i}_w", t(f"c{i}_w", (cout, cin, 3, 3))),
              (f"c{i}_b", t(f"c{i}_b", (cout,), 0.01)),
              (f"c{i}_g", t(f"c{i}_g", (cout,), 0.1)),
              (f"c{i}_be", t(f"c{i}_be", (cout,), 0.01)),
              (f"c{i}_m", t(f"c{i}_m", (cout,), 0.01)),
              (f"c{i}_v", t(f"c{i}_v", (cout,), 0.0))]
        ws[-1] = (ws[-1][0], np.abs(ws[-1][1]) + 1.0)   # variance > 0
        inits += [_tensor_proto(n, a) for n, a in ws]
        nodes += [
            _node("Conv", [cur, f"c{i}_w", f"c{i}_b"], [f"conv{i}"],
                  [_attr_ints("strides", [2, 2]),
                   _attr_ints("pads", [1, 1, 1, 1])]),
            _node("BatchNormalization",
                  [f"conv{i}", f"c{i}_g", f"c{i}_be", f"c{i}_m",
                   f"c{i}_v"], [f"bn{i}"]),
            _node("Relu", [f"bn{i}"], [f"act{i}"]),
        ]
        cur = f"act{i}"
    inits += [_tensor_proto("emb_w", t("emb_w", (512, PERCH_EMB), 0.05)),
              _tensor_proto("emb_b", t("emb_b", (PERCH_EMB,), 0.01)),
              _tensor_proto("head_w",
                            t("head_w", (PERCH_EMB, PERCH_SPECIES), 0.02)),
              _tensor_proto("head_b", t("head_b", (PERCH_SPECIES,), 0.01))]
    nodes += [
        _node("GlobalAveragePool", [cur], ["gap"]),
        _node("Flatten", ["gap"], ["flat"], [_attr_int("axis", 1)]),
        _node("Gemm", ["flat", "emb_w", "emb_b"], ["pre_emb"]),
        _node("Relu", ["pre_emb"], ["embedding"]),
        _node("Gemm", ["embedding", "head_w", "head_b"], ["logits"]),
    ]
    return _onnx_model(nodes, inits, inputs=["mel"], outputs=["logits"])
