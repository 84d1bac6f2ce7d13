"""The port's .tflite and .onnx importers against the JAX package's, on the
CPU.

Every graph that ``tests/test_tflite_import.py``,
``tests/test_onnx_import.py`` and ``tests/test_importer_fidelity.py``
build, and a few more (depthwise with a multiplier of 2, both pools at
SAME stride 2 on odd sizes, strided-slice masks and negative strides,
floor semantics, half-to-even rounding, the shape ops), goes through both
importers with the same seeded numpy inputs. Tolerance rtol 1e-5, atol
1e-6, unless a case says why it needs more; integer and boolean outputs
are equal in value (JAX runs without x64, so its integers may be
narrower). The parsers' results are equal field for field, the op tables
and the audit are the same, and an unsupported op raises the same error.
"""

import numpy as np
import pytest
import torch

from birdnet_go_tpu.inference import onnx_import as jonnx
from birdnet_go_tpu.inference import opaudit as jaudit
from birdnet_go_tpu.inference import protowire as pw
from birdnet_go_tpu.inference import tflite_import as jtfl
from birdnet_go_tpu.inference.tflite_import import Op
from birdnet_go_tpu_torch.inference import graph_ops
from birdnet_go_tpu_torch.inference import onnx_import as tonnx
from birdnet_go_tpu_torch.inference import opaudit as taudit
from birdnet_go_tpu_torch.inference import tflite_import as ttfl
from tests import onnx_builder as ob
from tests.test_importer_fidelity import _mbconv_se_flatbuffer
from tests.test_tflite_import import _dense_model
from tests.tflite_builder import (
    ModelBuilder,
    _int_vector,
    conv2d_options,
    dwconv2d_options,
    fully_connected_options,
    pool2d_options,
)

torch.set_num_threads(1)

I32 = ModelBuilder.TTYPE_I32
BOOL, COMPLEX64 = 6, 8
RTOL, ATOL = 1e-5, 1e-6


def _assert_outputs(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _opts(n_slots):
    """Options table of int32 slots (None: slot left out)."""
    def make(b, *vals):
        b.StartObject(n_slots)
        for slot, v in enumerate(vals):
            if v is not None:
                b.PrependInt32Slot(slot, v, 0)
        return b.EndObject()
    return make


def _float_opts(v):
    def make(b):
        b.StartObject(1)
        b.PrependFloat32Slot(0, v, 0.0)
        return b.EndObject()
    return make


def _bool_opts(*vals):
    def make(b):
        b.StartObject(len(vals))
        for slot, v in enumerate(vals):
            b.PrependBoolSlot(slot, v, False)
        return b.EndObject()
    return make


def _byte_opts(*vals):
    def make(b):
        b.StartObject(len(vals))
        for slot, v in enumerate(vals):
            b.PrependInt8Slot(slot, v, 0)
        return b.EndObject()
    return make


def _squeeze_opts(dims):
    def make(b):
        vec = _int_vector(b, dims)
        b.StartObject(1)
        b.PrependUOffsetTRelativeSlot(0, vec, 0)
        return b.EndObject()
    return make


def _i32(mb, name, values):
    values = np.asarray(values, np.int32)
    return mb.add_tensor(list(values.shape), name, values, ttype=I32)


def _finish(mb, inputs, outputs):
    mb.inputs, mb.outputs = inputs, outputs
    return mb.finish()


# -- TFLite graphs ---------------------------------------------------------------

TFLITE = {}


def _tflite_case(name, rtol=RTOL, atol=ATOL):
    def reg(fn):
        TFLITE[name] = (fn, rtol, atol)
        return fn
    return reg


@_tflite_case("dense_relu_logistic")
def _t_dense():
    buf, _, _ = _dense_model()
    return buf, [np.array([[0.5, -1.0, 2.0, 0.1]], np.float32)]


@_tflite_case("conv_same_relu_avgpool_valid")
def _t_conv_pool():
    mb = ModelBuilder()
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    x_t = mb.add_tensor([1, 8, 8, 1], "input")
    w_t = mb.add_tensor([2, 3, 3, 1], "w", w)
    b_t = mb.add_tensor([2], "b", np.array([0.05, -0.05], np.float32))
    c_t = mb.add_tensor([1, 8, 8, 2], "conv_out")
    p_t = mb.add_tensor([1, 4, 4, 2], "pool_out")
    mb.add_op(Op.CONV_2D, [x_t, w_t, b_t], [c_t],
              lambda b: conv2d_options(b, padding=0, activation=1))
    mb.add_op(Op.AVERAGE_POOL_2D, [c_t], [p_t],
              lambda b: pool2d_options(b, padding=1))
    x = rng.standard_normal((1, 8, 8, 1)).astype(np.float32)
    return _finish(mb, [x_t], [p_t]), [x]


@_tflite_case("dilated_conv_same")
def _t_dilated():
    mb = ModelBuilder()
    rng = np.random.default_rng(7)
    w = rng.standard_normal((3, 3, 3, 2)).astype(np.float32)
    x_t = mb.add_tensor([1, 12, 10, 2], "input")
    w_t = mb.add_tensor([3, 3, 3, 2], "w", w)
    y_t = mb.add_tensor([1, 12, 10, 3], "out")
    mb.add_op(Op.CONV_2D, [x_t, w_t, -1], [y_t],
              lambda b: conv2d_options(b, padding=0, dilation_w=2,
                                       dilation_h=3))
    x = rng.standard_normal((1, 12, 10, 2)).astype(np.float32)
    return _finish(mb, [x_t], [y_t]), [x]


@_tflite_case("depthwise_mul")
def _t_depthwise():
    mb = ModelBuilder()
    rng = np.random.default_rng(2)
    w = rng.standard_normal((1, 3, 3, 2)).astype(np.float32)
    x_t = mb.add_tensor([1, 6, 6, 2], "input")
    w_t = mb.add_tensor([1, 3, 3, 2], "w", w)
    d_t = mb.add_tensor([1, 6, 6, 2], "dw_out")
    y_t = mb.add_tensor([1, 6, 6, 2], "out")
    mb.add_op(Op.DEPTHWISE_CONV_2D, [x_t, w_t, -1], [d_t],
              lambda b: conv2d_options(b, padding=0))
    mb.add_op(Op.MUL, [d_t, d_t], [y_t])
    x = rng.standard_normal((1, 6, 6, 2)).astype(np.float32)
    return _finish(mb, [x_t], [y_t]), [x]


@_tflite_case("depthwise_multiplier2_same_stride2")
def _t_depthwise_m2():
    """C = 3, M = 2: output channel c·M + m reads input channel c; 7×9 at
    stride 2 pads SAME asymmetrically."""
    mb = ModelBuilder()
    rng = np.random.default_rng(21)
    w = rng.standard_normal((1, 3, 3, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    x_t = mb.add_tensor([2, 7, 9, 3], "input")
    w_t = mb.add_tensor([1, 3, 3, 6], "w", w)
    b_t = mb.add_tensor([6], "b", bias)
    y_t = mb.add_tensor([2, 4, 5, 6], "out")
    mb.add_op(Op.DEPTHWISE_CONV_2D, [x_t, w_t, b_t], [y_t],
              lambda b: dwconv2d_options(b, padding=0, stride_w=2,
                                         stride_h=2, depth_multiplier=2,
                                         activation=3))
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32) * 2
    return _finish(mb, [x_t], [y_t]), [x]


def _pool_same_stride2(code):
    mb = ModelBuilder()
    rng = np.random.default_rng(22)
    x_t = mb.add_tensor([2, 7, 9, 3], "input")
    y_t = mb.add_tensor([2, 4, 5, 3], "out")
    mb.add_op(code, [x_t], [y_t],
              lambda b: pool2d_options(b, padding=0, fw=3, fh=3))
    # all negative: a pad counted as 0 would win the max, or pull the mean
    x = -np.abs(rng.standard_normal((2, 7, 9, 3))).astype(np.float32) - 1
    return _finish(mb, [x_t], [y_t]), [x]


@_tflite_case("avgpool_same_stride2_counts_valid")
def _t_avgpool_same():
    return _pool_same_stride2(Op.AVERAGE_POOL_2D)


@_tflite_case("maxpool_same_stride2")
def _t_maxpool_same():
    return _pool_same_stride2(Op.MAX_POOL_2D)


@_tflite_case("fp16_weights_dense")
def _t_fp16():
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 2], "input")
    w_t = mb.add_tensor([1, 2], "w16", np.array([[0.5, -1.5]], np.float16),
                        ttype=ModelBuilder.TTYPE_F16)
    y_t = mb.add_tensor([1, 1], "out")
    mb.add_op(Op.FULLY_CONNECTED, [x_t, w_t, -1], [y_t],
              lambda b: fully_connected_options(b))
    return _finish(mb, [x_t], [y_t]), [np.array([[2.0, 1.0]], np.float32)]


@_tflite_case("mean_softmax")
def _t_mean_softmax():
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 4, 4, 3], "input")
    a_t = _i32(mb, "axes", [1, 2])
    m_t = mb.add_tensor([1, 3], "mean_out")
    s_t = mb.add_tensor([1, 3], "softmax_out")
    mb.add_op(Op.MEAN, [x_t, a_t], [m_t])
    mb.add_op(Op.SOFTMAX, [m_t], [s_t], _float_opts(1.5))
    x = np.random.default_rng(3).standard_normal((1, 4, 4, 3))
    return _finish(mb, [x_t], [s_t]), [x.astype(np.float32)]


# the float32 power spectrum of a 256- and a 2048-point rFFT: pocketfft
# (JAX) and torch's FFT sum in another order; |X|² up to ~1e3 there
@_tflite_case("stft_frontend_rfft2d_batch_matmul", rtol=1e-4, atol=1e-3)
def _t_stft():
    rng = np.random.default_rng(3)
    pcm = rng.standard_normal((1, 512)).astype(np.float32)
    fb = rng.random((129, 8)).astype(np.float32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 512], "pcm")
    beg0, end0 = _i32(mb, "b0", [0, 0]), _i32(mb, "e0", [1, 256])
    beg1, end1 = _i32(mb, "b1", [0, 256]), _i32(mb, "e1", [1, 512])
    strd = _i32(mb, "s", [1, 1])
    f0 = mb.add_tensor([1, 256], "f0")
    f1 = mb.add_tensor([1, 256], "f1")
    mb.add_op(Op.STRIDED_SLICE, [x_t, beg0, end0, strd], [f0])
    mb.add_op(Op.STRIDED_SLICE, [x_t, beg1, end1, strd], [f1])
    frames = mb.add_tensor([1, 2, 256], "frames")
    mb.add_op(Op.PACK, [f0, f1], [frames], lambda b: _opts(2)(b, 2, 1))
    fr4 = mb.add_tensor([1, 2, 1, 256], "frames4")
    mb.add_op(Op.EXPAND_DIMS, [frames, _i32(mb, "ax", [2])], [fr4])
    spec_c = mb.add_tensor([1, 2, 1, 129], "spec_c", ttype=COMPLEX64)
    mb.add_op(Op.RFFT2D, [fr4, _i32(mb, "flen", [1, 256])], [spec_c])
    mag = mb.add_tensor([1, 2, 1, 129], "mag")
    mb.add_op(Op.COMPLEX_ABS, [spec_c], [mag])
    pw = mb.add_tensor([1, 2, 1, 129], "power")
    mb.add_op(Op.SQUARE, [mag], [pw])
    pw3 = mb.add_tensor([1, 2, 129], "power3")
    mb.add_op(Op.RESHAPE, [pw, _i32(mb, "shp", [1, 2, 129])], [pw3])
    fb_t = mb.add_tensor([129, 8], "fb", fb)
    mel = mb.add_tensor([1, 2, 8], "mel")
    mb.add_op(Op.BATCH_MATMUL, [pw3, fb_t], [mel])
    return _finish(mb, [x_t], [mel]), [pcm]


@_tflite_case("slice_tile_greater_select")
def _t_select():
    x = np.random.default_rng(4).standard_normal((2, 6)).astype(np.float32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([2, 6], "x")
    sl = mb.add_tensor([2, 3], "sl")
    mb.add_op(Op.SLICE, [x_t, _i32(mb, "beg", [0, 1]),
                         _i32(mb, "size", [2, 3])], [sl])
    tl = mb.add_tensor([2, 6], "tl")
    mb.add_op(Op.TILE, [sl, _i32(mb, "reps", [1, 2])], [tl])
    zero = mb.add_tensor([1], "zero", np.zeros(1, np.float32))
    gt = mb.add_tensor([2, 6], "gt", ttype=BOOL)
    mb.add_op(Op.GREATER, [tl, zero], [gt])
    neg = mb.add_tensor([2, 6], "neg")
    mb.add_op(Op.NEG, [tl], [neg])
    out = mb.add_tensor([2, 6], "out")
    mb.add_op(Op.SELECT_V2, [gt, tl, neg], [out])
    return _finish(mb, [x_t], [out, gt]), [x]


@_tflite_case("split_v_reduce_argmax")
def _t_split_v():
    x = np.random.default_rng(5).standard_normal((2, 10)).astype(np.float32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([2, 10], "x")
    a_t = mb.add_tensor([2, 3], "a")
    b_t = mb.add_tensor([2, 7], "b")
    mb.add_op(Op.SPLIT_V, [x_t, _i32(mb, "sizes", [3, -1]),
                           _i32(mb, "axis", [1])], [a_t, b_t])
    red_ax = _i32(mb, "rax", [1])
    mx = mb.add_tensor([2], "mx")
    mb.add_op(Op.REDUCE_MAX, [b_t, red_ax], [mx])
    mn = mb.add_tensor([2], "mn")
    mb.add_op(Op.REDUCE_MIN, [b_t, red_ax], [mn])
    pr = mb.add_tensor([2], "pr")
    mb.add_op(Op.REDUCE_PROD, [a_t, red_ax], [pr])
    sm = mb.add_tensor([2, 1], "sm")
    mb.add_op(Op.SUM, [a_t, red_ax], [sm], _bool_opts(True))
    am = mb.add_tensor([2], "am", ttype=I32)
    mb.add_op(Op.ARG_MAX, [x_t, _i32(mb, "amax", [1])], [am])
    an = mb.add_tensor([2], "an", ttype=I32)
    mb.add_op(Op.ARG_MIN, [x_t, _i32(mb, "amin", [1])], [an])
    return _finish(mb, [x_t], [mx, mn, pr, sm, am, an]), [x]


@_tflite_case("cast_mirror_pad_cumsum")
def _t_cast_pad_cumsum():
    x = np.arange(12, dtype=np.int32).reshape(1, 3, 4)
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 3, 4], "x", ttype=I32)
    xf = mb.add_tensor([1, 3, 4], "xf")
    mb.add_op(Op.CAST, [x_t], [xf])
    pads = _i32(mb, "pads", [[0, 0], [1, 1], [0, 0]])
    pd = mb.add_tensor([1, 5, 4], "pd")
    mb.add_op(Op.MIRROR_PAD, [xf, pads], [pd], lambda b: _opts(1)(b, None))
    sym = mb.add_tensor([1, 7, 6], "sym")
    mb.add_op(Op.MIRROR_PAD,
              [xf, _i32(mb, "pads2", [[0, 0], [2, 2], [1, 1]])], [sym],
              _byte_opts(1))                              # SYMMETRIC
    cax = _i32(mb, "cax", [2])
    cs = mb.add_tensor([1, 5, 4], "cs")
    mb.add_op(Op.CUMSUM, [pd, cax], [cs])
    rev = mb.add_tensor([1, 5, 4], "rev")
    mb.add_op(Op.CUMSUM, [pd, cax], [rev], _bool_opts(True, True))
    return _finish(mb, [x_t], [cs, rev, sym]), [x]


@_tflite_case("resize_nearest")
def _t_resize_nearest():
    x = np.arange(8, dtype=np.float32).reshape(1, 2, 2, 2)
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 2, 2, 2], "x")
    out = mb.add_tensor([1, 4, 4, 2], "out")
    mb.add_op(Op.RESIZE_NEAREST_NEIGHBOR, [x_t, _i32(mb, "hw", [4, 4])],
              [out])
    return _finish(mb, [x_t], [out]), [x]


@_tflite_case("resize_bilinear_shrink_and_grow")
def _t_resize_bilinear():
    """RESIZE_BILINEAR as ``jax.image.resize``: the height shrinks
    (antialiased), the width grows."""
    x = np.random.default_rng(31).standard_normal((2, 6, 9, 3)).astype(
        np.float32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([2, 6, 9, 3], "x")
    out = mb.add_tensor([2, 4, 13, 3], "out")
    mb.add_op(Op.RESIZE_BILINEAR, [x_t, _i32(mb, "hw", [4, 13])], [out])
    return _finish(mb, [x_t], [out]), [x]


# 2048-point rFFT power (values to ~1e5) through a 64-band product
@_tflite_case("stft_gather_framing_mid_scale", rtol=1e-4, atol=1e-2)
def _t_gather_stft():
    rng = np.random.default_rng(9)
    sr, n_fft, hop = 48000, 2048, 1024
    frames = (sr - n_fft) // hop + 1
    pcm = rng.standard_normal((1, sr)).astype(np.float32)
    fb = rng.random((n_fft // 2 + 1, 64)).astype(np.float32)
    idx = (np.arange(frames)[:, None] * hop
           + np.arange(n_fft)[None, :]).astype(np.int32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, sr], "pcm")
    idx_t = mb.add_tensor([frames, n_fft], "frame_idx", idx, ttype=I32)
    fr = mb.add_tensor([1, frames, n_fft], "frames")
    mb.add_op(Op.GATHER, [x_t, idx_t], [fr], lambda b: _opts(1)(b, 1))
    fr4 = mb.add_tensor([1, frames, 1, n_fft], "frames4")
    mb.add_op(Op.EXPAND_DIMS, [fr, _i32(mb, "ax", [2])], [fr4])
    spec = mb.add_tensor([1, frames, 1, n_fft // 2 + 1], "spec",
                         ttype=COMPLEX64)
    mb.add_op(Op.RFFT2D, [fr4, _i32(mb, "flen", [1, n_fft])], [spec])
    mag = mb.add_tensor([1, frames, 1, n_fft // 2 + 1], "mag")
    mb.add_op(Op.COMPLEX_ABS, [spec], [mag])
    pw = mb.add_tensor([1, frames, 1, n_fft // 2 + 1], "pw")
    mb.add_op(Op.SQUARE, [mag], [pw])
    pw3 = mb.add_tensor([1, frames, n_fft // 2 + 1], "pw3")
    mb.add_op(Op.RESHAPE,
              [pw, _i32(mb, "shp", [1, frames, n_fft // 2 + 1])], [pw3])
    fb_t = mb.add_tensor(list(fb.shape), "fb", fb)
    mel = mb.add_tensor([1, frames, 64], "mel")
    mb.add_op(Op.BATCH_MATMUL, [pw3, fb_t], [mel])
    return _finish(mb, [x_t], [mel]), [pcm]


@_tflite_case("mbconv_se_topology")
def _t_mbconv():
    rng = np.random.default_rng(11)
    buf, _ = _mbconv_se_flatbuffer(rng)
    return buf, [rng.standard_normal((1, 16, 16, 3)).astype(np.float32)]


@_tflite_case("mbconv_se_topology_fp16")
def _t_mbconv_fp16():
    rng = np.random.default_rng(12)
    buf, _ = _mbconv_se_flatbuffer(rng, fp16=True)
    return buf, [rng.standard_normal((1, 16, 16, 3)).astype(np.float32)]


@_tflite_case("int8_per_channel_dequantized")
def _t_int8():
    rng = np.random.default_rng(5)
    cin, cout = 8, 6
    w_f = rng.standard_normal((cout, cin)).astype(np.float32)
    scale = np.maximum(np.abs(w_f).max(axis=1), 1e-6) / 127.0
    w_q = np.clip(np.round(w_f / scale[:, None]), -127, 127).astype(np.int8)
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, cin], "x")
    w_t = mb.add_tensor([cout, cin], "w", w_q, ttype=ModelBuilder.TTYPE_I8,
                        quant=(list(scale), [0] * cout, 0))
    b_q = np.round(rng.standard_normal(cout) / scale.mean()).astype(np.int32)
    b_t = mb.add_tensor([cout], "b", b_q, ttype=I32,
                        quant=([float(scale.mean())], [0], 0))
    q_t = mb.add_tensor([1, cout], "q")
    mb.add_op(Op.FULLY_CONNECTED, [x_t, w_t, b_t], [q_t],
              lambda b: fully_connected_options(b))
    y_t = mb.add_tensor([1, cout], "y")
    mb.add_op(Op.QUANTIZE, [q_t], [y_t])
    x = rng.standard_normal((1, cin)).astype(np.float32)
    return _finish(mb, [x_t], [y_t]), [x]


# a 144,000-term dot product per logit: float32 sums in another order
@_tflite_case("pcm_dense_head", rtol=1e-4, atol=1e-4)
def _t_pcm_head():
    rng = np.random.default_rng(14)
    w = (rng.standard_normal((6, 144000)) * 1e-4).astype(np.float32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 144000], "pcm")
    w_t = mb.add_tensor([6, 144000], "w", w)
    b_t = mb.add_tensor([6], "b", np.array([2.0, -2, -2, -2, -2, -2],
                                           np.float32))
    y_t = mb.add_tensor([1, 6], "logits")
    mb.add_op(Op.FULLY_CONNECTED, [x_t, w_t, b_t], [y_t],
              lambda b: fully_connected_options(b))
    t = np.arange(144000) / 48000.0
    pcm = (0.3 * np.sin(2 * np.pi * 2000 * t)).astype(np.float32)[None]
    return _finish(mb, [x_t], [y_t]), [pcm]


@_tflite_case("strided_slice_masks_negative_strides")
def _t_strided_slice():
    """begin and end masks, a shrink axis and negative strides, which torch
    indexing does not take."""
    x = np.random.default_rng(23).standard_normal((3, 8, 5)).astype(
        np.float32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([3, 8, 5], "x")
    outs = []
    # x[::-1, 6:1:-2, 1:] with begin_mask on dim 0 and end_mask on dim 2
    a = mb.add_tensor([3, 3, 4], "a")
    mb.add_op(Op.STRIDED_SLICE,
              [x_t, _i32(mb, "ab", [9, 6, 1]), _i32(mb, "ae", [0, 1, 0]),
               _i32(mb, "as", [-1, -2, 1])], [a],
              lambda b: _opts(5)(b, 1, 4, None, None, None))
    outs.append(a)
    # x[1, -2:, ::-3] with shrink on dim 0
    c = mb.add_tensor([2, 2], "c")
    mb.add_op(Op.STRIDED_SLICE,
              [x_t, _i32(mb, "cb", [1, -2, 4]), _i32(mb, "ce", [2, 8, 0]),
               _i32(mb, "cs", [1, 1, -3])], [c],
              lambda b: _opts(5)(b, 4, 4, None, None, 1))
    outs.append(c)
    return _finish(mb, [x_t], outs), [x]


@_tflite_case("floor_mod_div_round_half_even")
def _t_floor_ops():
    a = np.array([[-7.5, -2.5, -0.5, 0.5, 1.5, 2.5, 7.0, -7.0]], np.float32)
    b = np.array([[2.0, -3.0, 2.0, -2.0, 3.0, 2.0, -3.0, 3.0]], np.float32)
    ai = np.array([[-7, 7, -8, 9, -1, 0, 5, -5]], np.int32)
    mb = ModelBuilder()
    a_t, b_t = mb.add_tensor([1, 8], "a"), mb.add_tensor([1, 8], "b")
    ai_t = mb.add_tensor([1, 8], "ai", ttype=I32)
    bi_t = _i32(mb, "bi", [[3, -3, 3, -4, 2, 3, -2, 2]])
    outs = []
    for code, ins, tt in ((Op.FLOOR_MOD, [a_t, b_t], 0),
                          (Op.FLOOR_DIV, [a_t, b_t], 0),
                          (Op.FLOOR_MOD, [ai_t, bi_t], I32),
                          (Op.FLOOR_DIV, [ai_t, bi_t], I32),
                          (Op.ROUND, [a_t], 0), (Op.FLOOR, [a_t], 0),
                          (Op.CEIL, [a_t], 0)):
        t = mb.add_tensor([1, 8], f"o{len(outs)}", ttype=tt)
        mb.add_op(code, ins, [t])
        outs.append(t)
    return _finish(mb, [a_t, b_t, ai_t], outs), [a, b, ai]


@_tflite_case("elementwise_battery")
def _t_elementwise():
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    y = rng.standard_normal((2, 3, 4)).astype(np.float32)
    alpha = rng.random(4).astype(np.float32)
    mb = ModelBuilder()
    x_t, y_t = mb.add_tensor([2, 3, 4], "x"), mb.add_tensor([2, 3, 4], "y")
    al = mb.add_tensor([4], "alpha", alpha)
    outs = []

    def op(code, ins, shape, opts=None):
        t = mb.add_tensor(shape, f"o{len(outs)}")
        mb.add_op(code, ins, [t], opts)
        outs.append(t)
        return t

    s = [2, 3, 4]
    op(Op.LEAKY_RELU, [x_t], s, _float_opts(0.2))
    op(Op.HARD_SWISH, [x_t], s)
    op(Op.PRELU, [x_t, al], s)
    op(Op.ADD_N, [x_t, y_t, x_t], s)
    op(Op.SQUARED_DIFFERENCE, [x_t, y_t], s)
    op(Op.MAXIMUM, [x_t, y_t], s)
    op(Op.MINIMUM, [x_t, y_t], s)
    op(Op.DIV, [x_t, y_t], s, _byte_opts(1))             # fused RELU
    op(Op.SUB, [x_t, y_t], s, _byte_opts(2))             # RELU_N1_TO_1
    op(Op.ADD, [x_t, y_t], s, _byte_opts(4))             # TANH
    ax = mb.add_tensor([2, 3, 4], "ax")
    mb.add_op(Op.ABS, [x_t], [ax])
    op(Op.POW, [ax, y_t], s)
    op(Op.RSQRT, [ax], s)
    op(Op.SQRT, [ax], s)
    op(Op.LOG, [ax], s)
    op(Op.EXP, [x_t], s)
    op(Op.TANH, [x_t], s)
    op(Op.RELU6, [x_t], s)
    op(Op.RELU, [x_t], s)
    op(Op.ELU, [x_t], s)
    op(Op.SIN, [x_t], s)
    op(Op.COS, [x_t], s)
    op(Op.L2_NORMALIZATION, [x_t], s)
    op(Op.LOG_SOFTMAX, [x_t], s)
    op(Op.TRANSPOSE, [x_t, _i32(mb, "perm", [2, 0, 1])], [4, 2, 3])
    op(Op.PAD, [x_t, _i32(mb, "pads", [[0, 1], [2, 0], [1, 1]])], [3, 5, 6])
    op(Op.PADV2, [x_t, _i32(mb, "pads2", [[1, 0], [0, 0], [0, 2]]),
                  mb.add_tensor([1], "cval", np.array([-3.5], np.float32))],
       [3, 3, 6])
    op(Op.CONCATENATION, [x_t, y_t], [2, 3, 8],
       lambda b: _opts(1)(b, -1))
    sq = op(Op.EXPAND_DIMS, [x_t, _i32(mb, "ed", [-1])], [2, 3, 4, 1])
    op(Op.SQUEEZE, [sq], s, _squeeze_opts([3]))
    op(Op.DEQUANTIZE, [x_t], s)
    return _finish(mb, [x_t, y_t], outs), [x, y]


@_tflite_case("shape_ops_battery")
def _t_shape_ops():
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    img = rng.standard_normal((1, 3, 4, 2)).astype(np.float32)
    mb = ModelBuilder()
    x_t = mb.add_tensor([2, 3, 4], "x")
    img_t = mb.add_tensor([1, 3, 4, 2], "img")
    outs = []

    def op(code, ins, shape, opts=None, tt=0, n_out=1):
        ts = [mb.add_tensor(shape, f"o{len(outs)}_{k}", ttype=tt)
              for k in range(n_out)]
        mb.add_op(code, ins, ts, opts)
        outs.extend(ts)
        return ts[0]

    op(Op.SHAPE, [x_t], [3], tt=I32)
    op(Op.FILL, [_i32(mb, "dims", [2, 2]),
                 mb.add_tensor([1], "fv", np.array([1.25], np.float32))],
       [2, 2])
    op(Op.RANGE, [_i32(mb, "r0", [1]), _i32(mb, "r1", [10]),
                  _i32(mb, "r2", [3])], [3], tt=I32)
    op(Op.BROADCAST_TO, [x_t, _i32(mb, "bshape", [2, 2, 3, 4])],
       [2, 2, 3, 4])
    op(Op.GATHER_ND, [x_t, _i32(mb, "gnd", [[1, 2], [0, 0], [1, -1]])],
       [3, 4])
    op(Op.GATHER, [x_t, _i32(mb, "gi", [[2, 0], [-1, 1]])], [2, 2, 2, 4],
       lambda b: _opts(1)(b, 1))
    op(Op.SPLIT, [_i32(mb, "sax", [2]), x_t], [2, 3, 2],
       lambda b: _opts(1)(b, 2), n_out=2)
    op(Op.UNPACK, [x_t], [2, 4], lambda b: _opts(2)(b, 3, 1), n_out=3)
    op(Op.PACK, [x_t, x_t], [2, 3, 2, 4], lambda b: _opts(2)(b, 2, 2))
    op(Op.ZEROS_LIKE, [x_t], [2, 3, 4])
    op(Op.RESIZE_BILINEAR, [img_t, _i32(mb, "hw", [6, 8])], [1, 6, 8, 2])
    op(Op.RESIZE_NEAREST_NEIGHBOR, [img_t, _i32(mb, "hw2", [5, 7])],
       [1, 5, 7, 2])
    eq = op(Op.EQUAL, [x_t, x_t], [2, 3, 4], tt=BOOL)
    ne = op(Op.NOT_EQUAL, [x_t, x_t], [2, 3, 4], tt=BOOL)
    op(Op.LOGICAL_OR, [eq, ne], [2, 3, 4], tt=BOOL)
    op(Op.LOGICAL_AND, [eq, ne], [2, 3, 4], tt=BOOL)
    op(Op.LOGICAL_NOT, [eq], [2, 3, 4], tt=BOOL)
    op(Op.LESS_EQUAL, [x_t, mb.add_tensor([1], "z", np.zeros(1, np.float32))],
       [2, 3, 4], tt=BOOL)
    return _finish(mb, [x_t, img_t], outs), [x, img]


@pytest.mark.parametrize("case", sorted(TFLITE))
def test_tflite_graph_equals_jax(case):
    fn, rtol, atol = TFLITE[case]
    buf, inputs = fn()
    jg = jtfl.load_tflite(buf)
    want = jg.jitted()(jg.params, *inputs)
    got = ttfl.load_tflite(buf)(*inputs)
    _assert_outputs(got, want, rtol, atol)


def _tflite_parse_equal(buf):
    a, b = jtfl.parse_tflite(buf), ttfl.parse_tflite(buf)
    assert (a.inputs, a.outputs, a.description) == \
        (b.inputs, b.outputs, b.description)
    assert len(a.tensors) == len(b.tensors)
    for x, y in zip(a.tensors, b.tensors):
        assert (x.index, x.name, x.shape, x.dtype, x.buffer_index) == \
            (y.index, y.name, y.shape, y.dtype, y.buffer_index)
        assert (x.data is None) == (y.data is None)
        if x.data is not None:
            assert x.data.dtype == y.data.dtype
            np.testing.assert_array_equal(x.data, y.data)
    assert len(a.ops) == len(b.ops)
    for x, y in zip(a.ops, b.ops):
        assert (x.opcode, x.inputs, x.outputs, x.custom_code) == \
            (y.opcode, y.inputs, y.outputs, y.custom_code)
        assert (x.options is None) == (y.options is None)
        if x.options is not None:
            assert (x.options.buf, x.options.pos) == \
                (y.options.buf, y.options.pos)
    return b


@pytest.mark.parametrize("case", sorted(TFLITE))
def test_tflite_parse_equals_jax(case):
    buf, _ = TFLITE[case][0]()
    m = _tflite_parse_equal(buf)
    g = ttfl.TFLiteGraph(m)
    # every constant a buffer t{index}; float16 weights now float32
    names = {f"t{t.index}" for t in m.tensors if t.data is not None}
    assert set(dict(g.named_buffers())) == names
    for t in m.tensors:
        if t.data is not None:
            buf_t = getattr(g, f"t{t.index}")
            want = t.data.astype(np.float32) \
                if t.data.dtype == np.float16 else t.data
            assert buf_t.dtype == graph_ops.torch_dtype(want.dtype)
            np.testing.assert_array_equal(buf_t.numpy(), want)


# -- ONNX graphs -----------------------------------------------------------------

ONNX = {}


def _onnx_case(name, rtol=RTOL, atol=ATOL):
    def reg(fn):
        ONNX[name] = (fn, rtol, atol)
        return fn
    return reg


def _attr_str(name, v):
    return (pw.encode_len_field(1, name.encode())
            + pw.encode_len_field(4, v.encode())
            + pw.encode_varint_field(20, 3))


def _inits(**arrays):
    return [ob.tensor_proto(n, a) for n, a in arrays.items()]


@_onnx_case("mlp_matmul_gemm_sigmoid")
def _o_mlp():
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((4, 8)).astype(np.float32)
    b1 = rng.standard_normal(8).astype(np.float32)
    w2 = rng.standard_normal((8, 3)).astype(np.float32)
    nodes = [ob.node("MatMul", ["x", "w1"], ["h0"]),
             ob.node("Add", ["h0", "b1"], ["h1"]),
             ob.node("Relu", ["h1"], ["h2"]),
             ob.node("Gemm", ["h2", "w2"], ["h3"],
                     [ob.attr_float("alpha", 1.0)]),
             ob.node("Sigmoid", ["h3"], ["y"])]
    buf = ob.model(nodes, _inits(w1=w1, b1=b1, w2=w2), ["x"], ["y"])
    return buf, [np.array([[1.0, -0.5, 0.25, 2.0]], np.float32)]


@_onnx_case("conv_bn_relu_gap_flatten")
def _o_conv_bn():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    mean = rng.standard_normal(4).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    nodes = [
        ob.node("Conv", ["x", "w"], ["c"],
                [ob.attr_ints("pads", [1, 1, 1, 1]),
                 ob.attr_ints("strides", [1, 1]),
                 ob.attr_ints("kernel_shape", [3, 3])]),
        ob.node("BatchNormalization", ["c", "scale", "bias", "mean", "var"],
                ["bn"], [ob.attr_float("epsilon", 1e-5)]),
        ob.node("Relu", ["bn"], ["r"]),
        ob.node("GlobalAveragePool", ["r"], ["g"]),
        ob.node("Flatten", ["g"], ["y"], [ob.attr_int("axis", 1)]),
    ]
    buf = ob.model(nodes, _inits(w=w, scale=scale, bias=bias, mean=mean,
                                 var=var), ["x"], ["y"])
    return buf, [rng.standard_normal((2, 2, 6, 6)).astype(np.float32)]


@_onnx_case("grouped_conv_maxpool")
def _o_grouped():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 1, 3, 3)).astype(np.float32)
    nodes = [
        ob.node("Conv", ["x", "w"], ["c"],
                [ob.attr_ints("pads", [1, 1, 1, 1]), ob.attr_int("group", 4),
                 ob.attr_ints("kernel_shape", [3, 3])]),
        ob.node("MaxPool", ["c"], ["y"],
                [ob.attr_ints("kernel_shape", [2, 2]),
                 ob.attr_ints("strides", [2, 2])]),
    ]
    buf = ob.model(nodes, _inits(w=w), ["x"], ["y"])
    return buf, [rng.standard_normal((1, 4, 4, 4)).astype(np.float32)]


@_onnx_case("slice_transpose_concat")
def _o_slice():
    nodes = [
        ob.node("Transpose", ["x"], ["t"], [ob.attr_ints("perm", [1, 0])]),
        ob.node("Slice", ["t", "starts", "ends", "axes"], ["s"]),
        ob.node("Concat", ["s", "s"], ["y"], [ob.attr_int("axis", 0)]),
    ]
    buf = ob.model(nodes, _inits(starts=np.array([0], np.int64),
                                 ends=np.array([2], np.int64),
                                 axes=np.array([0], np.int64)), ["x"], ["y"])
    return buf, [np.arange(12, dtype=np.float32).reshape(3, 4)]


@_onnx_case("fp16_initializer_upcast")
def _o_fp16():
    w = np.array([[1.5], [-2.5]], np.float16)
    buf = ob.model([ob.node("MatMul", ["x", "w"], ["y"])], _inits(w=w),
                   ["x"], ["y"])
    return buf, [np.array([[2.0, 1.0]], np.float32)]


@_onnx_case("transformer_layernorm_split_where_expand_reduce",
            rtol=2e-5, atol=2e-5)   # the JAX test's own: var and rsqrt
def _o_transformer():
    x = np.random.default_rng(0).standard_normal((2, 6)).astype(np.float32)
    nodes = [
        ob.node("LayerNormalization", ["x", "scale", "bias"], ["ln"],
                [ob.attr_float("epsilon", 1e-5), ob.attr_int("axis", -1)]),
        ob.node("Split", ["ln", "sizes"], ["a", "b"], [ob.attr_int("axis", 1)]),
        ob.node("ReduceSum", ["b"], ["bsum"],
                [ob.attr_ints("axes", [1]), ob.attr_int("keepdims", 1)]),
        ob.node("Greater", ["a", "bsum"], ["mask"]),
        ob.node("Where", ["mask", "a", "bsum"], ["sel"]),
        ob.node("Expand", ["sel", "shape3"], ["exp"]),
        ob.node("ReduceMax", ["exp"], ["out"],
                [ob.attr_ints("axes", [0]), ob.attr_int("keepdims", 0)]),
    ]
    buf = ob.model(nodes, _inits(scale=np.full((6,), 2.0, np.float32),
                                 bias=np.full((6,), 0.5, np.float32),
                                 sizes=np.asarray([2, 4], np.int64),
                                 shape3=np.asarray([3, 2, 2], np.int64)),
                   ["x"], ["out", "mask"])
    return buf, [x]


@_onnx_case("qdq_per_axis_gemm")
def _o_qdq():
    rng = np.random.default_rng(11)
    w_f = rng.standard_normal((4, 6)).astype(np.float32)
    w_scale = np.maximum(np.abs(w_f).max(axis=1), 1e-6) / 127.0
    w_q = np.clip(np.round(w_f / w_scale[:, None]), -127, 127).astype(np.int8)
    nodes = [
        ob.node("QuantizeLinear", ["x", "xs", "xz"], ["xq"]),
        ob.node("DequantizeLinear", ["xq", "xs", "xz"], ["xdq"]),
        ob.node("QuantizeLinear", ["x", "xs"], ["uq"]),       # uint8 range
        ob.node("DequantizeLinear", ["wq", "ws", "wz"], ["wdq"],
                [ob.attr_int("axis", 0)]),
        ob.node("Gemm", ["xdq", "wdq"], ["y"], [ob.attr_int("transB", 1)]),
    ]
    buf = ob.model(nodes, _inits(xs=np.array(0.05, np.float32),
                                 xz=np.array(0, np.int8), wq=w_q,
                                 ws=w_scale.astype(np.float32),
                                 wz=np.zeros(4, np.int8)),
                   ["x"], ["y", "uq"])
    return buf, [rng.standard_normal((2, 6)).astype(np.float32)]


# 512-point STFT power (values to ~1e3) through a 40-band product
@_onnx_case("stft_hann_melweightmatrix", rtol=1e-4, atol=1e-3)
def _o_stft():
    pcm = np.random.default_rng(7).standard_normal((1, 4096)).astype(
        np.float32)
    nodes = [
        ob.node("HannWindow", ["flen"], ["win"]),
        ob.node("STFT", ["x", "step", "win"], ["spec"],
                [ob.attr_int("onesided", 1)]),
        ob.node("Mul", ["spec", "spec"], ["sq"]),
        ob.node("ReduceSum", ["sq"], ["pw"],
                [ob.attr_ints("axes", [-1]), ob.attr_int("keepdims", 0)]),
        ob.node("MelWeightMatrix", ["nmel", "dlen", "srate", "lo", "hi"],
                ["fb"]),
        ob.node("MatMul", ["pw", "fb"], ["mel"]),
    ]
    buf = ob.model(nodes, _inits(
        flen=np.array(512, np.int64), step=np.array(256, np.int64),
        nmel=np.array(40, np.int64), dlen=np.array(512, np.int64),
        srate=np.array(16000, np.int64), lo=np.array(20.0, np.float32),
        hi=np.array(8000.0, np.float32)), ["x"], ["mel", "fb", "win"])
    return buf, [pcm]


@_onnx_case("topk_argmax_tile_cumsum")
def _o_topk():
    x = np.random.default_rng(8).standard_normal((2, 6)).astype(np.float32)
    nodes = [
        ob.node("TopK", ["x", "k"], ["tv", "ti"],
                [ob.attr_int("axis", -1), ob.attr_int("largest", 1)]),
        ob.node("TopK", ["x", "k"], ["sv", "si"],
                [ob.attr_int("axis", 1), ob.attr_int("largest", 0)]),
        ob.node("ArgMax", ["x"], ["am"],
                [ob.attr_int("axis", 1), ob.attr_int("keepdims", 0)]),
        ob.node("ArgMin", ["x"], ["an"], [ob.attr_int("axis", 0)]),
        ob.node("Tile", ["x", "reps"], ["tl"]),
        ob.node("CumSum", ["x", "cax"], ["cs"]),
        ob.node("CumSum", ["x", "cax"], ["rcs"],
                [ob.attr_int("exclusive", 1), ob.attr_int("reverse", 1)]),
    ]
    buf = ob.model(nodes, _inits(k=np.array([3], np.int64),
                                 reps=np.array([1, 2], np.int64),
                                 cax=np.array(1, np.int64)),
                   ["x"], ["tv", "ti", "sv", "si", "am", "an", "tl", "cs",
                           "rcs"])
    return buf, [x]


# a 64-term dot product per logit, 14,795 of them
@_onnx_case("perch_scale_gemm_head", rtol=1e-5, atol=1e-5)
def _o_perch_head():
    rng = np.random.default_rng(13)
    w = (rng.standard_normal((64, 14795)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(14795) * 0.01).astype(np.float32)
    buf = ob.model([ob.node("Gemm", ["embedding", "W", "B"], ["logits"])],
                   _inits(W=w, B=b), ["embedding"], ["logits"])
    return buf, [rng.standard_normal((3, 64)).astype(np.float32)]


@_onnx_case("conv_same_upper_stride2_avgpool_pads")
def _o_same_conv_pools():
    """auto_pad SAME_UPPER at stride 2 on odd sizes; average pools with
    explicit asymmetric pads divide by the count of valid inputs; a 1-D
    conv and 1-D pools."""
    rng = np.random.default_rng(26)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    w1 = rng.standard_normal((2, 3, 5)).astype(np.float32)
    nodes = [
        ob.node("Conv", ["x", "w"], ["c"],
                [ob.attr_ints("strides", [2, 2]),
                 _attr_str("auto_pad", "SAME_UPPER")]),
        ob.node("AveragePool", ["c"], ["ap"],
                [ob.attr_ints("kernel_shape", [3, 3]),
                 ob.attr_ints("strides", [2, 1]),
                 ob.attr_ints("pads", [1, 0, 1, 2])]),
        ob.node("MaxPool", ["c"], ["mp"],
                [ob.attr_ints("kernel_shape", [2, 3]),
                 ob.attr_ints("pads", [0, 1, 1, 1])]),
        ob.node("Conv", ["s", "w1"], ["c1"],
                [ob.attr_ints("pads", [2, 1]), ob.attr_ints("strides", [2])]),
        ob.node("AveragePool", ["s"], ["ap1"],
                [ob.attr_ints("kernel_shape", [4]),
                 ob.attr_ints("strides", [3]), ob.attr_ints("pads", [1, 2])]),
        ob.node("MaxPool", ["s"], ["mp1"], [ob.attr_ints("kernel_shape", [2])]),
    ]
    buf = ob.model(nodes, _inits(w=w, w1=w1), ["x", "s"],
                   ["c", "ap", "mp", "c1", "ap1", "mp1"])
    x = -np.abs(rng.standard_normal((2, 3, 7, 9))).astype(np.float32)
    s = rng.standard_normal((2, 3, 11)).astype(np.float32)
    return buf, [x, s]


@_onnx_case("elementwise_mod_round_clip_battery")
def _o_elementwise():
    rng = np.random.default_rng(27)
    a = np.array([[-7.5, -2.5, -0.5, 0.5, 1.5, 2.5, 7.0, -7.0]], np.float32)
    b = np.array([[2.0, -3.0, 2.0, -2.0, 3.0, 2.0, -3.0, 3.0]], np.float32)
    ai = np.array([[-7, 7, -8, 9, -1, 0, 5, -5]], np.int64)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    unary = ["Round", "Floor", "Ceil", "Neg", "Abs", "Exp", "Sin", "Cos",
             "Erf", "Sigmoid", "Tanh", "Relu", "HardSwish", "Softplus",
             "Identity", "Dropout"]
    nodes = [ob.node("Mod", ["a", "b"], ["mod"]),
             ob.node("Mod", ["a", "b"], ["fmod"], [ob.attr_int("fmod", 1)]),
             ob.node("Mod", ["ai", "bi"], ["imod"]),
             ob.node("Div", ["a", "b"], ["div"]),
             ob.node("Pow", ["x", "two"], ["pow"]),
             ob.node("Abs", ["x"], ["ax"]),
             ob.node("Sqrt", ["ax"], ["sqrt"]),
             ob.node("Log", ["ax"], ["log"]),
             ob.node("Clip", ["x", "lo", "hi"], ["clip"]),
             ob.node("Clip", ["x", "", "hi"], ["cliphi"]),
             ob.node("HardSigmoid", ["x"], ["hsig"],
                     [ob.attr_float("alpha", 0.3)]),
             ob.node("LeakyRelu", ["x"], ["lrelu"],
                     [ob.attr_float("alpha", 0.1)]),
             ob.node("Elu", ["x"], ["elu"], [ob.attr_float("alpha", 0.7)]),
             ob.node("PRelu", ["x", "slope"], ["prelu"]),
             ob.node("Min", ["x", "a"], ["min"]),
             ob.node("Max", ["x", "a"], ["max"]),
             ob.node("Sub", ["x", "a"], ["sub"]),
             ob.node("Softmax", ["x"], ["sm0"], [ob.attr_int("axis", 0)]),
             ob.node("Greater", ["x", "a"], ["gt"]),
             ob.node("Less", ["x", "a"], ["lt"]),
             ob.node("Equal", ["x", "x"], ["eq"]),
             ob.node("GreaterOrEqual", ["x", "a"], ["ge"]),
             ob.node("LessOrEqual", ["x", "a"], ["le"]),
             ob.node("And", ["gt", "ge"], ["and"]),
             ob.node("Or", ["lt", "gt"], ["or"]),
             ob.node("Xor", ["lt", "le"], ["xor"]),
             ob.node("Not", ["eq"], ["not"])]
    nodes += [ob.node(u, ["x"], [u.lower()]) for u in unary]
    outs = [n for n in ("mod", "fmod", "imod", "div", "pow", "sqrt", "log",
                        "clip", "cliphi", "hsig", "lrelu", "elu", "prelu",
                        "min", "max", "sub", "sm0", "and", "or", "xor",
                        "not")] + [u.lower() for u in unary]
    buf = ob.model(nodes, _inits(bi=np.array([[3, -3, 3, -4, 2, 3, -2, 2]],
                                             np.int64),
                                 two=np.array(2.0, np.float32),
                                 lo=np.array(-0.5, np.float32),
                                 hi=np.array(0.7, np.float32),
                                 slope=rng.random(8).astype(np.float32)),
                   ["a", "b", "ai", "x"], outs)
    return buf, [a, b, ai, x]


@_onnx_case("shape_ops_battery")
def _o_shape_ops():
    rng = np.random.default_rng(28)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    nodes = [
        ob.node("Shape", ["x"], ["shape"]),
        ob.node("Cast", ["shape"], ["shapef"], [ob.attr_int("to", 1)]),
        ob.node("Cast", ["x"], ["xi"], [ob.attr_int("to", 7)]),
        ob.node("ConstantOfShape", ["cshape"], ["zeros"]),
        ob.node("Range", ["r0", "r1", "r2"], ["range"]),
        ob.node("Unsqueeze", ["x"], ["u"], [ob.attr_ints("axes", [0, 5])]),
        ob.node("Squeeze", ["u"], ["sq"], [ob.attr_ints("axes", [0, -1])]),
        ob.node("Pad", ["x", "pads"], ["pad"]),
        ob.node("Slice", ["x", "st", "en", "sax", "ssteps"], ["neg_slice"]),
        ob.node("Gather", ["x", "gidx"], ["gather"], [ob.attr_int("axis", 2)]),
        ob.node("GatherElements", ["x", "geidx"], ["gel"],
                [ob.attr_int("axis", 3)]),
        ob.node("Resize", ["x", "", "scales"], ["rnear"]),
        ob.node("Resize", ["x", "", "", "sizes"], ["rlin"],
                [_attr_str("mode", "linear")]),
        ob.node("Resize", ["x", "", "", "shrink"], ["rshrink"],
                [_attr_str("mode", "linear")]),        # antialiased
        ob.node("DFT", ["x"], ["dft"], [ob.attr_int("axis", 3)]),
        ob.node("DFT", ["x"], ["rdft"],
                [ob.attr_int("axis", 3), ob.attr_int("onesided", 1)]),
        ob.node("ReduceMin", ["x"], ["rmin"], [ob.attr_ints("axes", [1])]),
        ob.node("ReduceProd", ["x"], ["rprod"],
                [ob.attr_ints("axes", [1, 3]), ob.attr_int("keepdims", 0)]),
        ob.node("ReduceMean", ["x", "rax"], ["rmean"]),
        ob.node("Expand", ["x", "eshape"], ["expand"]),
        ob.node("Flatten", ["x"], ["flat0"], [ob.attr_int("axis", 0)]),
        ob.node("Split", ["x"], ["s0", "s1", "s2"],
                [ob.attr_int("axis", 1)]),
        ob.node("Reshape", ["x", "rshape"], ["reshaped"]),
        ob.node("Concat", ["s0", "s2"], ["cat"], [ob.attr_int("axis", -3)]),
    ]
    inits = _inits(
        cshape=np.array([2, 3], np.int64),
        r0=np.array(1, np.int64), r1=np.array(11, np.int64),
        r2=np.array(3, np.int64),
        pads=np.array([0, 1, 0, 2, 1, 0, 0, 1], np.int64),
        st=np.array([4, -1], np.int64), en=np.array([0, -6], np.int64),
        sax=np.array([3, 2], np.int64), ssteps=np.array([-2, -1], np.int64),
        gidx=np.array([[3, -1], [0, 2]], np.int64),
        geidx=rng.integers(0, 5, (2, 3, 4, 2)).astype(np.int64),
        scales=np.array([1.0, 1.0, 2.0, 1.5], np.float32),
        sizes=np.array([2, 3, 8, 10], np.int64),
        shrink=np.array([2, 3, 3, 2], np.int64),
        rax=np.array([-1], np.int64),
        eshape=np.array([3, 1, 1, 1, 1], np.int64),
        rshape=np.array([0, -1, 5], np.int64))
    outs = ["shapef", "xi", "zeros", "range", "sq", "pad", "neg_slice",
            "gather", "gel", "rnear", "rlin", "rshrink", "dft", "rdft", "rmin",
            "rprod", "rmean", "expand", "flat0", "s1", "reshaped", "cat",
            "shape"]
    return ob.model(nodes, inits, ["x"], outs), [x]


@_onnx_case("resize_every_axis", rtol=1e-5, atol=1e-5)
def _o_resize_every_axis():
    """Resize as ``jax.image.resize``, every axis that changes: a 1-D
    input [1, 2, 40] shrunk linearly (antialiased, as JAX's shrink is in
    any number of dimensions) and grown, a 3-D input [1, 2, 4, 6, 6]
    shrunk, and the batch and channel axes of [2, 3, 8, 5] resized
    linearly, by scales and nearest. Float32, rtol and atol 1e-5."""
    rng = np.random.default_rng(32)
    a = rng.standard_normal((1, 2, 40)).astype(np.float32)
    b = rng.standard_normal((1, 2, 4, 6, 6)).astype(np.float32)
    c = rng.standard_normal((2, 3, 8, 5)).astype(np.float32)
    lin = [_attr_str("mode", "linear")]
    nodes = [
        ob.node("Resize", ["a", "", "", "a_small"], ["a_shrink"], lin),
        ob.node("Resize", ["a", "", "", "a_big"], ["a_grow"], lin),
        ob.node("Resize", ["b", "", "", "b_small"], ["b_shrink"], lin),
        ob.node("Resize", ["c", "", "", "c_bc"], ["c_batch_channel"], lin),
        ob.node("Resize", ["c", "", "c_scales"], ["c_scaled"], lin),
        ob.node("Resize", ["c", "", "", "c_near"], ["c_nearest"]),
    ]
    inits = _inits(
        a_small=np.array([1, 2, 17], np.int64),
        a_big=np.array([1, 2, 93], np.int64),
        b_small=np.array([1, 2, 3, 4, 4], np.int64),
        c_bc=np.array([1, 5, 8, 5], np.int64),
        c_scales=np.array([1.5, 0.5, 0.5, 1.0], np.float32),
        c_near=np.array([3, 2, 8, 11], np.int64))
    outs = ["a_shrink", "a_grow", "b_shrink", "c_batch_channel",
            "c_scaled", "c_nearest"]
    return ob.model(nodes, inits, ["a", "b", "c"], outs), [a, b, c]


@pytest.mark.parametrize("case", sorted(ONNX))
def test_onnx_graph_equals_jax(case):
    fn, rtol, atol = ONNX[case]
    buf, inputs = fn()
    jg = jonnx.load_onnx(buf)
    want = jg.jitted()(jg.params, *inputs)
    got = tonnx.load_onnx(buf)(*inputs)
    _assert_outputs(got, want, rtol, atol)


@pytest.mark.parametrize("case", sorted(ONNX))
def test_onnx_parse_equals_jax(case):
    buf, _ = ONNX[case][0]()
    a, b = jonnx.parse_onnx(buf), tonnx.parse_onnx(buf)
    assert (a.inputs, a.outputs, a.name, a.input_shapes) == \
        (b.inputs, b.outputs, b.name, b.input_shapes)
    assert len(a.nodes) == len(b.nodes)
    for x, y in zip(a.nodes, b.nodes):
        assert (x.op_type, x.inputs, x.outputs, x.name) == \
            (y.op_type, y.inputs, y.outputs, y.name)
        assert x.attrs.keys() == y.attrs.keys()
        for k in x.attrs:
            np.testing.assert_array_equal(np.asarray(x.attrs[k]),
                                          np.asarray(y.attrs[k]))
    assert list(a.initializers) == list(b.initializers)
    g = tonnx.OnnxGraph(b)
    for k, arr in a.initializers.items():
        assert arr.dtype == b.initializers[k].dtype
        np.testing.assert_array_equal(arr, b.initializers[k])
        assert g.param(k).dtype == graph_ops.torch_dtype(arr.dtype)
        np.testing.assert_array_equal(g.param(k).numpy(), arr)


def test_onnx_topk_ties_take_the_same_index_sets():
    """Tied values: compare the values, and the index sets."""
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0]], np.float32)
    buf = ob.model([ob.node("TopK", ["x", "k"], ["v", "i"])],
                   _inits(k=np.array([4], np.int64)), ["x"], ["v", "i"])
    jg = jonnx.load_onnx(buf)
    jv, ji = jg.jitted()(jg.params, x)
    tv, ti = tonnx.load_onnx(buf)(x)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert set(ti.numpy()[0, :3]) == set(np.asarray(ji)[0, :3]) == {1, 2, 4}
    assert set(ti.numpy()[0, 3:]) | set(np.asarray(ji)[0, 3:]) <= {0, 5}


def test_onnx_constant_generators_fold_once():
    """Windows, MelWeightMatrix and Range over constants run at import and
    stay as buffers; the matrix equals the JAX function's."""
    buf, _ = _o_stft()
    g = tonnx.load_onnx(buf)
    assert [n.op_type for n in g._nodes] == ["STFT", "Mul", "ReduceSum",
                                             "MatMul"]
    jg = jonnx.parse_onnx(buf)
    node = jg.nodes[4]

    def val(name):
        return np.asarray(jg.initializers[name])
    val.const = val
    np.testing.assert_array_equal(g.param("fb").numpy(),
                                  jonnx._mel_weight_matrix(node, val))


def test_onnx_shape_like_inputs_must_be_initializers():
    buf = ob.model([ob.node("Reshape", ["x", "s"], ["y"])], [], ["x", "s"],
                   ["y"])
    x, s = np.zeros((2, 3), np.float32), np.array([3, 2], np.int64)
    jg = jonnx.load_onnx(buf)
    with pytest.raises(KeyError) as je:
        jg.apply(jg.params, x, s)
    with pytest.raises(KeyError) as te:
        tonnx.load_onnx(buf)(x, s)
    assert str(te.value) == str(je.value)
    assert "must be a constant initializer" in str(te.value)


# -- tables, audit, errors --------------------------------------------------------

def test_supported_ops_equal_jax():
    assert ttfl.supported_ops() == jtfl.supported_ops()
    assert tonnx.supported_ops() == jonnx.supported_ops()
    assert taudit.TFLITE_EXPECTED == jaudit.TFLITE_EXPECTED
    assert taudit.ONNX_EXPECTED == jaudit.ONNX_EXPECTED
    assert [(r.family, r.format, r.expected, r.supported, r.missing)
            for r in taudit.audit()] == [
        (r.family, r.format, r.expected, r.supported, r.missing)
        for r in jaudit.audit()]
    assert taudit.audit_table() == jaudit.audit_table()


def _rnn_tflite():
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 2], "input")
    y_t = mb.add_tensor([1, 2], "out")
    mb.add_op(Op.RNN, [x_t], [y_t])
    mb.add_op(Op.HARD_SWISH, [y_t], [x_t])
    mb.add_op(207, [x_t], [y_t])                 # not in Op at all
    return _finish(mb, [x_t], [y_t])


@pytest.mark.parametrize("fmt", ["tflite", "onnx"])
def test_unsupported_op_errors_equal(fmt):
    if fmt == "tflite":
        buf, jload, tload = _rnn_tflite(), jtfl.load_tflite, ttfl.load_tflite
    else:
        buf = ob.model([ob.node("LSTM", ["x"], ["h"]),
                        ob.node("Relu", ["h"], ["r"]),
                        ob.node("GRU", ["r"], ["y"])], [], ["x"], ["y"])
        jload, tload = jonnx.load_onnx, tonnx.load_onnx
    with pytest.raises(NotImplementedError) as je:
        jload(buf)
    with pytest.raises(NotImplementedError) as te:
        tload(buf)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("fmt", ["tflite", "onnx"])
def test_input_count_errors_equal(fmt):
    if fmt == "tflite":
        buf, jload, tload = _dense_model()[0], jtfl.load_tflite, \
            ttfl.load_tflite
    else:
        buf, jload, tload = _o_mlp()[0], jonnx.load_onnx, tonnx.load_onnx
    jg = jload(buf)
    with pytest.raises(ValueError) as je:
        jg.apply(jg.params)
    with pytest.raises(ValueError) as te:
        tload(buf)()
    assert str(te.value) == str(je.value)


def test_graph_moves_its_constants_with_to():
    """The constants are buffers, which ``state_dict`` holds and ``.to``
    moves; a forward reads them where they lie."""
    buf, inputs = _t_mbconv()
    g = ttfl.load_tflite(buf)
    before = {k: v.data_ptr() for k, v in g.named_buffers()}
    assert set(g.state_dict()) == set(before)
    g(*inputs)
    assert {k: v.data_ptr() for k, v in g.named_buffers()} == before
