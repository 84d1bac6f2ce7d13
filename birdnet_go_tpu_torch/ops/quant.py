"""Post-training int8 quantization of the EfficientNet backbone and int8
dense heads (port of ``birdnet_go_tpu/ops/quant.py``).

Scheme, as in the JAX package:

- weights: symmetric per-output-channel int8, BN folded first, computed in
  numpy float32 with the JAX package's operations in its order, so that
  codes and scales match it bit for bit;
- the stem conv stays float32 (BN folded);
- activations: symmetric per-tensor int8 at max-abs scales from a float32
  calibration pass (``calibrate_efficientnet``);
- each conv runs int8 × int8 → exact int32 sums, then the float32 epilogue
  ``acc · (w_scale · s_in) + bias``, swish and the requantization; the
  residual is added in float32; SE and the classifier stay float32.

On the card the 1×1 convolutions and the heads are ``torch._int_mm``
products (cuBLASLt int8 on the tensor cores) over NHWC rows; ``int_mm``
pads the shapes that ``_int_mm`` refuses there. The depthwise sums are a
float32 convolution of int8 values, exact because every partial sum is an
integer below 2²⁴ (k² · 127² ≤ 403,225) and every operand an integer of at
most 127, which float32 and TF32 hold exactly, as long as the algorithm sums
products directly; the card tests hold it to int32 tap sums, and
``chip_smoke.py`` every int8 conv's sums on the card to the CPU's.
Activations are NHWC throughout; weights keep the port's layouts
(OIHW, depthwise (C, 1, k, k), dense [out, in]).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from birdnet_go_tpu_torch.models import layers as L
from birdnet_go_tpu_torch.models.efficientnet import (
    EfficientNet,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.precision import full_float32

_QMAX = 127.0


# ---------------------------------------------------------------- helpers


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _fold_bn(w: np.ndarray, bn: L.BatchNorm, eps: float = 1e-3
             ) -> tuple[np.ndarray, np.ndarray]:
    """Fold inference BatchNorm into an OIHW conv weight and a bias:
    conv(x, w · k) + (bias − mean · k), k = scale / √(var + eps) per output
    channel (axis 0 here, the last axis of JAX's HWIO)."""
    k = _np(bn.scale) / np.sqrt(_np(bn.var) + eps)
    w_f = np.asarray(w, np.float32) * k[:, None, None, None]
    b_f = _np(bn.bias) - _np(bn.mean) * k
    return w_f, b_f.astype(np.float32)


def _quant_weight(w_f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel (axis 0) symmetric int8: (w_q, scale[cout])."""
    axes = tuple(range(1, w_f.ndim))
    amax = np.maximum(np.abs(w_f).max(axis=axes), 1e-12)
    scale = (amax / _QMAX).astype(np.float32)
    shape = (-1,) + (1,) * (w_f.ndim - 1)
    w_q = np.clip(np.round(w_f / scale.reshape(shape)), -127,
                  127).astype(np.int8)
    return w_q, scale


def quantize_tensor(x: torch.Tensor, scale: float) -> torch.Tensor:
    """clip(round(x / scale), ±127) as int8; ``torch.round`` rounds half to
    even, as ``jnp.round``."""
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8)


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a int8 [M, K] times wᵀ for w int8 [N, K] → exact int32 [M, N], by
    ``torch._int_mm``.

    On CUDA ``_int_mm`` takes only M > 16 and K, N multiples of 8: other
    shapes get zero rows and columns, which add nothing to the sums, and the
    result is sliced back. The CPU takes the same route."""
    m, k = a.shape
    n = w.shape[0]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    out = torch._int_mm(a, w.t())
    return out[:m, :n] if pm or pn else out


# ---------------------------------------------------------------- modules


class QConv(nn.Module):
    """An int8 convolution with BN folded: w_q int8 (OIHW, or (C, 1, k, k)
    depthwise), per-output-channel w_scale and a float32 bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 depthwise: bool = False):
        super().__init__()
        self.k, self.stride, self.depthwise = k, stride, depthwise
        self.register_buffer("w_q", torch.zeros(
            cout, 1 if depthwise else cin, k, k, dtype=torch.int8))
        self.register_buffer("w_scale", torch.zeros(cout))
        self.register_buffer("bias", torch.zeros(cout))


class FloatConv(nn.Module):
    """The float32 stem with BN folded: w (OIHW) and a bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.k, self.stride = k, stride
        self.register_buffer("w", torch.zeros(cout, cin, k, k))
        self.register_buffer("bias", torch.zeros(cout))


class QBlock(nn.Module):
    def __init__(self, blk: L.MBConv):
        super().__init__()
        cmid = blk.dw.w.shape[0]
        cin = blk.expand_conv.w.shape[1] if blk.expand_conv is not None \
            else cmid
        self.residual = blk.residual
        self.expand = (QConv(cin, cmid, 1) if blk.expand_conv is not None
                       else None)
        self.dw = QConv(cmid, cmid, blk.dw.k, blk.dw.stride, depthwise=True)
        self.se = (L.SqueezeExcite(cmid, blk.se.reduce.w.shape[0])
                   if blk.se is not None else None)
        self.project = QConv(cmid, blk.project_conv.w.shape[0], 1)


class QuantizedEfficientNet(nn.Module):
    """The int8 inference form of an ``EfficientNet``: buffers named as the
    JAX package's quantized tree (``stem.w``, ``blocks.3.dw.w_q``,
    ``head.w_scale``, ``classifier.w`` ...) in the port's layouts, and the
    activation scales {tap: float}. `template` gives the structure only.
    ``forward(mel)`` is ``apply_efficientnet_int8``."""

    def __init__(self, template: EfficientNet,
                 act_scales: Mapping[str, float] | None = None):
        super().__init__()
        self.cfg: EfficientNetConfig = template.cfg
        self.act_scales = dict(act_scales or {})
        stem = template.stem_conv
        self.stem = FloatConv(stem.w.shape[1], stem.w.shape[0], stem.k,
                              stem.stride)
        self.blocks = nn.ModuleList(QBlock(b) for b in template.blocks)
        self.head = QConv(template.head_conv.w.shape[1],
                          template.head_conv.w.shape[0], 1)
        self.classifier = L.Dense(template.classifier.w.shape[1],
                                  template.classifier.w.shape[0])

    def forward(self, mel: torch.Tensor) -> dict[str, torch.Tensor]:
        return apply_efficientnet_int8(self, mel)


# ---------------------------------------------------------------- calibration


def calibrate_efficientnet(net: EfficientNet, mel_batches,
                           compute_dtype: torch.dtype = torch.float32
                           ) -> dict[str, float]:
    """Max-abs activation scales at the input of every conv that runs in
    int8, from a forward over mel batches (NHWC [B, T, M, 1]) on the net's
    device: {tap: max|x| / 127} for ``stem``, ``b{i}.in``, ``b{i}.dw``,
    ``b{i}.proj`` and ``head``. The dataflow is ``MBConv.forward``'s, tapped
    where JAX's calibration taps it."""
    dev = net.stem_conv.w.device
    amax: dict[str, float] = {}

    def note(name: str, x: torch.Tensor) -> None:
        amax[name] = max(amax.get(name, 0.0), float(x.abs().max()), 1e-6)

    dt = compute_dtype
    with torch.inference_mode(), full_float32():
        for mel in mel_batches:
            x = torch.as_tensor(np.array(mel) if isinstance(mel, np.ndarray)
                                else mel, device=dev).to(dt)
            note("stem", x)
            h = L.swish(net.stem_bn(net.stem_conv(x.permute(0, 3, 1, 2), dt)))
            for i, blk in enumerate(net.blocks):
                note(f"b{i}.in", h)
                hin = h
                if blk.expand_conv is not None:
                    h = L.swish(blk.expand_bn(blk.expand_conv(h, dt)))
                note(f"b{i}.dw", h)
                h = L.swish(blk.dw_bn(blk.dw(h, dt)))
                if blk.se is not None:
                    h = blk.se(h, dt)
                note(f"b{i}.proj", h)
                h = blk.project_bn(blk.project_conv(h, dt))
                if blk.residual:
                    h = h + hin
            note("head", h)
    return {k: v / _QMAX for k, v in amax.items()}


# ---------------------------------------------------------------- quantize


def _qconv_state(conv: L.Conv, bn: L.BatchNorm) -> dict[str, torch.Tensor]:
    w_f, b_f = _fold_bn(_np(conv.w), bn)
    w_q, w_s = _quant_weight(w_f)
    return {"w_q": torch.from_numpy(w_q), "w_scale": torch.from_numpy(w_s),
            "bias": torch.from_numpy(b_f)}


def quantize_efficientnet(net: EfficientNet, act_scales: Mapping[str, float]
                          ) -> QuantizedEfficientNet:
    """float32 parameters + activation scales → the int8 module, on the
    CPU (``.to(device)`` moves it). The scales are rounded to float32, as
    the JAX tree stores them."""
    q = QuantizedEfficientNet(net, {k: float(np.float32(v))
                                    for k, v in act_scales.items()})
    state: dict[str, torch.Tensor] = {}

    def put(prefix: str, d: dict) -> None:
        state.update({f"{prefix}.{k}": v for k, v in d.items()})

    w_f, b_f = _fold_bn(_np(net.stem_conv.w), net.stem_bn)
    put("stem", {"w": torch.from_numpy(w_f), "bias": torch.from_numpy(b_f)})
    for i, blk in enumerate(net.blocks):
        if blk.expand_conv is not None:
            put(f"blocks.{i}.expand", _qconv_state(blk.expand_conv,
                                                   blk.expand_bn))
        put(f"blocks.{i}.dw", _qconv_state(blk.dw, blk.dw_bn))
        if blk.se is not None:
            put(f"blocks.{i}.se", {k: v.detach().float().cpu()
                                   for k, v in blk.se.state_dict().items()})
        put(f"blocks.{i}.project", _qconv_state(blk.project_conv,
                                                blk.project_bn))
    put("head", _qconv_state(net.head_conv, net.head_bn))
    put("classifier", {k: v.detach().float().cpu()
                       for k, v in net.classifier.state_dict().items()})
    q.load_state_dict(state, strict=True)
    return q


# ---------------------------------------------------------------- forward


def _acc_i8(x_q: torch.Tensor, layer: QConv) -> torch.Tensor:
    """int8 NHWC [B, H, W, Cin] through `layer` → exact int32 sums, NHWC.

    1×1: ``int_mm`` over the [B·H·W, Cin] rows. Depthwise: TF-SAME padding
    (``layers.same_pad``), then a float32 convolution of the int8 values
    with TF32 off, whose sums are exact integers (module docstring)."""
    if layer.depthwise:
        x = L.same_pad(x_q.permute(0, 3, 1, 2).float(), layer.k, layer.stride)
        with full_float32():
            acc = F.conv2d(x, layer.w_q.float(), stride=layer.stride,
                           groups=x.shape[1])
        return acc.permute(0, 2, 3, 1).to(torch.int32)
    b, h, w, c = x_q.shape
    acc = int_mm(x_q.reshape(b * h * w, c), layer.w_q[:, :, 0, 0])
    return acc.reshape(b, h, w, -1)


def _conv_i8(x_q: torch.Tensor, layer: QConv, s_in: float) -> torch.Tensor:
    """int8 conv → float32 pre-activation: acc · (w_scale · s_in) + bias,
    the scale vector formed first, as in JAX."""
    acc = _acc_i8(x_q, layer)
    return acc.to(torch.float32) * (layer.w_scale * s_in) + layer.bias


def _swish_q(y_f: torch.Tensor, s_out: float) -> torch.Tensor:
    """float32 swish, then the requantization to `s_out`."""
    return quantize_tensor(y_f * torch.sigmoid(y_f), s_out)


def apply_efficientnet_int8(q: QuantizedEfficientNet, mel: torch.Tensor
                            ) -> dict[str, torch.Tensor]:
    """mel NHWC [B, T, M, 1] → {"logits", "embedding"} float32 through the
    int8 backbone, on the device of `q`'s buffers.

    The dataflow is ``MBConv``'s: swish after the stem, expand and
    depthwise convs only; project outputs are linear, carry the residual in
    float32 and are requantized to the next tap's scale."""
    sc = q.act_scales
    with full_float32():
        x = L.same_pad(mel.to(torch.float32).permute(0, 3, 1, 2), q.stem.k,
                       q.stem.stride)
        h_f = F.conv2d(x, q.stem.w, stride=q.stem.stride)
        h_f = h_f.permute(0, 2, 3, 1) + q.stem.bias      # NHWC from here
        s_in = sc["b0.in"]
        x_q = _swish_q(h_f, s_in)
        n = len(q.blocks)
        for i, qb in enumerate(q.blocks):
            if qb.expand is not None:
                s_dw = sc[f"b{i}.dw"]
                d_q = _swish_q(_conv_i8(x_q, qb.expand, s_in), s_dw)
            else:
                d_q, s_dw = x_q, s_in
            h_f = _conv_i8(d_q, qb.dw, s_dw)
            h_f = h_f * torch.sigmoid(h_f)           # dw swish stays f32
            if qb.se is not None:
                pooled = h_f.mean(dim=(1, 2))
                g = L.swish(qb.se.reduce(pooled, torch.float32))
                g = torch.sigmoid(qb.se.expand(g, torch.float32))
                h_f = h_f * g[:, None, None, :]
            s_proj = sc[f"b{i}.proj"]
            h_f = _conv_i8(quantize_tensor(h_f, s_proj), qb.project, s_proj)
            if qb.residual:
                h_f = h_f + x_q.to(torch.float32) * s_in
            s_next = sc["head"] if i + 1 == n else sc[f"b{i + 1}.in"]
            x_q = quantize_tensor(h_f, s_next)
            s_in = s_next
        h_f = _conv_i8(x_q, q.head, sc["head"])
        h_f = h_f * torch.sigmoid(h_f)
        emb = h_f.mean(dim=(1, 2))
        logits = q.classifier(emb, torch.float32)
    return {"logits": logits, "embedding": emb}


def int8_layers(q: QuantizedEfficientNet) -> list[QConv]:
    """The int8 convolutions of `q` in the order the forward runs them."""
    out = []
    for qb in q.blocks:
        out += [c for c in (qb.expand, qb.dw, qb.project) if c is not None]
    return out + [q.head]


# ------------------------------------------------------- int8 dense heads


def quantize_dense_head(dense: L.Dense) -> dict[str, torch.Tensor]:
    """One dense head [out, in] → {"w_q" int8 [out, in], "w_scale" [out],
    "b"}: per-output-channel symmetric weight scales. Activations are
    quantized per row at run time, so no calibration is needed."""
    w_f = _np(dense.w).astype(np.float32)
    amax = np.maximum(np.abs(w_f).max(axis=1), 1e-12)
    w_scale = (amax / _QMAX).astype(np.float32)
    w_q = np.clip(np.round(w_f / w_scale[:, None]), -127, 127).astype(np.int8)
    q = {"w_q": torch.from_numpy(w_q), "w_scale": torch.from_numpy(w_scale)}
    if dense.b is not None:
        q["b"] = dense.b.detach().float().cpu().clone()
    return q


def apply_dense_int8(q: Mapping[str, torch.Tensor], x: torch.Tensor
                     ) -> torch.Tensor:
    """Embeddings [B, in] → float32 logits [B, out]: a dynamic per-row
    activation scale, an int8 × int8 → int32 product (``int_mm``) and the
    float32 epilogue acc · (x_scale · w_scale) + b."""
    x_f = x.to(torch.float32)
    x_scale = x_f.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) * (
        1.0 / _QMAX)
    x_q = torch.round(x_f / x_scale).clamp_(-127, 127).to(torch.int8)
    acc = int_mm(x_q, q["w_q"])
    y = acc.to(torch.float32) * (x_scale * q["w_scale"])
    if "b" in q:
        y = y + q["b"]
    return y


__all__ = [
    "QConv",
    "QuantizedEfficientNet",
    "apply_dense_int8",
    "apply_efficientnet_int8",
    "calibrate_efficientnet",
    "int8_layers",
    "int_mm",
    "quantize_dense_head",
    "quantize_efficientnet",
    "quantize_tensor",
]
