"""NN layers of the mel CNN (port of ``birdnet_go_tpu/models/layers.py``).

Activations are NCHW tensors; conv weights are OIHW, depthwise weights
(C, 1, k, k), dense weights [out, in]. Every module keeps its float32
parameters under the JAX pytree's names, so
``inference.params.params_from_jax`` maps one onto the other key for key. Compute follows the JAX contract: inputs and weights are
cast to `compute_dtype` (bf16 by default), products accumulate in float32,
and convolution outputs are stored in `compute_dtype`. BatchNorm runs in
its folded inference form, eps 1e-3. Serving only: there is no train mode.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _fan_in_init_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """Truncated normal in [-2, 2] scaled by sqrt(2 / fan_in), in place."""
    std = math.sqrt(2.0 / max(fan_in, 1))
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """TF "SAME" padding of the two spatial dims of NCHW `x`: out =
    ceil(n / stride), and an odd total pads the extra row or column at the
    bottom or right."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads)


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class Conv(nn.Module):
    """k×k convolution without bias, TF-SAME padding; `groups = cin` makes
    it depthwise."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.w = _param(cout, cin // groups, k, k)

    def init(self, generator: torch.Generator | None = None) -> None:
        _fan_in_init_(self.w, self.k * self.k * self.w.shape[1], generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        x = same_pad(x.to(compute_dtype), self.k, self.stride)
        return F.conv2d(x, self.w.to(compute_dtype), stride=self.stride,
                        groups=self.groups)


def depthwise(c: int, k: int, stride: int = 1) -> Conv:
    return Conv(c, c, k, stride, groups=c)


class BatchNorm(nn.Module):
    """Inference BatchNorm, folded: y = x·k + b with k = scale/√(var+eps)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        # identity until statistics are loaded
        self.scale = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = _param(c)
        self.mean = _param(c)
        self.var = nn.Parameter(torch.ones(c), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * k
        return (x * k.to(x.dtype)[:, None, None]
                + b.to(x.dtype)[:, None, None])


class Dense(nn.Module):
    """y = x @ wᵀ + b in float32: the float32 sum of products of operands
    rounded to `compute_dtype`, as JAX's ``apply_dense`` with its float32
    accumulator. The rounded operands are multiplied in float32, which is
    exact for bf16 operands while TF32 stays off."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.w = _param(cout, cin)
        self.b = _param(cout) if bias else None

    def init(self, generator: torch.Generator | None = None) -> None:
        _fan_in_init_(self.w, self.w.shape[1], generator)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        y = F.linear(x.to(compute_dtype).float(),
                     self.w.to(compute_dtype).float())
        return y + self.b if self.b is not None else y


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, c_squeeze: int):
        super().__init__()
        self.reduce = Dense(c, c_squeeze)
        self.expand = Dense(c_squeeze, c)

    def init(self, generator: torch.Generator | None = None) -> None:
        self.reduce.init(generator)
        self.expand.init(generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        pooled = x.mean(dim=(2, 3))                             # [B, C]
        s = swish(self.reduce(pooled, compute_dtype))
        s = torch.sigmoid(self.expand(s, compute_dtype))
        return x * s.to(x.dtype)[:, :, None, None]


class MBConv(nn.Module):
    """Inverted residual block: [expand 1×1 → BN → swish] → depthwise k×k →
    BN → swish → [SE] → project 1×1 → BN → [+ x]."""

    def __init__(self, cin: int, cout: int, k: int, expand: int,
                 stride: int = 1, se_ratio: float = 0.25):
        super().__init__()
        cmid = cin * expand
        self.residual = stride == 1 and cin == cout
        if expand != 1:
            self.expand_conv = Conv(cin, cmid, 1)
            self.expand_bn = BatchNorm(cmid)
        else:
            self.expand_conv = self.expand_bn = None
        self.dw = depthwise(cmid, k, stride)
        self.dw_bn = BatchNorm(cmid)
        self.se = (SqueezeExcite(cmid, max(1, int(cin * se_ratio)))
                   if se_ratio > 0 else None)
        self.project_conv = Conv(cmid, cout, 1)
        self.project_bn = BatchNorm(cout)

    def init(self, generator: torch.Generator | None = None) -> None:
        """Weights in the JAX init order: expand, depthwise, SE, project."""
        for m in (self.expand_conv, self.dw, self.se, self.project_conv):
            if m is not None:
                m.init(generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = swish(self.expand_bn(self.expand_conv(h, compute_dtype)))
        h = swish(self.dw_bn(self.dw(h, compute_dtype)))
        if self.se is not None:
            h = self.se(h, compute_dtype)
        h = self.project_bn(self.project_conv(h, compute_dtype))
        if self.residual:
            h = h + x.to(h.dtype)
        return h
