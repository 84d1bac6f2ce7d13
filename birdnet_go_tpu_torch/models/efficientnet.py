"""EfficientNet backbone over mel spectrograms (port of
``birdnet_go_tpu/models/efficientnet.py``).

A stem conv, a schedule of MBConv stages, a 1×1 head conv, global average
pool → embedding, and a dense classifier head. The public input keeps the
JAX layout, NHWC [B, frames, mels, C]; the module runs NCHW inside.

``forward(x, fused_blocks=True)`` routes each block that
``fused_block_ok`` admits through the two fused kernels
(``ops/pallas_mbconv.py``), as ``apply_efficientnet`` does; with
``train=True`` BN takes the batch's statistics and no block is fused.
``act_int8=True`` stores the stem's and every block's output as int8
(``int8_boundary``), never with ``train``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from birdnet_go_tpu_torch.models import layers as L
from birdnet_go_tpu_torch.ops.pallas_mbconv import (
    fused_block_ok,
    mbconv_fused,
)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    expand: int
    cout: int
    kernel: int
    stride: int
    repeats: int


# (expand, cout, kernel, stride, repeats): the B0 schedule; B1 = B0 with
# deeper repeats.
B0_BLOCKS = (
    BlockSpec(1, 16, 3, 1, 1),
    BlockSpec(6, 24, 3, 2, 2),
    BlockSpec(6, 40, 5, 2, 2),
    BlockSpec(6, 80, 3, 2, 3),
    BlockSpec(6, 112, 5, 1, 3),
    BlockSpec(6, 192, 5, 2, 4),
    BlockSpec(6, 320, 3, 1, 1),
)
B1_BLOCKS = (
    BlockSpec(1, 16, 3, 1, 2),
    BlockSpec(6, 24, 3, 2, 3),
    BlockSpec(6, 40, 5, 2, 3),
    BlockSpec(6, 80, 3, 2, 4),
    BlockSpec(6, 112, 5, 1, 4),
    BlockSpec(6, 192, 5, 2, 5),
    BlockSpec(6, 320, 3, 1, 2),
)


# the int8 activation boundary's static scale: block outputs are O(1), and
# [-8, 8] covers them with headroom
ACT_INT8_SCALE = 8.0 / 127.0


@functools.cache
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: a Python scalar that elementwise ops
    take exactly (they compute bf16 in float32 and round the result)."""
    return float(torch.tensor(value, dtype=dtype))


def quantize_boundary(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`h` → int8 codes clip(round(h · inv), ±127): inv = 1 /
    ACT_INT8_SCALE rounded to the compute `dtype`, the product rounded in
    `dtype` before ``round`` (half to even), as JAX's ``_int8_boundary``.
    Elementwise ops keep `h`'s memory format."""
    inv = _in_dtype(1.0 / ACT_INT8_SCALE, dtype)
    return torch.round(h.to(dtype) * inv).clamp_(-127, 127).to(torch.int8)


def dequantize_boundary(q: torch.Tensor, dtype: torch.dtype
                        ) -> torch.Tensor:
    """int8 codes → `dtype`, times ACT_INT8_SCALE rounded to `dtype` (bf16:
    0.06298828125, not 8/127), the product rounded in `dtype`."""
    return q.to(dtype) * _in_dtype(ACT_INT8_SCALE, dtype)


def int8_boundary(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Store an inter-block activation as int8 and read it back in the
    compute `dtype`. Eager torch materialises the int8 tensor, so no
    barrier is needed."""
    return dequantize_boundary(quantize_boundary(h, dtype), dtype)


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    blocks: tuple[BlockSpec, ...] = B0_BLOCKS
    stem_channels: int = 32
    embedding_dim: int = 1280
    num_classes: int = 6522
    se_ratio: float = 0.25


class EfficientNet(nn.Module):
    """x NHWC [B, T, M, C] → {"logits": [B, S], "embedding": [B, E]}, both
    float32. Parameters start as zeros with identity BN; `init` draws the
    weights."""

    def __init__(self, cfg: EfficientNetConfig, in_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.stem_conv = L.Conv(in_channels, cfg.stem_channels, 3, stride=2)
        self.stem_bn = L.BatchNorm(cfg.stem_channels)
        blocks = []
        cin = cfg.stem_channels
        for b in cfg.blocks:
            for r in range(b.repeats):
                blocks.append(L.MBConv(cin, b.cout, b.kernel, b.expand,
                                       stride=b.stride if r == 0 else 1,
                                       se_ratio=cfg.se_ratio))
                cin = b.cout
        self.blocks = nn.ModuleList(blocks)
        self.head_conv = L.Conv(cin, cfg.embedding_dim, 1)
        self.head_bn = L.BatchNorm(cfg.embedding_dim)
        self.classifier = L.Dense(cfg.embedding_dim, cfg.num_classes)

    def init(self, generator: torch.Generator | None = None
             ) -> "EfficientNet":
        """Fan-in truncated-normal weights, zero biases, identity BN, drawn
        in the JAX init's order. `generator` must live on the parameters'
        device. torch and JAX give different numbers from one seed."""
        self.stem_conv.init(generator)
        for blk in self.blocks:
            blk.init(generator)
        self.head_conv.init(generator)
        self.classifier.init(generator)
        return self

    def forward(self, x: torch.Tensor, fused_blocks: bool = False,
                train: bool = False, act_int8: bool = False
                ) -> dict[str, torch.Tensor]:
        dt = self.compute_dtype
        boundary = act_int8 and not train
        h = x.permute(0, 3, 1, 2)              # NHWC → NCHW (channels_last)
        h = L.swish(self.stem_bn(self.stem_conv(h, dt), train))
        if boundary:
            h = int8_boundary(h, dt)
        channels_last = False
        for blk in self.blocks:
            if (fused_blocks and fused_block_ok(blk.dw.stride, h.shape[2],
                                                h.shape[3], train)):
                if not channels_last:
                    # the kernels read [B, H·W, C], a view of channels_last
                    # memory; the convolutions of the unfused blocks keep
                    # that format, so this is the only copy
                    h = h.contiguous(memory_format=torch.channels_last)
                    channels_last = True
                h = mbconv_fused(blk, h, kernel=blk.dw.k, compute_dtype=dt)
            else:
                h = blk(h, dt, train)
            if boundary:
                h = int8_boundary(h, dt)
        h = L.swish(self.head_bn(self.head_conv(h, dt), train))
        emb = h.mean(dim=(2, 3))               # global average pool
        logits = self.classifier(emb, dt)
        return {"logits": logits.to(torch.float32),
                "embedding": emb.to(torch.float32)}
