"""EfficientNet backbone over mel spectrograms (port of
``birdnet_go_tpu/models/efficientnet.py``).

A stem conv, a schedule of MBConv stages, a 1×1 head conv, global average
pool → embedding, and a dense classifier head. The public input keeps the
JAX layout, NHWC [B, frames, mels, C]; the module runs NCHW inside.

``forward(x, fused_blocks=True)`` routes each block that
``fused_block_ok`` admits through the two fused kernels
(``ops/pallas_mbconv.py``), as ``apply_efficientnet`` does; with
``train=True`` BN takes the batch's statistics and no block is fused.
"""

from __future__ import annotations

import dataclasses

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
                train: bool = False) -> dict[str, torch.Tensor]:
        dt = self.compute_dtype
        h = x.permute(0, 3, 1, 2)              # NHWC → NCHW (channels_last)
        h = L.swish(self.stem_bn(self.stem_conv(h, dt), train))
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
        h = L.swish(self.head_bn(self.head_conv(h, dt), train))
        emb = h.mean(dim=(2, 3))               # global average pool
        logits = self.classifier(emb, dt)
        return {"logits": logits.to(torch.float32),
                "embedding": emb.to(torch.float32)}
