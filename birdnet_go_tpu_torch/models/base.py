"""Shared base for the mel + EfficientNet model families (port of
``birdnet_go_tpu/models/base.py``)."""

from __future__ import annotations

import torch
from torch import nn

from birdnet_go_tpu_torch.models.efficientnet import (
    EfficientNet,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig, melspec
from birdnet_go_tpu_torch.ops.pallas_melspec import melspec_fused
from birdnet_go_tpu_torch.ops.pcm import pcm16_to_float32


class MelCnnModel(nn.Module):
    """Mel front end + EfficientNet backbone, holding its own parameters.

    Subclasses set `spec` and pass the mel and backbone configs.
    """

    spec = None
    # route the stride-1 blocks through the fused MBConv kernels; off, as in
    # the JAX package
    fused_blocks = False
    # store the stem's and every block's output as int8 (the activation
    # boundary, ``efficientnet.int8_boundary``); off, as in the JAX package
    act_int8 = False

    def __init__(self, num_species: int, mel: MelConfig,
                 net: EfficientNetConfig,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_species = num_species
        self.mel = mel
        self.net = net
        self.compute_dtype = compute_dtype
        self.backbone = EfficientNet(net, compute_dtype=compute_dtype)

    def init(self, generator: torch.Generator | None = None
             ) -> "MelCnnModel":
        self.backbone.init(generator)
        return self

    def features(self, pcm: torch.Tensor) -> torch.Tensor:
        """float32 PCM [B, T] → mel features NHWC [B, frames, mels, 1]."""
        return melspec(pcm, self.mel)[..., None]

    def apply(self, pcm: torch.Tensor, train: bool = False
              ) -> dict[str, torch.Tensor]:
        """float32 PCM [B, T] → {"logits", "embedding"} through the plain
        mel, as the JAX XLA path runs. `fused_blocks` and `act_int8` reach
        the backbone here and in ``apply_int16``; `train` makes BN use the
        batch's statistics (the training path) and turns the boundary off."""
        return self.backbone(self.features(pcm).to(self.compute_dtype),
                             self.fused_blocks, train, self.act_int8)

    def _fused_ok(self) -> bool:
        """The mel config fits the fused kernel (n_fft 2048, hop % 128 == 0,
        power spectrogram)."""
        return (self.mel.n_fft == 2048 and self.mel.hop % 128 == 0
                and self.mel.power == 2.0)

    def apply_int16(self, pcm_i16: torch.Tensor) -> dict[str, torch.Tensor]:
        """int16 PCM [B, T] step. A fitting config goes through
        ``melspec_fused``: the CUDA kernel for a tensor on the card, its
        plain version for one on the CPU. Other configs take ``apply``."""
        if self._fused_ok():
            m = melspec_fused(pcm_i16, self.mel, out_dtype=self.compute_dtype)
            return self.backbone(m[..., None], self.fused_blocks,
                                 act_int8=self.act_int8)
        return self.apply(pcm16_to_float32(pcm_i16))

    def forward(self, pcm: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.apply(pcm)
