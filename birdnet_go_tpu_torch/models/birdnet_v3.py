"""BirdNET v3.0: 32 kHz / 5 s PCM → 6,522 species logits (port of
``birdnet_go_tpu/models/birdnet_v3.py``): the mel front end at hop 640 with
128 nonlinear bands to 15 kHz, and the EfficientNet-B1 backbone."""

from __future__ import annotations

import torch

from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    B1_BLOCKS,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig


class BirdNETv3(MelCnnModel):
    """`apply` takes float32 PCM [B, 160000] in [-1, 1]; `apply_int16` is
    the production int16 step. Both return {"logits": [B, 6522],
    "embedding": [B, 1280]}."""

    spec = registry.BIRDNET_V3

    def __init__(self, num_species: int | None = None,
                 mel: MelConfig | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        num_species = num_species or self.spec.num_species
        mel = mel or MelConfig(
            sample_rate=self.spec.sample_rate, n_fft=2048, hop=640,
            n_mels=128, fmin=0.0, fmax=15000.0, mag_scale="nonlinear")
        net = EfficientNetConfig(
            blocks=B1_BLOCKS, embedding_dim=self.spec.embedding_dim,
            num_classes=num_species)
        super().__init__(num_species, mel, net, compute_dtype)
