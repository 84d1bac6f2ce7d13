"""Google Perch v2: 32 kHz / 5 s PCM → 14,795 species logits and a
1,280-wide embedding (port of ``birdnet_go_tpu/models/perch_v2.py``): the
mel front end at hop 640 with 160 log bands from 60 Hz to 10 kHz, and the
EfficientNet-B1 backbone."""

from __future__ import annotations

import torch

from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    B1_BLOCKS,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig


class PerchV2(MelCnnModel):
    """`apply` takes float32 PCM [B, 160000] in [-1, 1]; `apply_int16` is
    the production int16 step. Both return {"logits": [B, 14795],
    "embedding": [B, 1280]}."""

    spec = registry.PERCH_V2

    def __init__(self, num_species: int | None = None,
                 mel: MelConfig | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        num_species = num_species or self.spec.num_species
        mel = mel or MelConfig(
            sample_rate=self.spec.sample_rate, n_fft=2048, hop=640,
            n_mels=160, fmin=60.0, fmax=10000.0, mag_scale="log")
        net = EfficientNetConfig(
            blocks=B1_BLOCKS, embedding_dim=self.spec.embedding_dim,
            num_classes=num_species)
        super().__init__(num_species, mel, net, compute_dtype)
