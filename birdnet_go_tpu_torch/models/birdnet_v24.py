"""BirdNET v2.4: 48 kHz / 3 s PCM → 6,522 species logits (port of
``birdnet_go_tpu/models/birdnet_v24.py``)."""

from __future__ import annotations

import torch

from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    B0_BLOCKS,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig


class BirdNETv24(MelCnnModel):
    """`apply` takes float32 PCM [B, 144000] in [-1, 1]; `apply_int16` is
    the production int16 step. Both return {"logits": [B, 6522],
    "embedding": [B, 1280]}. `net` replaces the B0 backbone's config (a
    narrow net, as ``train --tiny`` builds)."""

    spec = registry.BIRDNET_V24

    def __init__(self, num_species: int | None = None,
                 mel: MelConfig | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 net: EfficientNetConfig | None = None):
        num_species = num_species or self.spec.num_species
        mel = mel or MelConfig(
            sample_rate=self.spec.sample_rate, n_fft=2048, hop=512,
            n_mels=96, fmin=0.0, fmax=15000.0, mag_scale="nonlinear")
        net = net or EfficientNetConfig(
            blocks=B0_BLOCKS, embedding_dim=self.spec.embedding_dim,
            num_classes=num_species)
        super().__init__(num_species, mel, net, compute_dtype)
