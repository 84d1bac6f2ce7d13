"""BattyBirdNET two-stage bat classifier (port of
``birdnet_go_tpu/models/bat.py``).

Reference (internal/classifier/bat_onnx.go:19-120,
doc/wiki/detection-pipeline.md:103-117): a BirdNET v2.4 embedding extractor
(1024-dim pooled output) feeds a regional bat classifier head. Ultrasonic
audio captured at 256 kHz is fed unresampled as if it were 48 kHz (the
"slow-down trick"), which shifts bat calls into the band the embedding
model was trained on.

The embedding stage is the B0 backbone with a 1024-wide embedding; its own
classifier stays in the parameter tree, unused. The regional head is a
``Dense(1024, num_species)`` on the embedding rounded to the compute dtype.
Both stages run in one device step.
"""

from __future__ import annotations

import torch

from birdnet_go_tpu_torch.models import layers as L
from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    B0_BLOCKS,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.ops.pallas_melspec import melspec_fused
from birdnet_go_tpu_torch.ops.pcm import pcm16_to_float32


class BatClassifier(MelCnnModel):
    """`apply` takes float32 PCM [B, 144000] in [-1, 1]; `apply_int16` is
    the production int16 step. Both return {"logits": [B, 128],
    "embedding": [B, 1024]}. Parameters: ``backbone.*`` and ``head.*``, the
    JAX tree's {"backbone", "head"}. `net` replaces the B0 backbone's
    config (a narrow net for tests)."""

    spec = registry.BAT

    def __init__(self, num_species: int | None = None,
                 mel: MelConfig | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 net: EfficientNetConfig | None = None):
        num_species = num_species or self.spec.num_species
        # the mel front end in "48 kHz coordinates": the 256 kHz raw window
        # is 3 s × 48000 samples nominal, about 0.56 s of ultrasound
        mel = mel or MelConfig(
            sample_rate=self.spec.sample_rate, n_fft=2048, hop=512,
            n_mels=96, fmin=0.0, fmax=15000.0, mag_scale="nonlinear")
        net = net or EfficientNetConfig(
            blocks=B0_BLOCKS, embedding_dim=self.spec.embedding_dim,
            num_classes=num_species)
        super().__init__(num_species, mel, net, compute_dtype)
        self.head = L.Dense(net.embedding_dim, num_species)

    def init(self, generator: torch.Generator | None = None
             ) -> "BatClassifier":
        self.backbone.init(generator)
        self.head.init(generator)
        return self

    def _heads(self, emb: torch.Tensor) -> dict[str, torch.Tensor]:
        logits = self.head(emb, self.compute_dtype)
        return {"logits": logits.to(torch.float32), "embedding": emb}

    def apply(self, pcm: torch.Tensor) -> dict[str, torch.Tensor]:
        """float32 PCM → logits of the regional head and the embedding,
        through the plain mel."""
        feats = self.features(pcm).to(self.compute_dtype)
        emb = self.backbone(feats, self.fused_blocks)["embedding"]
        return self._heads(emb)

    def apply_int16(self, pcm_i16: torch.Tensor) -> dict[str, torch.Tensor]:
        """int16 PCM step: ``melspec_fused`` (the CUDA kernel for a tensor
        on the card) feeds the embedding backbone, then the regional
        head."""
        if not self._fused_ok():
            return self.apply(pcm16_to_float32(pcm_i16))
        m = melspec_fused(pcm_i16, self.mel, out_dtype=self.compute_dtype)
        emb = self.backbone(m[..., None], self.fused_blocks)["embedding"]
        return self._heads(emb)
