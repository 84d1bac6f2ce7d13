"""Geomodel range filter: (lat, lon, week) → per-species occurrence scores
(port of ``birdnet_go_tpu/models/geomodel.py``).

Input contract: [lat, lon, week] float32 with lat in [-90, 90], lon in
[-180, 180]; week uses the 48-week BirdNET year (week = (month-1)*4 +
min((day-1)//7+1, 4)); week = -1 disables seasonality. A sinusoidal
encoding of (lat, lon, week) feeds a ReLU MLP and a sigmoid. Parameters keep
the JAX pytree's keys (``mlp.<i>.w``, ``mlp.<i>.b``), so
``inference.params.load_jax_params`` loads a JAX tree key for key.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import math

import torch
from torch import nn

from birdnet_go_tpu_torch.models import layers as L
from birdnet_go_tpu_torch.models import registry

# 2/47 rounded to float32, as a Python float (see Geomodel.encode)
_TWO_OVER_47 = torch.tensor(2 / 47, dtype=torch.float32).item()


def birdnet_week(when: _dt.date) -> int:
    """48-week BirdNET year: (month-1)*4 + min((day-1)//7+1, 4)."""
    return (when.month - 1) * 4 + min((when.day - 1) // 7 + 1, 4)


@dataclasses.dataclass(frozen=True)
class GeomodelConfig:
    num_species: int = 6522
    num_frequencies: int = 16     # sinusoidal encoding frequencies per input
    hidden: tuple[int, ...] = (512, 512, 512)


class Geomodel(nn.Module):
    """Occurrence predictor: coords [..., 3] float32 → scores [..., S]."""

    spec = registry.GEOMODEL_V24

    def __init__(self, cfg: GeomodelConfig | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg or GeomodelConfig()
        self.compute_dtype = compute_dtype
        dims = [self.feature_dim, *self.cfg.hidden, self.cfg.num_species]
        self.mlp = nn.ModuleList(L.Dense(dims[i], dims[i + 1])
                                 for i in range(len(dims) - 1))

    @property
    def feature_dim(self) -> int:
        return 3 * 2 * self.cfg.num_frequencies

    def init(self, generator: torch.Generator | None = None) -> "Geomodel":
        """Fan-in truncated-normal weights, zero biases. torch and JAX give
        different numbers from one seed."""
        for layer in self.mlp:
            layer.init(generator)
        return self

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """[..., 3] (lat, lon, week) → sinusoidal features.

        Inputs are normalized to [-1, 1] (lat/90, lon/180, and week mapped
        over the 48-week year; week < 0 → 0 features for the seasonal
        block, "ignore seasonality").

        The top frequency multiplies each input by 2^15·π, so one ulp of
        the normalized input moves a feature by up to 0.01. The rounding
        is therefore the reference's as it runs compiled: XLA multiplies
        by the float32 reciprocals of 90 and 180, and computes the week
        term as one fused multiply-add, (week - 1)·f32(2/47) - 1. With an
        integral week the float64 product is exact, so rounding the
        float64 result once gives the fused multiply-add's value.
        """
        dev = coords.device
        lat_lon = coords[..., :2] * torch.tensor([1 / 90, 1 / 180],
                                                 device=dev)
        week = coords[..., 2]
        week_n = torch.where(
            week >= 0,
            ((week - 1.0).double() * _TWO_OVER_47 - 1.0).float(),
            torch.zeros_like(week))
        week_on = (week >= 0).to(torch.float32)
        base = torch.cat([lat_lon, week_n[..., None]], dim=-1)   # [..., 3]
        freqs = 2.0 ** torch.arange(self.cfg.num_frequencies,
                                    dtype=torch.float32, device=dev)
        ang = base[..., None] * freqs * math.pi                  # [..., 3, F]
        feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        # gate the week block when seasonality is disabled
        ones = torch.ones_like(week_on)
        gate = torch.stack([ones, ones, week_on], dim=-1)[..., None]
        feats = feats * gate
        return feats.reshape(*coords.shape[:-1], self.feature_dim)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """[..., 3] → occurrence scores [..., S] in [0, 1], float32."""
        h = self.encode(coords).to(self.compute_dtype)
        for layer in self.mlp[:-1]:
            h = torch.relu(layer(h, self.compute_dtype))
        logits = self.mlp[-1](h, self.compute_dtype)
        return torch.sigmoid(logits.to(torch.float32))
