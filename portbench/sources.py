"""Inputs the benchmark makes from the seed: the farm's waveform bank, the
range mask, field recordings. Frozen copies of the generators that
``chip_smoke.py`` and ``native/stream_farm.cpp`` used, computed on the
device in bulk."""

from __future__ import annotations

import math

import numpy as np
import torch


def _gen(seed: int, device: torch.device, salt: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + salt) % (2 ** 63))
    return g


def waveform_bank(seed: int, n: int, rate: int, device: torch.device
                  ) -> np.ndarray:
    """int16 [n, 2·rate]: looped 2 s soundscapes, the farm's synthesis: a
    fundamental f0 in [400, 8000) Hz at amplitude a in [0.05, 0.35) with
    its second and third harmonics at 0.4a and 0.2a, a chirp from c0 in
    [200, 4000) Hz rising by [100, 2000) Hz/s at 0.3a, a red-noise floor
    (one-pole 0.98 over 0.02 · N(0, 0.01), times 8), clipped to ±0.999."""
    g = _gen(seed, device, 1)
    u = torch.rand(n, 4, generator=g, device=device, dtype=torch.float64)
    f0 = 400.0 + 7600.0 * u[:, 0:1]
    amp = 0.05 + 0.30 * u[:, 1:2]
    c0 = (400.0 + 7600.0 * u[:, 2:3]) * 0.5
    slope = (400.0 + 7600.0 * u[:, 3:4]) * 0.25
    t = torch.arange(2 * rate, device=device, dtype=torch.float64)[None] / rate
    v = (amp * torch.sin(2 * math.pi * f0 * t)
         + 0.4 * amp * torch.sin(2 * math.pi * 2 * f0 * t)
         + 0.2 * amp * torch.sin(2 * math.pi * 3 * f0 * t)
         + 0.3 * amp * torch.sin(2 * math.pi * (c0 * t
                                                + 0.5 * slope * t * t)))
    noise = 0.01 * torch.randn(n, 1, 2 * rate + 1023, generator=g,
                               device=device, dtype=torch.float64)
    kern = (0.02 * 0.98 ** torch.arange(1024, device=device,
                                        dtype=torch.float64)).flip(0)
    red = torch.nn.functional.conv1d(noise, kern[None, None])[:, 0]
    v = (v + 8.0 * red).clamp(-0.999, 0.999)
    return torch.trunc(v * 32767.0).to(torch.int16).cpu().numpy()


def range_mask(seed: int, num_classes: int, share: float,
               device: torch.device) -> torch.Tensor:
    """float32 [S]: 1 for a seeded `share` of the species (the range
    filter's included set), at least 10."""
    g = _gen(seed, device, 2)
    keep = max(10, int(round(share * num_classes)))
    order = torch.randperm(num_classes, generator=g, device=device)
    mask = torch.zeros(num_classes, device=device)
    mask[order[:keep]] = 1.0
    return mask


def field_recording(seconds: float, rate: int, seed: int,
                    device: torch.device) -> np.ndarray:
    """float32 mono samples of a field-level recording, as a WAV of it
    reads: 10 s linear tone sweeps between random frequencies from 200 Hz
    to 12 kHz at -26 dBFS over -40 dBFS white noise, quantised to int16
    and scaled by 1/32768 (``chip_smoke.field_recording``'s signal)."""
    g = _gen(seed, device, 3)
    n, seg = int(seconds * rate), 10 * rate
    n_seg = -(-n // seg)
    ends = 200.0 + 11800.0 * torch.rand(2, n_seg, generator=g, device=device,
                                        dtype=torch.float64)
    k = torch.arange(n, device=device)
    f0, f1 = ends[:, k // seg]
    freq = f0 + (f1 - f0) * ((k % seg).to(torch.float64) / seg)
    phase = torch.cumsum(freq / rate, 0)
    tone = 0.05 * torch.sin(2 * math.pi * phase)
    x = tone + 0.01 * torch.randn(n, generator=g, device=device,
                                  dtype=torch.float64)
    pcm = torch.clamp(x * 32767, -32768, 32767).to(torch.int16)
    return (pcm.to(torch.float32) / 32768.0).cpu().numpy()
