"""1/3-octave-band sound level metering on a torch device (port of
``birdnet_go_tpu/ops/soundlevel.py``).

Reference: internal/audiocore/soundlevel/processor.go:41-440 — per-interval
RMS in 1/3-octave bands (IEC 61260 center frequencies). Band energies come
from the power spectrum the mel front end computes (``torch.fft.rfft``) →
rectangular band masks → dB levels, batched over streams.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from birdnet_go_tpu_torch.ops.melspec import MelConfig, _spectrum, frame_signal


def third_octave_centers(fmin: float = 25.0, fmax: float = 20000.0
                         ) -> np.ndarray:
    """IEC 61260 nominal 1/3-octave centers within [fmin, fmax]."""
    # band n: f = 1000 * 2^(n/3); generate a generous range then clip
    n = np.arange(-48, 30)
    f = 1000.0 * 2.0 ** (n / 3.0)
    return f[(f >= fmin) & (f <= fmax)]


@dataclasses.dataclass(frozen=True)
class SoundLevelConfig:
    sample_rate: int = 48000
    n_fft: int = 4096
    fmin: float = 25.0
    fmax: float = 20000.0

    @property
    def hop(self) -> int:
        return self.n_fft // 2


@functools.lru_cache(maxsize=8)
def _band_matrix(sample_rate: int, n_fft: int, fmin: float, fmax: float
                 ) -> tuple[np.ndarray, np.ndarray]:
    """[n_bins, n_bands] rectangular band-energy selection matrix."""
    centers = third_octave_centers(fmin, min(fmax, sample_rate / 2))
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate / 2, n_bins)
    lo = centers / 2 ** (1 / 6)
    hi = centers * 2 ** (1 / 6)
    m = ((freqs[:, None] >= lo[None, :])
         & (freqs[:, None] < hi[None, :])).astype(np.float32)
    return m, centers


@functools.lru_cache(maxsize=16)
def _band_matrix_on(sample_rate: int, n_fft: int, fmin: float, fmax: float,
                    device: torch.device) -> torch.Tensor:
    """``_band_matrix`` uploaded to `device` once (an ordinary tensor, also
    when the first caller runs in inference mode)."""
    m, _ = _band_matrix(sample_rate, n_fft, fmin, fmax)
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device)


def band_levels_db(pcm: torch.Tensor, cfg: SoundLevelConfig
                   ) -> tuple[torch.Tensor, np.ndarray]:
    """float32 PCM [..., T] → (levels dBFS [..., n_bands], centers).

    Level = 10·log10(mean band power per frame), averaged over frames —
    an RMS level per band for the interval.
    """
    mel_cfg = MelConfig(sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
                        hop=cfg.hop, window="hann", use_matmul_fft=False)
    frames = frame_signal(pcm, mel_cfg)
    power = _spectrum(frames, mel_cfg)           # [..., F, bins]
    _, centers = _band_matrix(cfg.sample_rate, cfg.n_fft, cfg.fmin,
                              cfg.fmax)
    band_power = torch.einsum("...fk,kb->...b", power, _band_matrix_on(
        cfg.sample_rate, cfg.n_fft, cfg.fmin, cfg.fmax, power.device))
    # normalize: window energy + frame count → mean-square per sample
    n_frames = frames.shape[-2]
    win = np.hanning(cfg.n_fft)
    norm = (win ** 2).sum() * n_frames * cfg.n_fft / 2
    msq = band_power / norm
    return 10.0 * torch.log10(msq + 1e-12), centers
