"""Ultrasonic validation filter for bat detections (port of
``birdnet_go_tpu/ops/ultrasonic.py``).

Reference: internal/audiocore/ultrasonic/filter.go — STFT (Hann) over the
raw high-rate window, coefficient of variation (CV) of the ultrasonic-band
energy across frames; a LOW CV means steady broadband noise rather than bat
calls, so the detection is "unlikely" (ComputeUSFrameCV at :20, IsUnlikely
at :71; CV threshold 0.15 default, conf/defaults.go:106-108).

The spectrum is ``torch.fft.rfft`` (cuFFT on the card), as the JAX package
computes it with ``jnp.fft`` outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from birdnet_go_tpu_torch.ops.melspec import MelConfig, _spectrum, frame_signal


@dataclasses.dataclass(frozen=True)
class UltrasonicConfig:
    sample_rate: int = 256000        # raw bat capture rate
    n_fft: int = 1024
    hop: int = 512
    band_low_hz: float = 16000.0     # ultrasonic band lower edge
    band_high_hz: float | None = None
    cv_threshold: float = 0.15


def ultrasonic_frame_cv(pcm: torch.Tensor, cfg: UltrasonicConfig
                        ) -> torch.Tensor:
    """float32 PCM [..., T] at the raw rate → CV of per-frame ultrasonic
    band energy [...]."""
    mel_cfg = MelConfig(sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
                        hop=cfg.hop, window="hann", use_matmul_fft=False)
    frames = frame_signal(pcm, mel_cfg)
    power = _spectrum(frames, mel_cfg)           # [..., F, bins]
    n_bins = cfg.n_fft // 2 + 1
    nyq = cfg.sample_rate / 2
    lo_bin = int(cfg.band_low_hz / nyq * (n_bins - 1))
    hi_bin = (int(cfg.band_high_hz / nyq * (n_bins - 1))
              if cfg.band_high_hz else n_bins)
    band = power[..., lo_bin:hi_bin].sum(dim=-1)    # [..., F]
    mean = band.mean(dim=-1)
    std = band.std(dim=-1, correction=0)
    return std / (mean + 1e-12)


def is_unlikely(pcm: torch.Tensor, cfg: UltrasonicConfig) -> torch.Tensor:
    """True where the window's ultrasonic energy is too steady to be a bat
    call (detection should be discarded)."""
    return ultrasonic_frame_cv(pcm, cfg) < cfg.cv_threshold
