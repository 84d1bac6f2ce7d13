"""EBU R128 / ITU-R BS.1770-4 loudness normalization (host numpy).

Reference: internal/audiocore/audionorm (audionorm.go:56-260, kweight.go,
truepeak.go, meter.go) — two-pass: measure K-weighted gated integrated
loudness + 4× oversampled true peak, then apply ONE linear gain targeting
−23 LUFS capped so true peak stays ≤ −1 dBTP. Used by the BirdWeather
soundscape upload.

Implements BS.1770-4 exactly: K-weighting = stage-1 high-shelf + stage-2
high-pass biquads (coefficients per the spec, adapted to the sample rate
via the standard bilinear redesign), 400 ms blocks with 75% overlap,
absolute gate −70 LUFS then relative gate −10 LU.

A copy of ``birdnet_go_tpu/audio/audionorm.py`` for the port;
``tests/test_torch_aux.py`` holds it to the original.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.signal import lfilter


@dataclasses.dataclass
class NormalizeOptions:
    target_lufs: float = -23.0
    max_true_peak_db: float = -1.0


def _k_weighting_coeffs(rate: int):
    """BS.1770-4 stage coefficients for an arbitrary sample rate.

    Redesign per Brecht De Man's parameterization: stage 1 is a high
    shelf (f0=1681.97 Hz, G=+3.9998 dB, Q=0.7072), stage 2 a high-pass
    (f0=38.135 Hz, Q=0.5003).
    """
    # stage 1: shelf
    f0, g_db, q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    k = math.tan(math.pi * f0 / rate)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b1 = [(vh + vb * k / q + k * k) / a0,
          2.0 * (k * k - vh) / a0,
          (vh - vb * k / q + k * k) / a0]
    a1 = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]
    # stage 2: high-pass
    f0, q = 38.13547087602444, 0.5003270373238773
    k = math.tan(math.pi * f0 / rate)
    a0 = 1.0 + k / q + k * k
    a2 = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]
    b2 = [1.0, -2.0, 1.0]
    b2 = [v / a0 for v in b2]
    return (np.array(b1), np.array(a1)), (np.array(b2), np.array(a2))


def measure_lufs(x: np.ndarray, rate: int) -> float:
    """Gated integrated loudness (mono) per BS.1770-4."""
    (b1, a1), (b2, a2) = _k_weighting_coeffs(rate)
    y = lfilter(b2, a2, lfilter(b1, a1, x.astype(np.float64)))
    block = int(0.4 * rate)
    hop = block // 4                      # 75% overlap
    if len(y) < block:
        pad = np.zeros(block)
        pad[:len(y)] = y
        y = pad
    n_blocks = (len(y) - block) // hop + 1
    idx = np.arange(n_blocks)[:, None] * hop + np.arange(block)[None, :]
    msq = np.mean(y[idx] ** 2, axis=1)
    lk = -0.691 + 10.0 * np.log10(msq + 1e-15)
    # absolute gate
    keep = lk > -70.0
    if not keep.any():
        return -70.0
    # relative gate: −10 LU below the absolute-gated mean
    ref = -0.691 + 10.0 * np.log10(np.mean(msq[keep]) + 1e-15)
    keep2 = keep & (lk > ref - 10.0)
    if not keep2.any():
        keep2 = keep
    return float(-0.691 + 10.0 * np.log10(np.mean(msq[keep2]) + 1e-15))


def true_peak_db(x: np.ndarray, rate: int, oversample: int = 4) -> float:
    """4× oversampled true peak in dBTP (BS.1770-4 annex 2)."""
    from scipy.signal import resample_poly

    up = resample_poly(x.astype(np.float64), oversample, 1)
    peak = np.max(np.abs(up)) if len(up) else 0.0
    return float(20.0 * np.log10(peak + 1e-15))


def plan_gain(x: np.ndarray, rate: int,
              opts: NormalizeOptions | None = None) -> float:
    """Linear gain bringing x to target LUFS without exceeding max dBTP."""
    opts = opts or NormalizeOptions()
    lufs = measure_lufs(x, rate)
    gain_db = opts.target_lufs - lufs
    tp = true_peak_db(x, rate)
    headroom = opts.max_true_peak_db - tp
    gain_db = min(gain_db, headroom)
    return float(10.0 ** (gain_db / 20.0))


def normalize(x: np.ndarray, rate: int,
              opts: NormalizeOptions | None = None) -> np.ndarray:
    """Two-pass normalize: measure, then apply one linear gain."""
    g = plan_gain(x, rate, opts)
    return np.clip(x * g, -1.0, 1.0).astype(np.float32)


def normalize_int16(pcm: np.ndarray, rate: int,
                    opts: NormalizeOptions | None = None) -> np.ndarray:
    x = pcm.astype(np.float32) / 32768.0
    y = normalize(x, rate, opts)
    return np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
