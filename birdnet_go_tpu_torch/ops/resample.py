"""Polyphase rational resampling on a torch device (port of
``birdnet_go_tpu/ops/resample.py``).

The JAX package writes L/M resampling as one convolution of the L-fold
zero-stuffed signal (``lhs_dilation=L``) at stride M. ``conv1d`` has no
input dilation, and stuffing the zeros would grow 44.1 → 48 kHz audio
160-fold, so the port uses the polyphase identity instead: with output
index j = q·L + r,

    y[q·L + r] = Σ_s x[q·M + s] · h[L·s + pad_lo − r·M],

which is one ``conv1d`` of the signal with L output channels (one per
phase r) at stride M, followed by interleaving the phases. The filter is
the JAX package's Kaiser-windowed sinc (``_design_filter``, a numpy copy),
so the outputs agree to float32 rounding.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from birdnet_go_tpu_torch.ops.precision import full_float32


@dataclasses.dataclass(frozen=True)
class ResampleConfig:
    """Static rational-resample configuration (hashable)."""

    in_rate: int
    out_rate: int
    taps_per_phase: int = 24     # filter half-quality; 24 ≈ "medium" quality
    beta: float = 8.6            # Kaiser window beta (~ -90 dB stopband)
    cutoff_scale: float = 0.97   # transition-band margin below Nyquist

    @property
    def ratio(self) -> tuple[int, int]:
        g = math.gcd(self.in_rate, self.out_rate)
        return self.out_rate // g, self.in_rate // g  # (L up, M down)

    def out_len(self, in_len: int) -> int:
        l, m = self.ratio
        return (in_len * l) // m


@functools.lru_cache(maxsize=32)
def _design_filter(l: int, m: int, taps_per_phase: int, beta: float,
                   cutoff_scale: float) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for L/M resampling, gain L, float32."""
    n_taps = 2 * taps_per_phase * max(l, m) + 1
    cutoff = cutoff_scale / max(l, m)          # normalized to the upsampled rate
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = np.sinc(n * cutoff) * cutoff
    h *= np.kaiser(n_taps, beta)
    h *= l / np.sum(h)                          # unity passband gain after ↑L
    return h.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _phase_weights(cfg: ResampleConfig) -> tuple[np.ndarray, int]:
    """The filter split into its L phases as a ``conv1d`` weight [L, 1, K],
    and the left zero padding of the signal.

    Phase r reads x[q·M + s] with tap h[L·s + pad_lo − r·M]; s runs over
    [s_lo, s_hi], the union of every phase's taps, and column s − s_lo of
    the weight holds that tap (0 where it falls outside the filter).
    """
    l, m = cfg.ratio
    h = _design_filter(l, m, cfg.taps_per_phase, cfg.beta, cfg.cutoff_scale)
    n_taps = h.shape[0]
    pad_lo = (n_taps - 1) // 2
    s_lo = -(pad_lo // l)                          # ceil(-pad_lo / L)
    s_hi = (n_taps - 1 + (l - 1) * m - pad_lo) // l
    s = np.arange(s_lo, s_hi + 1)
    tap = l * s[None, :] + pad_lo - m * np.arange(l)[:, None]   # [L, K]
    ok = (tap >= 0) & (tap < n_taps)
    w = np.where(ok, h[np.clip(tap, 0, n_taps - 1)], np.float32(0.0))
    return w.astype(np.float32)[:, None, :], -s_lo


def polyphase_resample(x: torch.Tensor, cfg: ResampleConfig) -> torch.Tensor:
    """Rational resample [..., T] → [..., T·L/M] float32, on x's device.

    Output sample j is centred on input j·M/L, as in the JAX function; the
    signal is zero outside [0, T).
    """
    l, m = cfg.ratio
    if l == 1 and m == 1:
        return x
    w, pad = _phase_weights(cfg)
    k = w.shape[-1]
    lead = x.shape[:-1]
    t = x.shape[-1]
    out_len = cfg.out_len(t)
    q = -(-out_len // l)                         # conv outputs per phase
    pad_hi = max(0, (q - 1) * m + k - t - pad)
    xf = F.pad(x.reshape(-1, 1, t).to(torch.float32), (pad, pad_hi))
    weight = torch.from_numpy(w).to(x.device)
    with full_float32():
        out = F.conv1d(xf, weight, stride=m)[..., :q]      # [N, L, Q]
    # phase-major → time order: y[q·L + r] = out[r, q]
    y = out.transpose(1, 2).reshape(-1, q * l)[:, :out_len]
    return y.reshape(*lead, out_len)
