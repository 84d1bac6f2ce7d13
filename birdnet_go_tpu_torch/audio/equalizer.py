"""RBJ audio-EQ-cookbook biquad filters + per-route filter chains.

Reference: internal/audiocore/equalizer (equalizer.go, builder.go) —
low-pass, high-pass, all-pass, band-pass, band-reject (notch), low/high
shelf, peaking EQ, composable into atomically-swappable chains applied in
the router's processing path.

A copy of ``birdnet_go_tpu/audio/equalizer.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class BiquadCoeffs:
    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def design_biquad(kind: str, rate: int, f0: float, q: float = 0.7071,
                  gain_db: float = 0.0) -> BiquadCoeffs:
    """RBJ cookbook designs. kind: lowpass|highpass|allpass|bandpass|
    bandreject|lowshelf|highshelf|peaking."""
    w0 = 2.0 * math.pi * f0 / rate
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    a = 10.0 ** (gain_db / 40.0)

    if kind == "lowpass":
        b0 = (1 - cw) / 2; b1 = 1 - cw; b2 = (1 - cw) / 2
        a0 = 1 + alpha; a1 = -2 * cw; a2 = 1 - alpha
    elif kind == "highpass":
        b0 = (1 + cw) / 2; b1 = -(1 + cw); b2 = (1 + cw) / 2
        a0 = 1 + alpha; a1 = -2 * cw; a2 = 1 - alpha
    elif kind == "bandpass":
        b0 = alpha; b1 = 0.0; b2 = -alpha
        a0 = 1 + alpha; a1 = -2 * cw; a2 = 1 - alpha
    elif kind == "bandreject":
        b0 = 1.0; b1 = -2 * cw; b2 = 1.0
        a0 = 1 + alpha; a1 = -2 * cw; a2 = 1 - alpha
    elif kind == "allpass":
        b0 = 1 - alpha; b1 = -2 * cw; b2 = 1 + alpha
        a0 = 1 + alpha; a1 = -2 * cw; a2 = 1 - alpha
    elif kind == "peaking":
        b0 = 1 + alpha * a; b1 = -2 * cw; b2 = 1 - alpha * a
        a0 = 1 + alpha / a; a1 = -2 * cw; a2 = 1 - alpha / a
    elif kind == "lowshelf":
        sq = 2.0 * math.sqrt(a) * alpha
        b0 = a * ((a + 1) - (a - 1) * cw + sq)
        b1 = 2 * a * ((a - 1) - (a + 1) * cw)
        b2 = a * ((a + 1) - (a - 1) * cw - sq)
        a0 = (a + 1) + (a - 1) * cw + sq
        a1 = -2 * ((a - 1) + (a + 1) * cw)
        a2 = (a + 1) + (a - 1) * cw - sq
    elif kind == "highshelf":
        sq = 2.0 * math.sqrt(a) * alpha
        b0 = a * ((a + 1) + (a - 1) * cw + sq)
        b1 = -2 * a * ((a - 1) + (a + 1) * cw)
        b2 = a * ((a + 1) + (a - 1) * cw - sq)
        a0 = (a + 1) - (a - 1) * cw + sq
        a1 = 2 * ((a - 1) - (a + 1) * cw)
        a2 = (a + 1) - (a - 1) * cw - sq
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    return BiquadCoeffs(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


class Biquad:
    """Stateful direct-form-II-transposed biquad for streaming chunks."""

    def __init__(self, coeffs: BiquadCoeffs):
        self.c = coeffs
        self._z1 = 0.0
        self._z2 = 0.0

    def process(self, x: np.ndarray) -> np.ndarray:
        from scipy.signal import lfilter

        c = self.c
        b = [c.b0, c.b1, c.b2]
        a = [1.0, c.a1, c.a2]
        zi = np.array([self._z1, self._z2])
        y, zf = lfilter(b, a, x.astype(np.float64), zi=zi)
        self._z1, self._z2 = float(zf[0]), float(zf[1])
        return y.astype(np.float32)

    def reset(self) -> None:
        self._z1 = self._z2 = 0.0


class FilterChain:
    """Ordered biquad chain + gain, swappable atomically (the router keeps
    a reference; replacing the chain object is the swap)."""

    def __init__(self, filters: list[Biquad] | None = None,
                 gain: float = 1.0):
        self.filters = filters or []
        self.gain = gain

    def process(self, x: np.ndarray) -> np.ndarray:
        y = x
        for f in self.filters:
            y = f.process(y)
        if self.gain != 1.0:
            y = (y * self.gain).astype(np.float32)
        return y

    @classmethod
    def from_config(cls, rate: int, specs: list[dict]) -> "FilterChain":
        """specs: [{"type": "highpass", "frequency": 300, "q": 0.7,
        "gain": 0.0}, ...]"""
        filters = [Biquad(design_biquad(
            s["type"], rate, float(s["frequency"]),
            q=float(s.get("q", 0.7071)), gain_db=float(s.get("gain", 0.0))))
            for s in specs]
        return cls(filters)
