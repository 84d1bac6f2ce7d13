"""Streaming polyphase resampler (host side) with exact chunk continuity.

Reference: internal/audiocore/resample/resample.go — per-route stateful
resampler, zero-alloc steady state. This implementation shares the filter
design with the device op (ops.resample.ResampleConfig) so host and device
paths are numerically identical; output is computed with absolute-index
bookkeeping so chunk boundaries introduce no discontinuity (the result
equals resampling the whole stream at once).

At 2,000-stream scale host resampling moves to the batched device path /
native code; this host path serves capture-rate conversion for moderate
stream counts and tests.

A copy of ``birdnet_go_tpu/audio/resampler.py`` for the port, over the
port's ``ops/resample.py``, with one divergence, accepted on purpose:
``process`` sums only the taps that meet input samples (the filter's
polyphase form: output j takes phase (−u) mod L of the filter, u = j·M −
pad_lo, against the inputs from ceil(u / L) on), where JAX's multiplies
the whole zero-stuffed signal, L − 1 of whose samples in L are zero. JAX's
way costs L times the work and a gather of n_out × n_taps floats a call:
on the card's host a 50 ms chunk at 44.1 kHz took 27.04 ms to 48 kHz and
49.55 ms to 32 kHz, this form 0.21 and 0.18 ms (NVIDIA H100 80GB HBM3,
700.00 W, in ``chip_smoke.py`` phase 19), and eight 44.1 kHz RTSP sources
fell behind real time JAX's way.

The sums are the same but for their float32 rounding. The contract, and
the tests that hold it:

- each chunk is as long as JAX's, within 1e-6 of the largest sample of
  JAX's chunk, and no further from the resampler's definition computed in
  float64 than JAX's chunk is, plus one float32 epsilon of the largest
  input sample (``tests/test_torch_aux.py``,
  ``test_streaming_resampler_equal_jax``);
- the engine's resampled int16 windows are within one int16 step of
  JAX's at no more than 1e-3 of their samples, and bit for bit with JAX's
  resampler in the port's engine (``tests/test_torch_app.py``).
"""

from __future__ import annotations

import math

import numpy as np

from birdnet_go_tpu_torch.ops.resample import ResampleConfig, _design_filter


class StreamingResampler:
    def __init__(self, in_rate: int, out_rate: int,
                 taps_per_phase: int = 24):
        self.cfg = ResampleConfig(in_rate, out_rate,
                                  taps_per_phase=taps_per_phase)
        self.l, self.m = self.cfg.ratio
        self.identity = (self.l == 1 and self.m == 1)
        if not self.identity:
            h = _design_filter(self.l, self.m, self.cfg.taps_per_phase,
                               self.cfg.beta, self.cfg.cutoff_scale)
            self.n_taps = len(h)
            self.pad_lo = (self.n_taps - 1) // 2
            # the filter's L phases: phase p holds the taps p, p + L, ...
            # (zero past the filter), the only ones that meet an input
            # sample of the zero-stuffed signal
            k = -(-self.n_taps // self.l)
            taps = self.l * np.arange(k)[None, :] \
                + np.arange(self.l)[:, None]
            self._phases = np.where(taps < self.n_taps,
                                    h[np.minimum(taps, self.n_taps - 1)],
                                    np.float32(0.0))
        self._in_total = 0            # absolute input samples received
        self._out_total = 0           # absolute output samples emitted
        # retained tail of past input (absolute index of tail[0])
        self._tail = np.zeros(0, np.float32)
        self._tail_start = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        """Feed a chunk of float32 samples; returns all newly-computable
        output samples (phase-continuous across calls)."""
        x = np.asarray(x, np.float32)
        if self.identity:
            return x
        if len(x):
            self._tail = np.concatenate([self._tail, x])
            self._in_total += len(x)

        # Output j needs upsampled positions [j·M − pad_lo, +n_taps), i.e.
        # inputs up to i_hi(j) = floor((j·M − pad_lo + n_taps − 1)/L).
        t = self._in_total
        j_max = ((t - 1) * self.l + self.pad_lo - self.n_taps + 1) // self.m
        n_new = j_max + 1 - self._out_total
        if n_new <= 0:
            return np.zeros(0, np.float32)

        # Output j's first tap sits at upsampled position u = j·M − pad_lo;
        # the taps that meet input samples are phase (−u) mod L of the
        # filter, against inputs ceil(u / L), ceil(u / L) + 1, ...
        # (negative inputs are the stream's leading zeros)
        u = np.arange(self._out_total, j_max + 1) * self.m - self.pad_lo
        first = -(-u // self.l)
        phase = first * self.l - u
        k = self._phases.shape[1]
        lead = max(0, -int(first[0]))
        seg = np.concatenate([np.zeros(lead, np.float32), self._tail,
                              np.zeros(k, np.float32)])
        rows = np.lib.stride_tricks.sliding_window_view(seg, k)[
            first - (self._tail_start - lead)]
        y = np.einsum("jk,jk->j", rows, self._phases[phase])

        self._out_total += n_new
        # trim retained input: next call needs inputs from i_lo(out_total)
        keep_from = math.floor((self._out_total * self.m - self.pad_lo)
                               / self.l)
        keep_from = max(keep_from, 0)
        if keep_from > self._tail_start:
            self._tail = self._tail[keep_from - self._tail_start:]
            self._tail_start = keep_from
        return y.astype(np.float32)

    def flush(self) -> np.ndarray:
        """Emit the final tail as if the stream ended (zero-padded)."""
        if self.identity:
            return np.zeros(0, np.float32)
        pad = int(np.ceil(self.n_taps / self.l)) + self.m
        out = self.process(np.zeros(pad, np.float32))
        want_total = self.cfg.out_len(self._in_total - pad)
        emitted_before = self._out_total - len(out)
        take = max(0, want_total - emitted_before)
        return out[:take]
