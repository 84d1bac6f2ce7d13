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
port's ``ops/resample.py``; ``tests/test_torch_aux.py`` holds it to the
original.
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
            self.h = _design_filter(self.l, self.m,
                                    self.cfg.taps_per_phase, self.cfg.beta,
                                    self.cfg.cutoff_scale)
            self.n_taps = len(self.h)
            self.pad_lo = (self.n_taps - 1) // 2
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

        j0 = self._out_total
        # input range needed: from i_lo(j0) through i_hi(j_max)
        i_lo = math.floor((j0 * self.m - self.pad_lo) / self.l)
        i_lo = min(i_lo, self._tail_start)    # never before what we kept
        # Build the segment in upsampled space with explicit absolute origin.
        seg_start = max(i_lo, 0)
        lead_zeros = max(0, -i_lo) if i_lo < 0 else 0
        seg = self._tail[seg_start - self._tail_start:]
        up_origin = (seg_start - lead_zeros) * self.l   # abs upsampled idx of xup[0]
        xup = np.zeros(lead_zeros * self.l + len(seg) * self.l
                       + self.n_taps, np.float32)
        xup[lead_zeros * self.l:(lead_zeros + len(seg)) * self.l:self.l] = seg

        offsets = (np.arange(j0, j0 + n_new) * self.m
                   - self.pad_lo - up_origin)
        win = np.lib.stride_tricks.sliding_window_view(xup, self.n_taps)
        y = win[offsets] @ self.h

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
