"""Ring buffers (copies of ``AnalysisBuffer`` and ``CaptureBuffer`` in
``birdnet_go_tpu/audio/buffers.py``, so that the port imports nothing of the
JAX package; ``tests/test_torch_hostplane.py`` and
``tests/test_torch_aux.py`` hold them to the originals).

AnalysisBuffer (reference: internal/audiocore/buffer/analysis.go:187-252,
spec in SURVEY.md Appendix C): an overwrite-mode ring with `overlap` and
`read_size` fixed at allocation (window = overlap + read_size). `read()`
returns None until `read_size` fresh samples exist; then the window is
[tail of previous window (overlap) | fresh read_size]; the first window's
overlap prefix is zero-filled. Overwrites by a slow consumer are counted
over a sliding window. Sizes are int16 sample counts.

CaptureBuffer (buffer/capture.go:39-232): a time-indexed ring at the source
rate for clip export; `read_segment(start, end)` extracts by wall-clock.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np


class AnalysisBuffer:
    """Overlapped-window ring buffer for one (source, model) pair."""

    def __init__(self, overlap_samples: int, read_samples: int,
                 capacity_samples: int | None = None):
        if read_samples <= 0 or overlap_samples < 0:
            raise ValueError("invalid buffer dimensions")
        self.overlap = overlap_samples
        self.read_size = read_samples
        self.window_size = overlap_samples + read_samples
        # the ring holds at least 2 windows of audio so a slow consumer has
        # slack before overwrites happen
        cap = capacity_samples or (2 * self.window_size)
        self.capacity = max(cap, self.window_size)
        self._ring = np.zeros(self.capacity, np.int16)
        self._wpos = 0                  # absolute samples written
        self._rpos = 0                  # absolute samples consumed by read()
        self._prev_tail = np.zeros(self.overlap, np.int16)
        self._have_prev = False
        self._lock = threading.Lock()
        # overwrite accounting: (timestamp, samples_lost) over a 5-min window
        self._overwrites: deque[tuple[float, int]] = deque()
        self.total_overwritten = 0

    def write(self, samples: np.ndarray, now: float | None = None) -> None:
        samples = np.asarray(samples, np.int16)
        n = len(samples)
        if n == 0:
            return
        with self._lock:
            # oversized write: the head that can never fit is dropped (lost),
            # only the freshest capacity-sized tail is stored
            truncated = max(0, n - self.capacity)
            if truncated:
                samples = samples[-self.capacity:]
                n = self.capacity
            # overwrite detection: unread data clobbered by the new write
            unread = self._wpos - self._rpos
            clobbered = max(0, unread + n - self.capacity)
            lost = truncated + clobbered
            if lost > 0:
                self._rpos += clobbered
                self.total_overwritten += lost
                self._overwrites.append((now or time.monotonic(), lost))
            start = self._wpos % self.capacity
            end = start + n
            if end <= self.capacity:
                self._ring[start:end] = samples
            else:
                k = self.capacity - start
                self._ring[start:] = samples[:k]
                self._ring[:end - self.capacity] = samples[k:]
            self._wpos += n

    def read(self) -> np.ndarray | None:
        """Return the next [window_size] window, or None if not enough fresh
        audio. Window = [overlap from previous window's tail | fresh data];
        the first window's overlap prefix is zeros."""
        with self._lock:
            if self._wpos - self._rpos < self.read_size:
                return None
            fresh = self._take(self._rpos, self.read_size)
            self._rpos += self.read_size
            window = np.concatenate([self._prev_tail, fresh])
            if self.overlap > 0:
                self._prev_tail = window[-self.overlap:].copy()
            self._have_prev = True
            return window

    def _take(self, abs_pos: int, n: int) -> np.ndarray:
        start = abs_pos % self.capacity
        end = start + n
        if end <= self.capacity:
            return self._ring[start:end].copy()
        k = self.capacity - start
        return np.concatenate([self._ring[start:],
                               self._ring[:end - self.capacity]])

    def available(self) -> int:
        with self._lock:
            return self._wpos - self._rpos

    def overwrite_rate(self, window_seconds: float = 300.0,
                       now: float | None = None) -> float:
        """Fraction of throughput lost to overwrites over the sliding
        window."""
        now = now or time.monotonic()
        with self._lock:
            while (self._overwrites
                   and self._overwrites[0][0] < now - window_seconds):
                self._overwrites.popleft()
            lost = sum(n for _, n in self._overwrites)
            if self._wpos == 0:
                return 0.0
            return lost / max(self._wpos, 1)


class CaptureBuffer:
    """Time-indexed ring at the source rate, for clip export by wall-clock.

    `write(samples, timestamp)` appends; `read_segment(start, end)` returns
    int16 PCM covering [start, end) seconds (unix time), zero-filling any
    part that has already been overwritten or not yet written.
    """

    def __init__(self, sample_rate: int, capacity_seconds: float = 120.0):
        self.sample_rate = sample_rate
        self.capacity = int(sample_rate * capacity_seconds)
        self._ring = np.zeros(self.capacity, np.int16)
        self._wpos = 0                    # absolute samples written
        self._t0: float | None = None     # wall time of absolute sample 0
        self._lock = threading.Lock()

    def write(self, samples: np.ndarray, timestamp: float | None = None) -> None:
        """Append samples; `timestamp` is the wall time of samples[0]."""
        samples = np.asarray(samples, np.int16)
        n = len(samples)
        if n == 0:
            return
        with self._lock:
            ts = time.time() if timestamp is None else timestamp
            if self._t0 is None:
                self._t0 = ts - self._wpos / self.sample_rate
            start = self._wpos % self.capacity
            end = start + n
            if end <= self.capacity:
                self._ring[start:end] = samples
            else:
                k = self.capacity - start
                self._ring[start:] = samples[:k]
                self._ring[:end - self.capacity] = samples[k:]
            self._wpos += n

    def window(self) -> tuple[float, float] | None:
        """(earliest, latest) wall-clock seconds still held in the ring;
        None before the first write. Lets on-demand clip export answer
        'is that audio still here?' instead of silently zero-filling."""
        with self._lock:
            if self._t0 is None:
                return None
            latest = self._t0 + self._wpos / self.sample_rate
            earliest = self._t0 + max(0, self._wpos - self.capacity) \
                / self.sample_rate
            return earliest, latest

    def read_segment(self, start_time: float, end_time: float) -> np.ndarray:
        """PCM for [start_time, end_time) seconds; zero-filled where absent."""
        if end_time <= start_time:
            return np.zeros(0, np.int16)
        with self._lock:
            n = int(round((end_time - start_time) * self.sample_rate))
            out = np.zeros(n, np.int16)
            if self._t0 is None:
                return out
            a0 = int(round((start_time - self._t0) * self.sample_rate))
            lo = max(a0, self._wpos - self.capacity, 0)
            hi = min(a0 + n, self._wpos)
            if hi <= lo:
                return out
            src0 = lo % self.capacity
            src1 = src0 + (hi - lo)
            if src1 <= self.capacity:
                seg = self._ring[src0:src1]
            else:
                k = self.capacity - src0
                seg = np.concatenate([self._ring[src0:],
                                      self._ring[:src1 - self.capacity]])
            out[lo - a0:hi - a0] = seg
            return out

    @property
    def duration_available(self) -> float:
        with self._lock:
            return min(self._wpos, self.capacity) / self.sample_rate
