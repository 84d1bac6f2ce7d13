"""AudioEngine: sources → capture/analysis buffers → window provider.

Reference: internal/audiocore/engine/engine.go (owns registry + router +
buffer manager) and internal/analysis/buffer_consumer.go (each frame →
CaptureBuffer at source rate + per-model AnalysisBuffers, resampling once
per unique target rate).

Sources push int16 PCM via `ingest()`; the engine maintains per-(source,
model) AnalysisBuffers with the model's BufferDimensions overlap semantics
and exposes `collect_ready()` — the DeviceLoop provider that drains every
ready window each tick.

A copy of ``birdnet_go_tpu/audio/engine.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_app.py`` holds it to the
original. Two divergences: the analysis rings are always the native
library's (``_make_analysis_buffer``), and ``ingest`` passes through the
engine's ``SourceGate``, which the app's device loop closes for each tick
and its batchers for each eager step they launch, and which a warm-up
holds open (no closing overlaps it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

import numpy as np

from birdnet_go_tpu_torch import native
from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer, CaptureBuffer
from birdnet_go_tpu_torch.audio.resampler import StreamingResampler
from birdnet_go_tpu_torch.audio.source import AudioSource, SourceRegistry
from birdnet_go_tpu_torch.models.registry import ModelSpec

log = logging.getLogger("birdnet_tpu.engine")


def _make_analysis_buffer(overlap_samples: int, read_samples: int,
                          capacity_samples: int):
    """The C++ ring buffer of the port's native library on the hot path.
    Where the JAX engine falls back to the Python ``AnalysisBuffer`` when
    its library is missing, the port's library builds on first use and
    raises when it cannot (``native/lib.py``), so nothing falls back."""
    return native.NativeAnalysisBuffer(overlap_samples, read_samples,
                                       capacity_samples)


class SourceGate:
    """Keeps the source threads off the GIL while the device loop works.

    The served step's eager ops (about a thousand a batch for v2.4) each
    release the GIL and take it back. Every source thread that waits for
    the GIL then takes a turn at each op, and on a host whose cores are
    busy each turn waits for the scheduler as well. In the app on an H100
    host a v2.4 launch took 49.5 ms among 64 source threads against
    10.6 ms alone, and with the host's cores loaded it grew to seconds.
    JAX's jitted step takes the GIL once a batch and needs no gate.

    The device loop's tick has the same trouble at each native ring it
    polls (ctypes releases the GIL too), so the app's ``DeviceLoop``
    holds the gate closed for a whole tick and its batchers for a launch.
    The sources, not the tick, then take what a busy host withholds: a
    ``ToneSource`` that falls behind pushes what it owes in one push, a
    ``FileLoopSource`` resumes its pace from now, and a live source
    (``RtspSource``, ``SoundcardSource``) backs up into its socket or its
    card's ring.

    A warm-up holds the gate open instead (``warming()``): its first
    call's set-up (up to 1.2 s for v3.0 on an NVIDIA H100 80GB HBM3,
    700.00 W) would hold every source that long, and a tick that closed
    the gate beside it traded the GIL with it for as long (a 397.8 ms
    closing beside v3.0's 451.5 ms warm-up on that card). No closing
    overlaps a running warm-up: ``closed()`` waits until every warm-up
    of another thread has ended, and ``warming()`` until every closing
    of another thread has ended; a closing that waits holds off new
    warm-ups, so a tick waits for at most the warm-ups already running.
    A thread's own warm-up and closings do not wait on each other, nor
    does a nested warm-up or closing (either would wait on itself).

    ``turn()`` is a source's pass through ``AudioEngine.ingest``; any
    number run at once. ``closed()`` is a tick or a launch: it stops new
    turns, waits for the running ones and holds them off until it ends,
    so the source threads wait on a lock instead of the GIL. Closings do
    not exclude each other and may nest. Turns may not: a turn inside a
    turn can deadlock against a closing that waits between them."""

    def __init__(self):
        self._cond = threading.Condition()
        self._closings = 0
        self._turns = 0
        # thread ident -> closings / warm-ups that thread holds
        self._closers: dict[int, int] = {}
        self._warmers: dict[int, int] = {}
        self._closers_waiting = 0

    @staticmethod
    def _others(held: dict[int, int], me: int) -> bool:
        return any(n for t, n in held.items() if t != me)

    @contextlib.contextmanager
    def turn(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._closings)
            self._turns += 1
        try:
            yield
        finally:
            with self._cond:
                self._turns -= 1
                if not self._turns:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def closed(self):
        me = threading.get_ident()
        with self._cond:
            if not self._closers.get(me):
                # a nested closing passes: warm-ups already wait on it
                self._closers_waiting += 1
                self._cond.wait_for(
                    lambda: not self._others(self._warmers, me))
                self._closers_waiting -= 1
            self._closings += 1
            self._closers[me] = self._closers.get(me, 0) + 1
            self._cond.wait_for(lambda: not self._turns)
        try:
            yield
        finally:
            with self._cond:
                self._closings -= 1
                self._closers[me] -= 1
                if not self._closers[me]:
                    del self._closers[me]
                self._cond.notify_all()

    @contextlib.contextmanager
    def warming(self):
        """Held by a warm-up while it runs: the gate stays open, and no
        other thread's closing begins until it ends."""
        me = threading.get_ident()
        with self._cond:
            self._cond.wait_for(
                lambda: self._warmers.get(me) or (
                    not self._others(self._closers, me)
                    and (not self._closers_waiting
                         or self._closers.get(me))))
            self._warmers[me] = self._warmers.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                self._warmers[me] -= 1
                if not self._warmers[me]:
                    del self._warmers[me]
                self._cond.notify_all()


@dataclasses.dataclass
class _ModelTap:
    spec: ModelSpec
    resampler: StreamingResampler | None      # None = no resample needed
    buffer: AnalysisBuffer
    rate: int                                 # samples/s as stored in buffer


class _StreamState:
    def __init__(self, source: AudioSource, specs: list[ModelSpec],
                 capture_seconds: float, overlaps: dict[str, float],
                 eq_specs: list[dict] | None = None):
        self.source = source
        self.capture = CaptureBuffer(source.sample_rate, capture_seconds)
        self.taps: list[_ModelTap] = []
        self.last_ingest = 0.0
        # per-stream equalizer chain at the SOURCE rate, applied before
        # any consumer (the router's processing path — equalizer.go);
        # swapped atomically by replacing the chain object
        self.eq = None
        if eq_specs:
            from birdnet_go_tpu_torch.audio.equalizer import FilterChain

            self.eq = FilterChain.from_config(source.sample_rate, eq_specs)
        # samples already delivered per model (drives window start times)
        for spec in specs:
            self.add_tap(spec, overlaps)

    def add_tap(self, spec: ModelSpec, overlaps: dict[str, float]) -> None:
        source = self.source
        # Bat raw-rate trick: when the source captures at the model's
        # raw_sample_rate, audio is fed UNRESAMPLED (slow-down trick,
        # detection-pipeline.md:103-117). Otherwise resample to the
        # model's consume rate.
        if spec.raw_sample_rate and \
                source.sample_rate == spec.raw_sample_rate:
            rs = None
        elif source.sample_rate == spec.sample_rate:
            rs = None
        else:
            rs = StreamingResampler(source.sample_rate, spec.sample_rate)
        # Buffer samples arrive at the source rate when fed unresampled
        # (incl. the bat 256 kHz passthrough), else at the model rate —
        # this rate drives wall-clock window timing in collect_ready.
        rate = source.sample_rate if rs is None else spec.sample_rate
        overlap_s = overlaps.get(spec.model_id, 0.0)
        clip = spec.clip_samples
        # AnalysisBuffer dims: default 50% overlap unless the user set
        # an explicit overlap (scaled per model — overlap.go:8).
        if overlap_s > 0:
            from birdnet_go_tpu_torch.ops.windows import window_hop_samples

            hop = window_hop_samples(clip, overlap_s, spec.sample_rate,
                                     clip_seconds=spec.clip_seconds)
            overlap_n = clip - hop
        else:
            overlap_n = clip // 2          # BufferDimensions default
        buf = _make_analysis_buffer(
            overlap_samples=overlap_n, read_samples=clip - overlap_n,
            capacity_samples=4 * clip)
        self.taps.append(_ModelTap(spec=spec, resampler=rs, buffer=buf,
                                   rate=rate))


class AudioEngine:
    """Owns stream state; thread-safe ingest + window collection."""

    def __init__(self, specs: list[ModelSpec],
                 capture_seconds: float = 120.0,
                 overlaps: dict[str, float] | None = None,
                 on_ingest=None, eq_specs: list[dict] | None = None):
        self.specs = specs
        self.capture_seconds = capture_seconds
        self.overlaps = overlaps or {}
        self.eq_specs = eq_specs or []
        self.registry = SourceRegistry()
        self._streams: dict[str, _StreamState] = {}
        self._lock = threading.Lock()
        self.on_ingest = on_ingest          # liveness watchdog feed
        self.gate = SourceGate()

    # -- sources -------------------------------------------------------------------

    def add_source(self, source: AudioSource) -> None:
        self.registry.add(source)
        with self._lock:
            self._streams[source.source_id] = _StreamState(
                source, self.specs, self.capture_seconds, self.overlaps,
                eq_specs=self.eq_specs)
        log.info("source added: %s (%s @ %d Hz)", source.source_id,
                 source.source_type.value, source.sample_rate)

    def remove_source(self, source_id: str) -> None:
        self.registry.remove(source_id)
        with self._lock:
            self._streams.pop(source_id, None)

    # -- runtime model management (orchestrator LoadModel rewires monitors) ----------

    def add_model(self, spec: ModelSpec) -> None:
        """Register a new model while serving: existing streams get a tap so
        the model immediately receives windows (buffer_manager UpdateMonitors
        analogue — a model loaded at runtime must not analyze nothing)."""
        with self._lock:
            if any(s.model_id == spec.model_id for s in self.specs):
                return
            self.specs.append(spec)
            for st in self._streams.values():
                st.add_tap(spec, self.overlaps)

    def remove_model(self, model_id: str) -> None:
        with self._lock:
            self.specs = [s for s in self.specs if s.model_id != model_id]
            for st in self._streams.values():
                st.taps = [t for t in st.taps
                           if t.spec.model_id != model_id]

    def set_equalizer(self, eq_specs: list[dict] | None) -> None:
        """Hot-swap the equalizer chain on every live stream (builder.go:
        chains are immutable; the swap is a reference replacement). Biquad
        state resets — one filter-length transient, same as the reference's
        rebuild."""
        from birdnet_go_tpu_torch.audio.equalizer import FilterChain

        with self._lock:
            self.eq_specs = eq_specs or []
            for st in self._streams.values():
                st.eq = (FilterChain.from_config(st.source.sample_rate,
                                                 self.eq_specs)
                         if self.eq_specs else None)

    def capture_buffer(self, source_id: str) -> CaptureBuffer | None:
        with self._lock:
            st = self._streams.get(source_id)
            return st.capture if st else None

    def sources(self) -> list[AudioSource]:
        return self.registry.list()

    # -- ingest (called from source reader threads) -----------------------------------

    def ingest(self, source_id: str, pcm_i16: np.ndarray,
               timestamp: float | None = None) -> None:
        """Push int16 PCM at the source rate; fans out to capture buffer
        and every model's analysis buffer (BufferConsumer.Write analogue).
        Waits while a tick or a launch holds ``gate`` closed."""
        with self.gate.turn():
            self._ingest(source_id, pcm_i16, timestamp)

    def _ingest(self, source_id: str, pcm_i16: np.ndarray,
                timestamp: float | None) -> None:
        with self._lock:
            st = self._streams.get(source_id)
        if st is None:
            return
        ts = time.time() if timestamp is None else timestamp
        st.last_ingest = ts
        if self.on_ingest is not None:
            self.on_ingest(source_id)
        eq = st.eq
        if eq is not None:
            # equalize BEFORE any consumer (capture, HLS, analysis) — the
            # reference filters in the router path ahead of fan-out
            y = eq.process(pcm_i16.astype(np.float32))
            pcm_i16 = np.clip(y, -32768, 32767).astype(np.int16)
        st.capture.write(pcm_i16, timestamp=ts)
        f32 = None
        for tap in st.taps:
            if tap.resampler is None:
                tap.buffer.write(pcm_i16)
            else:
                if f32 is None:
                    f32 = pcm_i16.astype(np.float32) / 32768.0
                out = tap.resampler.process(f32)
                if len(out):
                    tap.buffer.write(
                        np.clip(out * 32768.0, -32768, 32767).astype(np.int16))

    # -- window provider for the DeviceLoop ----------------------------------------------

    def collect_ready(self) -> list[tuple[str, np.ndarray, str, float, int]]:
        """Drain every ready window: [(model_id, pcm_i16, source_id,
        start_time, pcm_rate)]. Each window's start is derived from the tap's
        consumed-sample position relative to the last-ingest wall clock, so
        windows drained in the same tick (startup backlog, stalled tick,
        speed>1 file sources) carry distinct, correct spans — the reference
        stamps each window at its own dispatch (buffer_manager.go:489-492)."""
        out = []
        with self._lock:
            streams = list(self._streams.values())
        for st in streams:
            for tap in st.taps:
                while True:
                    w = tap.buffer.read()
                    if w is None:
                        break
                    # The window's final sample sits `available()` samples
                    # behind the write head (= last_ingest); the window spans
                    # len(w) buffer samples at the tap's stored rate (source
                    # rate for the bat raw passthrough, model rate otherwise).
                    behind = (tap.buffer.available() + len(w)) / tap.rate
                    start = st.last_ingest - behind
                    out.append((tap.spec.model_id, w,
                                st.source.source_id, start, tap.rate))
        return out

    # -- health ---------------------------------------------------------------------------

    def stream_health(self) -> dict[str, dict]:
        now = time.time()
        with self._lock:
            return {
                sid: {
                    "last_ingest_age_s": (now - st.last_ingest
                                          if st.last_ingest else None),
                    "capture_seconds_buffered": st.capture.duration_available,
                    "overwrite_rates": {
                        t.spec.model_id: t.buffer.overwrite_rate()
                        for t in st.taps},
                }
                for sid, st in self._streams.items()
            }
