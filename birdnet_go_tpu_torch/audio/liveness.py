"""Per-source liveness watchdog.

Reference: internal/audiocore/liveness.go:16-145 — a 5-state machine per
source (HEALTHY → ALARMED → RECOVERING → ESCALATED → FAILED) driven by
silence (no router dispatch within the timeout), with tiered recovery:
first a source restart, then escalation, then notify+give up; quiet-hours
aware (expected silence doesn't alarm).

A copy of ``birdnet_go_tpu/audio/liveness.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import threading
import time
from typing import Callable

log = logging.getLogger("birdnet_tpu.liveness")


class SourceState(str, enum.Enum):
    HEALTHY = "healthy"
    ALARMED = "alarmed"
    RECOVERING = "recovering"
    ESCALATED = "escalated"
    FAILED = "failed"


@dataclasses.dataclass
class LivenessConfig:
    silence_timeout_seconds: float = 60.0
    recovery_timeout_seconds: float = 30.0
    max_recovery_attempts: int = 3


@dataclasses.dataclass
class _SourceTrack:
    state: SourceState = SourceState.HEALTHY
    last_data: float = 0.0
    state_since: float = 0.0
    recovery_attempts: int = 0


class LivenessWatchdog:
    """Polls last-ingest ages; drives restart/escalate/notify callbacks.

    `restart(source_id)` should attempt recovery and return quickly;
    `notify(source_id, state)` reports escalation/failure.
    `is_quiet(source_id)` suppresses alarms during expected silence.
    """

    def __init__(self, config: LivenessConfig | None = None,
                 restart: Callable[[str], None] | None = None,
                 notify: Callable[[str, SourceState], None] | None = None,
                 is_quiet: Callable[[str], bool] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or LivenessConfig()
        self.restart = restart
        self.notify = notify
        self.is_quiet = is_quiet
        self.clock = clock
        self._tracks: dict[str, _SourceTrack] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def track(self, source_id: str) -> None:
        now = self.clock()
        with self._lock:
            self._tracks[source_id] = _SourceTrack(last_data=now,
                                                   state_since=now)

    def untrack(self, source_id: str) -> None:
        with self._lock:
            self._tracks.pop(source_id, None)

    def data_received(self, source_id: str) -> None:
        """Feed from the router/engine dispatch path."""
        now = self.clock()
        with self._lock:
            t = self._tracks.get(source_id)
            if t is None:
                return
            t.last_data = now
            if t.state != SourceState.HEALTHY:
                log.info("source %s recovered (%s → healthy)", source_id,
                         t.state.value)
                t.state = SourceState.HEALTHY
                t.state_since = now
                t.recovery_attempts = 0

    def state_of(self, source_id: str) -> SourceState | None:
        with self._lock:
            t = self._tracks.get(source_id)
            return t.state if t else None

    def check(self) -> None:
        """One watchdog evaluation pass (called by the loop or tests)."""
        now = self.clock()
        cfg = self.config
        with self._lock:
            items = list(self._tracks.items())
        for sid, t in items:
            if self.is_quiet is not None and self.is_quiet(sid):
                # expected silence — and refresh last_data so the quiet
                # window doesn't count as silence the instant it ends
                # (otherwise every source is force-restarted each morning
                # before it has a single watchdog interval to resume)
                t.last_data = now
                continue
            silent_for = now - t.last_data
            if t.state == SourceState.HEALTHY:
                if silent_for > cfg.silence_timeout_seconds:
                    self._transition(sid, t, SourceState.ALARMED, now)
            elif t.state == SourceState.ALARMED:
                # tiered recovery: attempt a restart
                self._transition(sid, t, SourceState.RECOVERING, now)
                t.recovery_attempts += 1
                if self.restart is not None:
                    try:
                        self.restart(sid)
                    except Exception:
                        log.exception("restart of %s failed", sid)
            elif t.state == SourceState.RECOVERING:
                if now - t.state_since > cfg.recovery_timeout_seconds:
                    if t.recovery_attempts >= cfg.max_recovery_attempts:
                        self._transition(sid, t, SourceState.FAILED, now)
                        if self.notify is not None:
                            self.notify(sid, SourceState.FAILED)
                    else:
                        self._transition(sid, t, SourceState.ESCALATED, now)
                        if self.notify is not None:
                            self.notify(sid, SourceState.ESCALATED)
            elif t.state == SourceState.ESCALATED:
                # escalated sources retry recovery on the next pass
                self._transition(sid, t, SourceState.ALARMED, now)

    def _transition(self, sid: str, t: _SourceTrack, to: SourceState,
                    now: float) -> None:
        log.warning("source %s: %s → %s", sid, t.state.value, to.value)
        t.state = to
        t.state_since = now

    def start(self, interval_seconds: float = 10.0) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(interval_seconds,), name="liveness",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.check()
            except Exception:
                log.exception("watchdog pass failed")
