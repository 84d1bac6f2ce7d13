"""Async event bus (reference: internal/events/eventbus.go:60 — non-blocking
publish, per-consumer bounded queues, dedup, slow-consumer detection).

Carries detection events (datastore save → alerting/notifications) and
error events (enhanced errors → telemetry) without coupling producers to
consumers.

A copy of ``birdnet_go_tpu/utils/events.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_app.py`` holds it to the
original.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable

log = logging.getLogger("birdnet_tpu.events")


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str                       # "detection" | "error" | "health" | ...
    payload: Any
    dedup_key: str | None = None
    timestamp: float = dataclasses.field(default_factory=time.time)


class EventBus:
    """Non-blocking fan-out with per-consumer bounded queues."""

    def __init__(self, queue_size: int = 256, dedup_window_seconds: float = 60.0):
        self._consumers: list[tuple[str, queue.Queue, Callable[[Event], None],
                                    threading.Thread]] = []
        self._queue_size = queue_size
        self._dedup: dict[str, float] = {}
        self._dedup_window = dedup_window_seconds
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self.published = 0
        self.deduped = 0
        self.dropped: dict[str, int] = {}
        self.slow_consumers: set[str] = set()
        # rolling operational history for /system/events/operational
        from collections import deque

        self._history: "deque[Event]" = deque(maxlen=200)

    def subscribe(self, name: str, handler: Callable[[Event], None],
                  kinds: set[str] | None = None) -> None:
        q: queue.Queue = queue.Queue(maxsize=self._queue_size)

        def _run():
            while not self._stopped.is_set():
                try:
                    ev = q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if ev is None:
                    return
                if kinds is not None and ev.kind not in kinds:
                    continue
                try:
                    handler(ev)
                except Exception:
                    log.exception("event consumer %s failed", name)

        t = threading.Thread(target=_run, name=f"events-{name}", daemon=True)
        t.start()
        with self._lock:
            self._consumers.append((name, q, handler, t))

    def publish(self, event: Event) -> bool:
        """Never blocks. Returns False if deduped or dropped everywhere."""
        if event.dedup_key:
            now = time.time()
            with self._lock:
                last = self._dedup.get(event.dedup_key)
                if last is not None and now - last < self._dedup_window:
                    self.deduped += 1
                    return False
                self._dedup[event.dedup_key] = now
                if len(self._dedup) > 4096:       # bounded dedup memory
                    cutoff = now - self._dedup_window
                    self._dedup = {k: v for k, v in self._dedup.items()
                                   if v >= cutoff}
        delivered = False
        with self._lock:
            consumers = list(self._consumers)
        for name, q, _, _ in consumers:
            try:
                q.put_nowait(event)
                delivered = True
            except queue.Full:
                with self._lock:
                    self.dropped[name] = self.dropped.get(name, 0) + 1
                    self.slow_consumers.add(name)
        self.published += 1
        with self._lock:
            self._history.append(event)
        return delivered

    def recent(self, limit: int = 50, kind: str | None = None) -> list[dict]:
        """Newest-last operational event history (the observability event
        buffer the reference's System Health page reads)."""
        with self._lock:
            evs = list(self._history)
        if kind:
            evs = [e for e in evs if e.kind == kind]
        return [{"kind": e.kind, "timestamp": e.timestamp,
                 "payload": e.payload} for e in evs[-limit:]]

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            consumers = list(self._consumers)
        for name, q, _, t in consumers:
            try:
                q.put_nowait(None)
            except queue.Full:
                pass
            t.join(timeout=2)
