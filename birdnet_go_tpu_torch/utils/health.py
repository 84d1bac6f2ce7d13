"""Health check registry + error ring buffer.

Reference: internal/health — named checks (audio, analysis, database,
network, range filter, streams, system) each returning status + detail,
aggregated for the System Health page; an slog handler tees WARN+ records
into a bounded ring buffer surfaced via the API (main.go:139-150).

A copy of ``birdnet_go_tpu/utils/health.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_app.py`` holds it to the
original.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable


@dataclasses.dataclass
class CheckResult:
    name: str
    healthy: bool
    detail: str = ""
    latency_ms: float = 0.0


class HealthRegistry:
    def __init__(self):
        self._checks: dict[str, Callable[[], CheckResult]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, check: Callable[[], CheckResult]) -> None:
        with self._lock:
            self._checks[name] = check

    def run_all(self) -> list[CheckResult]:
        with self._lock:
            checks = dict(self._checks)
        out = []
        for name, fn in checks.items():
            t0 = time.monotonic()
            try:
                res = fn()
            except Exception as e:  # a crashing check is itself unhealthy
                res = CheckResult(name=name, healthy=False,
                                  detail=f"{type(e).__name__}: {e}")
            res.latency_ms = (time.monotonic() - t0) * 1000.0
            out.append(res)
        return out

    def overall(self) -> bool:
        return all(r.healthy for r in self.run_all())


class ErrorRingBuffer(logging.Handler):
    """Logging handler keeping the last N WARN+ records for the API."""

    def __init__(self, capacity: int = 256, level=logging.WARNING):
        super().__init__(level=level)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock2 = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        entry = {
            "time": record.created,
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        # EnhancedError taxonomy: ErrorBuilder.build() logs the error
        # object itself; exc_info carries one when raised — surface
        # component/category/context in /system/errors either way
        cands = list(record.args or ())
        if record.exc_info and record.exc_info[1] is not None:
            cands.append(record.exc_info[1])
        for c in cands:
            if getattr(c, "category", None) and hasattr(c, "as_dict"):
                entry["component"] = c.component
                entry["category"] = c.category
                if c.context:
                    entry["context"] = dict(c.context)
                break
        with self._lock2:
            self._ring.append(entry)

    def recent(self, limit: int = 50) -> list[dict]:
        with self._lock2:
            items = list(self._ring)
        return items[-limit:]


GLOBAL_ERROR_BUFFER = ErrorRingBuffer()
