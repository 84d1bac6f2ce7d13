"""Circuit breaker (reference: used by birdweather and notification —
internal/birdweather circuit breaker, notification DoS protection).

A copy of ``birdnet_go_tpu/utils/circuit.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import threading
import time


class CircuitBreaker:
    """closed → (N failures) → open → (cooldown) → half-open → closed."""

    def __init__(self, failure_threshold: int = 5,
                 cooldown_seconds: float = 60.0):
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown_seconds
        self._failures = 0
        self._opened_at: float | None = None
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.cooldown:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        return self.state != "open"

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()

    def call(self, fn, *args, **kwargs):
        """Run fn under the breaker; raises CircuitOpenError when open."""
        if not self.allow():
            raise CircuitOpenError("circuit open")
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


class CircuitOpenError(RuntimeError):
    pass
