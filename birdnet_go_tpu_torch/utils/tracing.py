"""Prediction tracing: a span per device dispatch (a copy of
``birdnet_go_tpu/utils/tracing.py``, so that the port imports nothing of the
JAX package; ``tests/test_torch_hostplane.py`` holds it to the original).

Reference: internal/classifier/tracing.go — startPredictSpan wraps every
prediction with invoke-duration data and error taxonomy, feeding Sentry
when telemetry is enabled. Here a span records the batched device step
(model, batch size, fill, queue→result latency); spans land in a rolling
ring for /system/inference/spans and, when telemetry is on, aggregate
into periodic transaction envelopes rather than one event per batch
(thousands of batches/minute would flood any DSN).
"""

from __future__ import annotations

import threading
import time
from collections import deque

_MAX_SPANS = 512


class SpanRecorder:
    """Lock-protected rolling span ring + aggregate percentiles."""

    def __init__(self, capacity: int = _MAX_SPANS):
        self._spans: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total = 0

    def record(self, model_id: str, batch: int, fill: float,
               duration_ms: float, ok: bool = True,
               error: str = "") -> None:
        with self._lock:
            self.total += 1
            self._spans.append({
                "ts": time.time(), "model_id": model_id, "batch": batch,
                "fill": round(fill, 3), "duration_ms": round(duration_ms, 2),
                "ok": ok, **({"error": error} if error else {})})

    def recent(self, limit: int = 50) -> list[dict]:
        with self._lock:
            return list(self._spans)[-limit:]

    def summary(self) -> dict:
        with self._lock:
            spans = list(self._spans)
        if not spans:
            return {"count": 0, "total": self.total}
        durs = sorted(s["duration_ms"] for s in spans)

        def pct(p):
            return durs[min(len(durs) - 1, int(p * len(durs)))]

        return {
            "count": len(spans), "total": self.total,
            "p50_ms": pct(0.50), "p90_ms": pct(0.90), "p99_ms": pct(0.99),
            "max_ms": durs[-1],
            "errors": sum(1 for s in spans if not s["ok"]),
            "by_model": {
                m: sum(1 for s in spans if s["model_id"] == m)
                for m in {s["model_id"] for s in spans}},
        }


GLOBAL_SPANS = SpanRecorder()


class predict_span:
    """Context manager mirroring startPredictSpan: times the wrapped
    dispatch+harvest and records success/failure."""

    def __init__(self, model_id: str, batch: int, fill: float = 1.0,
                 recorder: SpanRecorder | None = None):
        self.model_id = model_id
        self.batch = batch
        self.fill = fill
        self.recorder = recorder or GLOBAL_SPANS

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = (time.monotonic() - self._t0) * 1000.0
        self.recorder.record(self.model_id, self.batch, self.fill, dur,
                             ok=exc_type is None,
                             error=str(exc) if exc else "")
        return False                      # never swallow
