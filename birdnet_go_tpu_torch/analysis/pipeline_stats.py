"""Periodic pipeline throughput logging.

Reference: internal/analysis/processor/pipeline_stats.go — a stats logger
that periodically emits one line summarizing the hot path (windows
analyzed, queue pressure, drops) so operators can read health from the
log stream without scraping /metrics.

A copy of ``birdnet_go_tpu/analysis/pipeline_stats.py`` for the port,
which imports nothing of the JAX package; ``tests/test_torch_app.py``
holds it to the original.
"""

from __future__ import annotations

import logging
import threading
import time

log = logging.getLogger("birdnet_tpu.pipeline")


class PipelineStatsLogger:
    """One INFO line per interval with per-model deltas; silent while the
    pipeline is idle (no windows since the last line)."""

    def __init__(self, device_loop, processor=None,
                 interval_seconds: float = 60.0):
        from birdnet_go_tpu_torch.analysis.eventtracker import LogDeduplicator

        self.device_loop = device_loop
        self.processor = processor
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last: dict[str, tuple[int, int, int]] = {}
        self._last_dropped = 0
        self.lines_emitted = 0
        # steady-state suppression: identical stats (rates bucketed to
        # 10 win/s) log once, then re-log on change or every 10 min
        # (reference: log_deduplicator.go should_log semantics)
        self.dedup = LogDeduplicator(health_check_interval=600.0)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="pipeline-stats", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def tick(self, now: float | None = None) -> str | None:
        """Compute + log one summary line; returns it (None when idle)."""
        parts = []
        key_parts = []
        total_windows = 0
        for model_id, b in self.device_loop.batchers.items():
            s = b.stats
            prev = self._last.get(model_id, (0, 0, 0))
            dw = s.windows_processed - prev[0]
            d_over = s.overruns - prev[1]
            d_def = s.windows_deferred - prev[2]
            self._last[model_id] = (s.windows_processed, s.overruns,
                                    s.windows_deferred)
            total_windows += dw
            # healthy steady state buckets coarsely (10 win/s) so rate
            # jitter doesn't defeat suppression; unhealthy deltas key
            # exactly so consecutive incidents keep logging
            key_parts.append((model_id, round(dw / self.interval / 10),
                              d_over, d_def))
            if dw or d_over or d_def:
                parts.append(
                    f"{model_id}: {dw / self.interval:.1f} win/s"
                    f" fill={s.last_batch_fill:.0%}"
                    f" lat={s.last_latency_ms:.0f}ms"
                    + (f" overruns+{d_over}" if d_over else "")
                    + (f" deferred+{d_def}" if d_def else ""))
        dropped = getattr(self.device_loop, "windows_dropped", 0)
        d_drop = dropped - self._last_dropped
        self._last_dropped = dropped
        if d_drop:
            parts.append(f"dropped+{d_drop}")
        pending = 0
        if self.processor is not None:
            pending = len(getattr(self.processor, "_pending", {}) or {})
            if pending:
                parts.append(f"pending={pending}")
        if not parts:
            return None                   # idle: don't spam the log
        # NB: a zero-throughput interval still logs when something
        # noteworthy happened (overruns, deferrals, drops, pending
        # backlog) — those are exactly the unhealthy intervals an
        # operator needs to see
        line = "pipeline: " + " | ".join(parts)
        # unhealthy intervals (any overrun/deferral/drop delta) bypass the
        # dedup entirely: during an ongoing incident every interval logs.
        # Healthy steady state dedups on (bucketed rate, bucketed pending)
        # so a silently growing backlog still breaks suppression.
        unhealthy = bool(d_drop) or any(k[2] or k[3] for k in key_parts)
        key_parts.append(("pending", round(pending / 10)))
        # should_log also records the key, so the first healthy interval
        # after an incident differs from the stored unhealthy key and the
        # "back to normal" line is emitted rather than suppressed
        ok, _reason = self.dedup.should_log("pipeline", tuple(key_parts))
        if not ok and not unhealthy:
            return None
        log.info(line)
        self.lines_emitted += 1
        return line

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                log.exception("pipeline stats tick failed")
