"""System resource monitor → alerting engine.

Reference: internal/monitor — a PURE metric collector: it samples CPU,
memory, and per-mount disk usage on a poll interval and publishes the
samples to the alerting engine (alerting.TryPublish); threshold
evaluation lives in user-configurable metric ALERT RULES, not here.
Disk paths critical to the deployment (database, clip exports, config
dir, plus configured extras) are auto-detected and deduplicated by
mount point so one physical volume produces one metric stream
(critical_paths.go GroupPathsByMountPoint).

A copy of ``birdnet_go_tpu/utils/monitor.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from pathlib import Path

log = logging.getLogger("birdnet_tpu.monitor")


def dedupe_by_mount(paths: list[str]) -> list[str]:
    """One representative path per distinct filesystem (st_dev), keeping
    the shortest existing path. Missing paths are dropped (a detached
    volume is not monitorable). GroupPathsByMountPoint analogue."""
    by_dev: dict[int, str] = {}
    for raw in paths:
        if not raw:
            continue
        p = Path(raw)
        if not p.exists():
            p = p.parent
            if not p.exists():
                continue
        try:
            dev = p.stat().st_dev
        except OSError:
            continue
        cur = by_dev.get(dev)
        if cur is None or len(str(p)) < len(cur):
            by_dev[dev] = str(p)
    return sorted(by_dev.values())


class SystemMonitor:
    """Polls cpu%, memory%, disk% and feeds alerting.publish_metric."""

    def __init__(self, alerting, settings,
                 extra_paths: list[str] | None = None):
        self.alerting = alerting
        self.settings = settings
        self.extra_paths = list(extra_paths or [])
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._prev_cpu: tuple[float, float] | None = None
        self.samples_published = 0

    # -- critical paths (critical_paths.go) ---------------------------------------

    def critical_paths(self) -> list[str]:
        s = self.settings
        candidates = list(getattr(s.monitoring, "disk_paths", []) or [])
        candidates += self.extra_paths
        if getattr(s.database, "path", None):
            candidates.append(str(Path(s.database.path).parent or "."))
        if getattr(s.export, "enabled", False):
            candidates.append(s.export.path)
        if s.data_dir:
            candidates.append(s.data_dir)
        # container volume conventions
        for vol in ("/data", "/config"):
            if os.path.isdir(vol):
                candidates.append(vol)
        return dedupe_by_mount(candidates)

    # -- sampling -------------------------------------------------------------------

    def _cpu_percent(self) -> float | None:
        """Whole-system CPU %% from /proc/stat deltas (first call primes
        the baseline and publishes nothing)."""
        try:
            with open("/proc/stat") as f:
                parts = f.readline().split()[1:]
            vals = [float(x) for x in parts[:8]]
        except (OSError, ValueError, IndexError):
            return None
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)
        total = sum(vals)
        prev = self._prev_cpu
        self._prev_cpu = (idle, total)
        if prev is None or total <= prev[1]:
            return None
        d_total = total - prev[1]
        d_idle = idle - prev[0]
        return max(0.0, min(100.0, 100.0 * (1.0 - d_idle / d_total)))

    @staticmethod
    def _memory_percent() -> float | None:
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    info[k] = float(v.split()[0])
            avail = info.get("MemAvailable", info.get("MemFree", 0.0))
            total = info["MemTotal"]
        except (OSError, KeyError, ValueError, IndexError):
            return None
        return max(0.0, min(100.0, 100.0 * (1.0 - avail / total)))

    def sample_once(self) -> int:
        """One poll: publish enabled metrics; returns samples published."""
        m = self.settings.monitoring
        n = 0
        if m.cpu:
            cpu = self._cpu_percent()
            if cpu is not None:
                self.alerting.publish_metric("cpu", cpu)
                n += 1
        if m.memory:
            mem = self._memory_percent()
            if mem is not None:
                self.alerting.publish_metric("memory", mem)
                n += 1
        if m.disk:
            for path in self.critical_paths():
                try:
                    u = shutil.disk_usage(path)
                except OSError:
                    continue
                pct = 100.0 * (u.total - u.free) / u.total if u.total else 0
                self.alerting.publish_metric("disk", pct, path=path)
                n += 1
        self.samples_published += n
        return n

    # -- loop -------------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="system-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        interval = float(self.settings.monitoring.check_interval_seconds)
        # prime the CPU baseline so the first published value is a real
        # interval average, not garbage
        self._cpu_percent()
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:
                log.exception("resource sample failed")
