"""Prometheus-text-format metrics registry (reference: internal/
observability — per-domain counters/gauges/histograms exposed on an
endpoint; no client library needed for the exposition format).

A copy of ``birdnet_go_tpu/utils/metrics.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_api.py`` holds it to the
original.
"""

from __future__ import annotations

import threading
from typing import Iterable


class _Metric:
    def __init__(self, name: str, help_text: str, mtype: str):
        self.name = name
        self.help = help_text
        self.type = mtype
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: dict[str, str] | None) -> tuple:
        return tuple(sorted((labels or {}).items()))

    def _render_labels(self, key: tuple) -> str:
        if not key:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in key)
        return "{" + inner + "}"


class Counter(_Metric):
    def __init__(self, name, help_text=""):
        super().__init__(name, help_text, "counter")

    def inc(self, amount: float = 1.0, labels: dict[str, str] | None = None):
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def render(self) -> Iterable[str]:
        with self._lock:
            for k, v in sorted(self._values.items()):
                yield f"{self.name}{self._render_labels(k)} {v:g}"


class Gauge(_Metric):
    def __init__(self, name, help_text=""):
        super().__init__(name, help_text, "gauge")

    def set(self, value: float, labels: dict[str, str] | None = None):
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def render(self) -> Iterable[str]:
        with self._lock:
            for k, v in sorted(self._values.items()):
                yield f"{self.name}{self._render_labels(k)} {v:g}"


class Histogram(_Metric):
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0)

    def __init__(self, name, help_text="", buckets=None):
        super().__init__(name, help_text, "histogram")
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, labels: dict[str, str] | None = None):
        k = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1

    def render(self) -> Iterable[str]:
        with self._lock:
            for k in sorted(self._counts):
                base = dict(k)
                for i, b in enumerate(self.buckets):
                    lbl = self._render_labels(
                        tuple(sorted({**base, "le": repr(b)}.items())))
                    yield f"{self.name}_bucket{lbl} {self._counts[k][i]}"
                inf = self._render_labels(
                    tuple(sorted({**base, "le": "+Inf"}.items())))
                yield f"{self.name}_bucket{inf} {self._totals[k]}"
                yield (f"{self.name}_sum{self._render_labels(k)} "
                       f"{self._sums[k]:g}")
                yield (f"{self.name}_count{self._render_labels(k)} "
                       f"{self._totals[k]}")


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_text, buckets))

    def _get_or_make(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def render(self) -> str:
        lines = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.type}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()
