"""Host-side tracing of the port: spans and counters where the work
happens, and the per-batch ring behind ``/api/v2/system/inference/spans``.

Reference: internal/classifier/tracing.go — startPredictSpan wraps every
prediction with invoke-duration data and error taxonomy. Here one recorder,
``GLOBAL_SPANS``, keeps:

- spans: ``span(name, batch=None, **labels)`` times a block on the calling
  thread, ``add(name, t0_ns, t1_ns, ...)`` records one from stored times.
  Each thread keeps a stack of its open spans, so a span knows its parent,
  takes its parent's batch id when given none, and has a self time (its
  duration less the part its children cover). Spans fire once per tick,
  batch, job or commit, never once per window.
- counters: ``count(name, n)``.
- the aggregate of the whole process: per span name and labels the calls,
  total, self and longest ns, and each counter's sum. It is always on;
  ``snapshot()`` copies it (``delta`` of two copies covers a stretch), and
  ``/metrics`` renders it.
- events, while ``record_events(True, capacity)`` is on: each span as
  (name, thread id, start ns, end ns, parent, batch id), up to `capacity`,
  counting those dropped beyond it. Off by default.
- the per-batch ring: ``record()`` keeps one record per device batch, the
  last 512 for ``recent()``; ``summary()`` covers every batch since the
  process started, its percentiles read from fixed buckets.

Every time is ``time.perf_counter_ns()``, the clock that a ``torch.profiler``
trace can be mapped onto with one ``record_function`` mark taken beside a
reading of it; thread ids are the operating system's, as the profiler's
are.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from collections import deque

_MAX_SPANS = 512
# batch latency buckets of summary(): 2**(1/8) apart (9% wide) from 10 µs
# to 22 minutes; a percentile is its bucket's upper edge, at most the max
_BUCKETS_MS = tuple(0.01 * 2 ** (i / 8) for i in range(8 * 27))
_EVENT_CAPACITY = 200_000


class _Span:
    """An open span on its thread's stack (``SpanRecorder.span``)."""

    __slots__ = ("rec", "name", "labels", "batch", "stack", "parent", "t0",
                 "t1", "child")

    def __init__(self, rec: "SpanRecorder", name: str, batch, labels: dict):
        self.rec = rec
        self.name = name
        self.batch = batch
        self.labels = labels

    def __enter__(self) -> "_Span":
        self.stack = stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.batch is None and parent is not None:
            self.batch = parent.batch
        self.child = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = t1 = time.perf_counter_ns()
        self.stack.pop()
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child += dur
        self.rec._close(self.name, self.labels, self.t0, t1,
                        dur - self.child,
                        parent.name if parent is not None else None,
                        self.batch)
        return False                      # never swallow


class SpanRecorder:
    """Spans, counters, events and the per-batch ring (module docstring)."""

    def __init__(self, capacity: int = _MAX_SPANS):
        self._spans: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total = 0
        self._local = threading.local()
        self._batch_ids = itertools.count(1)
        # whole-process aggregate: name, or (name, labels) where a span has
        # labels -> [calls, total ns, self ns, max ns]
        self._agg: dict[str | tuple, list[int]] = {}
        self._counters: dict[str, int] = {}
        self._events: list[tuple] = []
        self._events_on = False
        self._event_capacity = _EVENT_CAPACITY
        self.events_dropped = 0
        # per-batch ring aggregate of every batch since start
        self._hist = [0] * (len(_BUCKETS_MS) + 1)
        self._max_ms = 0.0
        self._errors = 0
        self._by_model: dict[str, int] = {}

    # -- spans and counters ---------------------------------------------------

    def _stack(self) -> list[_Span]:
        try:
            return self._local.stack
        except AttributeError:
            # the thread's id is read once: a system call on each event
            # cost ~10 µs on a virtualised host
            self._local.tid = threading.get_native_id()
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, batch: int | None = None, **labels) -> _Span:
        """Context manager timing its block as span `name` on this
        thread; inside a batch's span it takes that batch's id."""
        return _Span(self, name, batch, labels)

    def add(self, name: str, t0_ns: int, t1_ns: int,
            batch: int | None = None, **labels) -> None:
        """Record a span from stored ``perf_counter_ns`` times: it has no
        children and takes no part of the open span's self time (it need
        not lie inside it), but names that span as its parent and takes
        its batch id when given none."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        if batch is None and parent is not None:
            batch = parent.batch
        self._close(name, labels, t0_ns, t1_ns, t1_ns - t0_ns,
                    parent.name if parent is not None else None, batch)

    def new_batch(self) -> int:
        """A batch id unique in the process."""
        return next(self._batch_ids)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def _close(self, name, labels, t0, t1, self_ns, parent, batch) -> None:
        key = (name, tuple(sorted(labels.items()))) if labels else name
        dur = t1 - t0
        with self._lock:
            a = self._agg.get(key)
            if a is None:
                a = self._agg[key] = [0, 0, 0, 0]
            a[0] += 1
            a[1] += dur
            a[2] += self_ns
            if dur > a[3]:
                a[3] = dur
            if self._events_on:
                if len(self._events) < self._event_capacity:
                    self._events.append((name, self._local.tid, t0, t1,
                                         parent, batch))
                else:
                    self.events_dropped += 1

    def snapshot(self) -> dict:
        """A copy of the aggregate: ``spans`` keyed by the span's name, or
        ``name{k=v,...}`` where it has labels, each {name, labels, calls,
        total_ns, self_ns, max_ns}; ``counters`` by name."""
        with self._lock:
            agg = {k: list(v) for k, v in self._agg.items()}
            counters = dict(self._counters)
        spans = {}
        for key, (calls, total, self_ns, mx) in agg.items():
            name, labels = (key, ()) if isinstance(key, str) else key
            if labels:
                key = name + "{" + ",".join(f"{k}={v}" for k, v in labels) \
                    + "}"
            spans[key] = {"name": name, "labels": dict(labels),
                          "calls": calls, "total_ns": total,
                          "self_ns": self_ns, "max_ns": mx}
        return {"spans": spans, "counters": counters}

    def set_metrics(self, registry) -> None:
        """Set the aggregate's series in a ``utils.metrics`` registry:
        ``birdnet_span_seconds_total``, ``birdnet_span_self_seconds_total``
        and ``birdnet_span_calls_total`` labelled by ``span`` (and the
        span's own labels), and ``birdnet_trace_<counter>_total`` for each
        counter, dots made underscores."""
        snap = self.snapshot()
        for s in snap["spans"].values():
            labels = {**s["labels"], "span": s["name"]}
            registry.gauge("birdnet_span_seconds_total",
                           "host seconds in each span").set(
                s["total_ns"] / 1e9, labels=labels)
            registry.gauge("birdnet_span_self_seconds_total",
                           "host seconds in each span outside its "
                           "children").set(s["self_ns"] / 1e9, labels=labels)
            registry.gauge("birdnet_span_calls_total",
                           "times each span ran").set(s["calls"],
                                                      labels=labels)
        for name, v in snap["counters"].items():
            registry.gauge(
                f"birdnet_trace_{name.replace('.', '_')}_total").set(v)

    def record_events(self, on: bool,
                      capacity: int = _EVENT_CAPACITY) -> None:
        """Start (clearing what was kept) or stop keeping events."""
        with self._lock:
            if on:
                self._events = []
                self.events_dropped = 0
                self._event_capacity = capacity
            self._events_on = on

    def events(self) -> list[tuple]:
        """The events kept since ``record_events(True)``."""
        with self._lock:
            return list(self._events)

    # -- the per-batch ring ---------------------------------------------------

    def record(self, model_id: str, batch: int, fill: float,
               duration_ms: float, ok: bool = True,
               error: str = "") -> None:
        dur = round(duration_ms, 2)
        with self._lock:
            self.total += 1
            self._spans.append({
                "ts": time.time(), "model_id": model_id, "batch": batch,
                "fill": round(fill, 3), "duration_ms": dur,
                "ok": ok, **({"error": error} if error else {})})
            self._hist[bisect.bisect_left(_BUCKETS_MS, dur)] += 1
            if dur > self._max_ms:
                self._max_ms = dur
            if not ok:
                self._errors += 1
            self._by_model[model_id] = self._by_model.get(model_id, 0) + 1

    def recent(self, limit: int = 50) -> list[dict]:
        with self._lock:
            return list(self._spans)[-limit:]

    def summary(self) -> dict:
        """Every batch recorded since the process started."""
        with self._lock:
            n, hist, mx = self.total, list(self._hist), self._max_ms
            errors, by_model = self._errors, dict(self._by_model)
        if not n:
            return {"count": 0, "total": 0}
        cum = list(itertools.accumulate(hist))

        def pct(p):
            # the bucket of the (p·n)-th smallest batch, as the ring's
            # sorted list indexed it
            i = bisect.bisect_right(cum, min(n - 1, int(p * n)))
            return min(_BUCKETS_MS[i], mx) if i < len(_BUCKETS_MS) else mx

        return {
            "count": n, "total": n,
            "p50_ms": pct(0.50), "p90_ms": pct(0.90), "p99_ms": pct(0.99),
            "max_ms": mx, "errors": errors, "by_model": by_model,
        }


def delta(before: dict, after: dict) -> dict:
    """What happened between two ``snapshot()``s: calls, total and self ns
    and counters differenced (``max_ns`` is the later snapshot's)."""
    spans = {}
    for key, s in after["spans"].items():
        b = before["spans"].get(key)
        d = dict(s)
        if b is not None:
            for f in ("calls", "total_ns", "self_ns"):
                d[f] = s[f] - b[f]
        if d["calls"]:
            spans[key] = d
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in after["counters"].items()}
    return {"spans": spans,
            "counters": {k: v for k, v in counters.items() if v}}


GLOBAL_SPANS = SpanRecorder()
span = GLOBAL_SPANS.span
add = GLOBAL_SPANS.add
count = GLOBAL_SPANS.count
new_batch = GLOBAL_SPANS.new_batch
snapshot = GLOBAL_SPANS.snapshot
record_events = GLOBAL_SPANS.record_events
events = GLOBAL_SPANS.events
