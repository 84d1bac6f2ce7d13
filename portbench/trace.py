"""The device trace of a traced run: ``torch.profiler`` over a steady
stretch of the window, reduced to busy seconds, operations by name, idle
gaps named by the benchmark's span the host was in, and one kernel's
device time."""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def profiled(enabled: bool, device: torch.device, out: dict, spans=None):
    """Profile the block's host and device activity when `enabled`;
    fills `out` with the reduced trace (``reduce``). `spans` (a
    ``harness.Spans``) records the benchmark's host spans meanwhile, on
    every thread; a mark on this thread places them on the trace's
    clock."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("pb.mark"):
            mark = time.perf_counter_ns()
        t0 = time.perf_counter()
        if spans is not None:
            spans.record = True
        try:
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            if spans is not None:
                spans.record = False
        wall = time.perf_counter() - t0     # not the profiler's own stop
    host = []
    if spans is not None:
        host = [(n, (a - mark) / 1e3, (b - mark) / 1e3)
                for n, a, b in spans.events]
    out.update(reduce(prof, wall, host))


def _events(prof):
    """(name, is_device, start_us, end_us, thread) of every event."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            dev = "cuda" in str(e.device_type()).lower()
            start = e.start_ns() / 1e3 if hasattr(e, "start_ns") \
                else float(e.start_us())
            dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") \
                else float(e.duration_us())
            tid = e.start_thread_id() if hasattr(e, "start_thread_id") \
                else 0
            out.append((e.name(), dev, start, start + dur, tid))
        return out
    for e in prof.events():
        dev = "cuda" in str(e.device_type).lower()
        out.append((e.name, dev, float(e.time_range.start),
                    float(e.time_range.end), getattr(e, "thread", 0)))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(prof, wall_s: float, host=()) -> dict:
    """busy_s, window_s, device ops by total seconds, the longest idle
    gaps named by the innermost host span covering their middle, and the
    device events by name (for kernel readers). `host` holds (name, start
    µs, end µs) measured from the ``pb.mark`` event's start."""
    events = _events(prof)
    marks = [s for n, d, s, e, _ in events if not d and n == "pb.mark"]
    base = marks[0] if marks else 0.0
    # a record_function also shows on the device's timeline as a user
    # annotation; it is the host's, not device work
    dev = [(n, s, e) for n, d, s, e, _ in events
           if d and e > s and not n.startswith("pb.")]
    spans = [(n, s + base, e + base) for n, s, e in host]
    merged = _union((s, e) for _, s, e in dev)
    busy_us = sum(e - s for s, e in merged)
    by_name: dict[str, list] = {}
    for n, s, e in dev:
        rec = by_name.setdefault(n, [0.0, 0])
        rec[0] += (e - s) / 1e6
        rec[1] += 1
    ops = sorted(((n[:160], v[0]) for n, v in by_name.items()),
                 key=lambda x: -x[1])[:10]
    gaps = []
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        inner = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        name = min(inner)[1] if inner else "outside any span"
        gaps.append((name, (s1 - e0) / 1e6))
    gaps.sort(key=lambda x: -x[1])
    return {"busy_s": busy_us / 1e6, "window_s": wall_s,
            "device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps[:10]],
            "kernels": {n: {"seconds": v[0], "count": v[1]}
                        for n, v in by_name.items()},
            "device_events": len(dev)}


def kernel_time(trace: dict, needle: str) -> tuple[float, int]:
    """(device seconds, launches) of kernels whose name holds `needle`."""
    secs, count = 0.0, 0
    for name, rec in trace.get("kernels", {}).items():
        if needle in name:
            secs += rec["seconds"]
            count += rec["count"]
    return secs, count
