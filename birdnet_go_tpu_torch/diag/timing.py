"""Device times on a CUDA card, by CUDA events, in two ways.

- Per call (``event_ms``, ``timed_pair``, ``median_ms_pair``): one call
  between two events. Where a call's host work (checks, allocation, the
  ctypes launch) takes longer than its kernel, as for the MBConv kernels at
  most fused block shapes, the card waits between the events and this
  measures the host.
- By graph replay (``graph_ms``, ``graph_ms_pair``): ``GRAPH_CALLS`` calls
  captured in one CUDA graph, replayed between two events: the device time
  of one call with the host's work taken out, as in a step that keeps the
  card busy.

Pairs are timed in turns (plain, kernel, kernel, plain) after a warm-up of
each, so that a drift of the card's clocks falls on both.
"""

from __future__ import annotations

import numpy as np
import torch

REPS = 10
GRAPH_CALLS = 10


def event_ms(fn) -> float:
    """Device time of one call of `fn`, by CUDA events."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def _in_turns(plain, kernel) -> tuple[list[float], list[float]]:
    """REPS samples of each zero-argument timer, taken in turns."""
    tp, tk = [], []
    for _ in range(REPS // 2):
        tp.append(plain())
        tk += [kernel(), kernel()]
        tp.append(plain())
    return tp, tk


def timed_pair(plain, kernel) -> tuple[list[float], list[float]]:
    """Two callables' per-call event times, in turns, after a warm-up of
    each."""
    plain(), kernel()
    torch.cuda.synchronize()
    return _in_turns(lambda: event_ms(plain), lambda: event_ms(kernel))


def median_ms_pair(plain, kernel) -> tuple[float, float]:
    """Medians of ``timed_pair``'s times."""
    tp, tk = timed_pair(plain, kernel)
    return float(np.median(tp)), float(np.median(tk))


def graph_of(fn, calls: int = GRAPH_CALLS) -> torch.cuda.CUDAGraph:
    """`calls` calls of `fn` captured in one CUDA graph, after a warm-up
    on the current stream and on a side stream."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    # relaxed: the launchers set a kernel attribute while capturing
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return g


def _replay_ms(g: torch.cuda.CUDAGraph) -> float:
    return event_ms(g.replay) / GRAPH_CALLS


def graph_ms_pair(plain, kernel) -> tuple[float, float]:
    """Median device ms of one call of each, by graph replay, in turns."""
    gp, gk = graph_of(plain), graph_of(kernel)
    tp, tk = _in_turns(lambda: _replay_ms(gp), lambda: _replay_ms(gk))
    return float(np.median(tp)), float(np.median(tk))


def graph_ms(fn) -> float:
    """Median device ms of one call of `fn`, by graph replay."""
    g = graph_of(fn)
    return float(np.median([_replay_ms(g) for _ in range(REPS)]))
