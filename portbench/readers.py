"""The readers that the per-layer metrics share. Each file under
``metrics/`` names one of them as its ``read``; each takes a run's record
and returns a number, or None where the run has nothing to read.

Spans and counters come from the window's quiet stretch (the whole window,
or a traced run's part before the profiler); the device's numbers from the
profiled stretch."""

from __future__ import annotations

from portbench import work
from portbench.trace import kernel_time


def _per_call(rec, name):
    span = rec["spans"].get(name)
    if not span or not span["calls"]:
        return None
    return span["seconds"] * 1e3 / span["calls"]


def launch_ms(rec):
    """Host ms a call in ``TorchModelBatcher._launch`` (the copy's enqueue
    and the eager dispatch of the step), from the benchmark's wrapper."""
    return _per_call(rec, "launch")


def submit_ms(rec):
    """Host ms a call in ``Processor.submit_batch``, which the loop's
    harvest pays for each batch, from the benchmark's wrapper."""
    return _per_call(rec, "submit")


def collect_ms(rec):
    """Host ms a tick in the fill provider (``StreamFarm.collect`` into the
    pinned staging), from the benchmark's wrapper, over the ticks."""
    span = rec["spans"].get("collect")
    if not span or not rec.get("ticks"):
        return None
    return span["seconds"] * 1e3 / rec["ticks"]


def batch_fill(rec):
    """Windows processed over batches dispatched times ``max_batch``
    (``BatcherStats``), in percent."""
    fill = rec.get("batch_fill")
    return None if fill is None else 100.0 * fill


def device_idle_pct(rec):
    """Share of the profiled stretch in which no operation ran on the
    card."""
    t = rec.get("trace") or {}
    if not t.get("device_events") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def step_mfu(rec):
    """The whole step's share of the card's peak: each window's operations
    (``work.py``: the mel front end at the float32 peak, the backbone and
    head at their types' peaks) times the windows done, over the
    seconds."""
    if not rec.get("windows_done") or not rec.get("quiet_s"):
        return None
    return (100.0 * work.window_peak_seconds(rec["cfg"])
            * rec["windows_done"] / rec["quiet_s"])


def mel_roofline(rec):
    """The mel kernel's share of its roofline: the least time for a
    launch's work (``work.py``: the float32 operations of the transform,
    the filterbank and the scaling for ``max_batch`` windows, or the int16
    input read once and the mel rows written once) over the kernel's device
    time a launch in the trace."""
    secs, launches = kernel_time(rec.get("trace") or {}, "melspec_kernel")
    if not launches or secs <= 0:
        return None
    cfg = rec["cfg"]
    ops, nbytes = work.mel_work(cfg["mel"], cfg["clip_samples"])
    b = rec["max_batch"]
    least, _ = work.bound_seconds({"float32": ops * b}, nbytes * b)
    return 100.0 * least / (secs / launches)
