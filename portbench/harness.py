"""What every cell shares: the manifest and the files found by name, the
card's line, spans from the benchmark's own wrappers, the import guard and
the result line."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "birdnet_go_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path | None = None) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return load_json((root or ROOT.parent) / "BENCHMARK.json")


def config_file(name: str, base: Path = ROOT) -> Path:
    return base / "configs" / f"{name}.json"


def workload_file(name: str, base: Path = ROOT) -> Path:
    return base / "workloads" / f"{name}.json"


def metric_file(name: str, base: Path = ROOT) -> Path:
    return base / "metrics" / f"{name}.py"


def traffic_module(kind: str, base: Path = ROOT):
    """The generator of a traffic kind: ``traffic/<kind>.py``."""
    return load_module(base / "traffic" / f"{kind}.py", f"traffic_{kind}")


def load_module(path: Path, tag: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "portbench._loaded_" + "".join(
        c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, rec: dict, base: Path = ROOT):
    """The metric's reader applied to a run's record: a number or None
    where it found nothing to read."""
    return load_module(metric_file(name, base), f"metric_{name}").read(rec)


def card_line() -> str | None:
    """`nvidia-smi`'s "name, power.limit" of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole: ``birdnet_go_tpu_torch`` is not ``birdnet_go_tpu``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Spans:
    """Host time of the benchmark's wrappers around the program's calls.

    ``wrap(name, fn)`` times each call on the host clock; calls count only
    while ``open`` is set (the window's quiet stretch). While ``record`` is
    set (the profiled stretch) each call is kept instead as (name, start,
    end) in ``perf_counter_ns``, from whichever thread made it; the device
    trace's idle gaps are named by them."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.open = False
        self.record = False
        self.total: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.events: list[tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def wrap(self, name: str, fn):
        def call(*a, **k):
            t = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                self._add(name, t, time.perf_counter_ns())
        return call

    def _add(self, name: str, t0: int, t1: int) -> None:
        if self.record:
            with self._lock:
                self.events.append((name, t0, t1))
        elif self.open:
            with self._lock:
                self.total[name] += (t1 - t0) / 1e9
                self.calls[name] += 1


class SpanEvent(threading.Event):
    """A ``threading.Event`` whose waits are a span: the device loop's
    sleep between ticks."""

    def __init__(self, spans: Spans):
        super().__init__()
        self._wait = spans.wrap("sleep", super().wait)

    def wait(self, timeout=None):
        return self._wait(timeout)


def emit(result: dict, checks: list[tuple[str, float, float]]) -> None:
    """Print each compared number beside its limit as the last lines on
    standard error, and the result as the last line of standard output,
    with the same under ``checks``, last."""
    for name, value, limit in checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
