"""Phase 16's app leg on a host whose CPU cores are busy.

    python3 -m birdnet_go_tpu_torch.diag.app_contention \\
        [--legs burn8+nogate,burn8,plain] [--cap 240]

Run from the repository's root on a machine with a card: it builds the
kernels (``chip_smoke.phase_build``), then runs ``chip_smoke.app_leg``
once for each leg named, each in a process of its own. A leg named
``burnK`` runs beside K processes that spin a CPU core each; a leg named
with ``+nogate`` replaces ``SourceGate.closed`` by a no-op, which is the
app as it was before the gate. Each leg prints v2.4's and v3.0's latency
from the window's end, the batchers' launch times, the thread CPU, the
timeline and every tick over 300 ms (its start from the first tick, its
length), from the leg's record and a per-tick timer. Records and logs go
to ``build/app_contention/``. Nothing is gated; a leg still running
after ``--cap`` seconds is killed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "app_contention"
LONG_TICK_MS = 300.0


def _leg(record: Path, variant: str) -> None:
    """The app leg, with every tick timed and, for ``+nogate``, no gate."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from birdnet_go_tpu_torch import app as app_mod
    from birdnet_go_tpu_torch.audio.engine import SourceGate
    from birdnet_go_tpu_torch.scheduler.loop import DeviceLoop

    if "nogate" in variant:
        SourceGate.closed = lambda self: contextlib.nullcontext()
    ticks: list[tuple[float, float]] = []
    real_tick = DeviceLoop.run_tick

    def run_tick(self):
        t, p = time.time(), time.perf_counter()
        try:
            return real_tick(self)
        finally:
            ticks.append((t, (time.perf_counter() - p) * 1e3))

    DeviceLoop.run_tick = run_tick
    real_stop = app_mod.Application.stop

    def stop(self):
        DeviceLoop.run_tick = real_tick
        record.with_suffix(".ticks").write_text(json.dumps(ticks))
        return real_stop(self)

    app_mod.Application.stop = stop
    chip_smoke.app_leg(record)


def _report(record: Path) -> None:
    if not record.exists():
        print("no record")
        return
    r = json.loads(record.read_text())
    print("latency_ms", r["latency_ms"])
    print("runtime load", r["load"], "v3 first window after it",
          r["v3_first_after_load_s"])
    print("batcher calls", r["calls"])
    print("thread CPU s", r["thread_cpu_s"])
    print("produced", r["produced"], "served", r["served"], "dropped",
          r["windows_dropped"], "approved", r["approved"], "losses",
          r["losses"], "job queue", r["jobqueue"])
    for s in r["timeline"]:
        print("timeline", s)
    if not record.with_suffix(".ticks").exists():
        return
    ticks = json.loads(record.with_suffix(".ticks").read_text())
    t0 = ticks[0][0] if ticks else 0.0
    print("ticks", len(ticks), f"over {LONG_TICK_MS:.0f} ms:",
          [(round(t - t0, 2), round(d, 1)) for t, d in ticks
           if d > LONG_TICK_MS])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default="burn8+nogate,burn8,plain")
    ap.add_argument("--cap", type=float, default=240.0)
    ap.add_argument("--leg", nargs=2, metavar=("RECORD", "VARIANT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.leg:
        _leg(Path(args.leg[0]), args.leg[1])
        return
    sys.path.insert(0, str(REPO))
    import chip_smoke

    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    chip_smoke.phase_build()
    OUT.mkdir(parents=True, exist_ok=True)
    for i, variant in enumerate(args.legs.split(",")):
        record = OUT / f"leg{i}.json"
        for old in (record, record.with_suffix(".ticks")):
            old.unlink(missing_ok=True)
        burn = (int(variant.split("burn")[1].split("+")[0])
                if "burn" in variant else 0)
        burners = [subprocess.Popen([sys.executable, "-c",
                                     "while True: pass"])
                   for _ in range(burn)]
        t0 = time.monotonic()
        try:
            with open(OUT / f"leg{i}.log", "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", __spec__.name, "--leg",
                     str(record), variant], stdout=log, stderr=log,
                    cwd=REPO)
                try:
                    proc.wait(timeout=args.cap)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        finally:
            for b in burners:
                b.kill()
                b.wait()
        print(f"=== leg {i} ({variant}, {burn} spinning processes): exit "
              f"{proc.returncode} in {time.monotonic() - t0:.1f} s [{card}]")
        _report(record)


if __name__ == "__main__":
    main()
