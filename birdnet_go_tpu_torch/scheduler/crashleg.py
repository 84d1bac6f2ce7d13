"""Crash-durability soak leg: SIGKILL a mid-run durable soak, recover,
restart, and emit a machine-checkable record.

A victim subprocess runs the full pipeline (native farm → scheduler →
device step → processor → jobqueue → SQLite WAL + clip files) in durable
mode; this orchestrator SIGKILLs it mid-write, runs
`analysis.recovery.recover_startup()` (the production restart path the
``recover`` CLI command exposes), proves idempotency, then runs a restart
leg IN the recovered database and asserts the exact row equation
`after == before + persisted` — no detection double-counted across the
crash.

Reference semantics: main.go:63-83 (restart-on-exit-42 must come back
from unclean death), processor/threshold_persistence.go (periodic
snapshot + restore), internal/diskmanager (clip↔DB reconcile),
species_tracker InitFromDatabase (first-seen resync).

    python -m birdnet_go_tpu_torch.scheduler.crashleg --streams 2000 \\
        --kill-min-rows 200 --restart-seconds 20 --workdir build/crash

A copy of ``birdnet_go_tpu/scheduler/crashleg.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_recovery.py`` holds
it to the original. Where it differs from JAX:

- ``--device cuda|cpu|stub`` (cuda by default, as the port's soak): the
  victim is ``python -m birdnet_go_tpu_torch soak --device <d> --durable``
  without JAX's ``BIRDNET_TPU_PLATFORM=cpu``, and the restart leg runs
  ``run_soak`` on the same device (with the CLI's calibration, 1.5% of
  windows, on "cuda" and "cpu"). "cuda" raises without a card.
- The victim runs in a session of its own; after its SIGKILL it is reaped
  (a card frees its memory only then), its process group is checked for
  survivors (``group_alive_after_kill``; any is killed), and its log
  (``victim.log`` in the workdir) gives the calibrated threshold.
- The record adds ``device``, ``card`` (``nvidia-smi``'s name and power
  limit), ``trigger``, the recovery passes' seconds, the card's free
  memory before the restart leg, and the restart leg's
  ``mel_kernel_launches``, ``batches_dispatched``, approvals and
  threshold calibration; ``--workdir`` keeps the tree for the operator's
  commands (``recover``, ``db doctor``).
- ``thresholds_restored_ge_before_kill`` counts the thresholds the restart
  leg restored at its start (JAX counts those it persisted at its end,
  which a leg that restored none would also reach by learning its own),
  and ``restored_levels_match_db`` holds their levels to the recovered
  database's rows; both are part of ``pass``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import signal
import sqlite3
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

import torch

log = logging.getLogger("birdnet_tpu.crashleg")


def _ro_count(db: Path, sql: str) -> int:
    """Read-only poll of the victim's live WAL database."""
    try:
        con = sqlite3.connect(f"file:{db}?mode=ro", uri=True, timeout=2.0)
    except sqlite3.OperationalError:
        return 0
    try:
        return int(con.execute(sql).fetchone()[0])
    except sqlite3.OperationalError:
        return 0
    finally:
        con.close()


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


def _calibrated_threshold(victim_log: Path) -> float | None:
    """The threshold the victim's soak calibrated, from its log."""
    if not victim_log.exists():
        return None
    found = re.findall(r"calibrated threshold ([0-9.]+)",
                       victim_log.read_text(errors="replace"))
    return float(found[-1]) if found else None


def run_crash_leg(streams: int = 1000, kill_min_rows: int = 200,
                  restart_seconds: float = 30.0,
                  persist_interval_s: float = 2.0,
                  hit_stride: int = 4,
                  workdir: str | None = None,
                  device: str = "cuda") -> dict[str, Any]:
    from birdnet_go_tpu_torch.analysis.recovery import recover_startup
    from birdnet_go_tpu_torch.config.settings import Settings
    from birdnet_go_tpu_torch.datastore.sqlite import Datastore
    from birdnet_go_tpu_torch.scheduler.soak import _card_line, run_soak

    if device not in ("cuda", "cpu", "stub"):
        raise ValueError(f"unknown crash-leg device: {device}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("crashleg --device cuda needs a CUDA card "
                           "(torch.cuda.is_available() is false)")
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="crashleg_")
        workdir = tmp.name
    root = Path(workdir)
    root.mkdir(parents=True, exist_ok=True)
    db = root / "birds.db"
    clips = root / "clips"
    victim_log = root / "victim.log"
    repo = Path(__file__).resolve().parents[2]

    rec: dict[str, Any] = {
        "leg": "crash_durability",
        "streams": streams,
        "device": device,
        "card": _card_line() if device == "cuda" else None,
        "trigger": Settings().dynamic_threshold.trigger,
        "durable": {"persist_interval_s": persist_interval_s,
                    "hit_stride": hit_stride},
    }

    # ---- victim: full pipeline in durable mode, killed mid-write ----
    with open(victim_log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "birdnet_go_tpu_torch", "soak",
             "--device", device,
             "--streams", str(streams), "--seconds", "300",
             "--db", str(db), "--clips-dir", str(clips),
             "--durable", "--persist-interval", str(persist_interval_s),
             "--hit-stride", str(hit_stride)],
            cwd=repo, stdout=subprocess.DEVNULL, stderr=err,
            start_new_session=True)
    t0 = time.monotonic()
    try:
        deadline = t0 + 180.0
        rows = thr = 0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"victim exited early rc={proc.returncode}: "
                    f"{victim_log.read_text(errors='replace')[-2000:]}")
            rows = _ro_count(db, "SELECT COUNT(*) FROM detections")
            thr = _ro_count(db, "SELECT COUNT(*) FROM dynamic_thresholds")
            if rows >= kill_min_rows and thr >= 1:
                break
            time.sleep(0.5)
        else:
            raise RuntimeError(
                f"victim never reached kill state rows={rows} thr={thr}")
        time.sleep(0.7)              # more jobs in flight at the kill
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=15)        # reaped: the card frees its memory
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
            try:                     # the rest of the victim's session
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    killed_at = time.monotonic() - t0
    group_alive = _group_alive(proc.pid)
    if group_alive:
        os.killpg(proc.pid, signal.SIGKILL)

    wal = db.with_name(db.name + "-wal")
    rec["victim"] = {
        "killed_at_s": round(killed_at, 1),
        "signal": "SIGKILL",
        "returncode": proc.returncode,
        "rows_committed_before_kill": rows,
        "thresholds_before_kill": thr,
        "clips_on_disk_at_kill": sum(
            1 for p in clips.rglob("*") if p.is_file()) if clips.exists()
            else 0,
        "wal_left_behind_bytes": wal.stat().st_size if wal.exists() else 0,
        "group_alive_after_kill": group_alive,
        "calibrated_threshold": _calibrated_threshold(victim_log),
    }

    # ---- recovery: the production restart path, then prove idempotency --
    future = time.time() + 3600.0    # bypass clip recency guards: every
    # orphan in this leg was written seconds ago; production keeps them
    # until the recency window passes (see recovery.py docstring)
    t1 = time.monotonic()
    ledger = recover_startup(str(db), clips_dir=str(clips), now=future)
    t2 = time.monotonic()
    again = recover_startup(str(db), clips_dir=str(clips), now=future)
    rec["recovery_seconds"] = [round(t2 - t1, 3),
                               round(time.monotonic() - t2, 3)]
    rec["recovery_ledger"] = ledger
    rec["recovery_idempotent"] = (
        again["integrity"] == "ok"
        and again["detections"] == ledger["detections"]
        and again["clips"]["orphan_files_swept"] == 0
        and again["clips"]["dangling_refs_cleared"] == 0)

    # ---- restart leg: append to the recovered DB, exact row equation ---
    store = Datastore(str(db))
    try:
        before = store.count_detections()
        thresholds_before = store.load_dynamic_thresholds()
    finally:
        store.close()

    mem = (torch.cuda.mem_get_info() if device == "cuda" else None)
    r2 = run_soak(streams=streams, seconds=restart_seconds, device=device,
                  db_path=str(db), clips_dir=str(clips), durable=True,
                  persist_interval_s=persist_interval_s,
                  hit_stride=hit_stride, sim_mqtt_ms=1.0, sim_alert_ms=1.0,
                  calibrate_rate=None if device == "stub" else 0.015)
    persisted = r2["actions"]["detections_persisted"]

    store = Datastore(str(db))
    try:
        after = store.count_detections()
        dups = store.count_duplicate_detections()
        integ = store.integrity_check()
    finally:
        store.close()

    cal = r2["calibration"]
    restored = r2["durable"]["thresholds_restored"]
    db_levels = sorted([m, sci, st.level]
                       for (m, sci), st in thresholds_before.items())
    rec["restart"] = {
        "seconds": restart_seconds,
        "detections_before": before,
        "detections_persisted": persisted,
        "detections_after": after,
        "exact_count_equation_holds": after == before + persisted,
        "duplicate_detections": dups,
        "integrity": integ,
        "thresholds_restored_ge_before_kill":
            restored >= rec["victim"]["thresholds_before_kill"],
        "thresholds_restored": restored,
        "restored_levels_match_db":
            r2["durable"]["restored_levels"] == db_levels,
        "latency_ms": r2["latency_ms"],
        "drop_accounting": r2["drop_accounting"],
        "card_memory_free_gib": (round(mem[0] / 2**30, 2)
                                 if mem is not None else None),
        "card_memory_total_gib": (round(mem[1] / 2**30, 2)
                                  if mem is not None else None),
        "approved": r2["actions"]["approved"],
        "mel_kernel_launches": cal.get("mel_kernel_launches"),
        "batches_dispatched": cal.get("batches_dispatched"),
        "threshold_calibration": cal.get("threshold_calibration"),
    }
    rec["pass"] = bool(
        ledger["integrity"] == "ok"
        and ledger["duplicate_detections"] == 0
        and ledger["thresholds_restored"] >= 1
        and ledger["species_resynced"] >= 1
        and rec["recovery_idempotent"]
        and rec["restart"]["exact_count_equation_holds"]
        and rec["restart"]["thresholds_restored_ge_before_kill"]
        and rec["restart"]["restored_levels_match_db"]
        and dups == 0 and integ == "ok"
        and persisted > 0)
    if tmp is not None:
        tmp.cleanup()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu", "stub"],
                   default="cuda",
                   help="cuda: the v2.4 step on the card (default); cpu: "
                        "the same step on the CPU; stub: a latency model "
                        "of the card's step")
    p.add_argument("--streams", type=int, default=1000)
    p.add_argument("--kill-min-rows", type=int, default=200)
    p.add_argument("--restart-seconds", type=float, default=30.0)
    p.add_argument("--workdir", default=None,
                   help="keep the database, clips and victim log here "
                        "(default: a temporary directory, removed)")
    p.add_argument("--out", default=None,
                   help="append the record to this JSON file's 'runs'")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rec = run_crash_leg(streams=args.streams,
                        kill_min_rows=args.kill_min_rows,
                        restart_seconds=args.restart_seconds,
                        workdir=args.workdir, device=args.device)
    print(json.dumps(rec, indent=1))
    if args.out:
        path = Path(args.out)
        doc = (json.loads(path.read_text()) if path.exists()
               else {"runs": []})
        doc["runs"].append(rec)
        path.write_text(json.dumps(doc, indent=1))
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
