"""Startup crash recovery: one call proving the restart contract.

The reference restarts in-process on exit code 42 (main.go:63-83) and
relies on four durability mechanisms to make an unclean death safe:
SQLite WAL replay on reopen, dynamic-threshold persistence
(processor/threshold_persistence.go — periodic snapshot, restore on
start), clip↔DB reconciliation (internal/diskmanager/clip_reconcile.go),
and the species-tracker startup sync (species_tracker InitFromDatabase).
This module runs all four against a database + clip directory left
behind by a SIGKILLed process and returns a machine-checkable ledger,
the path ``python -m birdnet_go_tpu_torch recover`` exposes to operators.

Recovery is idempotent: a second pass over an already-recovered tree
reports zero swept orphans, zero cleared references, and the same
detection count.

A copy of ``birdnet_go_tpu/analysis/recovery.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_recovery.py`` holds
it to the original. It differs from JAX only through
``DiskManager.reconcile``, which pages through every clip reference
(``utils/diskmanager.py``): on a database of more than 100,000 clip rows
JAX's sweep deletes the oldest rows' clips, the port's keeps them.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any

log = logging.getLogger("birdnet_tpu.recovery")


def recover_startup(db_path: str, clips_dir: str | None = None,
                    now: float | None = None,
                    store: Any = None) -> dict[str, Any]:
    """Recover a crashed deployment's persistent state; return a ledger.

    Ledger keys:
      integrity            — PRAGMA integrity_check result ('ok' = healthy)
      wal                  — {busy, log_frames, checkpointed_frames}
      detections           — surviving committed rows
      duplicate_detections — double-count audit (MUST be 0)
      thresholds_restored  — dynamic-threshold species restored
      species_resynced     — first-seen species loaded into the tracker
      clips                — {orphan_files_swept, dangling_refs_cleared,
                             files_on_disk, refs_aborted_reason}

    `now` backdates the recency guards in tests; production passes None.
    A caller-supplied `store` is used (and left open); otherwise the
    database is opened and closed here.
    """
    from birdnet_go_tpu_torch.analysis.species_tracker import SpeciesTracker
    from birdnet_go_tpu_torch.datastore.sqlite import Datastore
    from birdnet_go_tpu_torch.utils.diskmanager import (
        DiskManager,
        RetentionPolicy,
    )

    now = now if now is not None else time.time()
    own_store = store is None
    # Opening the database IS the WAL recovery: SQLite replays committed
    # frames and discards the torn tail of an unsynced transaction.
    st = store if store is not None else Datastore(db_path)
    ledger: dict[str, Any] = {}
    try:
        ledger["integrity"] = st.integrity_check()
        ledger["wal"] = st.wal_checkpoint()
        ledger["detections"] = st.count_detections()
        ledger["duplicate_detections"] = st.count_duplicate_detections()
        ledger["thresholds_restored"] = len(st.load_dynamic_thresholds())
        tracker = SpeciesTracker()
        ledger["species_resynced"] = tracker.sync_from_datastore(st)

        clips: dict[str, Any] = {"orphan_files_swept": 0,
                                 "dangling_refs_cleared": 0,
                                 "files_on_disk": 0}
        if clips_dir:
            dm = DiskManager(clips_dir, RetentionPolicy(mode="none"),
                             datastore=st)
            rec = dm.reconcile()
            base = Path(clips_dir)
            # Orphan FILES (clip written, DB commit never landed): sweep
            # only those older than the recency window by mtime — a clip
            # the restarted encoder is mid-writing must survive.
            for rel in rec["orphan_files"]:
                p = base / rel
                try:
                    if now - p.stat().st_mtime < dm.CLIP_RECENCY_WINDOW:
                        continue
                    p.unlink()
                    clips["orphan_files_swept"] += 1
                except OSError as e:
                    log.warning("orphan sweep failed for %s: %s", rel, e)
            # Dangling REFERENCES (DB row committed, clip write lost):
            # clear clip_name so the UI never 404s — the fail-safe pass
            # with its detached-storage and recency guards.
            refs = dm.reconcile_orphans_pass(now=now)
            clips["dangling_refs_cleared"] = refs["cleared"]
            if refs["aborted"]:
                clips["refs_aborted_reason"] = refs["abort_reason"]
            clips["files_on_disk"] = sum(
                1 for p in base.rglob("*") if p.is_file())
        ledger["clips"] = clips
    finally:
        if own_store:
            st.close()
    log.info("startup recovery: %s", ledger)
    return ledger
