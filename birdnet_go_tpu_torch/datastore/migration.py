"""Live migration machinery: background legacy→native migration with
dual-write, validation, tail-sync cutover, pause/resume, and rollback.

Reference: internal/datastore/v2/migration/worker.go (batch loop, error
backoff, auto-pause after consecutive failures, validation with bounded
catch-up retries, cutover tail sync), v2/state_manager.go (persisted
MigrationState row + transitions), v2/mode.go (post-migration enhanced
mode flag). The direction is inverted relative to the reference — there,
legacy stays live and new records are dual-written into v2; here, the
native datastore is live from day one and during migration new detections
are *also* appended to the legacy database so an operator can roll back to
the reference deployment losslessly until cutover completes.

State machine:

    idle → migrating → validating → cutover → completed
              ↕ paused (operator or auto after max consecutive errors)
              ↘ cancelled / failed;  rollback ⇒ idle (migrated rows removed)

All progress is persisted in the target datastore (`migration_state`
single-row table + `migration_map` legacy-id→detection-id table), so a
restart resumes exactly where it left off and re-runs are idempotent.
The dual-write queue is bounded and drop-counted — it never blocks the
detection path (repo convention; reference worker.go:627 dirty-ID queue).

A copy of ``birdnet_go_tpu/datastore/migration.py`` for the port, over
the port's ``Datastore``; ``tests/test_torch_aux.py`` holds it to the
original.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any

from birdnet_go_tpu_torch.utils.imports import (
    legacy_note_entry,
    open_birdnet_go_db,
)

log = logging.getLogger("birdnet_tpu.migration")

# worker.go:22-46 constants, scaled to our batch loop
DEFAULT_BATCH_SIZE = 100
DEFAULT_SLEEP_BETWEEN_BATCHES = 0.1
DEFAULT_ERROR_BACKOFF = 5.0
DEFAULT_MAX_CONSECUTIVE_ERRORS = 10
VALIDATION_MAX_RETRIES = 5
VALIDATION_CATCHUP_PERCENT = 5.0
VALIDATION_CATCHUP_MIN = 100
RATE_WINDOW = 10            # batches sampled for the rate/ETA estimate
DUAL_WRITE_QUEUE_MAX = 4096

STATES = ("idle", "migrating", "validating", "cutover", "completed",
          "paused", "cancelled", "failed")


class MigrationStateStore:
    """Single-row persisted migration state in the *target* datastore
    (reference: v2/entities MigrationState via state_manager.go)."""

    def __init__(self, datastore):
        self._ds = datastore
        with datastore._lock:
            datastore._conn.executescript("""
            CREATE TABLE IF NOT EXISTS migration_state (
              id INTEGER PRIMARY KEY CHECK (id = 1),
              state TEXT NOT NULL DEFAULT 'idle',
              paused_from TEXT,
              legacy_path TEXT,
              total_records INTEGER NOT NULL DEFAULT 0,
              migrated_records INTEGER NOT NULL DEFAULT 0,
              last_migrated_id INTEGER NOT NULL DEFAULT 0,
              validation_attempts INTEGER NOT NULL DEFAULT 0,
              validation_mapped INTEGER NOT NULL DEFAULT -1,
              consecutive_errors INTEGER NOT NULL DEFAULT 0,
              started_at REAL, completed_at REAL, error TEXT);
            CREATE TABLE IF NOT EXISTS migration_map (
              legacy_id INTEGER PRIMARY KEY,
              det_id INTEGER NOT NULL,
              created INTEGER NOT NULL DEFAULT 1);
            INSERT OR IGNORE INTO migration_state (id) VALUES (1);
            """)
            try:    # map tables from earlier builds lack the created flag
                datastore._conn.execute(
                    "ALTER TABLE migration_map ADD COLUMN created INTEGER"
                    " NOT NULL DEFAULT 1")
            except Exception:
                pass
            try:    # state rows from earlier builds lack validation_mapped
                datastore._conn.execute(
                    "ALTER TABLE migration_state ADD COLUMN"
                    " validation_mapped INTEGER NOT NULL DEFAULT -1")
            except Exception:
                pass
            datastore._conn.commit()

    def get(self) -> dict[str, Any]:
        with self._ds._lock:
            row = self._ds._conn.execute(
                "SELECT * FROM migration_state WHERE id = 1").fetchone()
        return dict(row)

    def update(self, **fields) -> None:
        keys = ", ".join(f"{k} = ?" for k in fields)
        with self._ds._lock:
            self._ds._conn.execute(
                f"UPDATE migration_state SET {keys} WHERE id = 1",
                tuple(fields.values()))
            self._ds._conn.commit()

    def map_insert(self, legacy_id: int, det_id: int,
                   created: bool = True, commit: bool = True) -> None:
        """created=False records a dedup mapping onto a row that existed
        before the migration — rollback must not delete those.

        commit=False defers durability to the caller's batch-level
        store.update() commit: a crash between the detection insert and
        the map commit is safe because resume re-scans and the
        timestamp+species dedup re-maps the row without re-inserting."""
        with self._ds._lock:
            self._ds._conn.execute(
                "INSERT OR IGNORE INTO migration_map VALUES (?, ?, ?)",
                (legacy_id, det_id, 1 if created else 0))
            if commit:
                self._ds._conn.commit()

    def map_has(self, legacy_id: int) -> bool:
        with self._ds._lock:
            return self._ds._conn.execute(
                "SELECT 1 FROM migration_map WHERE legacy_id = ?",
                (legacy_id,)).fetchone() is not None

    def map_count(self) -> int:
        with self._ds._lock:
            return self._ds._conn.execute(
                "SELECT COUNT(*) FROM migration_map").fetchone()[0]

    def map_det_ids(self, created_only: bool = False) -> list[int]:
        q = "SELECT det_id FROM migration_map"
        if created_only:
            q += " WHERE created = 1"
        with self._ds._lock:
            return [r[0] for r in self._ds._conn.execute(q)]

    def map_clear(self) -> None:
        with self._ds._lock:
            self._ds._conn.execute("DELETE FROM migration_map")
            self._ds._conn.commit()


class MigrationWorker:
    """Background legacy→native migration (one instance per Application).

    Drives batches off a thread like the reference's worker goroutine
    (worker.go:346 run loop); every transition is persisted before the
    next batch so kill -9 at any point resumes correctly.
    """

    def __init__(self, datastore, legacy_path: str,
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 sleep_between: float = DEFAULT_SLEEP_BETWEEN_BATCHES,
                 error_backoff: float = DEFAULT_ERROR_BACKOFF,
                 max_consecutive_errors: int = DEFAULT_MAX_CONSECUTIVE_ERRORS,
                 dual_write: bool = True):
        self.ds = datastore
        self.legacy_path = str(legacy_path)
        self.batch_size = batch_size
        self.sleep_between = sleep_between
        self.error_backoff = error_backoff
        self.max_consecutive_errors = max_consecutive_errors
        self.dual_write_enabled = dual_write
        self.store = MigrationStateStore(datastore)

        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._rate_samples: collections.deque = collections.deque(
            maxlen=RATE_WINDOW)
        # bounded dual-write queue: (Detection, clip_name); never blocks
        self._dw_queue: collections.deque = collections.deque(
            maxlen=DUAL_WRITE_QUEUE_MAX)
        self._dw_dropped = 0
        self._dw_written = 0
        self._dw_lock = threading.Lock()
        self._uninstall_hook = None

    # -- lifecycle (worker.go:247-344) -------------------------------------

    def _alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _spawn(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="migration-worker", daemon=True)
        self._thread.start()

    def start(self, force: bool = False) -> None:
        """Begin the migration — or, when the persisted state says a run
        was interrupted (crash/restart left it mid-flight with no live
        thread), resume it in place keeping all progress. A completed run
        blocks new starts unless `force` — which resets the state row and
        the legacy-id map so a *different* legacy DB can be absorbed
        (existing native rows stay; timestamp+species dedup prevents
        duplicates)."""
        st = self.store.get()
        if st["state"] in ("migrating", "validating", "cutover"):
            if self._alive():
                raise RuntimeError(f"migration already {st['state']}")
            if st["legacy_path"] and st["legacy_path"] != self.legacy_path:
                raise RuntimeError(
                    f"an interrupted migration of {st['legacy_path']} is "
                    "pending; resume/cancel/rollback it first")
            self._spawn()               # resume the interrupted run
            return
        if st["state"] == "paused":
            raise RuntimeError("migration paused; resume to continue")
        if st["state"] == "completed":
            if not force:
                raise RuntimeError(
                    "migration already completed (use force to migrate "
                    "another database)")
            self.store.map_clear()
            self.store.update(state="idle", migrated_records=0,
                              last_migrated_id=0, completed_at=None)
        conn, _tables = open_birdnet_go_db(self.legacy_path)  # validates
        total = conn.execute("SELECT COUNT(*) FROM notes").fetchone()[0]
        conn.close()
        self.store.update(state="migrating", legacy_path=self.legacy_path,
                          total_records=total, started_at=time.time(),
                          error=None, consecutive_errors=0,
                          validation_attempts=0, validation_mapped=-1)
        self._spawn()

    def pause(self) -> None:
        st = self.store.get()
        if st["state"] in ("migrating", "validating", "cutover"):
            self.store.update(state="paused", paused_from=st["state"])
            self._wake.set()

    def resume(self) -> None:
        st = self.store.get()
        if st["state"] == "paused":
            self.store.update(state=st["paused_from"] or "migrating",
                              paused_from=None, consecutive_errors=0,
                              error=None)
            self._wake.set()
            if not self._alive():
                self._spawn()
        elif (st["state"] in ("migrating", "validating", "cutover")
              and not self._alive()):
            self._spawn()       # interrupted run (crash/restart)

    def cancel(self) -> None:
        """Stop and mark cancelled; migrated rows are kept (reference
        state_manager.go:307 Cancel)."""
        self.store.update(state="cancelled")
        self._stop.set()
        self._wake.set()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def rollback(self) -> None:
        """Remove every detection the migration CREATED (dedup-only map
        entries point at rows that predate it and are left alone) and
        reset to idle (state_manager.go:359 Rollback). Refused after
        cutover completes — at that point the native datastore is the
        system of record."""
        st = self.store.get()
        if st["state"] == "completed":
            raise RuntimeError("migration completed; rollback unavailable")
        self.stop()
        self.uninstall_dual_write()
        for det_id in self.store.map_det_ids(created_only=True):
            try:
                # locks carried over from legacy were created by the
                # migration itself, so it may remove them on rollback
                self.ds.lock_detection(det_id, False)
                self.ds.delete_detection(det_id)
            except Exception:
                log.exception("rollback: delete %s failed", det_id)
        self.store.map_clear()
        self.store.update(state="idle", migrated_records=0,
                          last_migrated_id=0, total_records=0,
                          validation_attempts=0, validation_mapped=-1,
                          consecutive_errors=0,
                          started_at=None, completed_at=None, error=None,
                          paused_from=None)

    # -- dual-write (inverted worker.go dirty-ID path) ----------------------

    def install_dual_write(self) -> None:
        """Wrap datastore.insert_detection so every *new* detection is also
        queued for append into the legacy database until cutover. Bounded +
        drop-counted; the worker thread drains the queue between batches."""
        if not self.dual_write_enabled or self._uninstall_hook is not None:
            return
        orig = self.ds.insert_detection
        if getattr(orig, "_migration_dual_write", False):
            # another worker's stale wrapper: never stack wrappers
            log.warning("dual-write: insert_detection already wrapped; "
                        "not stacking")
            return

        def wrapped(d, clip_name=None, **kw):
            det_id = orig(d, clip_name=clip_name, **kw)
            # skip rows the migration itself inserts (already in legacy)
            if d.source_id != "import:birdnet-go":
                if len(self._dw_queue) >= DUAL_WRITE_QUEUE_MAX:
                    self._dw_dropped += 1
                else:
                    self._dw_queue.append((d, clip_name))
            return det_id

        wrapped._migration_dual_write = True
        self.ds.insert_detection = wrapped
        self._uninstall_hook = lambda: setattr(
            self.ds, "insert_detection", orig)

    def uninstall_dual_write(self) -> None:
        if self._uninstall_hook is not None:
            self._uninstall_hook()
            self._uninstall_hook = None

    def _drain_dual_write(self) -> None:
        if not self._dw_queue:
            return
        import datetime as _dt
        import sqlite3

        with self._dw_lock:
            pending = []
            while self._dw_queue:
                pending.append(self._dw_queue.popleft())
            conn = None
            try:
                conn = sqlite3.connect(self.legacy_path, timeout=5.0)
                cols = {r[1] for r in conn.execute(
                    "PRAGMA table_info(notes)")}
            except Exception:
                # legacy DB briefly unreachable (e.g. locked by the old
                # deployment): re-queue and retry at the next drain
                if conn is not None:
                    conn.close()
                log.warning("dual-write drain: legacy DB unreachable, "
                            "%d rows re-queued", len(pending))
                for item in reversed(pending):
                    if len(self._dw_queue) < DUAL_WRITE_QUEUE_MAX:
                        self._dw_queue.appendleft(item)
                    else:
                        self._dw_dropped += 1
                return
            accepted: list = []   # rows whose INSERT succeeded pre-commit
            bad = 0
            try:
                for item in pending:
                    d, clip_name = item
                    try:
                        when = d.timestamp or _dt.datetime.now()
                        row = {"date": when.strftime("%Y-%m-%d"),
                               "time": when.strftime("%H:%M:%S"),
                               "scientific_name": d.species.scientific,
                               "common_name": d.species.common,
                               "species_code": d.species_code,
                               "confidence": d.confidence,
                               "clip_name": clip_name or ""}
                        row = {k: v for k, v in row.items() if k in cols}
                        conn.execute(
                            f"INSERT INTO notes ({', '.join(row)}) VALUES"
                            f" ({', '.join('?' * len(row))})",
                            tuple(row.values()))
                        accepted.append(item)
                    except Exception:
                        bad += 1
                        log.exception("dual-write: row rejected by legacy")
                conn.commit()
            except Exception:
                # commit failed (e.g. transient SQLITE_BUSY from the old
                # deployment): nothing landed, so re-queue the batch like
                # the unreachable-DB branch — only individually-rejected
                # rows are dropped. Losing the batch here would silently
                # break the lossless-rollback guarantee dual-write exists
                # to provide.
                log.warning("dual-write drain commit failed: %d rows "
                            "re-queued, %d rejected", len(accepted), bad)
                for item in reversed(accepted):
                    if len(self._dw_queue) < DUAL_WRITE_QUEUE_MAX:
                        self._dw_queue.appendleft(item)
                    else:
                        self._dw_dropped += 1
                self._dw_dropped += bad
                return
            finally:
                conn.close()
            # counted only after a successful commit — status must never
            # claim rows as written that are not durably in the legacy DB
            self._dw_written += len(accepted)
            self._dw_dropped += bad

    # -- run loop (worker.go:346-455) ---------------------------------------

    def _run(self) -> None:
        import sqlite3 as _sqlite3

        conn = None
        prev_sync = None
        try:
            conn, tables = open_birdnet_go_db(self.legacy_path)
            self.install_dual_write()
            # WAL + synchronous=NORMAL makes the per-row commits of the
            # batch loop cheap (no fsync per commit); the migration is
            # resumable, so relaxed last-commit durability is safe here
            try:
                with self.ds._lock:
                    prev_sync = self.ds._conn.execute(
                        "PRAGMA synchronous").fetchone()[0]
                    self.ds._conn.execute("PRAGMA synchronous=NORMAL")
            except Exception:
                prev_sync = None
            while not self._stop.is_set():
                try:
                    st = self.store.get()
                except _sqlite3.ProgrammingError:
                    break            # target datastore closed at shutdown
                state = st["state"]
                if state == "paused":
                    # dual-write keeps flowing while paused — losing live
                    # detections from the legacy DB would break rollback
                    self._drain_dual_write()
                    self._wake.wait(0.25)
                    self._wake.clear()
                    continue
                if state in ("cancelled", "failed", "completed", "idle"):
                    break
                try:
                    if state == "migrating":
                        self._migrate_batch(conn, tables, st)
                    elif state == "validating":
                        self._validate(conn, st)
                    elif state == "cutover":
                        self._cutover(conn, tables, st)
                    if st["consecutive_errors"]:
                        self.store.update(consecutive_errors=0)
                except Exception as e:
                    errs = st["consecutive_errors"] + 1
                    log.exception("migration batch failed (%d consecutive)",
                                  errs)
                    # re-read before auto-pausing: a cancel()/pause() that
                    # landed while this batch was in flight must not be
                    # overwritten with 'paused' (a later resume() would
                    # revive a run the operator cancelled)
                    cur = self.store.get()["state"]
                    if cur != state or self._stop.is_set():
                        continue
                    if errs >= self.max_consecutive_errors:
                        # auto-pause, operator can resume (worker.go:1221)
                        self.store.update(state="paused",
                                          paused_from=state,
                                          consecutive_errors=errs,
                                          error=str(e))
                    else:
                        self.store.update(consecutive_errors=errs,
                                          error=str(e))
                        self._wake.wait(self.error_backoff)
                        self._wake.clear()
                self._drain_dual_write()
                self._wake.wait(self.sleep_between)
                self._wake.clear()
        finally:
            self._drain_dual_write()
            if conn is not None:
                conn.close()
            if prev_sync is not None:
                try:
                    with self.ds._lock:
                        self.ds._conn.execute(
                            f"PRAGMA synchronous={int(prev_sync)}")
                except Exception:
                    pass
            # always unhook on thread exit: a dormant worker must not keep
            # queueing live detections (a resume re-installs the hook)
            self.uninstall_dual_write()

    def _ingest_legacy_row(self, conn, tables, n) -> bool:
        """Migrate one legacy `notes` row into the native store, recording
        it in migration_map. Rows the native store already holds at the
        same timestamp+species — in particular our own dual-writes flowing
        back in through the legacy scan — are mapped without re-insert.
        Returns True when a native row was actually created."""
        if self.store.map_has(n["id"]):
            return False
        entry = legacy_note_entry(conn, tables, n)
        if entry is None:            # unparseable date/time: count, skip
            self.store.map_insert(n["id"], -1, commit=False)
            return False
        d = entry["detection"]
        # second-granularity match: legacy date/time (and hence dual-write
        # round-trips) carry whole seconds, while native rows store
        # fractional wall-clock floats — an exact-equality probe would
        # miss every dual-written row and re-insert it at cutover.
        # Confidence must match too: it round-trips exactly through the
        # legacy REAL column, so dual-write echoes and force-restart
        # re-absorptions still dedup, while genuinely distinct legacy rows
        # at the same second (e.g. the same species heard on two source
        # nodes) migrate as separate detections instead of being silently
        # collapsed (reference parse keeps both).
        ts = d.timestamp.timestamp()
        with self.ds._lock:
            dup = self.ds._conn.execute(
                "SELECT id FROM detections WHERE timestamp >= ?"
                " AND timestamp < ? AND scientific_name = ?"
                " AND ABS(confidence - ?) < 1e-9 LIMIT 1",
                (ts, ts + 1.0, d.species.scientific,
                 d.confidence)).fetchone()
        if dup is not None:
            self.store.map_insert(n["id"], dup[0], created=False,
                                  commit=False)
            return False
        det_id = self.ds.insert_detection(
            d, clip_name=None, results=entry["results"] or None)
        if entry["review"]:
            self.ds.review_detection(det_id, entry["review"])
        for text in entry["comments"]:
            self.ds.add_comment(det_id, text)
        if entry["locked"]:
            self.ds.lock_detection(det_id, True)
        self.store.map_insert(n["id"], det_id, commit=False)
        return True

    def _migrate_batch(self, conn, tables, st) -> None:
        t0 = time.monotonic()
        rows = conn.execute(
            "SELECT id, date, time, scientific_name, common_name,"
            " species_code, confidence, clip_name FROM notes"
            " WHERE id > ? ORDER BY id LIMIT ?",
            (st["last_migrated_id"], self.batch_size)).fetchall()
        if not rows:
            self.store.update(state="validating")
            return
        migrated = 0
        last_id = st["last_migrated_id"]
        for n in rows:
            last_id = n["id"]
            if self._ingest_legacy_row(conn, tables, n):
                migrated += 1
        self.store.update(last_migrated_id=last_id,
                          migrated_records=self.store.map_count())
        self._rate_samples.append((migrated, time.monotonic() - t0))

    def _validate(self, conn, st) -> None:
        """Count comparison with bounded catch-up (worker.go:1280,
        validationCatchUpPercent).

        The target is frozen at the ids the scan has already covered
        (id <= last_migrated_id): under sustained live dual-write (or an
        external writer appending to legacy) a whole-table count keeps
        growing forever, and each validate→catch-up cycle would burn a
        retry until the run spuriously 'failed' — new tail rows are
        cutover tail-sync's job, not validation's. Catch-up passes that
        made forward progress also reset the retry budget."""
        legacy = conn.execute(
            "SELECT COUNT(*) FROM notes WHERE id <= ?",
            (st["last_migrated_id"],)).fetchone()[0]
        mapped = self.store.map_count()
        if mapped >= legacy:
            self.store.update(state="cutover", total_records=legacy,
                              validation_mapped=-1)
            return
        missing = legacy - mapped
        threshold = max(VALIDATION_CATCHUP_MIN,
                        legacy * VALIDATION_CATCHUP_PERCENT / 100.0)
        attempts = st["validation_attempts"] + 1
        if st["validation_mapped"] >= 0 and mapped > st["validation_mapped"]:
            attempts = 1        # the last catch-up made forward progress
        if attempts > VALIDATION_MAX_RETRIES:
            self.store.update(state="failed", validation_attempts=attempts,
                              error=f"validation failed: {missing} of "
                                    f"{legacy} legacy rows unmigrated")
            return
        if missing <= threshold:
            # catch-up: rescan from the start; migration_map dedups
            self.store.update(state="migrating", last_migrated_id=0,
                              validation_attempts=attempts,
                              validation_mapped=mapped,
                              total_records=legacy)
        else:
            self.store.update(state="failed", validation_attempts=attempts,
                              error=f"validation gap {missing}/{legacy} "
                                    f"exceeds catch-up threshold "
                                    f"{threshold:.0f}")

    def _cutover(self, conn, tables, st) -> None:
        """Tail sync: drain rows appended to the legacy DB after migration
        started (including our own dual-writes), then complete
        (worker.go:879 runTailSync)."""
        self._drain_dual_write()
        row = conn.execute("SELECT MAX(id) FROM notes").fetchone()
        max_id = row[0] or 0
        if max_id > st["last_migrated_id"]:
            # dual-written rows originate here — map them without re-insert
            new = conn.execute(
                "SELECT id, date, time, scientific_name, common_name,"
                " species_code, confidence, clip_name FROM notes"
                " WHERE id > ? ORDER BY id LIMIT ?",
                (st["last_migrated_id"], self.batch_size)).fetchall()
            last = st["last_migrated_id"]
            for n in new:
                last = n["id"]
                self._ingest_legacy_row(conn, tables, n)
            self.store.update(last_migrated_id=last,
                              migrated_records=self.store.map_count())
            return
        self.uninstall_dual_write()
        self.store.update(state="completed", completed_at=time.time(),
                          migrated_records=self.store.map_count())
        log.info("migration completed: %d records from %s",
                 self.store.map_count(), self.legacy_path)

    # -- status --------------------------------------------------------------

    def status(self) -> dict[str, Any]:
        st = self.store.get()
        done, total = st["migrated_records"], st["total_records"]
        rate = 0.0
        if self._rate_samples:
            n = sum(s[0] for s in self._rate_samples)
            dt = sum(s[1] for s in self._rate_samples)
            rate = n / dt if dt > 0 else 0.0
        eta = (total - done) / rate if rate > 0 and total > done else None
        return {
            "state": st["state"],
            "paused_from": st["paused_from"],
            "legacy_path": st["legacy_path"],
            "total_records": total,
            "migrated_records": done,
            # clamped: cutover tail rows can push the map past the total
            # frozen at validation time
            "progress_pct": min(100.0, round(100.0 * done / total, 1))
            if total else 0.0,
            "records_per_second": round(rate, 1),
            "eta_seconds": round(eta, 1) if eta is not None else None,
            "last_migrated_id": st["last_migrated_id"],
            "validation_attempts": st["validation_attempts"],
            "consecutive_errors": st["consecutive_errors"],
            "error": st["error"],
            "started_at": st["started_at"],
            "completed_at": st["completed_at"],
            "dual_write": {
                "enabled": self.dual_write_enabled,
                "installed": self._uninstall_hook is not None,
                "queued": len(self._dw_queue),
                "written": self._dw_written,
                "dropped": self._dw_dropped,
            },
        }
