"""Clip retention: age- and usage-based cleanup + clip↔DB reconciliation.

Reference: internal/diskmanager — deletes exported clips by age policy or
when disk usage exceeds a threshold (oldest-first, optionally sparing
locked/reviewed detections), and reconciles orphans between the clip
directory and the datastore.

A copy of ``birdnet_go_tpu/utils/diskmanager.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_recovery.py`` holds
it to the original. Where it differs from JAX:

- ``reconcile`` lists the database's clip references by paging through
  ``Datastore.get_clip_references`` (keyset by ``id``, as
  ``reconcile_orphans_pass`` pages), where JAX reads
  ``search_detections(limit=100000)``: on a database with more than
  100,000 clip rows JAX's set misses the oldest, reports their files as
  orphans, and ``recover_startup`` deletes them
  (``test_reconcile_pages_past_100k_clip_rows``).
"""

from __future__ import annotations

import dataclasses
import logging
import shutil
import threading
import time
from pathlib import Path

log = logging.getLogger("birdnet_tpu.diskmanager")

_MEDIA_EXTS = {".wav", ".flac", ".mp3", ".m4a", ".opus", ".png"}


@dataclasses.dataclass
class RetentionPolicy:
    mode: str = "age"                 # "age" | "usage" | "none"
    max_age_days: float = 30.0
    max_usage_percent: float = 80.0
    min_clips_per_species: int = 0    # keep at least N newest per species


@dataclasses.dataclass
class CleanupResult:
    scanned: int = 0
    deleted: int = 0
    freed_bytes: int = 0
    spared_locked: int = 0


class DiskManager:
    def __init__(self, clip_dir: str | Path, policy: RetentionPolicy,
                 datastore=None):
        self.clip_dir = Path(clip_dir)
        self.policy = policy
        self.datastore = datastore
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- policies ------------------------------------------------------------------

    def cleanup(self, now: float | None = None) -> CleanupResult:
        if self.policy.mode == "none" or not self.clip_dir.is_dir():
            return CleanupResult()
        now = now or time.time()
        # rglob: clips nest under year/month (buildClipPath layout);
        # legacy flat files still match
        files = [p for p in self.clip_dir.rglob("*")
                 if p.is_file() and p.suffix.lower() in _MEDIA_EXTS]
        res = CleanupResult(scanned=len(files))
        locked = self._locked_clip_names()
        if self.policy.mode == "age":
            cutoff = now - self.policy.max_age_days * 86400
            victims = [p for p in files if p.stat().st_mtime < cutoff]
        else:                                     # usage
            usage = shutil.disk_usage(self.clip_dir)
            used_pct = 100.0 * (usage.total - usage.free) / usage.total
            if used_pct <= self.policy.max_usage_percent:
                return res
            # delete oldest-first until under threshold (estimate by bytes)
            files.sort(key=lambda p: p.stat().st_mtime)
            need = (used_pct - self.policy.max_usage_percent) / 100.0 \
                * usage.total
            victims = []
            acc = 0
            for p in files:
                if acc >= need:
                    break
                victims.append(p)
                acc += p.stat().st_size
        for p in victims:
            # locked_clip_names stores DB clip_name values — relative
            # paths under the clip dir for nested clips, bare names for
            # legacy flat ones; check both forms
            rel = p.relative_to(self.clip_dir).as_posix()
            if rel in locked or p.name in locked:
                res.spared_locked += 1
                continue
            try:
                size = p.stat().st_size
                p.unlink()
                res.deleted += 1
                res.freed_bytes += size
            except OSError as e:
                log.warning("failed deleting %s: %s", p, e)
        return res

    def _locked_clip_names(self) -> set[str]:
        """Clips protected from retention (GetLockedNotesClipPaths —
        one indexed query rather than scanning every detection row)."""
        if self.datastore is None:
            return set()
        try:
            return set(self.datastore.locked_clip_names())
        except Exception:
            return set()

    # -- reconciliation ----------------------------------------------------------------

    def _db_clip_names(self) -> set[str]:
        """Every clip_name a detection row holds, paged by id in
        RECONCILE_CHUNK rows (no cap on the table's size)."""
        names: set[str] = set()
        after = 0
        while True:
            rows = self.datastore.get_clip_references(
                after, self.RECONCILE_CHUNK)
            if not rows:
                return names
            names.update(r["clip_name"] for r in rows)
            after = rows[-1]["id"]

    def reconcile(self) -> dict:
        """Report clip↔DB orphans: files w/o detection rows and rows whose
        clip file is missing."""
        db_clips = (self._db_clip_names() if self.datastore is not None
                    else set())
        fs_clips = {p.relative_to(self.clip_dir).as_posix()
                    for p in self.clip_dir.rglob("*")
                    if p.is_file() and p.suffix.lower() in _MEDIA_EXTS
                    and p.suffix.lower() != ".png"} \
            if self.clip_dir.is_dir() else set()
        return {
            "orphan_files": sorted(fs_clips - db_clips),
            "missing_files": sorted(db_clips - fs_clips),
        }

    # -- orphan reference reconcile (clip_reconcile.go) --------------------------------

    # Age below which a detection's clip may still be being written by
    # the encoder — keyed on the detection's COMPLETION time, never its
    # begin time (an extended capture starts minutes before its tail is
    # written). ClipRecencyWindow.
    CLIP_RECENCY_WINDOW = 600.0
    RECONCILE_CHUNK = 200

    def reconcile_orphans_pass(self, now: float | None = None,
                               chunk_pause: float = 0.0) -> dict:
        """Clear DB clip_name references whose audio file is confirmed
        missing (ghosts from failed exports). NEVER deletes files; only
        clears references so clip_name stays a truthful signal.

        Fail-safe guards (leave a stale reference rather than risk
        mass-clearing on a detached volume):
        - directory-present: unconfigured/missing clip dir aborts;
        - detached-storage: a chunk where EVERY evaluable row is an
          orphan (zero positive evidence storage is attached) aborts;
        - recency: rows completed within CLIP_RECENCY_WINDOW (or with
          unknown completion time) are skipped — a clip still being
          encoded is never cleared.
        """
        res = {"scanned": 0, "cleared": 0, "aborted": False,
               "abort_reason": ""}
        if self.datastore is None:
            res.update(aborted=True, abort_reason="no datastore")
            return res
        base = self.clip_dir
        if not base.is_dir():
            res.update(aborted=True,
                       abort_reason="clip directory unavailable")
            return res
        now = now or time.time()
        after = 0
        while not self._stop.is_set():
            rows = self.datastore.get_clip_references(
                after, self.RECONCILE_CHUNK)
            if not rows:
                return res
            res["scanned"] += len(rows)
            after = rows[-1]["id"]
            orphans, evaluable, present_seen = [], 0, False
            for r in rows:
                done = r.get("end_time") or 0
                if not done or now - done < self.CLIP_RECENCY_WINDOW:
                    continue                       # recency guard
                name = r["clip_name"]
                p = Path(name)
                if p.is_absolute() or ".." in p.parts:
                    continue                       # never resolve outside
                try:
                    exists = (base / p).is_file()
                except OSError:
                    continue                       # indeterminate: skip
                evaluable += 1
                if exists:
                    present_seen = True
                else:
                    orphans.append(name)
            if evaluable and not present_seen:
                # detached-storage guard: an all-orphan chunk is more
                # likely an unmounted share than a thousand failed
                # exports — abort with nothing cleared this chunk
                res.update(aborted=True,
                           abort_reason="no positive evidence storage is "
                                        "attached (all-orphan chunk)")
                return res
            if orphans:
                res["cleared"] += self.datastore.clear_clip_names(orphans)
                log.info("clip reconcile: cleared %d orphan references",
                         len(orphans))
            if chunk_pause and self._stop.wait(chunk_pause):
                break
        res.update(aborted=True, abort_reason="shutdown")
        return res

    # -- background loop ---------------------------------------------------------------

    def start(self, interval_seconds: float = 3600.0) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(interval_seconds,), name="diskmanager",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                res = self.cleanup()
                if res.deleted:
                    log.info("retention: deleted %d clips (%.1f MB)",
                             res.deleted, res.freed_bytes / 1e6)
            except Exception:
                log.exception("cleanup failed")
            try:
                rec = self.reconcile_orphans_pass(chunk_pause=3.0)
                if rec["aborted"] and rec["abort_reason"] != "shutdown":
                    log.warning("clip reconcile aborted: %s",
                                rec["abort_reason"])
            except Exception:
                log.exception("clip reconcile failed")
