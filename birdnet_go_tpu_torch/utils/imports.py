"""BirdNET-Pi data import.

Reference: internal/imports (2.6k LoC) — discovers a BirdNET-Pi
installation (its `BirdDB.txt`/CSV detection log and clip directory),
stages the data, and writes detections into the datastore.

BirdNET-Pi's detection log is semicolon/CSV with columns
Date;Time;Sci_Name;Com_Name;Confidence[;Lat;Lon;Cutoff;Week;Sens;Overlap]
(header optional, both ';' and ',' separators in the wild).

A copy of ``birdnet_go_tpu/utils/imports.py`` for the port, which imports
nothing of the JAX package: the BirdNET-Pi log importer and its job
manager (the API's ``imports/*`` routes, the CLI's ``import``), and the
legacy BirdNET-Go database import, whose ``open_birdnet_go_db`` and
``legacy_note_entry`` the live migration shares
(``datastore/migration.py``). ``tests/test_torch_imports.py`` holds it to
the original.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime as _dt
import logging
from pathlib import Path

from birdnet_go_tpu_torch.analysis.results import Detection
from birdnet_go_tpu_torch.taxonomy.labels import Species

log = logging.getLogger("birdnet_tpu.imports")


@dataclasses.dataclass
class ImportResult:
    scanned: int = 0
    imported: int = 0
    skipped: int = 0
    errors: int = 0


def _sniff_delimiter(sample: str) -> str:
    return ";" if sample.count(";") >= sample.count(",") else ","


_HEADER_HINTS = ("date", "sci_name", "com_name", "confidence")


def parse_birdnet_pi_log(path: str | Path) -> list[Detection]:
    """Parse a BirdNET-Pi detection log into Detection records."""
    path = Path(path)
    text = path.read_text(encoding="utf-8", errors="replace")
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return []
    delim = _sniff_delimiter(lines[0])
    rows = list(csv.reader(lines, delimiter=delim))
    start = 0
    first = [c.strip().lower() for c in rows[0]]
    if any(h in first for h in _HEADER_HINTS):
        start = 1
    out = []
    for row in rows[start:]:
        if len(row) < 5:
            continue
        try:
            date_s, time_s, sci, com, conf = (row[0].strip(), row[1].strip(),
                                              row[2].strip(), row[3].strip(),
                                              float(row[4]))
            ts = _dt.datetime.strptime(f"{date_s} {time_s}",
                                       "%Y-%m-%d %H:%M:%S")
        except (ValueError, IndexError):
            continue
        out.append(Detection(
            species=Species(sci, com), confidence=conf,
            begin_seconds=ts.timestamp(), end_seconds=ts.timestamp() + 3.0,
            model_id="BirdNET-Pi", source_id="birdnet-pi-import",
            timestamp=ts))
    return out


def import_birdnet_pi(datastore, log_path: str | Path,
                      min_confidence: float = 0.0,
                      dedup: bool = True) -> ImportResult:
    """Import a BirdNET-Pi log; dedup skips rows whose (timestamp, species)
    already exist."""
    res = ImportResult()
    detections = parse_birdnet_pi_log(log_path)
    res.scanned = len(detections)
    existing: set[tuple[float, str]] = set()
    if dedup:
        for row in datastore.search_detections(limit=1000000):
            existing.add((row["timestamp"], row["scientific_name"]))
    for d in detections:
        if d.confidence < min_confidence:
            res.skipped += 1
            continue
        key = (d.timestamp.timestamp(), d.species.scientific)
        if dedup and key in existing:
            res.skipped += 1
            continue
        try:
            datastore.insert_detection(d)
            existing.add(key)
            res.imported += 1
        except Exception:
            res.errors += 1
            log.exception("import row failed")
    return res


def discover_birdnet_pi(mounts: list[str | Path]) -> list[Path]:
    """Probe candidate mount points for BirdNET-Pi detection logs."""
    found = []
    for m in mounts:
        base = Path(m)
        if not base.is_dir():
            continue
        for candidate in ("BirdDB.txt", "BirdNET-Pi/BirdDB.txt",
                          "birdnet/BirdDB.txt"):
            p = base / candidate
            if p.is_file():
                found.append(p)
    return found


@dataclasses.dataclass
class ImportJob:
    """One asynchronous import (reference: api/v2 imports job API)."""

    id: int
    path: str
    status: str = "pending"       # pending|running|completed|failed|cancelled
    scanned: int = 0
    imported: int = 0
    skipped: int = 0
    errors: int = 0
    error: str = ""
    started_at: float = 0.0
    finished_at: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ImportJobManager:
    """Threaded import jobs with progress + cancel (POST /imports/birdnet-pi,
    GET /imports/jobs[/:id], POST /imports/jobs/:id/cancel)."""

    def __init__(self, datastore):
        import threading

        self.datastore = datastore
        self._jobs: dict[int, ImportJob] = {}
        self._cancel: dict[int, "threading.Event"] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._threading = threading

    def submit(self, path: str | Path,
               min_confidence: float = 0.0) -> ImportJob:
        import time as _t

        with self._lock:
            self._seq += 1
            job = ImportJob(id=self._seq, path=str(path))
            self._jobs[job.id] = job
            cancel = self._threading.Event()
            self._cancel[job.id] = cancel

        def _run():
            job.status = "running"
            job.started_at = _t.time()
            try:
                detections = parse_birdnet_pi_log(path)
                job.scanned = len(detections)
                existing = {(r["timestamp"], r["scientific_name"])
                            for r in self.datastore.search_detections(
                                limit=1000000)}
                for d in detections:
                    if cancel.is_set():
                        job.status = "cancelled"
                        break
                    if d.confidence < min_confidence:
                        job.skipped += 1
                        continue
                    key = (d.timestamp.timestamp(), d.species.scientific)
                    if key in existing:
                        job.skipped += 1
                        continue
                    try:
                        self.datastore.insert_detection(d)
                        existing.add(key)
                        job.imported += 1
                    except Exception:
                        job.errors += 1
                else:
                    job.status = "completed"
            except Exception as e:  # noqa: BLE001
                job.status = "failed"
                job.error = str(e)
            finally:
                job.finished_at = _t.time()

        t = self._threading.Thread(target=_run, name=f"import-{job.id}",
                                   daemon=True)
        t.start()
        return job

    def get(self, job_id: int) -> ImportJob | None:
        with self._lock:
            return self._jobs.get(job_id)

    def list(self) -> list[dict]:
        with self._lock:
            return [j.as_dict() for j in self._jobs.values()]

    def cancel(self, job_id: int) -> bool:
        with self._lock:
            ev = self._cancel.get(job_id)
            if ev is None:
                return False
            ev.set()
            return True


# -- legacy BirdNET-Go database import ----------------------------------------------

def open_birdnet_go_db(db_path: str | Path):
    """Open a reference GORM SQLite database read-only; returns
    (connection, table-name set). Raises ValueError if it isn't one."""
    import sqlite3

    conn = sqlite3.connect(f"file:{Path(db_path)}?mode=ro", uri=True)
    conn.row_factory = sqlite3.Row
    tables = {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")}
    if "notes" not in tables:
        conn.close()
        raise ValueError("not a BirdNET-Go database (no notes table)")
    return conn, tables


def legacy_note_entry(conn, tables: set, n) -> dict | None:
    """Convert one reference `notes` row (plus its results/reviews/comments/
    locks satellites) into our normalized entry dict, or None when the row's
    date/time is unparseable. Shared by the one-shot importer and the live
    migration worker (datastore/migration.py)."""
    try:
        when = _dt.datetime.strptime(
            f"{n['date']} {n['time']}", "%Y-%m-%d %H:%M:%S")
    except (ValueError, TypeError):
        return None
    det = Detection(
        species=Species(n["scientific_name"] or "",
                        n["common_name"] or ""),
        confidence=float(n["confidence"] or 0.0),
        begin_seconds=0.0, end_seconds=3.0,
        model_id="BirdNET_V2.4",           # legacy DB is v2.4-only
        source_id="import:birdnet-go",
        timestamp=when,
        species_code=n["species_code"] or "")
    entry = {"detection": det, "results": [], "review": None,
             "comments": [], "locked": False, "legacy_id": n["id"]}
    nid = n["id"]
    if "results" in tables:
        for r in conn.execute(
                "SELECT species, confidence FROM results"
                " WHERE note_id = ? ORDER BY confidence DESC",
                (nid,)):
            # label format "Scientific_Common" (detection/species.go)
            sci, _, common = (r["species"] or "").partition("_")
            entry["results"].append(
                (sci, common, float(r["confidence"] or 0.0)))
    if "note_reviews" in tables:
        row = conn.execute(
            "SELECT verified FROM note_reviews WHERE note_id = ?",
            (nid,)).fetchone()
        if row and row["verified"]:
            entry["review"] = row["verified"]
    if "note_comments" in tables:
        entry["comments"] = [
            r["entry"] for r in conn.execute(
                "SELECT entry FROM note_comments WHERE note_id = ?"
                " ORDER BY created_at", (nid,))]
    if "note_locks" in tables:
        entry["locked"] = conn.execute(
            "SELECT 1 FROM note_locks WHERE note_id = ?",
            (nid,)).fetchone() is not None
    return entry


def parse_birdnet_go_db(db_path: str | Path) -> list[dict]:
    """Read the reference's GORM SQLite schema (datastore/model.go: notes +
    note_reviews/note_comments/note_locks/results) into normalized rows so
    a reference deployment can switch to this framework with its history.

    Returns dicts: {detection: Detection, results: [(sci, common, conf)],
    review: str|None, comments: [str], locked: bool}."""
    conn, tables = open_birdnet_go_db(db_path)
    try:
        out = []
        for n in conn.execute(
                "SELECT id, date, time, scientific_name, common_name,"
                " species_code, confidence, clip_name FROM notes"):
            entry = legacy_note_entry(conn, tables, n)
            if entry is not None:
                out.append(entry)
        return out
    finally:
        conn.close()


def import_birdnet_go_db(datastore, db_path: str | Path,
                         dedup: bool = True) -> ImportResult:
    """Full-fidelity migration from a reference BirdNET-Go database:
    detections + secondary results + review verdicts + comments + locks."""
    res = ImportResult()
    rows = parse_birdnet_go_db(db_path)
    res.scanned = len(rows)
    existing: set[tuple[float, str]] = set()
    if dedup:
        for row in datastore.search_detections(limit=1000000):
            existing.add((row["timestamp"], row["scientific_name"]))
    for entry in rows:
        d = entry["detection"]
        key = (d.timestamp.timestamp(), d.species.scientific)
        if dedup and key in existing:
            res.skipped += 1
            continue
        try:
            det_id = datastore.insert_detection(
                d, clip_name=None, results=entry["results"] or None)
            if entry["review"]:
                datastore.review_detection(det_id, entry["review"])
            for text in entry["comments"]:
                datastore.add_comment(det_id, text)
            if entry["locked"]:
                datastore.lock_detection(det_id, True)
            existing.add(key)
            res.imported += 1
        except Exception:
            res.errors += 1
            log.exception("birdnet-go row import failed")
    return res
