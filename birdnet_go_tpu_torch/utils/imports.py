"""Legacy BirdNET-Go database access, for the live migration
(``datastore/migration.py``).

Reference: internal/datastore/model.go — the reference's GORM SQLite
schema: notes + note_reviews/note_comments/note_locks/results.

A copy of ``open_birdnet_go_db`` and ``legacy_note_entry`` from
``birdnet_go_tpu/utils/imports.py`` for the port; the BirdNET-Pi importers
and the one-shot legacy import of that module wait for the CLI's
``import`` command (ROADMAP.md queue 1). ``tests/test_torch_aux.py`` holds
the migration built on them to the JAX package's.
"""

from __future__ import annotations

import datetime as _dt
from pathlib import Path

from birdnet_go_tpu_torch.analysis.results import Detection
from birdnet_go_tpu_torch.taxonomy.labels import Species


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
