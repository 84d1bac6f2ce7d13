"""SQLite datastore.

Schema follows the reference's v2 normalized direction
(internal/datastore/v2/entities) at reduced surface: a `detections` table
(the Note analogue), `model_contributions` (consensus records),
`reviews`, `dynamic_thresholds`. WAL journal, busy-timeout, automigrate on
open (datastore/manage.go analogue).

A copy of ``birdnet_go_tpu/datastore/sqlite.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_detection.py``
holds it to the original.
"""

from __future__ import annotations

import datetime as _dt
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any

from birdnet_go_tpu_torch.analysis.results import Detection
from birdnet_go_tpu_torch.utils import tracing

_SCHEMA = """
CREATE TABLE IF NOT EXISTS detections (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    timestamp REAL NOT NULL,
    date TEXT NOT NULL,
    time TEXT NOT NULL,
    source_id TEXT NOT NULL DEFAULT '',
    model_id TEXT NOT NULL DEFAULT '',
    scientific_name TEXT NOT NULL,
    common_name TEXT NOT NULL DEFAULT '',
    species_code TEXT NOT NULL DEFAULT '',
    confidence REAL NOT NULL,
    begin_time REAL NOT NULL DEFAULT 0,
    end_time REAL NOT NULL DEFAULT 0,
    clip_name TEXT NOT NULL DEFAULT '',
    locked INTEGER NOT NULL DEFAULT 0
);
CREATE INDEX IF NOT EXISTS idx_det_ts ON detections(timestamp);
CREATE INDEX IF NOT EXISTS idx_det_sci ON detections(scientific_name);
CREATE INDEX IF NOT EXISTS idx_det_date ON detections(date);
-- point probe for the incremental daily_events species counter
CREATE INDEX IF NOT EXISTS idx_det_date_sci
    ON detections(date, scientific_name);

CREATE TABLE IF NOT EXISTS model_contributions (
    detection_id INTEGER NOT NULL REFERENCES detections(id) ON DELETE CASCADE,
    model_id TEXT NOT NULL,
    hit_count INTEGER NOT NULL,
    max_confidence REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_mc_det ON model_contributions(detection_id);

-- per-detection secondary predictions: the full top-K of the window that
-- produced the stored detection (reference: Note.Results children,
-- datastore/model.go + GetNoteResults)
CREATE TABLE IF NOT EXISTS results (
    detection_id INTEGER NOT NULL REFERENCES detections(id) ON DELETE CASCADE,
    result_rank INTEGER NOT NULL,      -- 'rank' is reserved in MySQL 8
    scientific_name TEXT NOT NULL,
    common_name TEXT NOT NULL DEFAULT '',
    confidence REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_results_det ON results(detection_id);

-- per-day rollups (reference: DailyEvents table, Save/GetDailyEvents)
CREATE TABLE IF NOT EXISTS daily_events (
    date TEXT PRIMARY KEY,
    detections INTEGER NOT NULL DEFAULT 0,
    species INTEGER NOT NULL DEFAULT 0,
    first_detection TEXT NOT NULL DEFAULT '',
    last_detection TEXT NOT NULL DEFAULT ''
);

CREATE TABLE IF NOT EXISTS reviews (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    detection_id INTEGER NOT NULL REFERENCES detections(id) ON DELETE CASCADE,
    verdict TEXT NOT NULL,             -- 'correct' | 'false_positive'
    comment TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_reviews_det ON reviews(detection_id);

CREATE TABLE IF NOT EXISTS dynamic_thresholds (
    model_id TEXT NOT NULL,
    scientific_name TEXT NOT NULL,
    level INTEGER NOT NULL,
    high_conf_count INTEGER NOT NULL,
    expires_at REAL NOT NULL,
    last_learned_at REAL NOT NULL DEFAULT 0,
    PRIMARY KEY (model_id, scientific_name)
);

CREATE TABLE IF NOT EXISTS image_cache (
    scientific_name TEXT PRIMARY KEY,   -- lowercased key
    url TEXT NOT NULL DEFAULT '',       -- '' = negative cache entry
    thumbnail_url TEXT NOT NULL DEFAULT '',
    author TEXT NOT NULL DEFAULT '',
    license TEXT NOT NULL DEFAULT '',
    provider TEXT NOT NULL DEFAULT '',
    cached_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS comments (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    detection_id INTEGER NOT NULL REFERENCES detections(id) ON DELETE CASCADE,
    text TEXT NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS threshold_events (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    model_id TEXT NOT NULL,
    scientific_name TEXT NOT NULL,
    previous_level INTEGER NOT NULL,
    new_level INTEGER NOT NULL,
    previous_value REAL NOT NULL,
    new_value REAL NOT NULL,
    reason TEXT NOT NULL,              -- 'high_confidence' | 'expiry'
    confidence REAL NOT NULL,
    created_at REAL NOT NULL
);

-- persisted notification inbox (reference: SaveNotificationHistory /
-- GetActiveNotificationHistory / DeleteExpiredNotificationHistory,
-- datastore/interfaces.go) so the UI inbox survives restarts
CREATE TABLE IF NOT EXISTS notifications (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    title TEXT NOT NULL,
    message TEXT NOT NULL,
    priority TEXT NOT NULL,
    timestamp REAL NOT NULL,
    is_read INTEGER NOT NULL DEFAULT 0,
    payload TEXT NOT NULL DEFAULT '{}'
);
CREATE INDEX IF NOT EXISTS idx_notif_ts ON notifications(timestamp);

CREATE TABLE IF NOT EXISTS hourly_weather (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    time REAL NOT NULL UNIQUE,
    temperature REAL, humidity REAL, pressure REAL,
    wind_speed REAL, wind_deg REAL, clouds REAL, description TEXT,
    icon TEXT
);
"""


class Datastore:
    """Thread-safe SQLite store (single connection + lock; WAL)."""

    def __init__(self, path: str | Path = ":memory:"):
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA busy_timeout=5000")
            self._conn.execute("PRAGMA foreign_keys=ON")
            self._conn.executescript(_SCHEMA)
            self._automigrate()
            self._conn.commit()

    def _automigrate(self) -> None:
        """Column-level migrations for databases created by older builds
        (GORM AutoMigrate analogue). Caller holds the lock."""
        cols = {r[1] for r in self._conn.execute(
            "PRAGMA table_info(dynamic_thresholds)")}
        if "last_learned_at" not in cols:
            self._conn.execute(
                "ALTER TABLE dynamic_thresholds"
                " ADD COLUMN last_learned_at REAL NOT NULL DEFAULT 0")
        wcols = {r[1] for r in self._conn.execute(
            "PRAGMA table_info(hourly_weather)")}
        if "icon" not in wcols:
            self._conn.execute(
                "ALTER TABLE hourly_weather ADD COLUMN icon TEXT")

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- detections ------------------------------------------------------------

    def insert_detection(self, d: Detection, clip_name: str | None = None,
                         contributions: dict[str, Any] | None = None,
                         results: list[tuple] | None = None) -> int:
        ts = (d.timestamp.timestamp() if d.timestamp else d.begin_seconds)
        when = _dt.datetime.fromtimestamp(ts)
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO detections (timestamp, date, time, source_id,"
                " model_id, scientific_name, common_name, species_code,"
                " confidence, begin_time, end_time, clip_name)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                (ts, when.strftime("%Y-%m-%d"), when.strftime("%H:%M:%S"),
                 d.source_id, d.model_id, d.species.scientific,
                 d.species.common, d.species_code, d.confidence,
                 d.begin_seconds, d.end_seconds, clip_name or ""))
            det_id = cur.lastrowid
            if contributions:
                for model_id, c in contributions.items():
                    self._conn.execute(
                        "INSERT INTO model_contributions (detection_id,"
                        " model_id, hit_count, max_confidence)"
                        " VALUES (?,?,?,?)",
                        (det_id, model_id, getattr(c, "count", 0),
                         getattr(c, "max_confidence", 0.0)))
            if results:
                # full top-K of the detecting window (Note.Results parity)
                for rank, (sci, common, conf) in enumerate(results, 1):
                    self._conn.execute(
                        "INSERT INTO results (detection_id, result_rank,"
                        " scientific_name, common_name, confidence)"
                        " VALUES (?,?,?,?,?)",
                        (det_id, rank, sci, common, float(conf)))
            self._bump_daily_events(when.strftime("%Y-%m-%d"),
                                    when.strftime("%H:%M:%S"),
                                    d.species.scientific)
            with tracing.span("db.commit"):
                self._conn.commit()
            return int(det_id)

    def _bump_daily_events(self, date: str, time_s: str, sci: str) -> None:
        """Incremental per-day rollup maintenance on the insert path
        (reference: DailyEvents maintained alongside Note saves). The
        full-rescan upsert this replaces made every insert O(rows that
        day) — quadratic across a day and the dominant CPU cost of bulk
        migration (measured 79% of migration time at 4k rows). Caller
        holds the lock; the detections row is already inserted, so the
        species is new for the day iff it now appears exactly once."""
        new_species = self._conn.execute(
            "SELECT COUNT(*) FROM (SELECT 1 FROM detections WHERE date = ?"
            " AND scientific_name = ? LIMIT 2)",
            (date, sci)).fetchone()[0] < 2
        # TEXT HH:MM:SS compares chronologically; '' (a row produced by a
        # legacy recompute over an empty day) must lose to any real time
        self._conn.execute(
            "INSERT INTO daily_events (date, detections, species,"
            " first_detection, last_detection) VALUES (?,1,1,?,?)"
            " ON CONFLICT(date) DO UPDATE SET"
            " detections = detections + 1,"
            " species = species + ?,"
            " first_detection = CASE WHEN first_detection = ''"
            "   THEN excluded.first_detection"
            "   ELSE MIN(first_detection, excluded.first_detection) END,"
            " last_detection = MAX(last_detection,"
            "   excluded.last_detection)",
            (date, time_s, time_s, 1 if new_species else 0))

    def _upsert_daily_events(self, date: str) -> dict[str, Any]:
        """Full recompute of the per-day rollup — the explicit
        save_daily_events API and repair paths; inserts use the
        incremental _bump_daily_events instead. Caller holds the lock."""
        row = self._conn.execute(
            "SELECT COUNT(*) AS n, COUNT(DISTINCT scientific_name) AS s,"
            " MIN(time) AS first, MAX(time) AS last"
            " FROM detections WHERE date = ?", (date,)).fetchone()
        ev = {"date": date, "detections": int(row["n"] or 0),
              "species": int(row["s"] or 0),
              "first_detection": row["first"] or "",
              "last_detection": row["last"] or ""}
        self._conn.execute(
            "INSERT INTO daily_events (date, detections, species,"
            " first_detection, last_detection) VALUES (?,?,?,?,?)"
            " ON CONFLICT(date) DO UPDATE SET detections=excluded"
            ".detections, species=excluded.species, first_detection="
            "excluded.first_detection, last_detection="
            "excluded.last_detection", (date, ev["detections"],
                                        ev["species"],
                                        ev["first_detection"],
                                        ev["last_detection"]))
        return ev

    def get_results(self, det_id: int) -> list[dict[str, Any]]:
        """Secondary predictions stored with a detection
        (GetNoteResults, datastore/interfaces.go)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT result_rank, scientific_name,"
                " common_name, confidence"
                " FROM results WHERE detection_id = ? ORDER BY result_rank",
                (det_id,)).fetchall()
        # alias host-side: `AS rank` would hit MySQL 8's reserved word
        return [{"rank": r["result_rank"],
                 "scientific_name": r["scientific_name"],
                 "common_name": r["common_name"],
                 "confidence": r["confidence"]} for r in rows]

    def optimize(self) -> None:
        """VACUUM + ANALYZE (reference: datastore Optimize / 'database
        doctor' maintenance)."""
        with self._lock:
            self._conn.commit()
            self._conn.execute("VACUUM")
            self._conn.execute("ANALYZE")

    def save_daily_events(self, date: str) -> dict[str, Any]:
        """Recompute + upsert the per-day rollup (SaveDailyEvents);
        insert_detection keeps it current automatically."""
        with self._lock:
            ev = self._upsert_daily_events(date)
            self._conn.commit()
        return ev

    def get_daily_events(self, date: str) -> dict[str, Any] | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM daily_events WHERE date = ?",
                (date,)).fetchone()
        return dict(row) if row else None

    def detection_trends(self, days: int = 30) -> dict[str, Any]:
        """Windowed trend comparison (GetDetectionTrends): this period vs
        the previous period of equal length — detections, active species,
        and per-day counts for sparklines."""
        now = _dt.date.today()
        cur_from = (now - _dt.timedelta(days=days - 1)).isoformat()
        prev_from = (now - _dt.timedelta(days=2 * days - 1)).isoformat()
        prev_to = (now - _dt.timedelta(days=days)).isoformat()
        with self._lock:
            def _window(frm, to):
                row = self._conn.execute(
                    "SELECT COUNT(*) AS n,"
                    " COUNT(DISTINCT scientific_name) AS s"
                    " FROM detections WHERE date >= ? AND date <= ?",
                    (frm, to)).fetchone()
                return int(row["n"] or 0), int(row["s"] or 0)

            cur_n, cur_s = _window(cur_from, now.isoformat())
            prev_n, prev_s = _window(prev_from, prev_to)
            daily = {r["date"]: r["n"] for r in self._conn.execute(
                "SELECT date, COUNT(*) AS n FROM detections"
                " WHERE date >= ? GROUP BY date", (cur_from,))}
        series = []
        for i in range(days):
            d = (now - _dt.timedelta(days=days - 1 - i)).isoformat()
            series.append({"date": d, "count": daily.get(d, 0)})
        def _pct(cur, prev):
            return None if prev == 0 else round((cur - prev) / prev * 100, 1)
        return {"days": days,
                "detections": cur_n, "detections_prev": prev_n,
                "detections_change_pct": _pct(cur_n, prev_n),
                "species": cur_s, "species_prev": prev_s,
                "species_change_pct": _pct(cur_s, prev_s),
                "daily": series}

    def latest_hourly_weather(self) -> dict[str, Any] | None:
        """Most recent stored observation (LatestHourlyWeather)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM hourly_weather ORDER BY time DESC LIMIT 1"
            ).fetchone()
        return dict(row) if row else None

    def locked_clip_names(self) -> list[str]:
        """Clip files protected from retention (GetLockedNotesClipPaths —
        consumed by the diskmanager's reconcile pass)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT clip_name FROM detections"
                " WHERE locked = 1 AND clip_name != ''").fetchall()
        return [r["clip_name"] for r in rows]

    def integrity_check(self) -> dict[str, Any]:
        """Database doctor: PRAGMA integrity_check + table inventory
        (the MySQL engine overrides this with SHOW TABLE STATUS)."""
        with self._lock:
            ok = self._conn.execute(
                "PRAGMA integrity_check").fetchone()[0] == "ok"
            tables = self._conn.execute(
                "SELECT COUNT(*) FROM sqlite_master WHERE type='table'"
            ).fetchone()[0]
        return {"tables": int(tables), "engine_ok": bool(ok)}

    def set_clip_name(self, det_id: int, clip_name: str) -> bool:
        """Attach a (re)generated clip to an existing detection
        (POST /audio/:id/clip — on-demand export)."""
        with self._lock:
            cur = self._conn.execute(
                "UPDATE detections SET clip_name = ? WHERE id = ?",
                (clip_name, det_id))
            self._conn.commit()
            return cur.rowcount > 0

    def get_detection(self, det_id: int) -> dict[str, Any] | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT *, (SELECT verdict FROM reviews rv"
                " WHERE rv.detection_id = detections.id"
                " ORDER BY rv.id DESC LIMIT 1) AS verdict"
                " FROM detections WHERE id = ?", (det_id,)).fetchone()
            if row is None:
                return None
            d = dict(row)
            d["contributions"] = [dict(r) for r in self._conn.execute(
                "SELECT model_id, hit_count, max_confidence FROM"
                " model_contributions WHERE detection_id = ?", (det_id,))]
            return d

    def delete_detection(self, det_id: int) -> bool:
        """Delete one unlocked detection and recompute its day's rollup
        in the same transaction, so daily_events never counts a deleted
        row (the JAX package's copy leaves the rollup stale)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT locked, date FROM detections WHERE id = ?",
                (det_id,)).fetchone()
            if row is None:
                return False
            if row["locked"]:
                raise PermissionError(f"detection {det_id} is locked")
            self._conn.execute("DELETE FROM detections WHERE id = ?",
                               (det_id,))
            self._upsert_daily_events(row["date"])
            self._conn.commit()
            return True

    def lock_detection(self, det_id: int, locked: bool = True) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE detections SET locked = ? WHERE id = ?",
                (1 if locked else 0, det_id))
            self._conn.commit()
            return cur.rowcount > 0

    def review_detection(self, det_id: int, verdict: str,
                         comment: str = "") -> int:
        if verdict not in ("correct", "false_positive"):
            raise ValueError(f"invalid verdict {verdict!r}")
        import time as _t

        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO reviews (detection_id, verdict, comment,"
                " created_at) VALUES (?,?,?,?)",
                (det_id, verdict, comment, _t.time()))
            self._conn.commit()
            return int(cur.lastrowid)

    # fixed time-of-day bands (search_advanced.go:282-317 — the reference
    # approximates dawn/day/dusk/night with static local-time windows)
    _TOD_BANDS = {
        "dawn": "(time >= '05:00:00' AND time < '07:00:00')",
        "day": "(time >= '07:00:00' AND time < '18:00:00')",
        "dusk": "(time >= '18:00:00' AND time < '20:00:00')",
        "night": "(time >= '20:00:00' OR time < '05:00:00')",
    }
    _SORTS = {
        "date_desc": "timestamp DESC", "date_asc": "timestamp ASC",
        "species_asc": "common_name ASC, timestamp DESC",
        "species_desc": "common_name DESC, timestamp DESC",
        "confidence_asc": "confidence ASC, timestamp DESC",
        "confidence_desc": "confidence DESC, timestamp DESC",
    }

    def search_detections(self, species: str | None = None,
                          date_from: str | None = None,
                          date_to: str | None = None,
                          source_id: str | None = None,
                          min_confidence: float | None = None,
                          max_confidence: float | None = None,
                          model_id: str | None = None,
                          hour_from: int | None = None,
                          hour_to: int | None = None,
                          verified: str | None = None,
                          locked: bool | None = None,
                          limit: int = 100, offset: int = 0,
                          order: str = "desc",
                          time_of_day: list[str] | None = None,
                          species_scientific: list[str] | None = None,
                          sort_by: str | None = None,
                          with_total: bool = False):
        """Advanced search (datastore/search_advanced.go filters):
        free-text species substring OR exact scientific-name list,
        confidence band, hour window or named time-of-day bands,
        verification state ('correct' | 'false_positive' | 'unreviewed'),
        lock state, model, multi-key sort. with_total=True returns
        (rows, total_matching) for pagination."""
        clauses, args = [], []
        if species or species_scientific:
            # free-text substring on either name column, OR-ed with
            # locale-resolved exact scientific names (HandleSearch
            # mergeSpeciesScientific, search.go:80-85)
            ors = []
            if species:
                # substring on BOTH name columns (search.go TextQuery →
                # scientific/common-name substring path)
                ors.append("scientific_name LIKE ? OR common_name LIKE ?")
                args += [f"%{species}%", f"%{species}%"]
            for sci in (species_scientific or [])[:50]:
                ors.append("scientific_name = ?")
                args.append(sci)
            clauses.append("(" + " OR ".join(ors) + ")")
        if date_from:
            clauses.append("date >= ?"); args.append(date_from)
        if date_to:
            clauses.append("date <= ?"); args.append(date_to)
        if source_id:
            clauses.append("source_id = ?"); args.append(source_id)
        if model_id:
            clauses.append("model_id = ?"); args.append(model_id)
        if min_confidence is not None:
            clauses.append("confidence >= ?"); args.append(min_confidence)
        if max_confidence is not None:
            clauses.append("confidence <= ?"); args.append(max_confidence)
        if hour_from is not None and hour_to is not None \
                and hour_from > hour_to:
            # overnight window (e.g. 22→4, the owl/bat band): wraps midnight
            clauses.append("(CAST(substr(time, 1, 2) AS INTEGER) >= ?"
                           " OR CAST(substr(time, 1, 2) AS INTEGER) <= ?)")
            args += [hour_from, hour_to]
        else:
            if hour_from is not None:
                clauses.append("CAST(substr(time, 1, 2) AS INTEGER) >= ?")
                args.append(hour_from)
            if hour_to is not None:
                clauses.append("CAST(substr(time, 1, 2) AS INTEGER) <= ?")
                args.append(hour_to)
        if time_of_day:
            bands = [self._TOD_BANDS[t.lower()] for t in time_of_day
                     if t.lower() in self._TOD_BANDS]
            if bands:
                clauses.append("(" + " OR ".join(bands) + ")")
        if locked is not None:
            clauses.append("locked = ?"); args.append(1 if locked else 0)
        if verified == "unreviewed":
            clauses.append("id NOT IN (SELECT detection_id FROM reviews)")
        elif verified in ("correct", "false_positive"):
            clauses.append(
                "id IN (SELECT detection_id FROM reviews WHERE verdict = ?)")
            args.append(verified)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        if sort_by in self._SORTS:
            order_sql = self._SORTS[sort_by]
        else:
            order_sql = "timestamp " + (
                "DESC" if order.lower() != "asc" else "ASC")
        # latest review verdict rides along so the browser can render
        # verification badges without N+1 review lookups (reference
        # VerificationBadges.svelte / ReviewCard.svelte)
        sql = (f"SELECT *, (SELECT verdict FROM reviews rv"
               f" WHERE rv.detection_id = detections.id"
               f" ORDER BY rv.id DESC LIMIT 1) AS verdict"
               f" FROM detections {where} ORDER BY {order_sql}"
               f" LIMIT ? OFFSET ?")
        with self._lock:
            rows = [dict(r) for r in self._conn.execute(
                sql, args + [limit, offset])]
            if not with_total:
                return rows
            (total,) = self._conn.execute(
                f"SELECT COUNT(*) FROM detections {where}",
                args).fetchone()
        return rows, int(total)

    def recent_detections(self, limit: int = 10) -> list[dict[str, Any]]:
        return self.search_detections(limit=limit)

    def detections_since(self, since_unix: float, limit: int = 100
                         ) -> list[dict[str, Any]]:
        """New detections after a timestamp (GET /detections/new)."""
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM detections WHERE timestamp > ?"
                " ORDER BY timestamp ASC LIMIT ?", (since_unix, limit))]

    # -- comments (NoteComment CRUD, datastore/interfaces.go) ------------------------

    def add_comment(self, det_id: int, text: str) -> int:
        import time as _t

        now = _t.time()
        with self._lock:
            exists = self._conn.execute(
                "SELECT 1 FROM detections WHERE id = ?",
                (det_id,)).fetchone()
            if exists is None:
                raise KeyError(f"detection {det_id} not found")
            cur = self._conn.execute(
                "INSERT INTO comments (detection_id, text, created_at,"
                " updated_at) VALUES (?,?,?,?)", (det_id, text, now, now))
            self._conn.commit()
            return int(cur.lastrowid)

    def list_comments(self, det_id: int) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM comments WHERE detection_id = ?"
                " ORDER BY id", (det_id,))]

    def update_comment(self, comment_id: int, text: str) -> bool:
        import time as _t

        with self._lock:
            cur = self._conn.execute(
                "UPDATE comments SET text = ?, updated_at = ? WHERE id = ?",
                (text, _t.time(), comment_id))
            self._conn.commit()
            return cur.rowcount > 0

    def delete_comment(self, comment_id: int) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM comments WHERE id = ?", (comment_id,))
            self._conn.commit()
            return cur.rowcount > 0

    # -- image cache (datastore ImageCache, interfaces.go:181-183) -------------------

    def get_image_cache(self, scientific_lower: str) -> dict | None:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM image_cache WHERE scientific_name = ?",
                (scientific_lower,)).fetchone()
            return dict(r) if r else None

    def get_image_cache_batch(self, names: list[str]) -> dict[str, dict]:
        if not names:
            return {}
        ph = ",".join("?" * len(names))
        with self._lock:
            return {r["scientific_name"]: dict(r) for r in self._conn.execute(
                f"SELECT * FROM image_cache WHERE scientific_name IN ({ph})",
                [n.lower() for n in names])}

    def save_image_cache(self, scientific_lower: str, **fields) -> None:
        cols = ["url", "thumbnail_url", "author", "license", "provider",
                "cached_at"]
        vals = [fields.get(c, "" if c != "cached_at" else 0.0) for c in cols]
        with self._lock:
            self._conn.execute(
                "INSERT INTO image_cache (scientific_name, url,"
                " thumbnail_url, author, license, provider, cached_at)"
                " VALUES (?,?,?,?,?,?,?) ON CONFLICT(scientific_name)"
                " DO UPDATE SET url=excluded.url,"
                " thumbnail_url=excluded.thumbnail_url,"
                " author=excluded.author, license=excluded.license,"
                " provider=excluded.provider, cached_at=excluded.cached_at",
                [scientific_lower, *vals])
            self._conn.commit()

    def get_reviews(self, det_id: int) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM reviews WHERE detection_id = ?"
                " ORDER BY id", (det_id,))]

    def first_detection_per_day(self, species: str | None = None,
                                date_from: str | None = None,
                                date_to: str | None = None
                                ) -> list[dict[str, Any]]:
        """Earliest detection time per day (dawn-onset/dawn-chorus input:
        the handler converts to minutes-after-civil-dawn via suncalc)."""
        clauses, args = [], []
        if species:
            clauses.append("scientific_name = ?"); args.append(species)
        if date_from:
            clauses.append("date >= ?"); args.append(date_from)
        if date_to:
            clauses.append("date <= ?"); args.append(date_to)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        # MAX(common_name): portable under MySQL's ONLY_FULL_GROUP_BY
        sql = (f"SELECT date, MIN(time) AS first_time, scientific_name,"
               f" MAX(common_name) AS common_name FROM detections {where}"
               f" GROUP BY date, scientific_name ORDER BY date")
        with self._lock:
            return [dict(r) for r in self._conn.execute(sql, args)]

    def count_detections(self, date_from: str | None = None) -> int:
        sql = "SELECT COUNT(*) FROM detections"
        args: list = []
        if date_from:
            sql += " WHERE date >= ?"
            args.append(date_from)
        with self._lock:
            (n,) = self._conn.execute(sql, args).fetchone()
            return int(n)

    def count_species(self, date_from: str | None = None) -> int:
        sql = "SELECT COUNT(DISTINCT scientific_name) FROM detections"
        args: list = []
        if date_from:
            sql += " WHERE date >= ?"
            args.append(date_from)
        with self._lock:
            (n,) = self._conn.execute(sql, args).fetchone()
            return int(n)

    # -- crash recovery / maintenance ------------------------------------------------

    def integrity_check(self) -> str:
        """`PRAGMA integrity_check` first row — 'ok' on a healthy file.
        Run after reopening a database whose writer was SIGKILLed; SQLite
        replays or rolls back the WAL on open, this verifies the result
        (reference restart path: main.go:63-83 reopens the store before
        services start)."""
        with self._lock:
            (res,) = self._conn.execute("PRAGMA integrity_check").fetchone()
            return str(res)

    def wal_checkpoint(self) -> dict[str, int]:
        """TRUNCATE-checkpoint the WAL into the main file. Returns
        {busy, log_frames, checkpointed_frames}; log_frames > 0 before
        the call means the killed process left unsynced WAL frames that
        this recovery folded in."""
        with self._lock:
            busy, log_n, ckpt = self._conn.execute(
                "PRAGMA wal_checkpoint(TRUNCATE)").fetchone()
            return {"busy": int(busy), "log_frames": int(log_n),
                    "checkpointed_frames": int(ckpt)}

    def count_duplicate_detections(self) -> int:
        """Rows beyond the first sharing (source, model, species,
        begin_time) — the double-count audit after a crash+restart. A
        legitimate pipeline never emits two detections of one species
        from one source/model at the identical window start; any excess
        means restart re-persisted work the killed process already
        committed."""
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COALESCE(SUM(c - 1), 0) FROM ("
                " SELECT COUNT(*) AS c FROM detections"
                " GROUP BY source_id, model_id, scientific_name,"
                " begin_time)").fetchone()
            return int(n)

    # -- analytics ----------------------------------------------------------------

    def species_summary(self, date_from: str | None = None,
                        date_to: str | None = None) -> list[dict[str, Any]]:
        clauses, args = [], []
        if date_from:
            clauses.append("date >= ?"); args.append(date_from)
        if date_to:
            clauses.append("date <= ?"); args.append(date_to)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        sql = (f"SELECT scientific_name,"
               f" MAX(common_name) AS common_name, COUNT(*) AS count,"
               f" MAX(confidence) AS max_confidence,"
               f" AVG(confidence) AS avg_confidence,"
               f" MIN(timestamp) AS first_seen, MAX(timestamp) AS last_seen"
               f" FROM detections {where} GROUP BY scientific_name"
               f" ORDER BY count DESC")
        with self._lock:
            return [dict(r) for r in self._conn.execute(sql, args)]

    def hourly_distribution(self, date: str | None = None,
                            species: str | None = None) -> list[int]:
        clauses, args = [], []
        if date:
            clauses.append("date = ?"); args.append(date)
        if species:
            clauses.append("scientific_name = ?"); args.append(species)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        sql = (f"SELECT CAST(substr(time, 1, 2) AS INTEGER) AS hr,"
               f" COUNT(*) AS n FROM detections {where} GROUP BY hr")
        out = [0] * 24
        with self._lock:
            for r in self._conn.execute(sql, args):
                if 0 <= r["hr"] < 24:
                    out[r["hr"]] = r["n"]
        return out

    def daily_species_summary(self, date: str,
                              min_confidence: float = 0.0
                              ) -> list[dict[str, Any]]:
        """Per-species summary for one day with 24-hour counts — the
        dashboard's species×hour grid (reference
        GET /api/v2/analytics/species/daily, analytics.go:193-265:
        count, hourly_counts[24], max confidence, first/latest heard,
        new-species flags from the all-time first detection)."""
        sql = ("SELECT scientific_name, MAX(common_name) AS common_name,"
               " MAX(species_code) AS species_code,"
               " COUNT(*) AS count, MAX(confidence) AS max_confidence,"
               " MIN(time) AS first_heard, MAX(time) AS latest_heard"
               " FROM detections WHERE date = ? AND confidence >= ?"
               " GROUP BY scientific_name ORDER BY count DESC")
        hr_sql = ("SELECT scientific_name,"
                  " CAST(substr(time, 1, 2) AS INTEGER) AS hr,"
                  " COUNT(*) AS n FROM detections"
                  " WHERE date = ? AND confidence >= ?"
                  " GROUP BY scientific_name, hr")
        first_sql = ("SELECT scientific_name, MIN(date) AS first_date"
                     " FROM detections GROUP BY scientific_name")
        with self._lock:
            rows = [dict(r) for r in self._conn.execute(
                sql, (date, min_confidence))]
            hourly: dict[str, list[int]] = {}
            for r in self._conn.execute(hr_sql, (date, min_confidence)):
                h = hourly.setdefault(r["scientific_name"], [0] * 24)
                if 0 <= r["hr"] < 24:
                    h[r["hr"]] = r["n"]
            first = {r["scientific_name"]: r["first_date"]
                     for r in self._conn.execute(first_sql)}
        import datetime as _dt

        day = _dt.date.fromisoformat(date)
        for r in rows:
            r["hourly_counts"] = hourly.get(r["scientific_name"],
                                            [0] * 24)
            r["high_confidence"] = r["max_confidence"] >= 0.8
            fd = first.get(r["scientific_name"])
            if fd:
                days = (day - _dt.date.fromisoformat(fd)).days
                r["days_since_first_seen"] = max(days, 0)
                # reference semantics: new within the 7-day window
                r["is_new_species"] = 0 <= days <= 7
        return rows

    def daily_counts(self, date_from: str, date_to: str
                     ) -> list[dict[str, Any]]:
        sql = ("SELECT date, COUNT(*) AS count,"
               " COUNT(DISTINCT scientific_name) AS species"
               " FROM detections WHERE date BETWEEN ? AND ?"
               " GROUP BY date ORDER BY date")
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                sql, (date_from, date_to))]

    def confidence_histogram(self, bins: int = 10) -> list[int]:
        out = [0] * bins
        with self._lock:
            for r in self._conn.execute(
                    "SELECT confidence FROM detections"):
                b = min(int(r["confidence"] * bins), bins - 1)
                out[b] += 1
        return out

    def detection_heatmap(self, date_from: str, date_to: str
                          ) -> dict[str, list[int]]:
        """date → 24-hour counts (analytics heatmap endpoint)."""
        sql = ("SELECT date, CAST(substr(time, 1, 2) AS INTEGER) AS hr,"
               " COUNT(*) AS n FROM detections WHERE date BETWEEN ? AND ?"
               " GROUP BY date, hr")
        out: dict[str, list[int]] = {}
        with self._lock:
            for r in self._conn.execute(sql, (date_from, date_to)):
                out.setdefault(r["date"], [0] * 24)[r["hr"]] = r["n"]
        return out

    def phenology(self, species: str, year: int | None = None
                  ) -> list[dict[str, Any]]:
        """Weekly detection counts for one species (phenology chart).

        Weeks use the BirdNET 48-week year: (month−1)·4 + min((day−1)//7+1, 4).
        """
        clauses = ["scientific_name = ?"]
        args: list[Any] = [species]
        if year is not None:
            clauses.append("substr(date, 1, 4) = ?")
            args.append(str(year))
        sql = ("SELECT date, COUNT(*) AS n FROM detections WHERE "
               + " AND ".join(clauses) + " GROUP BY date")
        weeks = [0] * 48
        with self._lock:
            for r in self._conn.execute(sql, args):
                y, m, d = (int(x) for x in r["date"].split("-"))
                week = (m - 1) * 4 + min((d - 1) // 7 + 1, 4)
                weeks[week - 1] += r["n"]
        return [{"week": i + 1, "count": c} for i, c in enumerate(weeks)]

    def year_over_year(self, species: str | None = None
                       ) -> dict[str, list[int]]:
        """Per-year monthly counts (year-over-year comparison view)."""
        clauses, args = [], []
        if species:
            clauses.append("scientific_name = ?")
            args.append(species)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        sql = (f"SELECT substr(date, 1, 4) AS y,"
               f" CAST(substr(date, 6, 2) AS INTEGER) AS m,"
               f" COUNT(*) AS n FROM detections {where} GROUP BY y, m")
        out: dict[str, list[int]] = {}
        with self._lock:
            for r in self._conn.execute(sql, args):
                out.setdefault(r["y"], [0] * 12)[r["m"] - 1] = r["n"]
        return out

    def species_accumulation(self, date_from: str, date_to: str
                             ) -> list[dict[str, Any]]:
        """Cumulative distinct-species curve over a date range."""
        sql = ("SELECT date, scientific_name FROM detections"
               " WHERE date BETWEEN ? AND ? ORDER BY date")
        seen: set[str] = set()
        by_date: dict[str, int] = {}
        with self._lock:
            for r in self._conn.execute(sql, (date_from, date_to)):
                seen.add(r["scientific_name"])
                by_date[r["date"]] = len(seen)
        return [{"date": d, "cumulative_species": n}
                for d, n in sorted(by_date.items())]

    def diversity(self, date_from: str, date_to: str) -> dict[str, float]:
        """Shannon index + richness over a date range."""
        import math

        sql = ("SELECT scientific_name, COUNT(*) AS n FROM detections"
               " WHERE date BETWEEN ? AND ? GROUP BY scientific_name")
        with self._lock:
            counts = [r["n"] for r in self._conn.execute(
                sql, (date_from, date_to))]
        total = sum(counts)
        if not total:
            return {"richness": 0, "shannon": 0.0, "detections": 0}
        shannon = -sum((c / total) * math.log(c / total) for c in counts)
        return {"richness": len(counts), "shannon": round(shannon, 4),
                "detections": total}

    def succession(self, date_from: str | None = None,
                   date_to: str | None = None, top_n: int = 10
                   ) -> list[dict[str, Any]]:
        """Monthly species composition (succession analytics): per month,
        the top-N species and their share of that month's detections."""
        clauses, args = [], []
        if date_from:
            clauses.append("date >= ?"); args.append(date_from)
        if date_to:
            clauses.append("date <= ?"); args.append(date_to)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        sql = (f"SELECT substr(date, 1, 7) AS month, scientific_name,"
               f" MAX(common_name) AS common_name, COUNT(*) AS count"
               f" FROM detections {where}"
               f" GROUP BY month, scientific_name ORDER BY month, count DESC")
        months: dict[str, list[dict]] = {}
        totals: dict[str, int] = {}
        with self._lock:
            for r in self._conn.execute(sql, args):
                m = r["month"]
                totals[m] = totals.get(m, 0) + r["count"]
                if len(months.setdefault(m, [])) < top_n:
                    months[m].append(dict(r))
        out = []
        for m in sorted(months):
            for row in months[m]:
                row["share"] = round(row["count"] / max(totals[m], 1), 4)
            out.append({"month": m, "total": totals[m],
                        "species": months[m]})
        return out

    def time_of_day_species(self, date_from: str, date_to: str,
                            top_n: int = 8,
                            species: str | None = None
                            ) -> list[dict[str, Any]]:
        """Per-species 24-hour activity profiles for the top-N species in a
        date range (reference TimeOfDaySpeciesChart.svelte /
        SpeciesRidgeline.svelte — frontend/src/lib/desktop/features/
        analytics/components). `species` narrows to one species (the
        drill-down modal's diel clock)."""
        clauses, args = ["date BETWEEN ? AND ?"], [date_from, date_to]
        if species:
            clauses.append("scientific_name = ?")
            args.append(species)
        sql = ("SELECT scientific_name, MAX(common_name) AS common_name,"
               " CAST(substr(time, 1, 2) AS INTEGER) AS hr, COUNT(*) AS n"
               " FROM detections WHERE " + " AND ".join(clauses)
               + " GROUP BY scientific_name, hr")
        rows: dict[str, dict[str, Any]] = {}
        with self._lock:
            for r in self._conn.execute(sql, args):
                e = rows.setdefault(r["scientific_name"], {
                    "scientific_name": r["scientific_name"],
                    "common_name": "", "hourly": [0] * 24, "total": 0})
                # MAX across ALL the species' groups, not the first seen
                e["common_name"] = max(e["common_name"],
                                       r["common_name"] or "")
                if 0 <= r["hr"] < 24:
                    e["hourly"][r["hr"]] = r["n"]
                    e["total"] += r["n"]
        return sorted(rows.values(), key=lambda e: -e["total"])[:top_n]

    def species_daily_trend(self, date_from: str, date_to: str,
                            top_n: int = 5) -> list[dict[str, Any]]:
        """Per-species daily counts for the range's top-N species
        (reference DailySpeciesTrendChart.svelte / SeasonalHeatmap.svelte).
        Returns [{scientific_name, common_name, total, daily: {date: n}}]."""
        sql = ("SELECT scientific_name, MAX(common_name) AS common_name,"
               " date, COUNT(*) AS n FROM detections"
               " WHERE date BETWEEN ? AND ? GROUP BY scientific_name, date")
        rows: dict[str, dict[str, Any]] = {}
        with self._lock:
            for r in self._conn.execute(sql, (date_from, date_to)):
                e = rows.setdefault(r["scientific_name"], {
                    "scientific_name": r["scientific_name"],
                    "common_name": "", "daily": {}, "total": 0})
                e["common_name"] = max(e["common_name"],
                                       r["common_name"] or "")
                e["daily"][r["date"]] = r["n"]
                e["total"] += r["n"]
        return sorted(rows.values(), key=lambda e: -e["total"])[:top_n]

    def new_species_first_seen(self) -> list[dict[str, Any]]:
        sql = ("SELECT scientific_name, MAX(common_name) AS common_name,"
               " MIN(date) AS first_date FROM detections"
               " GROUP BY scientific_name ORDER BY first_date DESC")
        with self._lock:
            return [dict(r) for r in self._conn.execute(sql)]

    def species_first_seen_since(self, since_date: str
                                 ) -> list[dict[str, Any]]:
        """Per-species first detection date within [since_date, now] —
        seeds the species tracker's this-year/this-season maps at startup
        (reference: species_tracker.go period sync)."""
        sql = ("SELECT scientific_name, MIN(date) AS first_date"
               " FROM detections WHERE date >= ?"
               " GROUP BY scientific_name")
        with self._lock:
            return [dict(r) for r in self._conn.execute(sql, (since_date,))]

    # -- insights (reference: datastore/v2/repository/insights_impl.go; all
    # queries exclude detections whose LATEST review verdict is
    # false_positive — falsePositiveExclusion analogue) ---------------------------

    _FP_EXCLUDE = (
        "id NOT IN (SELECT r1.detection_id FROM reviews r1"
        " WHERE r1.verdict = 'false_positive'"
        " AND r1.id = (SELECT MAX(r2.id) FROM reviews r2"
        " WHERE r2.detection_id = r1.detection_id))")

    def insights_expected_species(
            self, date_ranges: list[tuple[str, str]]
    ) -> list[dict[str, Any]]:
        """Species historically seen in any of the (inclusive) date
        ranges: years_seen = distinct calendar years, last_seen_date =
        most recent date (insights_impl.go GetExpectedSpeciesToday)."""
        if not date_ranges:
            return []
        ors = " OR ".join(["date BETWEEN ? AND ?"] * len(date_ranges))
        args = [d for rng in date_ranges for d in rng]
        sql = (f"SELECT scientific_name,"
               f" MAX(common_name) AS common_name,"
               f" COUNT(DISTINCT substr(date, 1, 4)) AS years_seen,"
               f" MAX(date) AS last_seen_date FROM detections"
               f" WHERE ({ors}) AND {self._FP_EXCLUDE}"
               f" GROUP BY scientific_name ORDER BY years_seen DESC,"
               f" scientific_name")
        with self._lock:
            return [dict(r) for r in self._conn.execute(sql, args)]

    def insights_phantom_species(self, since_unix: float,
                                 min_detections: int = 3,
                                 max_avg_confidence: float = 0.6
                                 ) -> list[dict[str, Any]]:
        """Frequent but chronically low-confidence species — likely
        misidentifications (insights_impl.go GetPhantomSpecies)."""
        sql = (f"SELECT scientific_name,"
               f" MAX(common_name) AS common_name,"
               f" COUNT(*) AS detection_count,"
               f" AVG(confidence) AS avg_confidence,"
               f" MAX(confidence) AS max_confidence FROM detections"
               f" WHERE timestamp >= ? AND {self._FP_EXCLUDE}"
               f" GROUP BY scientific_name"
               f" HAVING COUNT(*) >= ? AND AVG(confidence) < ?"
               f" ORDER BY avg_confidence ASC")
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                sql, (since_unix, min_detections, max_avg_confidence))]

    def insights_dawn_chorus_raw(self, since_unix: float,
                                 start_hour: int = 4, end_hour: int = 10
                                 ) -> list[dict[str, Any]]:
        """Per (species, date) earliest detection time inside the dawn
        band [start_hour, end_hour) — the handler aggregates averages
        (insights_impl.go GetDawnChorusRaw; time is already local)."""
        sql = (f"SELECT scientific_name,"
               f" MAX(common_name) AS common_name, date,"
               f" MIN(time) AS earliest_time FROM detections"
               f" WHERE timestamp >= ?"
               f" AND CAST(substr(time, 1, 2) AS INTEGER) >= ?"
               f" AND CAST(substr(time, 1, 2) AS INTEGER) < ?"
               f" AND {self._FP_EXCLUDE}"
               f" GROUP BY scientific_name, date")
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                sql, (since_unix, start_hour, end_hour))]

    def insights_new_arrivals(self, recent_date: str
                              ) -> list[dict[str, Any]]:
        """Species whose FIRST-EVER detection falls on/after recent_date
        (insights_impl.go GetNewArrivals)."""
        sql = (f"SELECT scientific_name,"
               f" MAX(common_name) AS common_name,"
               f" MIN(date) AS first_detected,"
               f" COUNT(*) AS detection_count FROM detections"
               f" WHERE {self._FP_EXCLUDE} GROUP BY scientific_name"
               f" HAVING MIN(date) >= ? ORDER BY first_detected DESC")
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                sql, (recent_date,))]

    def insights_gone_quiet(self, recent_date: str,
                            min_total_detections: int = 5
                            ) -> list[dict[str, Any]]:
        """Previously regular species with no detection since recent_date
        (insights_impl.go GetGoneQuiet)."""
        sql = (f"SELECT scientific_name,"
               f" MAX(common_name) AS common_name,"
               f" MAX(date) AS last_detected,"
               f" COUNT(*) AS total_detections FROM detections"
               f" WHERE {self._FP_EXCLUDE} GROUP BY scientific_name"
               f" HAVING COUNT(*) >= ? AND MAX(date) < ?"
               f" ORDER BY last_detected DESC")
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                sql, (min_total_detections, recent_date))]

    def insights_dashboard_kpis(self, today: str) -> dict[str, Any]:
        """Headline KPIs: lifetime species, today's detections, best day
        within the trailing year, and the last 90 distinct active dates
        for the caller's streak math (insights_impl.go
        GetDashboardKPIs)."""
        year_ago = f"{int(today[:4]) - 1}{today[4:]}"
        with self._lock:
            (lifetime,) = self._conn.execute(
                "SELECT COUNT(DISTINCT scientific_name) FROM detections"
                f" WHERE {self._FP_EXCLUDE}").fetchone()
            (today_n,) = self._conn.execute(
                "SELECT COUNT(*) FROM detections WHERE date = ?"
                f" AND {self._FP_EXCLUDE}", (today,)).fetchone()
            best = self._conn.execute(
                "SELECT date, COUNT(*) AS n FROM detections"
                f" WHERE date >= ? AND {self._FP_EXCLUDE}"
                " GROUP BY date ORDER BY n DESC, date DESC LIMIT 1",
                (year_ago,)).fetchone()
            dates = [r[0] for r in self._conn.execute(
                "SELECT DISTINCT date FROM detections"
                f" WHERE {self._FP_EXCLUDE}"
                " ORDER BY date DESC LIMIT 90")]
        return {"lifetime_species": int(lifetime),
                "today_detections": int(today_n),
                "best_day_date": best["date"] if best else "",
                "best_day_count": int(best["n"]) if best else 0,
                "recent_dates": dates}

    # -- dynamic thresholds ----------------------------------------------------------

    def save_dynamic_thresholds(self, state: dict[tuple[str, str], Any]
                                ) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM dynamic_thresholds")
            for (model_id, sci), st in state.items():
                self._conn.execute(
                    "INSERT INTO dynamic_thresholds (model_id,"
                    " scientific_name, level, high_conf_count, expires_at,"
                    " last_learned_at) VALUES (?,?,?,?,?,?)",
                    (model_id, sci, st.level, st.high_conf_count,
                     st.expires_at, st.last_learned_at))
            self._conn.commit()

    def load_dynamic_thresholds(self) -> dict[tuple[str, str], Any]:
        from birdnet_go_tpu_torch.analysis.dynamic_threshold import ThresholdState

        with self._lock:
            return {
                (r["model_id"], r["scientific_name"]): ThresholdState(
                    level=r["level"], high_conf_count=r["high_conf_count"],
                    expires_at=r["expires_at"],
                    last_learned_at=r["last_learned_at"])
                for r in self._conn.execute(
                    "SELECT * FROM dynamic_thresholds")
            }

    def save_threshold_event(self, ev: Any) -> None:
        """Persist one level transition (datastore.SaveThresholdEvent)."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO threshold_events (model_id, scientific_name,"
                " previous_level, new_level, previous_value, new_value,"
                " reason, confidence, created_at) VALUES (?,?,?,?,?,?,?,?,?)",
                (ev.model_id, ev.scientific, ev.previous_level, ev.new_level,
                 ev.previous_value, ev.new_value, ev.reason, ev.confidence,
                 ev.timestamp))
            self._conn.commit()

    def list_threshold_events(self, limit: int = 100,
                              scientific: str | None = None) -> list[dict]:
        q = "SELECT * FROM threshold_events"
        args: list = []
        if scientific:
            q += " WHERE scientific_name = ?"
            args.append(scientific)
        q += " ORDER BY id DESC LIMIT ?"
        args.append(limit)
        with self._lock:
            return [dict(r) for r in self._conn.execute(q, args)]

    def database_details(self) -> dict[str, Any]:
        """Storage observability for the system page (reference
        DatabaseSqliteDetails / DatabaseTableBreakdown /
        DatabaseLocksWalCard components, frontend .../features/system):
        journal mode, page accounting, WAL size on disk, and per-table
        row counts."""
        import os

        def _p1(c, name, default):
            row = c.execute(f"PRAGMA {name}").fetchone()
            return row[0] if row else default

        with self._lock:
            c = self._conn
            mode = _p1(c, "journal_mode", "?")
            page_count = _p1(c, "page_count", 0)
            page_size = _p1(c, "page_size", 0)
            freelist = _p1(c, "freelist_count", 0)
            tables = [r[0] for r in c.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
                " AND name NOT LIKE 'sqlite_%' ORDER BY name")]
        # COUNT(*) per table OUTSIDE one long lock hold: each count is an
        # index scan, but a big detections table must not stall the
        # processor's inserts for the whole breakdown
        breakdown = []
        for t in tables:
            with self._lock:
                # table names come from sqlite_master, not user input
                (n,) = self._conn.execute(
                    f'SELECT COUNT(*) FROM "{t}"').fetchone()
            breakdown.append({"table": t, "rows": int(n)})
        wal_bytes = 0
        if self.path != ":memory:":
            try:
                wal_bytes = os.path.getsize(self.path + "-wal")
            except OSError:
                pass
        # detections/hour over the trailing 24 h (DetectionRateChart)
        now = time.time()
        rate = [0] * 24
        with self._lock:
            for ts, n in self._conn.execute(
                    "SELECT CAST((? - timestamp) / 3600 AS INTEGER) AS age,"
                    " COUNT(*) FROM detections WHERE timestamp >= ?"
                    " GROUP BY age", (now, now - 86400)):
                if 0 <= ts < 24:
                    rate[23 - ts] = n
        return {
            "engine": "sqlite", "path": self.path,
            "journal_mode": mode,
            "size_bytes": page_count * page_size,
            "page_size": page_size, "page_count": page_count,
            "freelist_pages": freelist,
            "wal_bytes": wal_bytes,
            "tables": breakdown,
            "detections_per_hour_24h": rate,
        }

    def doctor(self, fix: bool = False) -> dict[str, Any]:
        """Database doctor (reference: tools/db-doctor + the datastore
        inspector role): integrity + FK checks, orphaned child rows,
        expected-index audit; with fix=True deletes orphans, recreates
        missing indices, checkpoints WAL, and VACUUM/ANALYZEs."""
        report: dict[str, Any] = {"fixed": [], "issues": []}
        with self._lock:
            ok = self._conn.execute("PRAGMA integrity_check").fetchone()[0]
            report["integrity"] = ok
            if ok != "ok":
                report["issues"].append(f"integrity: {ok}")
            fk = self._conn.execute("PRAGMA foreign_key_check").fetchall()
            if fk:
                report["issues"].append(f"{len(fk)} foreign-key violations")
            # orphaned children (pre-FK databases or imports)
            orphans = {}
            for child in ("model_contributions", "results", "reviews",
                          "comments"):
                n = self._conn.execute(
                    f"SELECT COUNT(*) FROM {child} c WHERE NOT EXISTS"
                    f" (SELECT 1 FROM detections d"
                    f"  WHERE d.id = c.detection_id)").fetchone()[0]
                if n:
                    orphans[child] = n
                    report["issues"].append(f"{n} orphaned {child}")
                    if fix:
                        self._conn.execute(
                            f"DELETE FROM {child} WHERE NOT EXISTS"
                            f" (SELECT 1 FROM detections d"
                            f"  WHERE d.id = {child}.detection_id)")
                        report["fixed"].append(f"deleted {n} {child}")
            report["orphans"] = orphans
            # expected indices
            have = {r[0] for r in self._conn.execute(
                "SELECT name FROM sqlite_master WHERE type='index'")}
            expected = {"idx_det_ts", "idx_det_sci", "idx_det_date",
                        "idx_mc_det", "idx_results_det", "idx_notif_ts"}
            missing = sorted(expected - have)
            if missing:
                report["issues"].append(f"missing indices: {missing}")
                if fix:
                    self._conn.executescript(_SCHEMA)   # recreates indices
                    report["fixed"].append(f"recreated {missing}")
            report["journal_mode"] = self._conn.execute(
                "PRAGMA journal_mode").fetchone()[0]
            report["detections"] = self._conn.execute(
                "SELECT COUNT(*) FROM detections").fetchone()[0]
            if fix:
                # commit the repairs BEFORE the checkpoint — TRUNCATE
                # cannot run with this connection's write txn open
                self._conn.commit()
                self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        if fix:
            self.optimize()
            report["fixed"].append("wal checkpoint + vacuum/analyze")
            # re-diagnose: the exit code must reflect POST-repair health
            # (a fixed orphan clears its FK violation; corruption that
            # survives the repair keeps the report unhealthy)
            post = self.doctor(fix=False)
            post["fixed"] = report["fixed"]
            post["pre_fix_issues"] = report["issues"]
            return post
        report["healthy"] = not report["issues"]
        return report

    # -- notification history ----------------------------------------------------------

    def save_notification(self, title: str, message: str, priority: str,
                          timestamp: float, payload_json: str = "{}") -> int:
        """Persist an inbox entry (datastore.SaveNotificationHistory)."""
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO notifications (title, message, priority,"
                " timestamp, payload) VALUES (?,?,?,?,?)",
                (title, message, priority, timestamp, payload_json))
            self._conn.commit()
            return int(cur.lastrowid)

    def load_notifications(self, limit: int = 500) -> list[dict]:
        """Active history, oldest first (GetActiveNotificationHistory)."""
        with self._lock:
            rows = [dict(r) for r in self._conn.execute(
                "SELECT * FROM notifications ORDER BY id DESC LIMIT ?",
                (limit,))]
        rows.reverse()
        return rows

    def set_notification_read(self, nid: int | None = None,
                              read: bool = True) -> int:
        """Mark one (or, with nid=None, all) notifications read/unread."""
        with self._lock:
            if nid is None:
                cur = self._conn.execute(
                    "UPDATE notifications SET is_read = ?", (int(read),))
            else:
                cur = self._conn.execute(
                    "UPDATE notifications SET is_read = ? WHERE id = ?",
                    (int(read), nid))
            self._conn.commit()
            return cur.rowcount

    def delete_notification(self, nid: int) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM notifications WHERE id = ?", (nid,))
            self._conn.commit()
            return cur.rowcount > 0

    def delete_expired_notifications(self, older_than_unix: float) -> int:
        """Prune history past its TTL (DeleteExpiredNotificationHistory)."""
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM notifications WHERE timestamp < ?",
                (older_than_unix,))
            self._conn.commit()
            return cur.rowcount

    # -- weather ------------------------------------------------------------------------

    def save_hourly_weather(self, time_unix: float, **fields) -> None:
        cols = ["temperature", "humidity", "pressure", "wind_speed",
                "wind_deg", "clouds", "description", "icon"]
        vals = [fields.get(c) for c in cols]
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO hourly_weather (time, "
                + ", ".join(cols) + ") VALUES (?,?,?,?,?,?,?,?,?)",
                (time_unix, *vals))
            self._conn.commit()

    def get_clip_references(self, after_id: int = 0,
                            limit: int = 200) -> list[dict[str, Any]]:
        """Keyset-paginated projection for the clip reconcile crawler
        (GetNoteClipReferences): rows with a non-empty clip_name and
        id > after_id, ascending. end_time is the capture COMPLETION
        time used for the recency guard."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, clip_name, end_time FROM detections"
                " WHERE id > ? AND clip_name != ''"
                " ORDER BY id ASC LIMIT ?", (after_id, limit)).fetchall()
        return [{"id": r[0], "clip_name": r[1], "end_time": r[2]}
                for r in rows]

    def clear_clip_names(self, clip_names: list[str]) -> int:
        """Batch-clear clip_name for rows matching the given DB-format
        values (ClearNoteClipPathsByNames). Never touches disk."""
        if not clip_names:
            return 0
        with self._lock:
            cur = self._conn.execute(
                "UPDATE detections SET clip_name = '' WHERE clip_name IN ("
                + ",".join("?" * len(clip_names)) + ")", clip_names)
            self._conn.commit()
            return cur.rowcount

    def get_hourly_weather(self, date: str) -> list[dict[str, Any]]:
        t0 = _dt.datetime.strptime(date, "%Y-%m-%d").timestamp()
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM hourly_weather WHERE time >= ? AND time < ?"
                " ORDER BY time", (t0, t0 + 86400))]
