"""MySQL datastore: the full SQLite datastore surface over the wire client.

Reference: internal/datastore/mysql.go (GORM MySQL driver). Design: the
SQLite datastore's ~40 query methods are dialect-portable except for a
handful of constructs, so MySQLDatastore subclasses Datastore and swaps
`self._conn` for a shim that (a) translates those constructs
(AUTOINCREMENT, ON CONFLICT upserts, CAST AS INTEGER, PRAGMA),
(b) executes over the wire-level MySQLConnection, and (c) returns
sqlite3.Row-compatible rows — one implementation of the 62-method-role
interface, two engines.

A copy of ``birdnet_go_tpu/datastore/mysql.py`` for the port, which
imports nothing of the JAX package, over the port's own ``Datastore`` and
``_SCHEMA`` (``datastore/sqlite.py``); ``tests/test_torch_mysql.py`` runs
every ``Datastore`` method through both packages' ``MySQLDatastore`` and
compares the rows. Where it differs, each a statement that MySQL refuses
and SQLite (so the test server) takes, found by reading every statement
the port's ``Datastore`` issues:

- ``translate_sql`` also turns SQLite's two-argument scalar ``MIN(a, b)``
  and ``MAX(a, b)`` (the daily rollup's upsert) into ``LEAST`` and
  ``GREATEST``, and names every derived table (``FROM (SELECT ...)``
  without an alias is MySQL's error 1248; the daily rollup's species
  probe and the duplicate audit have one);
- ``executescript`` recognises ``CREATE INDEX IF NOT EXISTS`` behind the
  schema's ``--`` comments (MySQL has no such clause; JAX's sends the
  commented one as it is);
- ``wal_checkpoint`` reports nothing to checkpoint (InnoDB keeps no WAL
  file; JAX's reads SQLite's PRAGMA and fails).
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Any

from birdnet_go_tpu_torch.datastore.mysql_wire import MySQLConnection
from birdnet_go_tpu_torch.datastore.sqlite import _SCHEMA, Datastore

log = logging.getLogger("birdnet_tpu.mysql")

_EXCLUDED = re.compile(r"excluded\.(\w+)")
_INLINE_FK = re.compile(
    r"(\w+)\s+((?:INTEGER|VARCHAR\(\d+\)|TEXT)\s+NOT\s+NULL)\s+"
    r"REFERENCES\s+(\w+)\s*\((\w+)\)\s+ON\s+DELETE\s+CASCADE",
    re.IGNORECASE)
_ON_CONFLICT = re.compile(
    r"ON CONFLICT\s*\(([^)]+)\)\s*DO UPDATE SET", re.IGNORECASE)


# columns that participate in keys/indexes in the schema — MySQL refuses
# TEXT in a key specification without a length, so these become VARCHAR
_KEY_COLUMNS = ("model_id", "scientific_name", "date", "source_id")
_KEY_COL_RE = re.compile(
    r"\b(" + "|".join(_KEY_COLUMNS) + r")\s+TEXT\b")


# SQLite's scalar two-argument MIN/MAX (MySQL's MIN and MAX aggregate)
_SCALAR_MINMAX = re.compile(r"\b(MIN|MAX)\(([^(),]+),([^(),]+)\)",
                            re.IGNORECASE)
_DERIVED = re.compile(r"\bFROM\s*\(\s*SELECT\b", re.IGNORECASE)
# what may follow a derived table that names no alias
_NOT_ALIAS = re.compile(
    r"\s*(?:$|\)|,|;|(?:WHERE|GROUP|ORDER|LIMIT|HAVING|UNION|JOIN|INNER|"
    r"LEFT|RIGHT|CROSS|ON)\b)", re.IGNORECASE)


def _name_derived_tables(sql: str) -> str:
    """``FROM (SELECT ...)`` → ``FROM (SELECT ...) AS _dN`` where no alias
    follows (MySQL requires one)."""
    inserts = []
    for m in _DERIVED.finditer(sql):
        depth = 0
        for k in range(sql.index("(", m.start()), len(sql)):
            depth += {"(": 1, ")": -1}.get(sql[k], 0)
            if depth == 0:
                break
        if _NOT_ALIAS.match(sql, k + 1):
            inserts.append(k + 1)
    for n, k in enumerate(sorted(inserts, reverse=True)):
        sql = f"{sql[:k]} AS _d{len(inserts) - 1 - n}{sql[k:]}"
    return sql


def translate_sql(sql: str) -> str:
    """SQLite dialect → MySQL dialect for the statements this codebase uses."""
    out = sql.replace("AUTOINCREMENT", "AUTO_INCREMENT")
    out = _SCALAR_MINMAX.sub(
        lambda m: ("LEAST(" if m.group(1).upper() == "MIN" else "GREATEST(")
        + f"{m.group(2)},{m.group(3)})", out)
    out = _name_derived_tables(out)
    out = out.replace("AS INTEGER)", "AS SIGNED)")
    # sqlite upsert dialects → MySQL upserts
    out = _ON_CONFLICT.sub("ON DUPLICATE KEY UPDATE", out)
    out = _EXCLUDED.sub(r"VALUES(\1)", out)
    out = re.sub(r"^\s*INSERT OR REPLACE INTO", "REPLACE INTO", out,
                 flags=re.IGNORECASE)
    # TEXT cannot be a key in MySQL without a prefix length: give every
    # key-participating column (PKs, composite PKs, indexed columns) a
    # bounded VARCHAR instead
    out = out.replace("TEXT PRIMARY KEY", "VARCHAR(191) PRIMARY KEY")
    if "CREATE TABLE" in out.upper():
        out = _KEY_COL_RE.sub(r"\1 VARCHAR(191)", out)
        # MySQL refuses DEFAULT on TEXT columns (error 1101); every insert
        # in this codebase supplies these columns explicitly, so the
        # default is only a sqlite nicety — drop it for MySQL
        out = re.sub(r"TEXT NOT NULL DEFAULT '[^']*'", "TEXT NOT NULL", out)
        # MySQL parses but silently DISCARDS column-level REFERENCES
        # clauses — hoist them into table-level FOREIGN KEY constraints so
        # ON DELETE CASCADE actually exists on InnoDB (otherwise
        # delete_detection leaves orphaned child rows forever)
        fks: list[str] = []

        def _hoist(m: "re.Match[str]") -> str:
            fks.append(f"FOREIGN KEY ({m.group(1)}) REFERENCES "
                       f"{m.group(3)}({m.group(4)}) ON DELETE CASCADE")
            return f"{m.group(1)} {m.group(2)}"

        out = _INLINE_FK.sub(_hoist, out)
        if fks:
            i = out.rindex(")")
            out = out[:i] + ",\n    " + ",\n    ".join(fks) + out[i:]
    return out


class _Row:
    """sqlite3.Row stand-in: r["col"], dict(r), iteration, indexing."""

    __slots__ = ("_cols", "_vals")

    def __init__(self, cols: list[str], vals: tuple):
        self._cols = cols
        self._vals = vals

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._vals[key]
        return self._vals[self._cols.index(key)]

    def keys(self):
        return list(self._cols)

    def __iter__(self):
        return iter(self._vals)

    def __len__(self):
        return len(self._vals)


class _Cursor:
    def __init__(self, cols, rows, affected, lastrowid):
        self._rows = [_Row(cols, r) for r in rows]
        self.rowcount = affected
        self.lastrowid = lastrowid
        self._idx = 0

    def fetchone(self):
        if self._idx >= len(self._rows):
            return None
        r = self._rows[self._idx]
        self._idx += 1
        return r

    def fetchall(self):
        rows, self._rows = self._rows[self._idx:], []
        return rows

    def __iter__(self):
        rows = self._rows[self._idx:]
        self._idx = len(self._rows)
        return iter(rows)


# Value typing happens in the wire client now, keyed on each column's
# declared type from ColumnDefinition41 — pattern-based coercion turned a
# TEXT species_code '0123' into 123 (type divergence vs the sqlite
# engine, which returns str for TEXT no matter what it looks like).


class _ConnShim:
    """Duck-types the sqlite3.Connection surface the Datastore methods use."""

    def __init__(self, conn: MySQLConnection):
        self._conn = conn

    def execute(self, sql: str, args: tuple | list = ()) -> _Cursor:
        sql = translate_sql(sql)
        up = sql.lstrip().upper()
        if up.startswith("PRAGMA"):
            return _Cursor([], [], 0, 0)
        if up.startswith(("SELECT", "SHOW", "DESCRIBE")):
            cols, rows = self._conn.query(sql, tuple(args))
            return _Cursor(cols, rows, 0, 0)
        affected, last = self._conn.execute(sql, tuple(args))
        return _Cursor([], [], affected, last)

    def executescript(self, script: str) -> None:
        for stmt in script.split(";"):
            # the statement without the comment lines that lead it
            stmt = "\n".join(ln for ln in stmt.strip().splitlines()
                             if not ln.lstrip().startswith("--")).strip()
            if not stmt:
                continue
            # MySQL has no CREATE INDEX IF NOT EXISTS: probe + swallow
            # the duplicate-key error instead.
            if stmt.upper().startswith("CREATE INDEX IF NOT EXISTS"):
                stmt = stmt.replace("IF NOT EXISTS ", "", 1)
                try:
                    self.execute(stmt)
                except Exception as e:          # 1061 = duplicate key name
                    if getattr(e, "code", None) != 1061:
                        log.debug("index create skipped: %s", e)
                continue
            self.execute(stmt)

    def commit(self) -> None:                  # autocommit on the wire
        pass

    def close(self) -> None:
        self._conn.close()


class MySQLDatastore(Datastore):
    """Datastore on MySQL: same behavior surface as the SQLite engine."""

    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "birdnet", password: str = "",
                 database: str = "birdnet",
                 connection: MySQLConnection | None = None):
        # NOTE: deliberately does NOT call Datastore.__init__ (which opens
        # sqlite); replicates its setup with the shim connection.
        self.path = f"mysql://{user}@{host}:{port}/{database}"
        conn = connection or MySQLConnection(
            host=host, port=port, user=user, password=password,
            database=database)
        self._conn = _ConnShim(conn)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._automigrate()

    def _automigrate(self) -> None:
        try:
            cols = {r[0] for r in self._conn.execute(
                "SHOW COLUMNS FROM dynamic_thresholds")}
            if "last_learned_at" not in cols:
                self._conn.execute(
                    "ALTER TABLE dynamic_thresholds"
                    " ADD COLUMN last_learned_at REAL NOT NULL DEFAULT 0")
        except Exception:
            log.debug("automigrate probe failed", exc_info=True)

    def wal_checkpoint(self) -> dict[str, int]:
        """InnoDB keeps no WAL file: nothing to checkpoint."""
        return {"busy": 0, "log_frames": 0, "checkpointed_frames": 0}

    def integrity_check(self) -> dict[str, Any]:
        """Database doctor (mysql inspector role): table status summary."""
        with self._lock:
            rows = [dict(zip(r.keys(), r)) for r in self._conn.execute(
                "SHOW TABLE STATUS")]
        return {"tables": len(rows), "engine_ok": True}

    def doctor(self, fix: bool = False) -> dict[str, Any]:
        """MySQL doctor: orphan audit is dialect-portable; the sqlite
        PRAGMA checks are replaced by table status (InnoDB enforces the
        hoisted FK constraints, so new orphans can't appear)."""
        report: dict[str, Any] = {"fixed": [], "issues": [],
                                  "integrity": "ok"}
        orphans = {}
        with self._lock:
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
            report["detections"] = self._conn.execute(
                "SELECT COUNT(*) FROM detections").fetchone()[0]
            report["journal_mode"] = "innodb"
        if fix:
            self.optimize()
            report["fixed"].append("optimize table")
            post = self.doctor(fix=False)
            post["fixed"] = report["fixed"]
            post["pre_fix_issues"] = report["issues"]
            return post
        report["healthy"] = not report["issues"]
        return report

    def optimize(self) -> None:
        """sqlite VACUUM/ANALYZE are invalid MySQL; OPTIMIZE TABLE covers
        both roles (rebuild + stats refresh) on InnoDB."""
        with self._lock:
            tables = [r[0] for r in self._conn.execute("SHOW TABLES")]
            for t in tables:
                try:
                    self._conn.execute(f"OPTIMIZE TABLE {t}")
                except Exception as e:  # noqa: BLE001
                    log.debug("optimize %s: %s", t, e)

    def database_details(self):
        """MySQL flavor of the storage observability surface (reference
        DatabaseMysqlInnodbCard / DatabaseTableBreakdown): engine
        status via SHOW TABLE STATUS instead of sqlite PRAGMAs."""
        import time as _time

        breakdown, size = [], 0
        with self._lock:
            for row in self._conn.execute("SHOW TABLE STATUS"):
                name, engine = row[0], row[1]
                rows_est = int(row[4] or 0)
                bytes_ = int((row[6] or 0)) + int((row[8] or 0))
                breakdown.append({"table": name, "rows": rows_est,
                                  "engine": engine})
                size += bytes_
        now = _time.time()
        rate = [0] * 24
        with self._lock:
            # FLOOR, not CAST: MySQL CAST AS SIGNED rounds-to-nearest
            # (2.6h -> bucket 3) where sqlite CAST truncates; FLOOR keeps
            # the two engines' hour buckets identical
            for age, n in self._conn.execute(
                    "SELECT FLOOR((? - timestamp) / 3600),"
                    " COUNT(*) FROM detections WHERE timestamp >= ?"
                    " GROUP BY 1", (now, now - 86400)):
                if 0 <= age < 24:
                    rate[23 - int(age)] = int(n)
        return {
            "engine": "mysql", "path": self.path,
            "journal_mode": "innodb",
            "size_bytes": size, "page_size": None, "page_count": None,
            "freelist_pages": None, "wal_bytes": None,
            "tables": breakdown,
            "detections_per_hour_24h": rate,
        }
