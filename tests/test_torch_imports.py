"""The port's importers (``birdnet_go_tpu_torch/utils/imports.py``), their
API routes and the CLI's ``import``, against the JAX package's, on the
CPU.

Every case feeds the same seeded inputs (``diag/import_data.py``: a
BirdNET-Pi ``BirdDB.txt`` with lines the parser skips, a legacy
BirdNET-Go database with results, reviews, comments and locks) through
both packages and asserts equal records: the parsed detections, the import
counts, and what each package's ``Datastore`` then holds (every detection
as ``search_detections`` returns it, with its results, reviews, comments
and lock), a second import skipping every row, ``ImportJobManager``'s
statuses, progress and cancel, the six ``imports/*`` routes over HTTP on
both API servers (``tests/test_torch_api.py``'s ``pair``: each app bound
to a port of its own), and the CLI's lines and exit codes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sqlite3
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from birdnet_go_tpu.cli import main as jcli
from birdnet_go_tpu_torch.cli import main as tcli
from birdnet_go_tpu_torch.diag.import_data import (
    write_birdnet_go_db,
    write_birdnet_pi_log,
)
from tests.test_torch_api import V2, pair  # noqa: F401  (fixture)
from tests.test_torch_app import tiny_v24  # noqa: F401  (fixture)

PACKAGES = ("birdnet_go_tpu", "birdnet_go_tpu_torch")
# columns holding the wall clock at which a row was written
WALL = {"created_at", "updated_at", "started_at", "finished_at"}
# the source ids of imported detections
IMPORTED = ("birdnet-pi-import", "import:birdnet-go")


def _pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(
        name=name,
        imports=importlib.import_module(f"{name}.utils.imports"),
        sqlite=importlib.import_module(f"{name}.datastore.sqlite"))


J, T = (_pkg(n) for n in PACKAGES)


def _plain(x):
    """A comparable value: dataclasses as their fields, datetimes as
    ISO text, dicts without the wall-clock columns."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "isoformat"):
        return x.isoformat()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items()) if k not in WALL}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _both(case):
    """`case(P)` through both packages; their records equal."""
    j, t = (_plain(case(P)) for P in (J, T))
    assert t == j
    return t


def _held(ds) -> list:
    """Every detection a datastore holds, oldest first, with its results,
    reviews, comments and lock."""
    rows = ds.search_detections(limit=10 ** 6, order="asc")
    return [[r, ds.get_results(r["id"]), ds.get_reviews(r["id"]),
             ds.list_comments(r["id"])] for r in rows]


# -- BirdNET-Pi ----------------------------------------------------------------

@pytest.mark.parametrize("delimiter,header", [(";", True), (",", False)])
def test_parse_birdnet_pi_log_equal_jax(tmp_path, delimiter, header):
    log = tmp_path / "BirdDB.txt"
    made = write_birdnet_pi_log(log, 300, seed=1, junk=5,
                                delimiter=delimiter, header=header)
    out = _both(lambda P: P.imports.parse_birdnet_pi_log(log))
    assert len(out) == made["rows"]
    assert _both(lambda P: P.imports._sniff_delimiter(
        log.read_text().splitlines()[1])) == delimiter
    empty = tmp_path / "empty.txt"
    empty.write_text("\n \n")
    assert _both(lambda P: P.imports.parse_birdnet_pi_log(empty)) == []


def test_import_birdnet_pi_equal_jax(tmp_path):
    """An import with a confidence floor, then the same log again: every
    row skipped (dedup on timestamp and species)."""
    log = tmp_path / "BirdDB.txt"
    made = write_birdnet_pi_log(log, 400, seed=2, junk=3)

    def case(P):
        ds = P.sqlite.Datastore(":memory:")
        first = P.imports.import_birdnet_pi(ds, log, min_confidence=0.6)
        second = P.imports.import_birdnet_pi(ds, log)
        third = P.imports.import_birdnet_pi(ds, log, dedup=False)
        return [first, second, third, ds.count_detections(), _held(ds)]

    first, second, third, count, _ = _both(case)
    assert first["scanned"] == made["rows"] and first["errors"] == 0
    assert first["imported"] + first["skipped"] == made["rows"]
    assert second == {"scanned": made["rows"], "imported":
                      made["rows"] - first["imported"],
                      "skipped": first["imported"], "errors": 0}
    assert third["imported"] == made["rows"] and count == 2 * made["rows"]


def test_discover_birdnet_pi_equal_jax(tmp_path):
    for rel in ("a/BirdDB.txt", "b/BirdNET-Pi/BirdDB.txt",
                "c/birdnet/BirdDB.txt", "d/other.txt"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("x")
    mounts = [tmp_path / m for m in "abcde"] + [tmp_path / "a/BirdDB.txt"]
    out = _both(lambda P: [str(p.relative_to(tmp_path)) for p in
                           P.imports.discover_birdnet_pi(mounts)])
    assert out == ["a/BirdDB.txt", "b/BirdNET-Pi/BirdDB.txt",
                   "c/birdnet/BirdDB.txt"]


# -- BirdNET-Go ------------------------------------------------------------------

def test_import_birdnet_go_db_equal_jax(tmp_path):
    """Detections, results, reviews, comments and locks carried over, and
    a second import skipping every note."""
    legacy = tmp_path / "birdnet.db"
    made = write_birdnet_go_db(legacy, 250, seed=3)

    def case(P):
        ds = P.sqlite.Datastore(":memory:")
        parsed = P.imports.parse_birdnet_go_db(legacy)
        first = P.imports.import_birdnet_go_db(ds, legacy)
        second = P.imports.import_birdnet_go_db(ds, legacy)
        return [parsed, first, second, _held(ds)]

    parsed, first, second, held = _both(case)
    assert len(parsed) == made["notes"]
    assert first == {"scanned": made["notes"], "imported": made["notes"],
                     "skipped": 0, "errors": 0}
    assert second["skipped"] == made["notes"] and second["imported"] == 0
    assert sum(len(r[1]) for r in held) == made["results"]
    assert sum(len(r[2]) for r in held) == made["reviews"]
    assert sum(len(r[3]) for r in held) == made["comments"]
    assert sum(bool(r[0]["locked"]) for r in held) == made["locks"]


def test_birdnet_go_db_refusals_equal_jax(tmp_path):
    """A database without ``notes`` raises the same ValueError, and a note
    whose date does not parse is left out by both."""
    other = tmp_path / "foreign.db"
    with sqlite3.connect(other) as conn:
        conn.execute("CREATE TABLE stuff (x)")
    errors = []
    for P in (J, T):
        with pytest.raises(ValueError) as e:
            P.imports.parse_birdnet_go_db(other)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    legacy = tmp_path / "birdnet.db"
    write_birdnet_go_db(legacy, 20, seed=4)
    with sqlite3.connect(legacy) as conn:
        conn.execute("UPDATE notes SET date = 'someday' WHERE id = 7")
    out = _both(lambda P: P.imports.parse_birdnet_go_db(legacy))
    assert len(out) == 19


# -- ImportJobManager -------------------------------------------------------------

def _wait(cond, seconds: float = 20.0) -> bool:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_import_job_manager_equal_jax(tmp_path, monkeypatch):
    """Two jobs run to ``completed`` (the second skipping every row), a
    job cancelled while it parses ends ``cancelled`` with nothing
    imported, a missing file fails, and unknown ids answer None and
    False."""
    log = tmp_path / "BirdDB.txt"
    made = write_birdnet_pi_log(log, 200, seed=5, junk=2)

    def case(P):
        ds = P.sqlite.Datastore(":memory:")
        mgr = P.imports.ImportJobManager(ds)
        rec = []
        for floor in (0.7, 0.0):
            job = mgr.submit(log, min_confidence=floor)
            assert _wait(lambda: job.status not in ("pending", "running"))
            rec.append(job.as_dict())
        parsing, release = threading.Event(), threading.Event()
        real = P.imports.parse_birdnet_pi_log

        def held(path):
            parsing.set()
            assert release.wait(10)
            return real(path)

        monkeypatch.setattr(P.imports, "parse_birdnet_pi_log", held)
        job = mgr.submit(log)
        assert parsing.wait(10)
        rec.append(job.status)
        rec.append(mgr.cancel(job.id))
        release.set()
        assert _wait(lambda: job.status == "cancelled")
        monkeypatch.setattr(P.imports, "parse_birdnet_pi_log", real)
        rec.append(job.as_dict())
        bad = mgr.submit(tmp_path / "missing.txt")
        assert _wait(lambda: bad.status == "failed")
        rec += [bad.status, bool(bad.error), mgr.get(99), mgr.cancel(99),
                [j["status"] for j in mgr.list()], ds.count_detections()]
        return rec

    rec = _both(case)
    assert rec[0]["status"] == rec[1]["status"] == "completed"
    assert rec[0]["imported"] + rec[1]["imported"] == made["rows"]
    assert rec[1]["skipped"] == rec[0]["imported"]
    assert rec[2:4] == ["running", True]
    assert rec[4]["status"] == "cancelled" and rec[4]["imported"] == 0
    assert rec[5:9] == ["failed", True, None, False]


# -- the API ------------------------------------------------------------------------

def _call_both(pair, method, path, body=None):  # noqa: F811
    """The request to both servers: (status, JSON) of each, equal but for
    the wall clock."""
    out = {}
    for name, side in pair.items():
        st, _, b = side.client.call(method, path, body)
        out[name] = (st, _plain(json.loads(b)))
    assert out["torch"] == out["jax"], (method, path, out)
    return out["torch"]


def test_import_routes_answer_as_jax(pair, tmp_path):  # noqa: F811
    """``imports/validate``, ``imports/birdnet-pi`` polled through
    ``imports/jobs/{id}`` until completed, ``imports/jobs``, a cancel,
    the same log again (every row skipped), ``imports/birdnet-go``, and
    the refusals (a missing file, a foreign database, an unknown job)."""
    log = tmp_path / "BirdDB.txt"
    made = write_birdnet_pi_log(log, 150, seed=6, junk=2)
    legacy = tmp_path / "birdnet.db"
    go = write_birdnet_go_db(legacy, 60, seed=7)
    foreign = tmp_path / "foreign.db"
    with sqlite3.connect(foreign) as conn:
        conn.execute("CREATE TABLE stuff (x)")
    st, out = _call_both(pair, "POST", f"{V2}/imports/validate",
                         {"path": str(log)})
    assert st == 200 and out["detections"] == made["rows"]
    _call_both(pair, "POST", f"{V2}/imports/validate",
               {"path": str(tmp_path / "nope.txt")})
    _call_both(pair, "GET", f"{V2}/imports/jobs")
    jobs = []
    for _ in range(2):
        # the job at submit: its thread may have begun (its status and
        # progress are the moment's); the id and path are the same
        got = {}
        for name, side in pair.items():
            st, _, b = side.client.call("POST", f"{V2}/imports/birdnet-pi",
                                        {"path": str(log)})
            job = json.loads(b)["job"]
            got[name] = (st, job["id"], job["path"])
        assert got["torch"] == got["jax"] and got["torch"][0] == 202
        path = f"{V2}/imports/jobs/{got['torch'][1]}"
        for side in pair.values():
            assert _wait(lambda: json.loads(side.client.call(
                "GET", path)[2])["status"] == "completed")
        jobs.append(_call_both(pair, "GET", path)[1])
    assert jobs[0]["imported"] == made["rows"] == jobs[1]["skipped"]
    st, out = _call_both(pair, "GET", f"{V2}/imports/jobs")
    assert [j["status"] for j in out["jobs"]] == ["completed"] * 2
    assert _call_both(pair, "POST", f"{V2}/imports/jobs/1/cancel") == \
        (200, {"cancelled": True})
    assert _call_both(pair, "POST", f"{V2}/imports/jobs/9/cancel")[0] == 404
    assert _call_both(pair, "GET", f"{V2}/imports/jobs/9")[0] == 404
    assert _call_both(pair, "POST", f"{V2}/imports/birdnet-pi",
                      {"path": str(tmp_path / "nope.txt")})[0] == 400
    st, out = _call_both(pair, "POST", f"{V2}/imports/birdnet-go",
                         {"path": str(legacy)})
    assert (st, out["imported"]) == (200, go["notes"])
    assert _call_both(pair, "POST", f"{V2}/imports/birdnet-go",
                      {"path": str(legacy)})[1]["skipped"] == go["notes"]
    assert _call_both(pair, "POST", f"{V2}/imports/birdnet-go",
                      {"path": str(foreign)})[0] == 400
    assert _call_both(pair, "POST", f"{V2}/imports/birdnet-go",
                      {"path": str(tmp_path / "nope.db")})[0] == 400
    # the imported rows (the apps' own detections are tests/test_torch_api's)
    held = {name: _plain([r for r in _held(side.app.datastore) if
                          r[0]["source_id"] in IMPORTED])
            for name, side in pair.items()}
    assert held["torch"] == held["jax"]
    assert len(held["torch"]) == made["rows"] + go["notes"]


# -- the CLI ------------------------------------------------------------------------

def test_cli_import_lines_equal_jax(tmp_path, capsys):
    """``import`` of both CLIs into databases of their own: a floor, the
    rest, then everything again; the same lines and exit codes."""
    log = tmp_path / "BirdDB.txt"
    write_birdnet_pi_log(log, 120, seed=8, junk=1)
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        db = tmp_path / f"{name}.db"
        rec = []
        for extra in (["--min-confidence", "0.8"], [], []):
            rc = cli.main(["import", str(log), "--database", str(db)]
                          + extra)
            rec.append((rc, capsys.readouterr().out.splitlines()))
        out[name] = rec
    assert out["torch"] == out["jax"]
    assert [rc for rc, _ in out["torch"]] == [0, 0, 0]
    assert out["torch"][2][1] == ["scanned 120, imported 0, skipped 120, "
                                  "errors 0"]
