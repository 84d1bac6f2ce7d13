"""The port's crash recovery (``utils/diskmanager.py``,
``analysis/recovery.py``, ``scheduler/crashleg.py``), its host commands
(``recover``, ``db``, ``gen-schema``, ``notify``, ``migrate``, ``support``
with ``utils/support.py`` and ``config/schema.py``) and retention in the
app, against the JAX package's, on the CPU.

Each case runs once through the JAX package's modules and once through the
port's from the same inputs; ``_both`` asserts the two records equal after
``_plain``. The disk manager's cases are JAX's own
(``tests/test_integrations.py``): the files left and the results equal.
The crash leg runs once, on the port's stub device (``run_crash_leg``:
200 streams, killed after 40 rows and 1 threshold, a 6 s restart leg); the
tree its victim left is copied before recovery, and JAX's and the port's
``recover_startup`` give equal ledgers on the copies.

Divergences, each shown by its own test: the port's ``reconcile`` pages
through every clip reference, where JAX reads the newest 100,000 rows and
its recovery deletes the older rows' clips
(``test_reconcile_pages_past_100k_clip_rows``); ``system.json`` lists the
torch devices (``test_support_lists_torch_devices``); ``db`` refuses
``database.type: mysql`` (``test_db_doctor_refuses_mysql``); the crash leg
takes ``--device`` and adds keys to JAX's record
(``test_crash_leg_record_has_jax_keys_and_the_ports``).
"""

import dataclasses
import datetime
import importlib
import io
import json
import os
import shutil
import sqlite3
import tarfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_migration import _legacy_with_n
from tests import test_torch_app as app_tests
from tests.test_torch_app import _app_settings, _patch_models, tiny_v24  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("birdnet_go_tpu", "birdnet_go_tpu_torch")


def _pkg(name: str) -> SimpleNamespace:
    mod = {k: importlib.import_module(f"{name}.{path}") for k, path in (
        ("app", "app"),
        ("cli", "cli.main"),
        ("diskmanager", "utils.diskmanager"),
        ("labels", "taxonomy.labels"),
        ("recovery", "analysis.recovery"),
        ("results", "analysis.results"),
        ("schema", "config.schema"),
        ("settings", "config.settings"),
        ("sqlite", "datastore.sqlite"),
        ("support", "utils.support"))}
    return SimpleNamespace(**mod)


J, T = _pkg(PACKAGES[0]), _pkg(PACKAGES[1])


def _plain(x):
    """A comparable value: dataclasses by class name and fields, dicts
    with sorted items."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return sorted((repr(_plain(k)), _plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _both(case, *args):
    """`case` through both packages: the two records, asserted equal."""
    want, got = case(J, *args), case(T, *args)
    assert _plain(got) == _plain(want)
    return got


def _dir(tmp_path: Path, P) -> Path:
    d = tmp_path / P.app.__name__.split(".")[0]
    d.mkdir(parents=True, exist_ok=True)
    return d


def _detection(P, sci="Turdus merula", common="Eurasian Blackbird",
               conf=0.9, ts=1_700_000_000.0, source="s1"):
    """``tests/test_realtime_core.py``'s detection, in package `P`."""
    return P.results.Detection(
        species=P.labels.Species(sci, common), confidence=conf,
        begin_seconds=ts, end_seconds=ts + 12, model_id="BirdNET_V2.4",
        source_id=source, timestamp=datetime.datetime.fromtimestamp(ts),
        species_code="eurbla")


def _files(d: Path) -> list[str]:
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*")
                  if p.is_file())


# -- the disk manager (tests/test_integrations.py's cases) ---------------------------

def _age_policy_and_locked_spared(P, tmp_path):
    d = _dir(tmp_path, P) / "clips"
    d.mkdir()
    old, new, locked = d / "old.wav", d / "new.wav", d / "locked.wav"
    for p in (old, new, locked):
        p.write_bytes(b"RIFF")
    t_old = time.time() - 40 * 86400
    os.utime(old, (t_old, t_old))
    os.utime(locked, (t_old, t_old))
    ds = P.sqlite.Datastore(":memory:")
    ds.lock_detection(ds.insert_detection(_detection(P),
                                          clip_name="locked.wav"))
    dm = P.diskmanager.DiskManager(
        d, P.diskmanager.RetentionPolicy(mode="age", max_age_days=30),
        datastore=ds)
    return dm.cleanup(), _files(d)


def _reconcile(P, tmp_path):
    d = _dir(tmp_path, P) / "clips"
    d.mkdir()
    (d / "orphan.wav").write_bytes(b"RIFF")
    ds = P.sqlite.Datastore(":memory:")
    ds.insert_detection(_detection(P), clip_name="missing.wav")
    dm = P.diskmanager.DiskManager(d, P.diskmanager.RetentionPolicy(),
                                   datastore=ds)
    return dm.reconcile(), _files(d)


def _nested_year_month_layout(P, tmp_path):
    d = _dir(tmp_path, P) / "clips"
    sub = d / "2026" / "03"
    sub.mkdir(parents=True)
    old, locked = sub / "old.wav", sub / "locked.flac"
    old.write_bytes(b"RIFF")
    locked.write_bytes(b"fLaC")
    t_old = time.time() - 40 * 86400
    os.utime(old, (t_old, t_old))
    os.utime(locked, (t_old, t_old))
    ds = P.sqlite.Datastore(":memory:")
    ds.lock_detection(ds.insert_detection(
        _detection(P), clip_name="2026/03/locked.flac"))
    ds.insert_detection(_detection(P), clip_name="2026/04/missing.wav")
    dm = P.diskmanager.DiskManager(
        d, P.diskmanager.RetentionPolicy(mode="age", max_age_days=30),
        datastore=ds)
    return dm.cleanup(), dm.reconcile(), _files(d)


def _reconcile_orphans_pass_guards(P, tmp_path):
    d = _dir(tmp_path, P) / "clips"
    d.mkdir()
    old_ts = time.time() - 3600
    DM, Policy = P.diskmanager.DiskManager, P.diskmanager.RetentionPolicy

    def seed(ds, n_present, n_ghost):
        for i in range(n_present):
            name = f"2026/01/present{i}.wav"
            f = d / name
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_bytes(b"RIFF")
            ds.insert_detection(_detection(P, ts=old_ts), clip_name=name)
        for i in range(n_ghost):
            ds.insert_detection(_detection(P, ts=old_ts),
                                clip_name=f"2026/01/ghost{i}.wav")

    out = []
    ds = P.sqlite.Datastore(":memory:")
    seed(ds, 2, 3)                    # positive evidence: ghosts cleared
    out.append(DM(d, Policy(), datastore=ds).reconcile_orphans_pass())
    out.append([r["clip_name"] for r in ds.get_clip_references()])
    ds2 = P.sqlite.Datastore(":memory:")
    seed(ds2, 0, 5)                   # detached storage: all orphan
    out.append(DM(d, Policy(), datastore=ds2).reconcile_orphans_pass())
    out.append(len(ds2.get_clip_references()))
    ds3 = P.sqlite.Datastore(":memory:")
    seed(ds3, 1, 0)                   # recency: a fresh ghost stays
    ds3.insert_detection(_detection(P, ts=time.time()),
                         clip_name="2026/01/encoding.wav")
    out.append(DM(d, Policy(), datastore=ds3).reconcile_orphans_pass())
    out.append(DM(d / "unmounted", Policy(),
                  datastore=ds).reconcile_orphans_pass())
    # a reconcile pages past RECONCILE_CHUNK rows
    dm = DM(d, Policy(), datastore=ds)
    dm.RECONCILE_CHUNK = 2
    out.append(dm.reconcile())
    return out, _files(d)


DISK_CASES = {"age_policy_and_locked_spared": _age_policy_and_locked_spared,
              "reconcile": _reconcile,
              "nested_year_month_layout": _nested_year_month_layout,
              "reconcile_orphans_pass_guards":
                  _reconcile_orphans_pass_guards}


@pytest.mark.parametrize("name", sorted(DISK_CASES))
def test_disk_manager_matches_jax(name, tmp_path):
    rec = _both(DISK_CASES[name], tmp_path)
    if name == "age_policy_and_locked_spared":
        res, left = rec
        assert (res.deleted, res.spared_locked) == (1, 1)
        assert left == ["locked.wav", "new.wav"]
    elif name == "reconcile":
        assert rec[0] == {"orphan_files": ["orphan.wav"],
                          "missing_files": ["missing.wav"]}


def test_reconcile_pages_past_100k_clip_rows(tmp_path):
    """100,050 rows with a clip, of which only the 50 oldest have their
    file (the newer rows completed within the recency window, so neither
    package clears their references). JAX's ``reconcile`` reads the
    newest 100,000 rows (``search_detections(limit=100000)``), reports the
    50 files as orphans, and its ``recover_startup`` deletes them; the
    port's pages through every row, reports none and deletes none."""
    now = time.time()
    src = tmp_path / "src"
    clips = src / "clips"
    (clips / "2026" / "01").mkdir(parents=True)
    db = src / "birds.db"
    T.sqlite.Datastore(str(db)).close()
    n, kept = 100_050, 50
    names = [f"2026/01/c{i:06d}.wav" for i in range(n)]
    rows = []
    for i, name in enumerate(names):
        ts = now - 2 * 86400 + i
        done = now - 86400 if i < kept else now - 60
        rows.append((ts, "2026-01-01", "06:00:00", "s1", "BirdNET_V2.4",
                     "Turdus merula", "Eurasian Blackbird", 0.9, ts, done,
                     name))
    with sqlite3.connect(db) as con:
        con.executemany(
            "INSERT INTO detections (timestamp, date, time, source_id,"
            " model_id, scientific_name, common_name, confidence,"
            " begin_time, end_time, clip_name)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?)", rows)
    for name in names[:kept]:
        f = clips / name
        f.write_bytes(b"RIFF")
        os.utime(f, (now - 86400, now - 86400))
    out = []
    for P in (J, T):
        d = tmp_path / P.app.__name__.split(".")[0]
        shutil.copytree(src, d)
        store = P.sqlite.Datastore(str(d / "birds.db"))
        dm = P.diskmanager.DiskManager(
            d / "clips", P.diskmanager.RetentionPolicy(mode="none"),
            datastore=store)
        rec = dm.reconcile()
        store.close()
        ledger = P.recovery.recover_startup(str(d / "birds.db"),
                                            clips_dir=str(d / "clips"),
                                            now=now)
        out.append((rec, ledger, _files(d / "clips")))
    (jrec, jled, jleft), (trec, tled, tleft) = out
    assert jrec["orphan_files"] == names[:kept]
    assert jled["clips"]["orphan_files_swept"] == kept and jleft == []
    assert trec["orphan_files"] == []
    assert tled["clips"]["orphan_files_swept"] == 0
    assert tleft == names[:kept]
    assert len(jrec["missing_files"]) == len(trec["missing_files"]) \
        == n - kept
    for led in (jled, tled):
        assert led["detections"] == n
        assert led["clips"]["dangling_refs_cleared"] == 0


# -- the crash leg ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def crash_leg(tmp_path_factory):
    """``run_crash_leg(device="stub")`` on 200 streams, killed after 40
    rows and 1 threshold (``tests/test_crash_durability.py``'s victim),
    with a 6 s restart leg; the tree the victim left is copied twice when
    recovery first runs."""
    from birdnet_go_tpu_torch.scheduler import crashleg

    root = tmp_path_factory.mktemp("crashleg")
    work, copies = root / "work", {}        # package name → copy
    real = T.recovery.recover_startup

    def first_copies(db_path, clips_dir=None, now=None, store=None):
        if not copies:
            for P in (J, T):
                d = root / P.app.__name__.split(".")[0]
                d.mkdir()
                shutil.copy2(db_path, d / "birds.db")
                wal = Path(db_path + "-wal")
                if wal.exists():
                    shutil.copy2(wal, d / "birds.db-wal")
                shutil.copytree(clips_dir, d / "clips")
                copies[P.app.__name__] = d
        return real(db_path, clips_dir=clips_dir, now=now, store=store)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T.recovery, "recover_startup", first_copies)
        rec = crashleg.run_crash_leg(streams=200, kill_min_rows=40,
                                     restart_seconds=6.0,
                                     workdir=str(work), device="stub")
    return rec, copies


def _jax_crash_record() -> dict:
    """The crash leg's record of JAX's own run (``SOAK_r05.json``)."""
    runs = json.loads((REPO / "SOAK_r05.json").read_text())["runs"]
    return next(r for r in runs if r.get("leg") == "crash_durability")


def test_crash_leg_record_has_jax_keys_and_the_ports(crash_leg):
    rec, _ = crash_leg
    jrec = _jax_crash_record()
    assert set(jrec) | {"device", "card", "trigger",
                        "recovery_seconds"} == set(rec)
    assert set(jrec["victim"]) | {"group_alive_after_kill",
                                  "calibrated_threshold"} \
        == set(rec["victim"])
    assert set(jrec["restart"]) | {
        "card_memory_free_gib", "card_memory_total_gib", "approved",
        "mel_kernel_launches", "batches_dispatched",
        "threshold_calibration", "thresholds_restored",
        "restored_levels_match_db"} == set(rec["restart"])
    assert set(jrec["recovery_ledger"]) == set(rec["recovery_ledger"])
    v, r = rec["victim"], rec["restart"]
    assert rec["pass"] and rec["device"] == "stub" and rec["card"] is None
    assert rec["trigger"] == 0.9
    assert v["signal"] == "SIGKILL" and v["returncode"] == -9
    assert v["rows_committed_before_kill"] >= 40
    assert v["thresholds_before_kill"] >= 1
    assert not v["group_alive_after_kill"]
    # the restart leg appended to the recovered database: exact equation
    assert r["detections_persisted"] > 0
    assert r["detections_after"] == r["detections_before"] \
        + r["detections_persisted"]
    assert r["exact_count_equation_holds"] and r["duplicate_detections"] == 0
    assert r["drop_accounting"]["farm_samples_lost"] == 0
    # the stub launches no kernel and has no card
    assert r["mel_kernel_launches"] is None and r["batches_dispatched"] is None
    assert r["card_memory_free_gib"] is None


def test_recovery_of_the_killed_tree_matches_jax(crash_leg):
    """JAX's and the port's ``recover_startup`` on copies of the tree the
    victim left: equal ledgers, convergence (no orphan either way after),
    and idempotency (a second pass finds nothing to heal)."""
    rec, copies = crash_leg
    future = time.time() + 3600.0          # past the recency guards

    def case(P):
        d = copies[P.app.__name__]
        ledger = P.recovery.recover_startup(str(d / "birds.db"),
                                            clips_dir=str(d / "clips"),
                                            now=future)
        store = P.sqlite.Datastore(str(d / "birds.db"))
        try:
            converged = P.diskmanager.DiskManager(
                d / "clips", P.diskmanager.RetentionPolicy(mode="none"),
                datastore=store).reconcile()
        finally:
            store.close()
        again = P.recovery.recover_startup(str(d / "birds.db"),
                                           clips_dir=str(d / "clips"),
                                           now=future)
        return ledger, converged, again

    ledger, converged, again = _both(case)
    assert ledger["integrity"] == "ok"
    assert ledger["detections"] >= rec["victim"]["rows_committed_before_kill"]
    assert ledger["duplicate_detections"] == 0
    assert ledger["thresholds_restored"] >= 1
    assert ledger["species_resynced"] >= 1
    assert "refs_aborted_reason" not in ledger["clips"]
    assert converged == {"orphan_files": [], "missing_files": []}
    assert again["detections"] == ledger["detections"]
    assert again["clips"]["orphan_files_swept"] == 0
    assert again["clips"]["dangling_refs_cleared"] == 0
    # the leg's own recovery of the original tree saw the same state
    assert {k: v for k, v in rec["recovery_ledger"].items() if k != "wal"} \
        == {k: v for k, v in ledger.items() if k != "wal"}
    assert rec["recovery_idempotent"]


def test_restart_leg_restores_the_thresholds_of_the_killed_run(crash_leg):
    """The port's restart leg counts the thresholds it restored at its
    start, not those it persisted at its end (JAX): at least as many as
    the victim had persisted at the kill, with the levels of the
    recovered database's rows."""
    rec, _ = crash_leg
    r = rec["restart"]
    assert r["thresholds_restored"] >= \
        rec["victim"]["thresholds_before_kill"] >= 1
    assert r["thresholds_restored_ge_before_kill"]
    assert r["restored_levels_match_db"]


def test_crash_leg_refuses_unknown_device(tmp_path):
    from birdnet_go_tpu_torch.scheduler import crashleg

    with pytest.raises(ValueError, match="unknown crash-leg device"):
        crashleg.run_crash_leg(device="tpu", workdir=str(tmp_path))


# -- the CLI's host commands -----------------------------------------------------------

def _cli(P, argv, capsys) -> tuple[int, str, str]:
    rc = P.cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_recover_command_matches_jax(tmp_path, capsys):
    """``recover --ignore-recency`` on a tree with an orphan file and a
    dangling reference beside a present clip: the same ledger and exit
    code; a second run finds nothing to heal."""
    def case(P):
        d = _dir(tmp_path, P)
        clips = d / "clips"
        (clips / "2026").mkdir(parents=True)
        (clips / "2026" / "orphan.wav").write_bytes(b"RIFF")
        (clips / "2026" / "kept.wav").write_bytes(b"RIFF")
        ds = P.sqlite.Datastore(str(d / "birds.db"))
        old = time.time() - 7200
        ds.insert_detection(_detection(P, ts=old), clip_name="2026/kept.wav")
        ds.insert_detection(_detection(P, ts=old, source="s2"),
                            clip_name="2026/lost.wav")
        ds.close()
        argv = ["recover", "--db", str(d / "birds.db"), "--clips-dir",
                str(clips), "--ignore-recency"]
        first, second = _cli(P, argv, capsys), _cli(P, argv, capsys)
        return first[0], json.loads(first[1]), second[0], \
            json.loads(second[1]), _files(clips)

    rc, ledger, rc2, again, left = _both(case)
    assert rc == rc2 == 0
    assert ledger["clips"]["orphan_files_swept"] == 1
    assert ledger["clips"]["dangling_refs_cleared"] == 1
    assert again["clips"]["orphan_files_swept"] == 0
    assert again["clips"]["dangling_refs_cleared"] == 0
    assert left == ["2026/kept.wav"]


def test_db_doctor_matches_jax(tmp_path, capsys):
    """``tests/test_cli_commands.py``'s doctor case through both CLIs: an
    orphaned child row found, repaired by ``--fix``, healthy after; a
    missing database exits 2."""
    def case(P):
        d = _dir(tmp_path, P)
        db = d / "doc.db"
        ds = P.sqlite.Datastore(db)
        ds.insert_detection(_detection(P))
        ds.close()
        conn = sqlite3.connect(db)
        conn.execute("INSERT INTO results (detection_id, result_rank,"
                     " scientific_name, confidence) VALUES (9999, 1, 'X',"
                     " 0.5)")
        conn.execute("DROP INDEX idx_det_sci")
        conn.commit()
        conn.close()
        runs = [_cli(P, ["db", "doctor", "--db", str(db), *extra], capsys)
                for extra in ([], ["--fix"], [])]
        missing = _cli(P, ["db", "doctor", "--db", str(d / "none.db")],
                       capsys)
        return ([(rc, json.loads(out)) for rc, out, _ in runs],
                (missing[0], missing[1].replace(str(d), "")))

    runs, missing = _both(case)
    assert [rc for rc, _ in runs] == [1, 0, 0]
    assert runs[0][1]["orphans"] == {"results": 1}
    assert any("deleted 1 results" in f for f in runs[1][1]["fixed"])
    assert runs[2][1]["healthy"] and runs[2][1]["detections"] == 1
    assert missing[0] == 2 and "database not found" in missing[1]


def test_db_doctor_on_mysql_as_jax(tmp_path, capsys):
    """``database.type: mysql`` without ``--db``: each package's doctor
    connects to MySQL (the port's test server, caching_sha2 with RSA full
    auth) and finds, fixes and then clears an orphaned result row, with
    JAX's output and exit codes. With ``--db`` the SQLite file is
    doctored."""
    from birdnet_go_tpu_torch.diag.mysql_server import MySQLServer

    def case(P):
        srv = MySQLServer(password="pw", plugin="caching_sha2_password",
                          sha2_full_auth=True)
        srv.start()
        try:
            cfg = _dir(tmp_path, P) / "cfg.json"
            cfg.write_text(json.dumps({"database": {
                "type": "mysql", "host": "127.0.0.1", "port": srv.port,
                "user": "doctor", "password": "pw", "name": ""}}))
            mysql = importlib.import_module(
                f"{P.app.__name__[:-4]}.datastore.mysql")
            ds = mysql.MySQLDatastore(port=srv.port, user="doctor",
                                      password="pw", database="")
            ds.insert_detection(_detection(P, "Parus major", "Great Tit"))
            with srv._lock:
                srv.db.execute("INSERT INTO results (detection_id,"
                               " result_rank, scientific_name, common_name,"
                               " confidence) VALUES (99, 1, 'x', 'x', 0.5)")
                srv.db.commit()
            ds.close()
            runs = []
            for extra in ([], ["--fix"], []):
                rc, out, _ = _cli(P, ["db", "doctor", "--config", str(cfg),
                                      *extra], capsys)
                runs.append((rc, json.loads(out)))
            return runs, srv.full_auths
        finally:
            srv.stop()

    runs, auths = _both(case)
    assert [rc for rc, _ in runs] == [1, 0, 0] and auths == 1
    assert runs[0][1]["orphans"] == {"results": 1}
    assert runs[2][1]["healthy"] and runs[2][1]["detections"] == 1
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"database": {"type": "mysql"}}))
    db = tmp_path / "x.db"
    T.sqlite.Datastore(db).close()
    rc, out, _ = _cli(T, ["db", "doctor", "--config", str(cfg), "--db",
                          str(db)], capsys)
    assert rc == 0 and json.loads(out)["healthy"]


def test_gen_schema_matches_jax(capsys):
    schema = _both(lambda P: json.loads(_cli(P, ["gen-schema"], capsys)[1]))
    assert schema["type"] == "object"
    assert "webserver" in schema["properties"]
    assert schema["properties"]["retention"]["properties"]["mode"] == \
        {"type": "string", "default": "none"}


def test_notify_matches_jax(tmp_path, capsys):
    """No target: delivered to 0 of 0, exit 0. A JSON config with two
    command targets, one that appends the title and message to a file
    and one that fails: delivered to 1 of 2, exit 0, the file written."""
    def case(P):
        d = _dir(tmp_path, P)
        sink = d / "sink.txt"
        cfg = d / "notify.json"
        cfg.write_text(json.dumps({"notification": {"targets": [
            {"name": "file", "kind": "command", "command": [
                "sh", "-c", f"printf '%s' '$title|$message' >> {sink}"]},
            {"name": "fails", "kind": "command", "command": ["false"]}]}}))
        runs = [_cli(P, argv, capsys)[:2] for argv in (
            ["notify", "--message", "hello"],
            ["notify", "--config", str(cfg), "--title", "t"])]
        return runs, sink.read_text()

    runs, sink = _both(case)
    assert runs == [(0, "delivered to 0/0 target(s)\n"),
                    (0, "delivered to 1/2 target(s)\n")]
    assert sink == "t|CLI test notification"


def test_migrate_matches_jax(tmp_path, capsys):
    """``tests/test_cli_commands.py``'s migrate case through both CLIs:
    82 rows migrated, a second run refused, rollback after cutover
    refused, rollback of an unfinished migration allowed."""
    def case(P):
        d = _dir(tmp_path, P)
        legacy, db = d / "legacy.db", d / "native.db"
        _legacy_with_n(legacy, 80)
        migration = importlib.import_module(
            f"{P.app.__name__.split('.')[0]}.datastore.migration")
        out = [_cli(P, ["migrate", str(legacy), "--database", str(db),
                        "--batch-size", "32"], capsys)]
        out.append(_cli(P, ["migrate", str(legacy), "--database", str(db)],
                        capsys))
        out.append(_cli(P, ["migrate", str(legacy), "--database", str(db),
                            "--rollback"], capsys))
        migration.MigrationStateStore(P.sqlite.Datastore(db)).update(
            state="cancelled")
        out.append(_cli(P, ["migrate", str(legacy), "--database", str(db),
                            "--rollback"], capsys))
        rows = P.sqlite.Datastore(db).count_detections()
        # the progress line carries a rate and an ETA; the port logs at
        # INFO on stderr, JAX at WARNING
        return [(rc, o.rsplit("\r", 1)[-1].split(")")[0],
                 [ln for ln in e.splitlines() if ln.startswith("error")])
                for rc, o, e in out], rows

    out, rows = _both(case)
    assert [rc for rc, _, _ in out] == [0, 1, 1, 0]
    assert out[0][1] == "completed: 82/82 (100.0%"
    assert "already completed" in out[1][2][0]
    assert "rollback unavailable" in out[2][2][0]
    assert rows == 0


# -- support ---------------------------------------------------------------------------

_DEVICE_KEYS = {"devices", "devices_error", "jax", "torch", "cuda"}


def _system_json(data: bytes) -> dict:
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        return json.loads(tar.extractfile("system.json").read())


def test_support_matches_jax(tmp_path, capsys):
    """``scrub`` equal; ``support --output`` writes a bundle whose
    ``system.json`` is JAX's apart from the device keys and the time."""
    cfg = {"mqtt": {"password": "hunter2", "host": "x"},
           "url": "rtsp://admin:pw@cam/stream",
           "list": [{"api_key": "abc"}]}

    def case(P):
        d = _dir(tmp_path, P)
        rc, out, _ = _cli(P, ["support", "--output", str(d)], capsys)
        (bundle,) = d.glob("support-bundle-*.tar.gz")
        sysinfo = _system_json(bundle.read_bytes())
        return (P.support.scrub(cfg), rc, out.startswith(
            "support bundle written to "),
            {k: v for k, v in sysinfo.items()
             if k not in _DEVICE_KEYS | {"time"}})

    scrubbed, rc, said, sysinfo = _both(case)
    assert scrubbed["mqtt"]["password"] == "***" and rc == 0 and said
    assert "pw" not in scrubbed["url"] and "platform" in sysinfo


def test_support_lists_torch_devices(monkeypatch):
    """The port's ``system.json`` names the CUDA cards torch sees (JAX's
    lists ``jax.devices()``, which names the CPU here), with torch's and
    CUDA's versions; without a card ``devices`` is empty and
    ``devices_error`` says so."""
    jsys = _system_json(J.support.collect_support_bundle().data)
    assert jsys["devices"] and "jax" in jsys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tsys = _system_json(T.support.collect_support_bundle().data)
    assert tsys["devices"] == [] and "no CUDA card" in tsys["devices_error"]
    assert tsys["torch"] == torch.__version__ and "cuda" in tsys
    assert "jax" not in tsys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"NVIDIA H100 80GB HBM3 #{i}")
    tsys = _system_json(T.support.collect_support_bundle().data)
    assert tsys["devices"] == ["NVIDIA H100 80GB HBM3 #0",
                               "NVIDIA H100 80GB HBM3 #1"]
    assert "devices_error" not in tsys


# -- retention in the app --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["age", "usage"])
def test_app_runs_the_disk_manager(mode, tmp_path, monkeypatch, tiny_v24):
    """``retention.mode`` age or usage: ``setup`` builds a ``DiskManager``
    over the export path with the settings' policy and the app's
    datastore, ``start`` runs its thread every ``check_interval_hours``,
    ``stop`` ends it; as JAX's app does. (The port refused retention
    before it had the disk manager.)"""
    def case(P):
        A = app_tests.J if P is J else app_tests.T
        _patch_models(A, monkeypatch, tiny_v24)
        s = _app_settings(A, _dir(tmp_path, P))
        s.realtime.sources = []
        s.retention.mode = mode
        s.retention.max_age_days = 7.0
        s.retention.max_usage_percent = 90.0
        s.retention.check_interval_hours = 0.5
        app = (P.app.Application(s) if P is J
               else P.app.Application(s, device="cpu"))
        app.setup()
        dm = app.diskmanager
        intervals = []
        start = dm.start
        dm.start = lambda interval: (intervals.append(interval),
                                     start(interval))
        built = (type(dm).__module__, dm.clip_dir == Path(s.export.path),
                 dm.policy, dm.datastore is app.datastore)
        app.start(warmup=False)
        running = dm._thread is not None and dm._thread.is_alive()
        thread = dm._thread
        app.stop()
        return (built[1:], intervals, running, dm._thread is None,
                thread.is_alive(),
                any(t.name == "diskmanager" for t in threading.enumerate()))

    built, intervals, running, cleared, alive, left = _both(case)
    assert built[0] and built[2]
    assert built[1].mode == mode
    assert intervals == [1800.0] and running
    assert cleared and not alive and not left
