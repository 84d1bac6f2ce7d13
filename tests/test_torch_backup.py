"""The port's backup (``utils/backup.py``) against the JAX package's, on
the CPU: archives encrypted by either package decrypt in the other (and
fail alike with a wrong passphrase or a flipped byte), the SQLite snapshot
is JAX's byte for byte, ``verify_archive`` reports alike on either's
archives, every target of ``tests/test_backup_targets.py`` runs against
the same fakes (FTP, S3's SigV4 signatures, SFTP, rsync, Google Drive)
with the same results, and the S3 and Drive targets run on each package's
default transport (httpx in JAX, the port's urllib) against loopback
fakes of the two services, which see the same requests.
"""

from __future__ import annotations

import hashlib
import importlib
import io
import json
import re
import sqlite3
import tarfile
import urllib.parse
from types import SimpleNamespace

import pytest

from birdnet_go_tpu_torch.diag.fake_services import FakeHttp
from tests.test_backup_targets import (
    FakeDriveSession,
    FakeSftpRunner,
    MiniFtpServer,
    _FakeS3Session,
)


def _pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(name=name, backup=importlib.import_module(
        f"{name}.utils.backup"), settings=importlib.import_module(
        f"{name}.config.settings"))


J, T = _pkg("birdnet_go_tpu"), _pkg("birdnet_go_tpu_torch")
BOTH = (J, T)
_STAMP = re.compile(r"birdnet-backup-\d{8}T\d+")


def _stamped(text: str) -> str:
    """An archive's name without the wall clock in it."""
    return _STAMP.sub("birdnet-backup-<stamp>", text)


def _db(path) -> str:
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE detections (id INTEGER PRIMARY KEY,"
                 " species TEXT, conf REAL)")
    conn.executemany("INSERT INTO detections (species, conf) VALUES (?, ?)",
                     [("Turdus merula", 0.9), ("Strix aluco", 0.75),
                      ("it's \"quoted\"", 0.5)])
    conn.commit()
    conn.close()
    return str(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encryption_crosses_packages(writer):
    """An archive one package encrypts the other decrypts; a wrong
    passphrase and a flipped byte fail alike in both."""
    w, r = (J, T) if writer == "jax" else (T, J)
    data = bytes(range(256)) * 40
    blob = w.backup.encrypt_backup(data, "hunter2")
    assert blob[:6] == b"BNBK1\0"
    assert r.backup.decrypt_backup(blob, "hunter2") == data
    errors = []
    for P in BOTH:
        for bad in ((blob, "wrong"), (blob[:-1] + bytes([blob[-1] ^ 1]),
                                      "hunter2"), (b"plain", "x")):
            with pytest.raises(ValueError) as e:
                P.backup.decrypt_backup(*bad)
            errors.append(str(e.value))
    assert errors[:3] == errors[3:]


def test_snapshot_and_archive_as_jax(tmp_path):
    """``snapshot_sqlite`` writes JAX's SQL; an archive of either package,
    plain or encrypted, verifies in both with the same report."""
    db = _db(tmp_path / "d.db")
    assert T.backup.snapshot_sqlite(db) == J.backup.snapshot_sqlite(db)
    reports = {}
    for P in BOTH:
        for pw in ("", "pw"):
            mgr = P.backup.BackupManager(P.backup.BackupConfig(
                enabled=True, target_dir=str(tmp_path / P.name / (pw or "-")),
                passphrase=pw), db_path=db)
            name = mgr.run_once()
            blob = mgr.target.fetch(name)
            reports[(P.name, pw)] = [
                {k: v for k, v in Q.backup.verify_archive(blob, pw).items()}
                for Q in BOTH]
            assert name.endswith(".tar.gz.enc" if pw else ".tar.gz")
    flat = [r for rs in reports.values() for r in rs]
    for pw in ("", "pw"):
        assert reports[("birdnet_go_tpu", pw)] == \
            reports[("birdnet_go_tpu_torch", pw)]
    assert all(r["database"]["tables"]["detections"] == 3 for r in flat)


def test_verify_detects_corruption_as_jax(tmp_path):
    db = _db(tmp_path / "d.db")
    out = []
    for P in BOTH:
        mgr = P.backup.BackupManager(P.backup.BackupConfig(
            enabled=True, target_dir=str(tmp_path / P.name)), db_path=db)
        blob = bytearray(mgr.target.fetch(mgr.run_once()))
        blob[len(blob) // 2] ^= 0xFF
        rec = []
        for Q in BOTH:
            try:
                Q.backup.verify_archive(bytes(blob))
                rec.append("verified")
            except Exception as e:  # noqa: BLE001
                rec.append(type(e).__name__)
        enc = P.backup.encrypt_backup(b"x", "pw")
        with pytest.raises(ValueError, match="passphrase"):
            P.backup.verify_archive(enc)
        out.append(rec)
    assert "verified" not in out[0] + out[1]
    # manifest tampering: a changed member fails its checksum in both
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in (("database.sql", b"CREATE TABLE t (x);"),
                           ("manifest.json", json.dumps(
                               {"database.sql": "0" * 64}).encode())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    msgs = []
    for P in BOTH:
        with pytest.raises(ValueError) as e:
            P.backup.verify_archive(buf.getvalue())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "checksum mismatch for database.sql"


def test_manager_retention_and_verify_as_jax(tmp_path):
    """Three runs with keep=2 leave the newest two; verify() reads the
    latest; the same in both packages."""
    db = _db(tmp_path / "d.db")
    out = []
    for P in BOTH:
        mgr = P.backup.BackupManager(P.backup.BackupConfig(
            enabled=True, target_dir=str(tmp_path / P.name), keep=2,
            passphrase="s3cret"), db_path=db)
        names = [mgr.run_once() for _ in range(3)]
        left = mgr.target.list()
        report = mgr.verify()
        out.append((left == names[1:], report["archive"] == names[-1],
                    report["encrypted"], report["database"], mgr.runs,
                    len(report["files"])))
    assert out[0] == out[1]
    assert out[1][:3] == (True, True, True)


def test_ftp_target_as_jax(tmp_path):
    """tests/test_backup_targets.py's FTP cases through both: store, list,
    delete, a manager with retention, a wrong password."""
    import ftplib

    out = []
    for P in BOTH:
        root = tmp_path / P.name
        root.mkdir()
        srv = MiniFtpServer(root)
        srv.start()
        try:
            t = P.backup.FtpTarget("127.0.0.1", user="u", password="pw",
                                   port=srv.port)
            t.store("b1.tar.gz", b"archive-one")
            t.store("b2.tar.gz", b"archive-two")
            rec = [t.list(), (root / "b1.tar.gz").read_bytes()]
            t.delete("b1.tar.gz")
            rec.append(t.list())
            mgr = P.backup.BackupManager(P.backup.BackupConfig(
                enabled=True, keep=2), db_path=_db(tmp_path / f"{P.name}.db"),
                target=t)
            for _ in range(3):
                mgr.run_once()
            rec.append(len(t.list()))
            bad = P.backup.FtpTarget("127.0.0.1", user="u", password="wrong",
                                     port=srv.port)
            with pytest.raises(ftplib.error_perm):
                bad.store("x.tar.gz", b"data")
            out.append(rec)
        finally:
            srv.stop()
    assert out[0] == out[1]


def test_s3_sigv4_as_jax():
    """The same requests with the same clock sign alike, byte for byte;
    list and delete read alike."""
    out = []
    for P in BOTH:
        sess = _FakeS3Session()
        t = P.backup.S3Target("bkt", "AKIDEXAMPLE", "secret",
                              region="eu-west-1", session=sess,
                              clock=lambda: 1700000000.0)
        t.store("b1.tar.gz", b"payload")
        names = t.list()
        t.delete("a.tar.gz")
        out.append((sess.requests, names))
    assert out[0] == out[1]


def test_sftp_rsync_gdrive_targets_as_jax(tmp_path):
    """SFTP's batches, rsync's mirror and Drive's REST calls against
    tests/test_backup_targets.py's fakes: the same batches, files and
    results in both."""
    import shutil

    out = []
    for P in BOTH:
        base = tmp_path / P.name
        runner = FakeSftpRunner(base / "remote")
        (base / "remote" / "backups").mkdir(parents=True)
        s = P.backup.SftpTarget("h", "u", directory="backups", runner=runner)
        s.store("a.tar.gz", b"alpha")
        s.store("b.tar.gz.enc", b"beta")
        rec = [s.list(), s.fetch("b.tar.gz.enc")]
        s.delete("a.tar.gz")
        with pytest.raises(RuntimeError):
            s.delete("missing.tar.gz")
        rec += [s.list(), runner.batches]
        synced = []

        def fake_rsync(args):
            synced.append([a.replace(str(base), "<base>") for a in args])
            shutil.rmtree(args[-1], ignore_errors=True)
            shutil.copytree(args[-2], args[-1])
            return 0, ""

        r = P.backup.RsyncTarget(str(base / "dest"), base / "staging",
                                 runner=fake_rsync)
        r.store("a.tar.gz", b"alpha")
        r.store("b.tar.gz", b"beta")
        r.delete("a.tar.gz")
        rec += [sorted(p.name for p in (base / "dest").iterdir()),
                r.fetch("b.tar.gz"), synced]
        sess = FakeDriveSession()
        g = P.backup.GDriveTarget("cid", "csec", "rt-xyz",
                                  folder_id="folder9", session=sess)
        g.store("a.tar.gz", b"alpha")
        g.store("b.tar.gz.enc", b"beta")
        rec += [g.list(), g.fetch("b.tar.gz.enc")]
        g.delete("a.tar.gz")
        with pytest.raises(FileNotFoundError):
            g.fetch("missing.tar.gz")
        rec += [g.list(), sess.token_calls]
        out.append(rec)
    assert out[0] == out[1]


def test_build_target_as_jax(tmp_path):
    cases = [dict(target_dir=str(tmp_path)),
             dict(target="sftp", remote={"host": "h", "user": "u"}),
             dict(target="rsync", target_dir=str(tmp_path / "st"),
                  remote={"dest": "h:/backups"}),
             dict(target="ftp", remote={"host": "h"}),
             dict(target="s3", remote={"bucket": "b", "access_key": "k",
                                       "secret_key": "s"}),
             dict(target="gdrive", remote={"client_id": "c",
                                           "client_secret": "s",
                                           "refresh_token": "r"}),
             dict(target="webdav")]
    out = []
    for P in BOTH:
        rec = []
        for kw in cases:
            try:
                rec.append(type(P.backup.build_target(
                    P.settings.BackupSettings(**kw))).__name__)
            except ValueError as e:
                rec.append(str(e))
        out.append(rec)
    assert out[0] == out[1]
    assert out[1][-1] == "unknown backup target 'webdav'"


# -- S3 and Drive over each transport --------------------------------------------------

def _s3_server() -> FakeHttp:
    """A bucket under ``/backups/``: PUT, GET, DELETE and list-type=2, each
    refused (403) unless its Authorization is the SigV4 signature JAX's
    signer gives the request as it arrived (host, date, payload hash)."""
    import calendar
    import time as _time

    objects: dict[str, bytes] = {}

    def authed(fn):
        def answer(r):
            h = r["headers"]
            stamp = calendar.timegm(_time.strptime(h.get("x-amz-date", ""),
                                                   "%Y%m%dT%H%M%SZ"))
            signer = J.backup.S3Target(
                "bkt", "AKIDEXAMPLE", "secret", region="eu-west-1",
                endpoint=f"http://{h['host']}", session=object(),
                clock=lambda: stamp)
            want = signer._sign(r["method"], r["path"], r["raw"], r["query"])
            if h.get("authorization") != want["Authorization"] or \
                    h.get("x-amz-content-sha256") != hashlib.sha256(
                        r["raw"]).hexdigest():
                return 403, b"<Error>SignatureDoesNotMatch</Error>"
            return fn(r)
        return answer

    def put(r):
        objects[r["path"]] = r["raw"]
        return 200, b""

    def get(r):
        if r["path"] == "/":
            prefix = urllib.parse.parse_qs(r["query"])["prefix"][0]
            keys = "".join(f"<Contents><Key>{k[1:]}</Key></Contents>"
                           for k in sorted(objects) if k[1:].startswith(
                               prefix))
            return 200, f"<ListBucketResult>{keys}</ListBucketResult>" \
                .encode(), {"Content-Type": "application/xml"}
        if r["path"] not in objects:
            return 404, b"<Error>NoSuchKey</Error>"
        return 200, objects[r["path"]]

    def delete(r):
        objects.pop(r["path"], None)
        return 204, b""

    return FakeHttp("s3", [("PUT", r"/backups/.+", authed(put)),
                           ("GET", r"/(backups/.+)?", authed(get)),
                           ("DELETE", r"/backups/.+", authed(delete))])


def test_s3_over_each_transport_as_jax(tmp_path):
    """A backup manager on the S3 target over each package's default
    transport against the loopback bucket: the same requests (signed
    alike at the same clock), archives and verification."""
    db = _db(tmp_path / "d.db")
    out = []
    for P in BOTH:
        srv = _s3_server().start()
        try:
            t = P.backup.S3Target(
                "bkt", "AKIDEXAMPLE", "secret", region="eu-west-1",
                endpoint=f"http://127.0.0.1:{srv.port}",
                clock=lambda: 1700000000.0)
            t.store("x.tar.gz", b"\x00latin\xff")
            rec = [t.fetch("x.tar.gz"), t.list()]
            t.delete("x.tar.gz")
            mgr = P.backup.BackupManager(P.backup.BackupConfig(
                enabled=True, keep=1, passphrase="pw"), db_path=db, target=t)
            mgr.run_once()
            mgr.run_once()
            rec += [len(t.list()), mgr.verify()["database"]]
            # (the server checked each signature; an archive's payload
            # hash holds its gzip time stamp: compared where it is fixed)
            rec.append([(r["method"], _stamped(r["path"]), r["query"],
                         r["headers"]["x-amz-date"]) + (
                (r["headers"]["x-amz-content-sha256"],)
                if "birdnet-backup" not in r["path"] else ())
                for r in srv.requests])
            with pytest.raises(Exception) as e:
                t.fetch("missing.tar.gz")
            rec.append(type(e.value).__name__)
            out.append(rec)
        finally:
            srv.stop()
    assert out[0] == out[1]
    assert out[1][0] == b"\x00latin\xff" and out[1][1] == ["x.tar.gz"]


def _drive_server() -> FakeHttp:
    """OAuth2's token endpoint and Drive v3's files: multipart upload, a
    q-filtered list, alt=media download and delete, each refused (401)
    without the access token."""
    files: dict[str, tuple[str, bytes]] = {}
    ids = iter(range(1, 1 << 20))

    def token(r):
        form = urllib.parse.parse_qs(r["body"])
        if form.get("grant_type") != ["refresh_token"] or \
                form.get("refresh_token") != ["rt-xyz"]:
            return 400, {"error": "invalid_grant"}
        return 200, {"access_token": "at-1", "expires_in": 3600}

    def authed(fn):
        def answer(r):
            if r["headers"].get("authorization") != "Bearer at-1":
                return 401, {"error": "unauthorized"}
            return fn(r)
        return answer

    def upload(r):
        boundary = r["headers"]["content-type"].split("boundary=")[1]
        parts = r["raw"].split(b"--" + boundary.encode())
        meta = json.loads(parts[1].split(b"\r\n\r\n", 1)[1]
                          .rsplit(b"\r\n", 1)[0])
        fid = f"id{next(ids)}"
        files[fid] = (meta["name"],
                      parts[2].split(b"\r\n\r\n", 1)[1].rsplit(b"\r\n", 1)[0])
        return 200, {"id": fid}

    def listing(r):
        q = urllib.parse.parse_qs(r["query"])["q"][0]
        m = re.search(r"name = '([^']+)'", q)
        return 200, {"files": [{"id": f, "name": n} for f, (n, _) in
                               files.items() if m is None
                               or n == m.group(1)]}

    def media(r):
        fid = r["path"].rsplit("/", 1)[1]
        if fid not in files:
            return 404, {"error": "not found"}
        return 200, files[fid][1]

    def delete(r):
        files.pop(r["path"].rsplit("/", 1)[1], None)
        return 204, b""

    return FakeHttp("drive", [
        ("POST", "/token", token),
        ("POST", "/upload/drive/v3/files", authed(upload)),
        ("GET", "/drive/v3/files", authed(listing)),
        ("GET", r"/drive/v3/files/\w+", authed(media)),
        ("DELETE", r"/drive/v3/files/\w+", authed(delete))])


def test_gdrive_over_each_transport_as_jax(tmp_path):
    """A backup manager on the Drive target over each package's default
    transport against the loopback Drive: the token fetched once, the
    archives stored, listed, fetched, verified and deleted alike."""
    db = _db(tmp_path / "d.db")
    out = []
    for P in BOTH:
        srv = _drive_server().start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            t = P.backup.GDriveTarget(
                "cid", "csec", "rt-xyz", folder_id="folder9",
                endpoint=f"{base}/drive/v3",
                upload_endpoint=f"{base}/upload/drive/v3",
                token_endpoint=f"{base}/token")
            t.store("a.tar.gz", b"alpha\x00\xff")
            rec = [t.list(), t.fetch("a.tar.gz")]
            t.delete("a.tar.gz")
            with pytest.raises(FileNotFoundError):
                t.fetch("a.tar.gz")
            mgr = P.backup.BackupManager(P.backup.BackupConfig(
                enabled=True, keep=1), db_path=db, target=t)
            names = [mgr.run_once() for _ in range(2)]
            rec += [t.list() == names[1:], mgr.verify()["database"]]
            rec.append([(r["method"], r["path"],
                         _stamped(r["query"].split("&")[0]))
                        for r in srv.requests])
            out.append(rec)
        finally:
            srv.stop()
    assert out[0] == out[1]
    assert out[1][0] == ["a.tar.gz"] and out[1][1] == b"alpha\x00\xff"
    assert [p for _, p, _ in out[1][-1]].count("/token") == 1
