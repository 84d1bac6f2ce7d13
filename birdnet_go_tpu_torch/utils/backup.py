"""Backup manager: sources → archives → targets, with a scheduler.

Reference: internal/backup (8.6k LoC) — sources (sqlite DB via the online
backup API, config files), targets (local/FTP/SFTP/S3/rsync/GDrive),
optional encryption, retention of N archives, scheduled runs. This
implements the sqlite+config sources, the local-directory target, gzip
tar archives, SHA-256 manifests, and retention; remote targets plug in
behind the same Target protocol.

A copy of ``birdnet_go_tpu/utils/backup.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_backup.py`` holds it to the
original (archives encrypted by one package decrypt in the other, every
target against the same fakes). ``cryptography`` (AES-256-GCM, scrypt) is
imported inside ``encrypt_backup`` and ``decrypt_backup`` only, as in JAX.
The S3 and Google Drive targets' default session is the port's transport
(``utils/httpclient.py`` ``UrllibSession``) where JAX's builds an
``httpx.Client``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import io
import json
import logging
import sqlite3
import tarfile
import threading
import time
from pathlib import Path
from typing import Protocol

from birdnet_go_tpu_torch.utils.httpclient import UrllibSession

log = logging.getLogger("birdnet_tpu.backup")


@dataclasses.dataclass
class BackupConfig:
    enabled: bool = False
    target_dir: str = "data/backups"
    keep: int = 7
    include_config: str | None = None      # path to config.yaml
    interval_hours: float = 24.0
    # passphrase → AES-256-GCM encrypted archives (reference:
    # internal/backup encryption of archives before upload)
    passphrase: str = ""


_ENC_MAGIC = b"BNBK1\0"


def encrypt_backup(data: bytes, passphrase: str) -> bytes:
    """AES-256-GCM with a scrypt-derived key. Layout:
    magic(6) | salt(16) | nonce(12) | ciphertext+tag."""
    import os

    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from cryptography.hazmat.primitives.kdf.scrypt import Scrypt

    salt = os.urandom(16)
    key = Scrypt(salt=salt, length=32, n=2 ** 14, r=8, p=1).derive(
        passphrase.encode())
    nonce = os.urandom(12)
    ct = AESGCM(key).encrypt(nonce, data, _ENC_MAGIC)
    return _ENC_MAGIC + salt + nonce + ct


def decrypt_backup(blob: bytes, passphrase: str) -> bytes:
    """Inverse of encrypt_backup; raises ValueError on wrong passphrase
    or tampered data (GCM tag)."""
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from cryptography.hazmat.primitives.kdf.scrypt import Scrypt

    if not blob.startswith(_ENC_MAGIC):
        raise ValueError("not an encrypted backup")
    salt = blob[6:22]
    nonce = blob[22:34]
    key = Scrypt(salt=salt, length=32, n=2 ** 14, r=8, p=1).derive(
        passphrase.encode())
    try:
        return AESGCM(key).decrypt(nonce, blob[34:], _ENC_MAGIC)
    except InvalidTag as e:
        raise ValueError("wrong passphrase or corrupted archive") from e


class Target(Protocol):
    def store(self, name: str, data: bytes) -> None: ...

    def list(self) -> list[str]: ...

    def delete(self, name: str) -> None: ...

    def fetch(self, name: str) -> bytes: ...


class LocalTarget:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)

    def store(self, name: str, data: bytes) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.dir / (name + ".tmp")
        tmp.write_bytes(data)
        tmp.rename(self.dir / name)

    def list(self) -> list[str]:
        if not self.dir.is_dir():
            return []
        return sorted(p.name for p in self.dir.iterdir()
                      if p.suffix in (".gz", ".enc"))

    def delete(self, name: str) -> None:
        (self.dir / name).unlink(missing_ok=True)

    def fetch(self, name: str) -> bytes:
        return (self.dir / name).read_bytes()


class FtpTarget:
    """FTP target via stdlib ftplib (reference: backup FTP target)."""

    def __init__(self, host: str, user: str = "anonymous",
                 password: str = "", directory: str = "/",
                 port: int = 21, tls: bool = False, timeout: float = 30.0):
        self.host, self.port = host, port
        self.user, self.password = user, password
        self.directory = directory
        self.tls = tls
        self.timeout = timeout

    def _connect(self):
        import ftplib

        ftp = (ftplib.FTP_TLS if self.tls else ftplib.FTP)(timeout=self.timeout)
        ftp.connect(self.host, self.port)
        ftp.login(self.user, self.password)
        if self.tls:
            ftp.prot_p()
        if self.directory and self.directory != "/":
            ftp.cwd(self.directory)
        return ftp

    def store(self, name: str, data: bytes) -> None:
        ftp = self._connect()
        try:
            ftp.storbinary(f"STOR {name}.tmp", io.BytesIO(data))
            ftp.rename(f"{name}.tmp", name)     # atomic-ish publish
        finally:
            ftp.quit()

    def list(self) -> list[str]:
        ftp = self._connect()
        try:
            return sorted(n for n in ftp.nlst()
                          if n.endswith((".gz", ".enc")))
        finally:
            ftp.quit()

    def delete(self, name: str) -> None:
        ftp = self._connect()
        try:
            ftp.delete(name)
        finally:
            ftp.quit()

    def fetch(self, name: str) -> bytes:
        ftp = self._connect()
        try:
            buf = io.BytesIO()
            ftp.retrbinary(f"RETR {name}", buf.write)
            return buf.getvalue()
        finally:
            ftp.quit()


class S3Target:
    """S3-compatible target with from-scratch SigV4 signing (reference:
    backup S3 target; no AWS SDK in this image)."""

    def __init__(self, bucket: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", prefix: str = "backups/",
                 endpoint: str | None = None, session=None,
                 clock=time.time):
        self.bucket = bucket
        self.access_key, self.secret_key = access_key, secret_key
        self.region = region
        self.prefix = prefix
        self.endpoint = (endpoint
                         or f"https://{bucket}.s3.{region}.amazonaws.com")
        self.session = session or UrllibSession(timeout=60.0)
        self.clock = clock

    # SigV4 (https://docs.aws.amazon.com/general/latest/gr/sigv4.html)
    def _sign(self, method: str, path: str, payload: bytes,
              query: str = "") -> dict[str, str]:
        import hmac
        from urllib.parse import urlparse

        host = urlparse(self.endpoint).netloc
        now = _dt.datetime.fromtimestamp(self.clock(), _dt.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(payload).hexdigest()
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed = ";".join(sorted(headers))
        canonical = "\n".join([
            method, path, query,
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed, payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                             hashlib.sha256(canonical.encode()).hexdigest()])

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope},"
            f" SignedHeaders={signed}, Signature={signature}")
        return headers

    def _request(self, method: str, name: str = "", query: str = "",
                 payload: bytes = b""):
        path = "/" + self.prefix + name if name else "/"
        headers = self._sign(method, path, payload, query)
        url = self.endpoint + path + (f"?{query}" if query else "")
        r = self.session.request(method, url, content=payload or None,
                                 headers=headers)
        r.raise_for_status()
        return r

    def store(self, name: str, data: bytes) -> None:
        self._request("PUT", name, payload=data)

    def list(self) -> list[str]:
        import re

        r = self._request("GET", query="list-type=2&prefix="
                          + self.prefix.replace("/", "%2F"))
        keys = re.findall(r"<Key>([^<]+)</Key>", r.text)
        return sorted(k[len(self.prefix):] for k in keys
                      if k.endswith((".gz", ".enc")))

    def delete(self, name: str) -> None:
        self._request("DELETE", name)

    def fetch(self, name: str) -> bytes:
        return self._request("GET", name).content


class SftpTarget:
    """SFTP target via OpenSSH's `sftp` in batch mode (reference:
    internal/backup SFTP target). Paramiko-free by design: batch files
    drive the system client with key-based auth (`identity`), the
    standard unattended-backup setup; password auth is intentionally
    unsupported (would need sshpass/a TTY). `runner` is injectable for
    the in-process fake used by tests."""

    def __init__(self, host: str, user: str, directory: str = ".",
                 port: int = 22, identity: str | None = None,
                 timeout: float = 60.0, runner=None):
        self.host, self.user = host, user
        self.directory = directory.rstrip("/") or "."
        self.port = port
        self.identity = identity
        self.timeout = timeout
        self._runner = runner or self._subprocess_runner

    def _subprocess_runner(self, batch: str,
                           workdir: str) -> "tuple[int, str]":
        import subprocess

        cmd = ["sftp", "-b", "-", "-P", str(self.port),
               "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=accept-new"]
        if self.identity:
            cmd += ["-i", self.identity]
        cmd.append(f"{self.user}@{self.host}")
        p = subprocess.run(cmd, input=batch.encode(), capture_output=True,
                           timeout=self.timeout, cwd=workdir)
        return p.returncode, p.stdout.decode(errors="replace") \
            + p.stderr.decode(errors="replace")

    def _run(self, batch: str, workdir: str) -> str:
        rc, out = self._runner(batch, workdir)
        if rc != 0:
            raise RuntimeError(f"sftp failed ({rc}): {out[:300]}")
        return out

    def store(self, name: str, data: bytes) -> None:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            local = Path(td) / name
            local.write_bytes(data)
            # upload under .tmp then server-side rename = atomic publish
            self._run(f"put {name} {self.directory}/{name}.tmp\n"
                      f"rename {self.directory}/{name}.tmp"
                      f" {self.directory}/{name}\n", td)

    def list(self) -> list[str]:
        out = self._run(f"ls -1 {self.directory}\n", ".")
        names = []
        for line in out.splitlines():
            line = line.strip()
            if line.startswith("sftp>") or not line:
                continue
            base = line.rsplit("/", 1)[-1]
            if base.endswith((".gz", ".enc")):
                names.append(base)
        return sorted(names)

    def delete(self, name: str) -> None:
        self._run(f"rm {self.directory}/{name}\n", ".")

    def fetch(self, name: str) -> bytes:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            self._run(f"get {self.directory}/{name} {name}\n", td)
            return (Path(td) / name).read_bytes()


class RsyncTarget:
    """rsync target (reference: internal/backup rsync target): archives
    live in a local staging directory that is mirrored to `dest`
    (local path or [user@]host:path) with `rsync -a --delete` after
    every mutation — the canonical rsync backup shape, and restores
    keep working from staging even when the remote is unreachable.
    `runner` is injectable for tests; hosts without an rsync binary get
    a clear error at first use, never silent data loss."""

    def __init__(self, dest: str, staging_dir: str | Path,
                 extra_args: list[str] | None = None,
                 timeout: float = 300.0, runner=None):
        self.dest = dest.rstrip("/")
        self.staging = LocalTarget(staging_dir)
        self.extra_args = extra_args or []
        self.timeout = timeout
        self._runner = runner or self._subprocess_runner

    def _subprocess_runner(self, args: list[str]) -> "tuple[int, str]":
        import subprocess

        p = subprocess.run(["rsync", *args], capture_output=True,
                           timeout=self.timeout)
        return p.returncode, p.stdout.decode(errors="replace") \
            + p.stderr.decode(errors="replace")

    def _sync(self) -> None:
        self.staging.dir.mkdir(parents=True, exist_ok=True)
        rc, out = self._runner(["-a", "--delete", *self.extra_args,
                                str(self.staging.dir) + "/",
                                self.dest + "/"])
        if rc != 0:
            raise RuntimeError(f"rsync failed ({rc}): {out[:300]}")

    def store(self, name: str, data: bytes) -> None:
        self.staging.store(name, data)
        self._sync()

    def list(self) -> list[str]:
        return self.staging.list()

    def delete(self, name: str) -> None:
        self.staging.delete(name)
        self._sync()

    def fetch(self, name: str) -> bytes:
        return self.staging.fetch(name)


class GDriveTarget:
    """Google Drive target (reference: backup/targets/gdrive.go).

    Speaks the Drive v3 REST API directly over the pooled HTTP client:
    OAuth2 refresh-token exchange (the unattended-backup grant — the
    interactive consent that PRODUCES the refresh token happens once,
    out of band), multipart upload into a folder, name-filtered list,
    delete, and download. `endpoint`/`token_endpoint` are injectable so
    tests run against an in-process Drive fake."""

    def __init__(self, client_id: str, client_secret: str,
                 refresh_token: str, folder_id: str = "root",
                 endpoint: str = "https://www.googleapis.com/drive/v3",
                 upload_endpoint: str =
                 "https://www.googleapis.com/upload/drive/v3",
                 token_endpoint: str =
                 "https://oauth2.googleapis.com/token",
                 session=None):
        self.client_id = client_id
        self.client_secret = client_secret
        self.refresh_token = refresh_token
        self.folder_id = folder_id
        self.endpoint = endpoint.rstrip("/")
        self.upload_endpoint = upload_endpoint.rstrip("/")
        self.token_endpoint = token_endpoint
        self.session = session or UrllibSession(timeout=60.0)
        self._access_token: str | None = None
        self._token_expiry = 0.0

    def _token(self) -> str:
        if self._access_token and time.time() < self._token_expiry - 60:
            return self._access_token
        r = self.session.post(self.token_endpoint, data={
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "refresh_token": self.refresh_token,
            "grant_type": "refresh_token",
        })
        r.raise_for_status()
        tok = r.json()
        self._access_token = tok["access_token"]
        self._token_expiry = time.time() + float(
            tok.get("expires_in", 3600))
        return self._access_token

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self._token()}"}

    def _find(self, name: str) -> str | None:
        q = (f"name = '{name}' and '{self.folder_id}' in parents "
             "and trashed = false")
        r = self.session.get(f"{self.endpoint}/files",
                             params={"q": q, "fields": "files(id,name)"},
                             headers=self._headers())
        r.raise_for_status()
        files = r.json().get("files", [])
        return files[0]["id"] if files else None

    def store(self, name: str, data: bytes) -> None:
        import uuid

        meta = json.dumps({"name": name,
                           "parents": [self.folder_id]}).encode()
        boundary = uuid.uuid4().hex
        body = (b"--" + boundary.encode()
                + b"\r\nContent-Type: application/json;"
                  b" charset=UTF-8\r\n\r\n" + meta
                + b"\r\n--" + boundary.encode()
                + b"\r\nContent-Type: application/octet-stream\r\n\r\n"
                + data + b"\r\n--" + boundary.encode() + b"--")
        r = self.session.post(
            f"{self.upload_endpoint}/files",
            params={"uploadType": "multipart"},
            content=body,
            headers={**self._headers(),
                     "Content-Type":
                     f"multipart/related; boundary={boundary}"})
        r.raise_for_status()

    def list(self) -> list[str]:
        q = f"'{self.folder_id}' in parents and trashed = false"
        r = self.session.get(f"{self.endpoint}/files",
                             params={"q": q, "fields": "files(id,name)",
                                     "pageSize": "1000"},
                             headers=self._headers())
        r.raise_for_status()
        return sorted(f["name"] for f in r.json().get("files", [])
                      if f["name"].endswith((".gz", ".enc")))

    def delete(self, name: str) -> None:
        fid = self._find(name)
        if fid:
            r = self.session.delete(f"{self.endpoint}/files/{fid}",
                                    headers=self._headers())
            r.raise_for_status()

    def fetch(self, name: str) -> bytes:
        fid = self._find(name)
        if fid is None:
            raise FileNotFoundError(name)
        r = self.session.get(f"{self.endpoint}/files/{fid}",
                             params={"alt": "media"},
                             headers=self._headers())
        r.raise_for_status()
        return r.content


def build_target(settings) -> Target:
    """BackupSettings → Target (app wiring; reference: backup target
    registry keyed by config type)."""
    kind = getattr(settings, "target", "local") or "local"
    remote = dict(getattr(settings, "remote", None) or {})
    if kind == "local":
        return LocalTarget(settings.target_dir)
    if kind == "ftp":
        return FtpTarget(**remote)
    if kind == "s3":
        return S3Target(**remote)
    if kind == "sftp":
        return SftpTarget(**remote)
    if kind == "rsync":
        remote.setdefault("staging_dir", settings.target_dir)
        return RsyncTarget(**remote)
    if kind == "gdrive":
        return GDriveTarget(**remote)
    raise ValueError(f"unknown backup target {kind!r}")


def verify_archive(blob: bytes, passphrase: str = "") -> dict:
    """Restore verification (reference: backup validate/restore path):
    decrypt, untar, check every manifest SHA-256, load database.sql into
    a scratch sqlite and run PRAGMA integrity_check plus row counts.
    Returns a report dict; raises ValueError on any failure."""
    was_encrypted = blob.startswith(_ENC_MAGIC)
    if was_encrypted:
        if not passphrase:
            raise ValueError("archive is encrypted: passphrase required")
        blob = decrypt_backup(blob, passphrase)
    # report what the ARCHIVE is, not what the caller supplied — a
    # pre-encryption archive verified with a passphrase configured must
    # not claim a security property it lacks
    report: dict = {"files": {}, "encrypted": was_encrypted}
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        members = {m.name: tar.extractfile(m).read()
                   for m in tar.getmembers() if m.isfile()}
    manifest = json.loads(members.get("manifest.json", b"{}"))
    if not manifest:
        raise ValueError("archive has no manifest.json")
    for arcname, want in manifest.items():
        if arcname == "manifest.json":
            continue
        data = members.get(arcname)
        if data is None:
            raise ValueError(f"manifest entry missing from archive:"
                             f" {arcname}")
        got = hashlib.sha256(data).hexdigest()
        if got != want:
            raise ValueError(f"checksum mismatch for {arcname}")
        report["files"][arcname] = {"bytes": len(data), "sha256_ok": True}
    if "database.sql" in members:
        db = sqlite3.connect(":memory:")
        try:
            db.executescript(members["database.sql"].decode())
            integrity = db.execute("PRAGMA integrity_check").fetchone()[0]
            if integrity != "ok":
                raise ValueError(f"restored DB integrity: {integrity}")
            tables = [r[0] for r in db.execute(
                "SELECT name FROM sqlite_master WHERE type='table'")]
            counts = {t: db.execute(
                f'SELECT COUNT(*) FROM "{t}"').fetchone()[0]
                for t in tables}
            report["database"] = {"integrity": "ok", "tables": counts}
        finally:
            db.close()
    return report


def snapshot_sqlite(db_path: str) -> bytes:
    """Consistent online snapshot via the sqlite backup API (works while
    the live connection keeps writing — the WAL equivalent of the
    reference's sqlite source)."""
    src = sqlite3.connect(db_path)
    try:
        buf = sqlite3.connect(":memory:")
        src.backup(buf)
        return b"".join(line.encode() + b"\n" for line in buf.iterdump())
    finally:
        src.close()


class BackupManager:
    def __init__(self, config: BackupConfig, db_path: str,
                 target: Target | None = None):
        self.config = config
        self.db_path = db_path
        self.target = target or LocalTarget(config.target_dir)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.runs = 0
        self.failures = 0

    def run_once(self) -> str:
        """Create one archive; returns its name."""
        stamp = _dt.datetime.now().strftime("%Y%m%dT%H%M%S%f")
        name = f"birdnet-backup-{stamp}.tar.gz"
        manifest: dict[str, str] = {}
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            def add(arcname: str, data: bytes):
                manifest[arcname] = hashlib.sha256(data).hexdigest()
                info = tarfile.TarInfo(arcname)
                info.size = len(data)
                info.mtime = int(time.time())
                tar.addfile(info, io.BytesIO(data))

            if Path(self.db_path).is_file():
                add("database.sql", snapshot_sqlite(self.db_path))
            if self.config.include_config \
                    and Path(self.config.include_config).is_file():
                add("config.yaml",
                    Path(self.config.include_config).read_bytes())
            add("manifest.json", json.dumps(manifest, indent=2).encode())
        payload = buf.getvalue()
        if self.config.passphrase:
            payload = encrypt_backup(payload, self.config.passphrase)
            name += ".enc"
        self.target.store(name, payload)
        self.runs += 1
        self._apply_retention()
        log.info("backup written: %s (%d bytes)", name, buf.tell())
        return name

    def verify(self, name: str | None = None) -> dict:
        """Fetch an archive (latest by default) from the target and run
        the full restore verification. Raises on failure."""
        archives = self.target.list()
        if name is None:
            if not archives:
                raise ValueError("no archives on target")
            name = archives[-1]
        report = verify_archive(self.target.fetch(name),
                                self.config.passphrase)
        report["archive"] = name
        return report

    def _apply_retention(self) -> None:
        archives = self.target.list()
        excess = len(archives) - self.config.keep
        for name in archives[:max(excess, 0)]:
            self.target.delete(name)

    def start(self) -> None:
        if not self.config.enabled:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="backup",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_hours * 3600):
            try:
                self.run_once()
            except Exception as e:
                self.failures += 1
                from birdnet_go_tpu_torch.utils.errors import (
                    Category,
                    from_exception,
                )

                # tagged error → /system/errors ring + telemetry (the
                # builder logs once, with the traceback in exc_info)
                from_exception(e, "backup", Category.FILE_IO)
