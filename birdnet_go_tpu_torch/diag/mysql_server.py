"""A MySQL server for tests: speaks the wire protocol the port's client
speaks (handshake v10, ``mysql_native_password``, ``caching_sha2_password``
with its fast auth and its full auth by RSA, an AuthSwitchRequest, the
text protocol's COM_QUERY, COM_PING and COM_QUIT) and runs each statement
on SQLite, so the answers are real. Not a feature of the port: it is
what ``chip_smoke.py`` phase 20 and the port's tests serve MySQL with.

    server = MySQLServer("build/x/mysql.db", plugin="caching_sha2_password",
                         sha2_full_auth=True)
    server.start()          # a thread; server.port is the port it bound
    ...
    server.stop()

A copy of ``tests/test_mysql.py::FakeMySQLServer`` (the JAX package's test
server), which ``tests/test_torch_mysql.py`` holds it to. Where it
differs:

- the database is a file (`path`; ``:memory:`` as before), so a caller
  can count rows after the server has gone; each statement is committed
  when it has run, as autocommit does;
- each connection is served on a thread of its own (the original serves
  one after another), one SQLite connection under a lock for all;
- ``sha2_full_auth`` asks for full auth on a user's first connection
  only, as MySQL 8's cold cache does, and takes the fast path after it
  (``full_auth_first_only=False``: on every connection, as the
  original); its RSA key pair (one a process) and the OAEP decryption are
  written out on Python's integers (``RsaKey``), where the original
  takes them from ``cryptography``;
- it reads back what the port's ``translate_sql`` writes beyond JAX's
  (``LEAST``/``GREATEST`` are SQLite's scalar ``MIN``/``MAX``), lists no
  table of SQLite's own (``sqlite_sequence``) and answers ``SHOW TABLE
  STATUS`` with MySQL's first columns (name,
  engine, version, row format, rows, average row length, data length,
  maximum data length, index length), which
  ``MySQLDatastore.database_details`` reads;
- it records when each detection row was committed (``committed``: id
  and wall clock), and each statement (``queries``).
"""

from __future__ import annotations

import base64
import hashlib
import math
import re
import secrets
import socket
import sqlite3
import struct
import threading
import time

from birdnet_go_tpu_torch.datastore.mysql_wire import (
    caching_sha2_token,
    native_password_token,
)

SCRAMBLE = bytes(range(1, 21))                 # fixed 20-byte nonce


# -- RSA for full auth, on Python's integers ---------------------------------------
#
# The server's key pair and its OAEP decryption, written out here rather
# than taken from ``cryptography`` (which the port imports only where the
# client encrypts): the client's blob is checked by an implementation of
# its own.

def _probably_prime(n: int, rounds: int = 32) -> bool:
    if n < 4:
        return n in (2, 3)
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for _ in range(rounds):
        x = pow(secrets.randbelow(n - 3) + 2, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits: int) -> int:
    while True:
        n = secrets.randbits(bits) | (3 << (bits - 2)) | 1
        if _probably_prime(n):
            return n


def _der(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        return bytes([tag, n]) + body
    size = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(size)]) + size + body


def _der_int(v: int) -> bytes:
    return _der(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big"))


def _mgf1_sha1(seed: bytes, n: int) -> bytes:
    out = b"".join(hashlib.sha1(seed + i.to_bytes(4, "big")).digest()
                   for i in range((n + 19) // 20))
    return out[:n]


class RsaKey:
    """An RSA key pair (e = 65537): its public key as PEM
    SubjectPublicKeyInfo, and RSAES-OAEP decryption with SHA-1 and MGF1
    (PKCS #1 v2.2 §7.1.2, the padding MySQL's full auth uses)."""

    E = 65537

    def __init__(self, n: int, d: int):
        self.n, self.d = n, d
        self.k = (n.bit_length() + 7) // 8

    @classmethod
    def generate(cls, bits: int = 2048) -> "RsaKey":
        while True:
            p, q = _prime(bits // 2), _prime(bits // 2)
            phi = (p - 1) * (q - 1)
            if p != q and math.gcd(cls.E, phi) == 1:
                return cls(p * q, pow(cls.E, -1, phi))

    def pem(self) -> bytes:
        rsa_oid = _der(0x30, _der(0x06, bytes.fromhex("2a864886f70d010101"))
                       + _der(0x05, b""))
        key = _der(0x30, _der_int(self.n) + _der_int(self.E))
        spki = _der(0x30, rsa_oid + _der(0x03, b"\x00" + key))
        b64 = base64.encodebytes(spki).replace(b"\n", b"")
        lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
        return (b"-----BEGIN PUBLIC KEY-----\n" + b"\n".join(lines)
                + b"\n-----END PUBLIC KEY-----\n")

    def decrypt_oaep_sha1(self, blob: bytes) -> bytes:
        if len(blob) != self.k:
            raise ValueError("ciphertext length")
        em = pow(int.from_bytes(blob, "big"), self.d, self.n) \
            .to_bytes(self.k, "big")
        masked_seed, masked_db = em[1:21], em[21:]
        seed = bytes(a ^ b for a, b in zip(
            masked_seed, _mgf1_sha1(masked_db, 20)))
        db = bytes(a ^ b for a, b in zip(
            masked_db, _mgf1_sha1(seed, self.k - 21)))
        if em[0] != 0 or db[:20] != hashlib.sha1(b"").digest():
            raise ValueError("decryption error")
        rest = db[20:].lstrip(b"\x00")
        if not rest.startswith(b"\x01"):
            raise ValueError("decryption error")
        return rest[1:]


_KEY: RsaKey | None = None
_KEY_LOCK = threading.Lock()


def _lenenc(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    return b"\xfd" + n.to_bytes(3, "little")


def _lenenc_str(s: bytes) -> bytes:
    return _lenenc(len(s)) + s


class MySQLServer(threading.Thread):
    """Protocol-accurate MySQL 8-ish server backed by SQLite."""

    def __init__(self, path: str = ":memory:", password: str = "sekret",
                 auth_switch: bool = False,
                 plugin: str = "mysql_native_password",
                 sha2_full_auth: bool = False,
                 full_auth_first_only: bool = True,
                 host: str = "127.0.0.1", port: int = 0):
        super().__init__(daemon=True, name="mysql-server")
        self.password = password
        self.auth_switch = auth_switch
        self.plugin = plugin
        self.sha2_full_auth = sha2_full_auth
        self.full_auth_first_only = full_auth_first_only
        self.queries: list[str] = []
        self.committed: list[tuple[int, float]] = []
        self.full_auths = 0
        self._cached: set[str] = set()         # users past full auth
        self._lock = threading.Lock()
        self.db = sqlite3.connect(path, check_same_thread=False)
        self.db.row_factory = sqlite3.Row
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._conns: list[socket.socket] = []

    @staticmethod
    def _rsa_key() -> "RsaKey":
        """The key pair, made once a process (about a second)."""
        global _KEY
        with _KEY_LOCK:
            if _KEY is None:
                _KEY = RsaKey.generate()
            return _KEY

    # -- packet io ---------------------------------------------------------------

    def _read_packet(self, conn):
        hdr = b""
        while len(hdr) < 4:
            chunk = conn.recv(4 - len(hdr))
            if not chunk:
                return None, 0
            hdr += chunk
        n = int.from_bytes(hdr[:3], "little")
        body = b""
        while len(body) < n:
            chunk = conn.recv(n - len(body))
            if not chunk:
                return None, 0
            body += chunk
        return body, hdr[3]

    def _send(self, conn, payload, seq):
        conn.sendall(len(payload).to_bytes(3, "little") + bytes([seq])
                     + payload)
        return seq + 1

    def _ok(self, conn, seq, affected=0, last_id=0):
        return self._send(conn, b"\x00" + _lenenc(affected)
                          + _lenenc(last_id) + b"\x02\x00\x00\x00", seq)

    def _err(self, conn, seq, code, msg):
        return self._send(conn, b"\xff" + struct.pack("<H", code)
                          + b"#HY000" + msg.encode(), seq)

    def _eof(self, conn, seq):
        return self._send(conn, b"\xfe\x00\x00\x02\x00", seq)

    # -- session -----------------------------------------------------------------

    def run(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="mysql-session").start()

    def _serve(self, conn):
        try:
            self._session(conn)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _session(self, conn):
        greeting = (bytes([10]) + b"8.0.fake\x00"
                    + struct.pack("<I", 7) + SCRAMBLE[:8] + b"\x00"
                    + struct.pack("<H", 0xF7FF)            # caps low
                    + bytes([45]) + struct.pack("<H", 2)
                    + struct.pack("<H", 0x000F)             # caps high
                    + bytes([21]) + b"\x00" * 10
                    + SCRAMBLE[8:] + b"\x00"
                    + self.plugin.encode() + b"\x00")
        seq = self._send(conn, greeting, 0)
        resp, seq_in = self._read_packet(conn)
        if resp is None:
            return
        caps, _, _ = struct.unpack("<IIB", resp[:9])
        self.client_caps = caps
        pos = 32
        end = resp.index(b"\x00", pos)
        user = resp[pos:end].decode()
        pos = end + 1
        tok_len = resp[pos]
        token = resp[pos + 1:pos + 1 + tok_len]
        seq = seq_in + 1
        if self.auth_switch:
            seq = self._send(conn, b"\xfe" + self.plugin.encode() + b"\x00"
                             + SCRAMBLE + b"\x00", seq)
            token, seq_in = self._read_packet(conn)
            seq = seq_in + 1
        if self.plugin == "caching_sha2_password":
            full = self.sha2_full_auth and not (
                self.full_auth_first_only and user in self._cached)
            if full:
                # cold cache: demand full auth via the server RSA key
                seq = self._send(conn, b"\x01\x04", seq)
                req, seq_in = self._read_packet(conn)
                assert req == b"\x02", "client must request the pubkey"
                key = self._rsa_key()
                seq = self._send(conn, b"\x01" + key.pem(), seq_in + 1)
                blob, seq_in = self._read_packet(conn)
                xored = key.decrypt_oaep_sha1(blob)
                got = bytes(b ^ SCRAMBLE[i % 20]
                            for i, b in enumerate(xored))
                seq = seq_in + 1
                if got != self.password.encode() + b"\x00":
                    self._err(conn, seq, 1045,
                              f"Access denied for user '{user}'")
                    return
                self.full_auths += 1
                self._cached.add(user)
            else:
                expect = caching_sha2_token(self.password, SCRAMBLE)
                if token != expect:
                    self._err(conn, seq, 1045,
                              f"Access denied for user '{user}'")
                    return
                seq = self._send(conn, b"\x01\x03", seq)  # fast auth OK
        else:
            expect = native_password_token(self.password, SCRAMBLE)
            if token != expect:
                self._err(conn, seq, 1045,
                          f"Access denied for user '{user}'")
                return
        self._ok(conn, seq)

        while True:
            pkt, _ = self._read_packet(conn)
            if pkt is None or pkt[:1] == b"\x01":           # COM_QUIT
                return
            if pkt[:1] == b"\x0e":                          # COM_PING
                self._ok(conn, 1)
                continue
            sql = pkt[1:].decode()
            self.queries.append(sql)
            try:
                self._handle_query(conn, sql)
            except Exception as e:  # noqa: BLE001
                self._err(conn, 1, 1064, str(e))

    def _handle_query(self, conn, sql):
        up = sql.upper()
        if up.startswith("SHOW COLUMNS"):
            table = sql.split()[-1].strip("`")
            with self._lock:
                cols = [r[1] for r in self.db.execute(
                    f"PRAGMA table_info({table})")]
            self._rows(conn, ["Field"], [(c,) for c in cols])
            return
        if up.startswith("SHOW TABLE STATUS"):
            with self._lock:
                names = [r[0] for r in self.db.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"
                    " AND name NOT LIKE 'sqlite_%'")]
                counts = [self.db.execute(
                    f'SELECT COUNT(*) FROM "{n}"').fetchone()[0]
                    for n in names]
            self._rows(conn, ["Name", "Engine", "Version", "Row_format",
                              "Rows", "Avg_row_length", "Data_length",
                              "Max_data_length", "Index_length"],
                       [(n, "InnoDB", 10, "Dynamic", c, 0, 16384, 0, 0)
                        for n, c in zip(names, counts)])
            return
        if up.startswith("SHOW TABLES"):
            with self._lock:
                names = [r[0] for r in self.db.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"
                    " AND name NOT LIKE 'sqlite_%'")]
            self._rows(conn, ["Tables_in_fake"], [(n,) for n in names])
            return
        if up.startswith("OPTIMIZE TABLE"):
            self._rows(conn, ["Table", "Msg_text"],
                       [(sql.split()[-1], "OK")])
            return
        lite = self._to_sqlite(sql)
        with self._lock:
            cur = self.db.execute(lite)
            if up.startswith("SELECT"):
                cols = [d[0] for d in cur.description]
                rows = cur.fetchall()
            else:
                self.db.commit()
                if re.match(r"\s*INSERT INTO detections\b", sql, re.I):
                    self.committed.append((cur.lastrowid, time.time()))
        if up.startswith("SELECT"):
            self._rows(conn, cols, rows)
        else:
            self._ok(conn, 1, affected=cur.rowcount if cur.rowcount > 0
                     else 0, last_id=cur.lastrowid or 0)

    @staticmethod
    def _to_sqlite(sql: str) -> str:
        # MySQL backslash string escapes → sqlite quote doubling (kept
        # for hand-written SQL; escape() itself emits doubled quotes)
        out = sql.replace("\\\\", "\x01").replace("\\'", "''")
        out = out.replace("\x01", "\\")
        # mode-safe hex literals → sqlite string literal
        out = re.sub(
            r"CONVERT\(x'([0-9a-fA-F]*)' USING utf8mb4\)",
            lambda m: "'" + bytes.fromhex(m.group(1)).decode()
                            .replace("'", "''") + "'",
            out)
        out = out.replace("AUTO_INCREMENT", "AUTOINCREMENT")
        out = out.replace("AS SIGNED)", "AS INTEGER)")
        out = out.replace("VARCHAR(191) PRIMARY KEY", "TEXT PRIMARY KEY")
        # SQLite's scalar min/max take two arguments
        out = re.sub(r"\bLEAST\(", "MIN(", out)
        out = re.sub(r"\bGREATEST\(", "MAX(", out)
        m = re.search(r"ON DUPLICATE KEY UPDATE", out, re.IGNORECASE)
        if m:
            body = out[m.end():]
            body = re.sub(r"VALUES\((\w+)\)", r"excluded.\1", body)
            # conflict target = the table's PK (MySQL infers it; sqlite
            # needs it spelled out)
            tm = re.search(r"INSERT INTO (\w+)", out, re.IGNORECASE)
            pk = {"daily_events": "date"}.get(
                tm.group(1) if tm else "", "scientific_name")
            out = (out[:m.start()]
                   + f"ON CONFLICT({pk}) DO UPDATE SET" + body)
        return out

    def _rows(self, conn, cols, rows):
        # per-column MySQL type inferred from the sqlite value types so
        # the wire client's type-keyed coercion reproduces sqlite typing
        # (LONGLONG=8, DOUBLE=5, VAR_STRING=253)
        ctypes_ = []
        for i, _ in enumerate(cols):
            t = 253
            for r in rows:
                v = r[i]
                if v is None:
                    continue
                if isinstance(v, bool) or isinstance(v, int):
                    t = 8
                elif isinstance(v, float):
                    t = 5
                break
            ctypes_.append(t)
        seq = self._send(conn, _lenenc(len(cols)), 1)
        for c, t in zip(cols, ctypes_):
            coldef = (_lenenc_str(b"def") + _lenenc_str(b"") +
                      _lenenc_str(b"t") + _lenenc_str(b"t") +
                      _lenenc_str(c.encode()) + _lenenc_str(c.encode()) +
                      b"\x0c" + struct.pack("<HIBHB", 45, 255, t, 0, 0)
                      + b"\x00\x00")
            seq = self._send(conn, coldef, seq)
        seq = self._eof(conn, seq)
        for r in rows:
            payload = b""
            for v in r:
                payload += b"\xfb" if v is None \
                    else _lenenc_str(str(v).encode())
            seq = self._send(conn, payload, seq)
        self._eof(conn, seq)

    def stop(self):
        self._stop = True
        self._srv.close()
        for conn in self._conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        with self._lock:
            self.db.close()
