"""Wire-level MySQL client (no external driver — the same stance as the
wire-level MQTT client).

Reference: internal/datastore/mysql.go uses GORM's MySQL driver; this
implements the protocol subset a datastore needs directly on a socket:

- handshake v10 + HandshakeResponse41 with mysql_native_password
  (SHA1(pw) XOR SHA1(scramble + SHA1(SHA1(pw)))) AND MySQL 8's default
  caching_sha2_password (SHA256 fast path; full auth via the server's
  RSA public key with OAEP when the cache is cold), including the
  AuthSwitchRequest path servers send when their default plugin differs;
- COM_QUERY text protocol (length-encoded resultsets), COM_PING, COM_QUIT;
- OK/ERR/EOF packet handling and sql_mode-safe literal escaping (quote
  doubling + hex literals — identical parse under default AND
  NO_BACKSLASH_ESCAPES modes; the text protocol has no bind parameters).

A copy of ``birdnet_go_tpu/datastore/mysql_wire.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_mysql.py`` holds it
to the original against ``diag/mysql_server.py``. ``cryptography`` (RSA
full auth) is imported inside ``sha2_rsa_encrypt`` only, where a server
asks for it, as in JAX.
"""

from __future__ import annotations

import hashlib
import logging
import socket
import struct
import threading

log = logging.getLogger("birdnet_tpu.mysql")

CLIENT_LONG_PASSWORD = 0x00000001
CLIENT_FOUND_ROWS = 0x00000002
CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_TRANSACTIONS = 0x00002000
CLIENT_SECURE_CONNECTION = 0x00008000
CLIENT_PLUGIN_AUTH = 0x00080000

UTF8MB4 = 45


class MySQLError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


def native_password_token(password: str, scramble: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(scramble + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(scramble + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def caching_sha2_token(password: str, scramble: bytes) -> bytes:
    """caching_sha2_password fast-path scramble (MySQL 8 default):
    SHA256(pw) XOR SHA256(SHA256(SHA256(pw)) + scramble)."""
    if not password:
        return b""
    h1 = hashlib.sha256(password.encode()).digest()
    h2 = hashlib.sha256(h1).digest()
    h3 = hashlib.sha256(h2 + scramble).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def sha2_rsa_encrypt(password: str, scramble: bytes, pem_key: bytes) -> bytes:
    """caching_sha2 full auth without TLS: NUL-terminated password XORed
    with the repeating scramble, RSA-OAEP(SHA-1) encrypted to the
    server's public key (MySQL's RSA_PKCS1_OAEP_PADDING)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    key = serialization.load_pem_public_key(pem_key)
    data = password.encode() + b"\x00"
    xored = bytes(b ^ scramble[i % len(scramble)]
                  for i, b in enumerate(data))
    return key.encrypt(xored, padding.OAEP(
        mgf=padding.MGF1(hashes.SHA1()), algorithm=hashes.SHA1(),
        label=None))


# Characters whose escape sequence differs between the server's default
# sql_mode (backslash escapes) and NO_BACKSLASH_ESCAPES (quote doubling
# only). A literal using ONLY doubled quotes parses identically in both
# modes; anything carrying these goes as a hex literal instead, which no
# sql_mode reinterprets. (Quoting audit: the previous backslash-style
# escape() was an injection vector against NO_BACKSLASH_ESCAPES servers.)
_HEX_FORCING = set("\\\x00\x1a") | {chr(c) for c in range(0x20)}


def escape(value) -> str:
    """Mode-safe SQL-literal encoding for the text protocol."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, bytes):
        return "x'" + value.hex() + "'"
    s = str(value)
    if any(ch in _HEX_FORCING for ch in s):
        return ("CONVERT(x'" + s.encode("utf-8").hex()
                + "' USING utf8mb4)")
    return "'" + s.replace("'", "''") + "'"


def _lenenc_int(data: bytes, pos: int) -> tuple[int | None, int]:
    first = data[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFB:                       # NULL
        return None, pos + 1
    if first == 0xFC:
        return struct.unpack("<H", data[pos + 1:pos + 3])[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack("<Q", data[pos + 1:pos + 9])[0], pos + 9


def _lenenc_str(data: bytes, pos: int) -> tuple[bytes | None, int]:
    n, pos = _lenenc_int(data, pos)
    if n is None:
        return None, pos
    return data[pos:pos + n], pos + n


class MySQLConnection:
    """One authenticated connection (thread-safe query serialization)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "", connect_timeout: float = 10.0):
        self.host, self.port = host, port
        self.user, self.password, self.database = user, password, database
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(30.0)
        self._seq = 0
        self._lock = threading.Lock()
        self.server_version = ""
        self._handshake()

    # -- packet framing -----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("MySQL server closed the connection")
            buf += chunk
        return buf

    def _read_packet(self) -> bytes:
        hdr = self._read_exact(4)
        length = int.from_bytes(hdr[:3], "little")
        self._seq = (hdr[3] + 1) & 0xFF
        return self._read_exact(length)

    def _send_packet(self, payload: bytes) -> None:
        self._sock.sendall(len(payload).to_bytes(3, "little")
                           + bytes([self._seq]) + payload)
        self._seq = (self._seq + 1) & 0xFF

    # -- handshake ---------------------------------------------------------------

    def _handshake(self) -> None:
        greeting = self._read_packet()
        if greeting[0] == 0xFF:
            raise self._err(greeting)
        if greeting[0] != 10:
            raise MySQLError(0, f"unsupported protocol {greeting[0]}")
        pos = 1
        end = greeting.index(b"\x00", pos)
        self.server_version = greeting[pos:end].decode()
        pos = end + 1 + 4                      # thread id
        scramble = greeting[pos:pos + 8]
        pos += 8 + 1                           # filler
        cap = struct.unpack("<H", greeting[pos:pos + 2])[0]
        pos += 2
        plugin = "mysql_native_password"
        if len(greeting) > pos:
            pos += 1 + 2                       # charset, status
            cap |= struct.unpack("<H", greeting[pos:pos + 2])[0] << 16
            pos += 2
            auth_len = greeting[pos]
            pos += 1 + 10                      # reserved
            if cap & CLIENT_SECURE_CONNECTION:
                extra = max(13, auth_len - 8)
                scramble += greeting[pos:pos + extra].rstrip(b"\x00")
                pos += extra
            if cap & CLIENT_PLUGIN_AUTH and pos < len(greeting):
                endp = greeting.find(b"\x00", pos)
                plugin = greeting[pos:endp if endp >= 0 else None].decode()

        # CLIENT_FOUND_ROWS: report MATCHED rows like sqlite3's rowcount,
        # so "did this UPDATE hit a row" checks agree across both engines
        caps = (CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS
                | CLIENT_PROTOCOL_41
                | CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION
                | CLIENT_PLUGIN_AUTH)
        if self.database:
            caps |= CLIENT_CONNECT_WITH_DB
        scramble = scramble[:20]
        token = self._auth_token(plugin, scramble)
        resp = struct.pack("<IIB23x", caps, 1 << 24, UTF8MB4)
        resp += self.user.encode() + b"\x00"
        resp += bytes([len(token)]) + token
        if self.database:
            resp += self.database.encode() + b"\x00"
        resp += plugin.encode() + b"\x00"
        self._send_packet(resp)
        self._auth_loop(plugin, scramble)
        log.info("connected to MySQL %s at %s:%d", self.server_version,
                 self.host, self.port)

    def _auth_token(self, plugin: str, scramble: bytes) -> bytes:
        if plugin == "mysql_native_password":
            return native_password_token(self.password, scramble)
        if plugin == "caching_sha2_password":
            return caching_sha2_token(self.password, scramble)
        raise MySQLError(0, f"unsupported auth plugin {plugin}")

    def _auth_loop(self, plugin: str, scramble: bytes) -> None:
        """Drive the post-HandshakeResponse auth exchange: AuthSwitch
        (0xFE), caching_sha2's AuthMoreData (0x01: 0x03 fast-auth ok /
        0x04 full auth → request the server RSA key and send the OAEP
        blob), then OK/ERR."""
        for _ in range(8):                     # bounded: no infinite loop
            pkt = self._read_packet()
            if pkt[0] == 0x00:
                return
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            if pkt[0] == 0xFE:                 # AuthSwitchRequest
                endp = pkt.index(b"\x00", 1)
                plugin = pkt[1:endp].decode()
                scramble = pkt[endp + 1:].rstrip(b"\x00")[:20]
                self._send_packet(self._auth_token(plugin, scramble))
                continue
            if pkt[0] == 0x01 and plugin == "caching_sha2_password":
                code = pkt[1] if len(pkt) > 1 else 0
                if code == 0x03:               # fast auth OK; OK follows
                    continue
                if code == 0x04:               # full auth
                    self._send_packet(b"\x02")  # request server public key
                    more = self._read_packet()
                    if more[0] != 0x01:
                        raise MySQLError(0, "expected server public key")
                    self._send_packet(sha2_rsa_encrypt(
                        self.password, scramble, more[1:]))
                    continue
            raise MySQLError(0, "unexpected auth response")
        raise MySQLError(0, "auth exchange did not converge")

    @staticmethod
    def _err(pkt: bytes) -> MySQLError:
        code = struct.unpack("<H", pkt[1:3])[0]
        msg = pkt[3:]
        if msg[:1] == b"#":                    # SQL state marker
            msg = msg[6:]
        return MySQLError(code, msg.decode(errors="replace"))

    # -- commands ----------------------------------------------------------------

    def ping(self) -> bool:
        with self._lock:
            self._seq = 0
            self._send_packet(b"\x0e")
            return self._read_packet()[0] == 0x00

    def close(self) -> None:
        try:
            with self._lock:
                self._seq = 0
                self._send_packet(b"\x01")
        except OSError:
            pass
        finally:
            self._sock.close()

    def execute(self, sql: str, args: tuple = ()) -> tuple[int, int]:
        """Run a statement; returns (affected_rows, last_insert_id)."""
        _, _, ok = self._query(sql, args)
        return ok

    def query(self, sql: str, args: tuple = ()
              ) -> tuple[list[str], list[tuple]]:
        cols, rows, _ = self._query(sql, args)
        return cols, rows

    def _interpolate(self, sql: str, args: tuple) -> str:
        if not args:
            return sql
        parts = sql.split("?")
        if len(parts) - 1 != len(args):
            raise ValueError("placeholder count mismatch")
        out = parts[0]
        for a, p in zip(args, parts[1:]):
            out += escape(a) + p
        return out

    def _query(self, sql: str, args: tuple
               ) -> tuple[list[str], list[tuple], tuple[int, int]]:
        text = self._interpolate(sql, args)
        with self._lock:
            self._seq = 0
            self._send_packet(b"\x03" + text.encode())
            pkt = self._read_packet()
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            if pkt[0] == 0x00:                 # OK: no resultset
                affected, pos = _lenenc_int(pkt, 1)
                last_id, _ = _lenenc_int(pkt, pos)
                return [], [], (affected or 0, last_id or 0)
            ncols, _ = _lenenc_int(pkt, 0)
            cols = []
            ctypes_ = []
            for _ in range(ncols):
                col = self._read_packet()
                name, ctype = self._column_def(col)
                cols.append(name)
                ctypes_.append(ctype)
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:   # EOF before rows
                pkt = self._read_packet()
            rows = []
            while True:
                if pkt[0] == 0xFE and len(pkt) < 9:   # EOF / OK terminator
                    break
                if pkt[0] == 0xFF:
                    raise self._err(pkt)
                pos = 0
                row = []
                for i in range(ncols):
                    v, pos = _lenenc_str(pkt, pos)
                    row.append(_typed_value(v, ctypes_[i]))
                rows.append(tuple(row))
                pkt = self._read_packet()
            return cols, rows, (0, 0)

    @staticmethod
    def _column_def(pkt: bytes) -> tuple[str, int]:
        """ColumnDefinition41: catalog, schema, table, org_table, name,
        org_name, then a fixed block [lenenc 0x0c, charset u16, length u32,
        TYPE u8, flags u16, decimals u8] — the type byte drives value
        coercion (the text protocol ships every value as a string)."""
        pos = 0
        for _ in range(4):                     # skip to the `name` field
            _, pos = _lenenc_str(pkt, pos)
        name, pos = _lenenc_str(pkt, pos)
        _, pos = _lenenc_str(pkt, pos)         # org_name
        ctype = 0xFD                           # default: VAR_STRING
        try:
            _, pos = _lenenc_int(pkt, pos)     # fixed-block length (0x0c)
            pos += 2 + 4                       # charset + column_length
            ctype = pkt[pos]
        except (IndexError, ValueError):
            pass
        return (name or b"").decode(), ctype


# MySQL text-protocol column types → Python types. Integer family:
# TINY/SHORT/LONG/LONGLONG/INT24/YEAR; float family: DECIMAL/FLOAT/
# DOUBLE/NEWDECIMAL. Everything else stays str — coercing by column TYPE
# (not by value pattern) keeps type parity with the sqlite engine, where
# a TEXT column holding '42' stays a string.
_INT_TYPES = frozenset({0x01, 0x02, 0x03, 0x08, 0x09, 0x0D})
_FLOAT_TYPES = frozenset({0x00, 0x04, 0x05, 0xF6})


def _typed_value(v: bytes | None, ctype: int):
    if v is None:
        return None
    s = v.decode(errors="replace")
    try:
        if ctype in _INT_TYPES:
            return int(s)
        if ctype in _FLOAT_TYPES:
            return float(s)
    except ValueError:
        pass
    return s
