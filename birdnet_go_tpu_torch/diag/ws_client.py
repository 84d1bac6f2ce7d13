"""A small WebSocket client (RFC 6455) on the standard library: a socket,
``ssl`` for ``wss://``, masked frames out, the server's frames in. Not a
feature of the port: ``chip_smoke.py`` phase 20 drives the API's
terminal (``GET /api/v2/system/ws``) with it over HTTPS, and the port's
tests send crafted frames with ``client_frame``.

    c = WsClient("wss://localhost:8443/api/v2/system/ws",
                 headers={"Cookie": "...", "Origin": "https://localhost:8443"},
                 ssl_context=ctx)
    c.send_text("echo hi\\n")
    opcode, data = c.recv_message(timeout=5)
    c.close()

A handshake that is not answered 101 leaves ``status``, ``headers`` and
``body`` for the caller to read, and the socket closed.
"""

from __future__ import annotations

import base64
import os
import socket
import struct
import time
import urllib.parse

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def client_frame(opcode: int, payload: bytes, *, fin: bool = True,
                 mask: bool = True, mask_key: bytes | None = None) -> bytes:
    """One frame as a client sends it: masked with `mask_key` (random
    unless given) unless `mask` is false."""
    n = len(payload)
    first = (0x80 if fin else 0) | opcode
    bit = 0x80 if mask else 0
    if n < 126:
        head = struct.pack("!BB", first, bit | n)
    elif n < 65536:
        head = struct.pack("!BBH", first, bit | 126, n)
    else:
        head = struct.pack("!BBQ", first, bit | 127, n)
    if not mask:
        return head + payload
    key = mask_key if mask_key is not None else os.urandom(4)
    if not n:
        return head + key
    stream = (key * (n // 4 + 1))[:n]
    body = (int.from_bytes(payload, "little")
            ^ int.from_bytes(stream, "little")).to_bytes(n, "little")
    return head + key + body


class WsClient:
    """One WebSocket connection (see the module's docstring)."""

    def __init__(self, url: str, *, headers: dict | None = None,
                 ssl_context=None, timeout: float = 10.0):
        u = urllib.parse.urlsplit(url)
        secure = u.scheme in ("wss", "https")
        port = u.port or (443 if secure else 80)
        self.host = u.hostname
        sock = socket.create_connection((u.hostname, port), timeout=timeout)
        if secure:
            sock = ssl_context.wrap_socket(sock, server_hostname=u.hostname)
        self.sock = sock
        self._buf = b""
        self.key = base64.b64encode(os.urandom(16)).decode()
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        h = {"Host": u.netloc, "Upgrade": "websocket",
             "Connection": "Upgrade", "Sec-WebSocket-Key": self.key,
             "Sec-WebSocket-Version": "13", **(headers or {})}
        head = f"GET {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in h.items() if v is not None) + "\r\n"
        sock.sendall(head.encode("latin-1"))
        raw = self._read_until(b"\r\n\r\n", timeout)
        lines = raw.decode("latin-1").split("\r\n")
        self.status = int(lines[0].split()[1])
        self.headers = {}
        for ln in lines[1:]:
            if ln:
                k, _, v = ln.partition(":")
                self.headers[k.strip().lower()] = v.strip()
        self.body = b""
        if self.status != 101:
            n = int(self.headers.get("content-length", "0"))
            self.body = self._read_exactly(n, timeout)
            self.sock.close()

    # the wire ----------------------------------------------------------------------

    def _fill(self, deadline: float) -> None:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("no data from the server")
        self.sock.settimeout(left)
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("the server closed the connection")
        self._buf += chunk

    def _read_until(self, sep: bytes, timeout: float) -> bytes:
        deadline = time.monotonic() + timeout
        while sep not in self._buf:
            self._fill(deadline)
        out, _, self._buf = self._buf.partition(sep)
        return out

    def _read_exactly(self, n: int, timeout: float) -> bytes:
        deadline = time.monotonic() + timeout
        while len(self._buf) < n:
            self._fill(deadline)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def send_raw(self, data: bytes) -> None:
        self.sock.sendall(data)

    def send_frame(self, opcode: int, payload: bytes, fin: bool = True
                   ) -> None:
        self.send_raw(client_frame(opcode, payload, fin=fin))

    def send_text(self, text: str) -> None:
        self.send_frame(OP_TEXT, text.encode())

    def send_binary(self, data: bytes) -> None:
        self.send_frame(OP_BINARY, data)

    def recv_frame(self, timeout: float = 10.0) -> tuple[bool, int, bytes]:
        """(fin, opcode, payload) of the server's next frame."""
        b0, b1 = self._read_exactly(2, timeout)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack("!H", self._read_exactly(2, timeout))[0]
        elif n == 127:
            n = struct.unpack("!Q", self._read_exactly(8, timeout))[0]
        if b1 & 0x80:
            raise ConnectionError("the server sent a masked frame")
        return bool(b0 & 0x80), b0 & 0x0F, self._read_exactly(n, timeout)

    def recv_message(self, timeout: float = 10.0) -> tuple[int, bytes]:
        """(opcode, payload) of the next data or close message, pings
        answered, fragments joined."""
        deadline = time.monotonic() + timeout
        parts, first = [], None
        while True:
            fin, op, data = self.recv_frame(max(0.0, deadline
                                                - time.monotonic()))
            if op == OP_PING:
                self.send_frame(OP_PONG, data)
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                return op, data
            first = op if first is None else first
            parts.append(data)
            if fin:
                return first, b"".join(parts)

    def read_until(self, marker: bytes, timeout: float = 10.0) -> bytes:
        """Data messages joined until `marker` appears in them."""
        deadline = time.monotonic() + timeout
        got = b""
        while marker not in got:
            op, data = self.recv_message(max(0.0, deadline
                                             - time.monotonic()))
            if op == OP_CLOSE:
                raise ConnectionError(f"closed before {marker!r}: {got!r}")
            got += data
        return got

    def close(self, code: int = 1000, timeout: float = 5.0) -> int | None:
        """The close handshake: our close frame, then the server's; its
        code (None where it sent none)."""
        got = None
        try:
            self.send_frame(OP_CLOSE, struct.pack("!H", code))
            deadline = time.monotonic() + timeout
            while True:
                _, op, data = self.recv_frame(max(0.0, deadline
                                                  - time.monotonic()))
                if op == OP_CLOSE:
                    got = struct.unpack("!H", data[:2])[0] \
                        if len(data) >= 2 else None
                    break
        except (ConnectionError, TimeoutError, OSError):
            pass
        finally:
            self.sock.close()
        return got

    def read_to_eof(self, timeout: float = 10.0) -> bytes:
        """Every byte the server sends until it closes the connection."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                self._fill(deadline)
        except ConnectionError:
            pass
        out, self._buf = self._buf, b""
        self.sock.close()
        return out
