"""A small HTTP/1.1 server on ``asyncio``, on the standard library alone:
the part of ``aiohttp.web`` that the port's API uses, under aiohttp's
names and with its behaviour, so that the handlers of
``birdnet_go_tpu/api/`` are copied with their imports renamed (the card's
machine has no aiohttp).

What it offers, each as aiohttp 3 does it (``tests/test_torch_api.py``
holds every point against the JAX package's aiohttp server):

- ``Application(middlewares=...)`` with its ``router``: ``add_get`` (which
  also answers ``HEAD``), ``add_post``, ``add_put``, ``add_patch``,
  ``add_delete``, ``add_static``; ``{name}`` and ``{name:regex}``
  patterns, with ``match_info`` percent-decoded. A path is resolved as
  aiohttp's ``UrlDispatcher`` does: from its longest prefix to its
  shortest, and among the routes of one prefix the first registered
  wins. A path that matches with the wrong method gets 405 with
  ``Allow``; any other miss 404. Middlewares see those answers too;
- ``Request`` (``method``, ``path``, ``query``, ``match_info``,
  ``headers``, ``cookies``, ``remote``, ``host``, ``content_type``,
  ``can_read_body``, ``read()``, ``text()``, ``json()``, ``post()``); a
  body over ``client_max_size`` (1 MiB) raises 413 where a handler reads
  it, and is drained for up to 10 s before the connection closes
  (aiohttp's lingering close);
- ``Response``, ``json_response``, ``StreamResponse`` (chunked:
  ``prepare``, ``write``, ``drain``, ``write_eof``; a write to a closed
  connection raises ``ConnectionResetError``, which ends the SSE pumps),
  ``FileResponse`` (the type from ``mimetypes``, ``Last-Modified`` and
  ``ETag``, one ``Range`` for 206 or 416, ``If-Modified-Since`` and
  ``If-None-Match`` for 304, ``If-Match`` and ``If-Unmodified-Since`` for
  412, a missing file an empty 404);
- ``HTTPException`` and the subclasses the handlers raise or answer
  (a response and an exception at once, as in aiohttp), and the
  ``middleware`` decorator;
- an unhandled exception answers 500 and is logged; the connection
  serves on. Keep-alive, with an idle timeout;
- ``WebSocketResponse``, ``WSMsgType``, ``WSMessage`` and
  ``WSCloseCode`` (RFC 6455, as aiohttp's server speaks it): the
  handshake in ``prepare`` (``Upgrade: websocket``, ``Connection:
  upgrade``, ``Sec-WebSocket-Version`` 13, 8 or 7 and a 16-byte key,
  answered 101 with ``Sec-WebSocket-Accept``; a request without one of
  them gets aiohttp's 400 and its text); frames with 7, 16 and 64-bit
  lengths, continuations reassembled, a ping answered with a pong,
  control frames of at most 125 bytes, text that must be UTF-8 (else
  1007), messages under ``max_msg_size`` (4 MiB, else 1009), the close
  handshake with its code; ``send_str``, ``send_bytes``, ``close``,
  ``closed``, ``receive`` and ``async for msg in ws``. Once ``prepare``
  returns, the connection belongs to the socket: no further request is
  parsed on it. Where it differs from aiohttp: a client frame that is
  not masked closes the socket with 1002, as RFC 6455 §5.1 requires
  (aiohttp reads it); no extension is negotiated (aiohttp offers
  permessage-deflate to a client that asks), no heartbeat;
- ``AppRunner`` and ``TCPSite``: ``cleanup()`` stops listening, sends
  every open WebSocket a close frame with 1001 (going away), lets the
  handlers send what they hold for a tenth of a second, then ends every
  open connection, streams and sockets included, so that it returns
  while an SSE or WebSocket client is still connected (aiohttp waits for
  such handlers up to its shutdown timeout). ``TCPSite.port`` is the
  port bound, which port 0 leaves to the OS; with an ``ssl_context`` it
  serves HTTPS.

Not offered: chunked request bodies (400), multipart bodies (``post()``
reads url-encoded forms and answers an empty form otherwise), and more
than one request at a time per connection.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import datetime
import email.utils
import enum
import functools
import hashlib
import http
import http.cookies
import json
import logging
import mimetypes
import os
import re
import struct
import sys
import urllib.parse
from collections import deque
from collections.abc import MutableMapping
from pathlib import Path
from typing import Any, NamedTuple

log = logging.getLogger("birdnet_tpu.api.web")

CLIENT_MAX_SIZE = 1024 ** 2          # aiohttp's default client_max_size
LINGER_S = 10.0                      # aiohttp's default lingering_time
KEEPALIVE_TIMEOUT = 75.0             # aiohttp's default keepalive_timeout
SHUTDOWN_GRACE = 0.1                 # cleanup() lets handlers run this
SHUTDOWN_TIMEOUT = 5.0               # ... then cancels and waits this
_SERVER = f"Python/{sys.version_info[0]}.{sys.version_info[1]} " \
          f"birdnet_go_tpu_torch"


# -- headers, query ---------------------------------------------------------------

class Headers(MutableMapping):
    """Case-insensitive header mapping that keeps each name's spelling."""

    def __init__(self, data=None):
        self._d: dict[str, tuple[str, str]] = {}
        if data:
            self.update(data)

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value) -> None:
        self._d[key.lower()] = (key, str(value))

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.lower() in self._d

    def __iter__(self):
        return (name for name, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)

    def __repr__(self) -> str:
        return f"Headers({dict(self.items())!r})"


class Query(dict):
    """A query string's fields, the first value of each (as aiohttp's
    ``MultiDictProxy.get`` and ``[]`` read them)."""

    def __init__(self, qs: str = ""):
        super().__init__()
        for k, v in urllib.parse.parse_qsl(qs, keep_blank_values=True):
            self.setdefault(k, v)


# -- responses ----------------------------------------------------------------------

def _reason(status: int) -> str:
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return ""


class StreamResponse:
    """A response whose body the handler writes after ``prepare``: with
    a ``Content-Length`` header as is, otherwise chunked (HTTP/1.1) or
    up to the connection's close (HTTP/1.0)."""

    def __init__(self, *, status: int = 200, reason: str | None = None,
                 headers=None):
        self._status = int(status)
        self._reason = reason or _reason(self._status)
        self._headers = Headers(headers)
        self._cookies = http.cookies.SimpleCookie()
        self._req: Request | None = None
        self._chunked = False
        self._eof = False
        self._closes = False

    # status, headers, cookies -----------------------------------------------------

    @property
    def status(self) -> int:
        return self._status

    @property
    def reason(self) -> str:
        return self._reason

    def set_status(self, status: int, reason: str | None = None) -> None:
        self._status = int(status)
        self._reason = reason or _reason(self._status)

    @property
    def headers(self) -> Headers:
        return self._headers

    @property
    def content_type(self) -> str:
        raw = self._headers.get("Content-Type", "application/octet-stream")
        return raw.split(";", 1)[0].strip().lower()

    @content_type.setter
    def content_type(self, value: str) -> None:
        self._headers["Content-Type"] = value

    @property
    def prepared(self) -> bool:
        return self._req is not None

    def set_cookie(self, name: str, value: str, *, expires=None,
                   domain=None, max_age=None, path: str = "/",
                   secure=None, httponly=None, samesite=None) -> None:
        self._cookies[name] = value
        m = self._cookies[name]
        m["path"] = path
        for key, v in (("expires", expires), ("domain", domain),
                       ("max-age", max_age), ("secure", secure),
                       ("httponly", httponly), ("samesite", samesite)):
            if v is not None and v is not False:
                m[key] = str(v) if key not in ("secure", "httponly") else v

    def del_cookie(self, name: str, *, path: str = "/",
                   domain=None) -> None:
        self._cookies.pop(name, None)
        self.set_cookie(name, "", max_age=0, path=path, domain=domain,
                        expires="Thu, 01 Jan 1970 00:00:00 GMT")

    # the wire -----------------------------------------------------------------------

    def _head(self, request: Request) -> bytes:
        h = self._headers
        if self._status not in (204, 304):
            h.setdefault("Content-Type", "application/octet-stream")
        h.setdefault("Date", email.utils.formatdate(usegmt=True))
        h.setdefault("Server", _SERVER)
        if "Content-Length" not in h and self._status not in (204, 304):
            if request.version >= (1, 1):
                self._chunked = True
                h["Transfer-Encoding"] = "chunked"
            else:
                self._closes = True
        if not request.keep_alive or self._closes:
            h["Connection"] = "close"
        lines = [f"HTTP/1.1 {self._status} {self._reason}"]
        lines += [f"{k}: {v}" for k, v in h.items()]
        lines += [f"Set-Cookie: {m.OutputString()}"
                  for m in self._cookies.values()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    def _check_open(self, client_gone: bool = False) -> None:
        """Raise ``ConnectionResetError`` where the connection is closing
        or, with `client_gone`, where the client has ended its side (an
        SSE client that went away: asyncio's transport would take the
        write and drop it)."""
        req = self._req
        if req is None:
            raise RuntimeError("write() before prepare()")
        tr = req._writer.transport
        if tr is None or tr.is_closing() \
                or client_gone and req._reader.at_eof():
            raise ConnectionResetError("Cannot write to closing transport")

    async def prepare(self, request: Request) -> None:
        if self._req is not None:
            return
        self._req = request
        self._check_open()
        request._writer.write(self._head(request))
        await request._writer.drain()

    async def write(self, data: bytes) -> None:
        """A handler's write into its stream."""
        self._check_open(client_gone=True)
        await self._send(data)

    async def _send(self, data: bytes) -> None:
        self._check_open()
        if self._eof:
            raise RuntimeError("write() after write_eof()")
        if not data or self._req.method == "HEAD":
            return
        w = self._req._writer
        if self._chunked:
            w.write(b"%x\r\n" % len(data) + bytes(data) + b"\r\n")
        else:
            w.write(bytes(data))
        await w.drain()

    async def drain(self) -> None:
        self._check_open()
        await self._req._writer.drain()

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof:
            return
        if data:
            await self._send(data)
        self._eof = True
        if self._chunked and self._req.method != "HEAD":
            self._check_open()
            self._req._writer.write(b"0\r\n\r\n")
            await self._req._writer.drain()


class Response(StreamResponse):
    """A response with its whole body: `text` (a ``charset``, utf-8 by
    default, goes into the content type, ``text/plain`` by default) or
    `body` bytes."""

    def __init__(self, *, body: bytes | None = None, status: int = 200,
                 reason: str | None = None, text: str | None = None,
                 headers=None, content_type: str | None = None,
                 charset: str | None = None):
        super().__init__(status=status, reason=reason, headers=headers)
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        has_ct = "Content-Type" in self._headers
        if has_ct and (content_type or charset):
            raise ValueError("passing both Content-Type header and "
                             "content_type or charset params is forbidden")
        if text is not None:
            if not isinstance(text, str):
                raise TypeError(f"text argument must be str "
                                f"({type(text)!r})")
            charset = charset or "utf-8"
            if not has_ct:
                self._headers["Content-Type"] = \
                    f"{content_type or 'text/plain'}; charset={charset}"
            body = text.encode(charset)
        elif content_type:
            self._headers["Content-Type"] = content_type + (
                f"; charset={charset}" if charset else "")
        self._body = body

    @property
    def body(self) -> bytes | None:
        return self._body

    @body.setter
    def body(self, value: bytes | None) -> None:
        self._body = value

    async def prepare(self, request: Request) -> None:
        if self._req is not None:
            return
        if self._status in (204, 304):
            self._headers.pop("Content-Length", None)
        else:
            self._headers["Content-Length"] = str(len(self._body or b""))
        await super().prepare(request)

    async def write_eof(self, data: bytes = b"") -> None:
        if not self._eof and self._body and self._status not in (204, 304):
            await self._send(self._body)
        await super().write_eof(data)


def json_response(data: Any = None, *, status: int = 200,
                  reason: str | None = None, headers=None,
                  content_type: str = "application/json",
                  dumps=json.dumps) -> Response:
    return Response(text=dumps(data), status=status, reason=reason,
                    headers=headers, content_type=content_type)


# -- HTTP exceptions ----------------------------------------------------------------

class HTTPException(Response, Exception):
    """A response to raise: its text is ``"<status>: <reason>"`` unless
    given."""

    status_code = -1

    def __init__(self, *, headers=None, reason: str | None = None,
                 body: bytes | None = None, text: str | None = None,
                 content_type: str | None = None):
        if body is None and text is None \
                and self.status_code not in (204, 304):
            text = f"{self.status_code}: {reason or _reason(self.status_code)}"
        Response.__init__(self, status=self.status_code, headers=headers,
                          reason=reason, body=body, text=text,
                          content_type=content_type)
        Exception.__init__(self, self.reason)

    def __str__(self) -> str:
        return self.reason

    def __repr__(self) -> str:
        return f"<{type(self).__name__}: {self.reason}>"

    __hash__ = object.__hash__


class HTTPFound(HTTPException):
    status_code = 302

    def __init__(self, location: str, **kw):
        super().__init__(**kw)
        self._headers["Location"] = str(location)
        self.location = location


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPForbidden(HTTPException):
    status_code = 403


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, method: str, allowed_methods, **kw):
        super().__init__(**kw)
        self._headers["Allow"] = ",".join(sorted(allowed_methods))
        self.method = method.upper()
        self.allowed_methods = set(allowed_methods)


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int, **kw):
        kw.setdefault("text", f"Maximum request body size {max_size} "
                              f"exceeded, actual body size {actual_size}")
        super().__init__(**kw)


def middleware(f):
    """Marks a new-style middleware, ``async def f(request, handler)``."""
    f.__middleware_version__ = 1
    return f


# -- files ----------------------------------------------------------------------------

_RANGE = re.compile(r"^bytes=(\d*)-(\d*)$")


def _http_range(value: str | None) -> slice:
    """aiohttp's ``BaseRequest.http_range``: one ``bytes=a-b`` range as a
    slice (end exclusive; ``-n`` as start -n); ValueError otherwise."""
    start = end = None
    if value is not None:
        m = _RANGE.match(value)
        if m is None:
            raise ValueError("range not in acceptable format")
        start = int(m.group(1)) if m.group(1) else None
        end = int(m.group(2)) if m.group(2) else None
        if start is None and end is not None:
            start, end = -end, None
        if start is not None and end is not None:
            end += 1
            if start >= end:
                raise ValueError("start cannot be after end")
        if start is None and end is None:
            raise ValueError("No start or end of range specified")
    return slice(start, end, 1)


def _etag_in(header: str, etag: str, weak: bool) -> bool:
    """Whether an If-Match / If-None-Match value names `etag` (unquoted),
    ``*`` naming any; a weak comparison ignores ``W/``."""
    for tag in (t.strip() for t in header.split(",")):
        if tag == "*":
            return True
        if weak and tag.startswith("W/"):
            tag = tag[2:]
        if tag == f'"{etag}"':
            return True
    return False


def _http_date(value: str | None) -> float | None:
    if not value:
        return None
    try:
        dt = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError, IndexError):
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.timestamp()


# aiohttp's content types: mimetypes' without its encodings (a .gz file is
# application/gzip, not gzip-encoded), with these added
_MIME = mimetypes.MimeTypes()
_MIME.encodings_map.clear()
for _ct, _ext in (("application/gzip", ".gz"),
                  ("application/x-brotli", ".br"),
                  ("application/x-bzip2", ".bz2"),
                  ("application/x-compress", ".Z"),
                  ("application/x-xz", ".xz")):
    _MIME.add_type(_ct, _ext)


class FileResponse(StreamResponse):
    """A file from disk, as aiohttp's ``FileResponse`` sends it."""

    def __init__(self, path, chunk_size: int = 256 * 1024,
                 status: int = 200, reason: str | None = None,
                 headers=None):
        super().__init__(status=status, reason=reason, headers=headers)
        self._path = Path(path)
        self._chunk = chunk_size

    async def prepare(self, request: Request) -> None:
        if self._req is not None:
            return
        try:
            st = os.stat(self._path)
            if not self._path.is_file():
                self.set_status(403)
                return await StreamResponse.prepare(self, request)
        except PermissionError:
            self.set_status(403)
            return await StreamResponse.prepare(self, request)
        except OSError:                      # missing: 404, empty
            self.set_status(404)
            return await StreamResponse.prepare(self, request)
        size, mtime = st.st_size, st.st_mtime
        etag = f"{st.st_mtime_ns:x}-{size:x}"
        hq, h = request.headers, self._headers
        im, inm = hq.get("If-Match"), hq.get("If-None-Match")
        ius = _http_date(hq.get("If-Unmodified-Since"))
        ims = _http_date(hq.get("If-Modified-Since"))
        if (im is not None and not _etag_in(im, etag, weak=False)
                or im is None and ius is not None and mtime > ius):
            self.set_status(412)
            h["Content-Length"] = "0"
            return await StreamResponse.prepare(self, request)
        if (inm is not None and _etag_in(inm, etag, weak=True)
                or inm is None and ims is not None and mtime <= ims):
            self.set_status(304)
            h["ETag"] = f'"{etag}"'
            h["Last-Modified"] = email.utils.formatdate(mtime, usegmt=True)
            h.pop("Content-Length", None)
            return await StreamResponse.prepare(self, request)
        start, count = None, size
        if_range = _http_date(hq.get("If-Range"))
        if hq.get("If-Range") is None or (if_range is not None
                                          and mtime <= if_range):
            try:
                rng = _http_range(hq.get("Range"))
            except ValueError:
                return await self._unsatisfiable(request, size)
            start, end = rng.start, rng.stop
            if start is not None:
                if start < 0 and end is None:
                    start = max(0, start + size)
                    count = size - start
                else:
                    count = min(end if end is not None else size,
                                size) - start
                if start >= size:
                    return await self._unsatisfiable(request, size)
                self.set_status(206)
        if "Content-Type" not in h:
            h["Content-Type"] = _MIME.guess_type(str(self._path))[0] \
                or "application/octet-stream"
        h["ETag"] = f'"{etag}"'
        h["Last-Modified"] = email.utils.formatdate(mtime, usegmt=True)
        h["Content-Length"] = str(count)
        h["Accept-Ranges"] = "bytes"
        if self._status == 206:
            h["Content-Range"] = f"bytes {start}-{start + count - 1}/{size}"
        await StreamResponse.prepare(self, request)
        if request.method == "HEAD" or count == 0:
            return
        # read on the loop: a local file's chunk is quick, and the default
        # executor may be busy with the handlers' device work
        with open(self._path, "rb") as f:
            f.seek(start or 0)
            left = count
            while left > 0:
                chunk = f.read(min(self._chunk, left))
                if not chunk:
                    break
                left -= len(chunk)
                await self._send(chunk)

    async def _unsatisfiable(self, request: Request, size: int) -> None:
        self.set_status(416)
        self._headers["Content-Range"] = f"bytes */{size}"
        await StreamResponse.prepare(self, request)


# -- WebSockets (RFC 6455) ------------------------------------------------------------

WS_KEY = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
WS_MAX_MSG_SIZE = 4 * 1024 * 1024      # aiohttp's default max_msg_size
_WS_QUEUE_LIMIT = 2 * 2 ** 16          # buffered bytes before reading pauses


class WSCloseCode(enum.IntEnum):
    OK = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    UNSUPPORTED_DATA = 1003
    ABNORMAL_CLOSURE = 1006
    INVALID_TEXT = 1007
    POLICY_VIOLATION = 1008
    MESSAGE_TOO_BIG = 1009
    MANDATORY_EXTENSION = 1010
    INTERNAL_ERROR = 1011
    SERVICE_RESTART = 1012
    TRY_AGAIN_LATER = 1013
    BAD_GATEWAY = 1014


_ALLOWED_CLOSE_CODES = {int(c) for c in WSCloseCode}


class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    # aiohttp's own types
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Any


WS_CLOSED_MESSAGE = WSMessage(WSMsgType.CLOSED, None, None)
WS_CLOSING_MESSAGE = WSMessage(WSMsgType.CLOSING, None, None)


class WebSocketError(Exception):
    """A protocol error: its close code and reason."""

    def __init__(self, code: int, message: str):
        self.code = code
        super().__init__(code, message)

    def __str__(self) -> str:
        return self.args[1]


def _unmask(data: bytes, mask: bytes) -> bytes:
    n = len(data)
    if not n:
        return data
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little")
            ^ int.from_bytes(key, "little")).to_bytes(n, "little")


def _frame(opcode: int, payload: bytes) -> bytes:
    """A server frame (FIN set, not masked)."""
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", 0x80 | opcode, n)
    elif n < 65536:
        head = struct.pack("!BBH", 0x80 | opcode, 126, n)
    else:
        head = struct.pack("!BBQ", 0x80 | opcode, 127, n)
    return head + payload


class _WSQueue:
    """The messages the frame reader has parsed, for ``receive``; the
    reader waits while more than ``_WS_QUEUE_LIMIT`` bytes are buffered
    (aiohttp pauses its transport's reading)."""

    def __init__(self):
        self._buf: deque = deque()
        self._size = 0
        self._eof = False
        self._exc: BaseException | None = None
        self._ready = asyncio.Event()
        self._room = asyncio.Event()
        self._room.set()

    def feed(self, msg: WSMessage, size: int) -> None:
        self._buf.append((msg, size))
        self._size += size
        if self._size > _WS_QUEUE_LIMIT:
            self._room.clear()
        self._ready.set()

    def feed_eof(self) -> None:
        self._eof = True
        self._ready.set()

    def set_exception(self, exc: BaseException) -> None:
        self._eof = True
        self._exc = exc
        self._ready.set()

    async def wait_room(self) -> None:
        await self._room.wait()

    async def read(self) -> WSMessage:
        while not self._buf and not self._eof:
            self._ready.clear()
            await self._ready.wait()
        if self._buf:
            msg, size = self._buf.popleft()
            self._size -= size
            if self._size <= _WS_QUEUE_LIMIT:
                self._room.set()
            return msg
        if self._exc is not None:
            raise self._exc
        raise EOFError


class WebSocketResponse(StreamResponse):
    """The server side of a WebSocket, as aiohttp's (see the module's
    docstring): ``prepare`` answers the handshake, then the handler
    ``receive``s (or iterates) and sends; a reader task parses the
    client's frames into a queue."""

    def __init__(self, *, timeout: float = 10.0,
                 max_msg_size: int = WS_MAX_MSG_SIZE):
        super().__init__(status=101)
        self._closes = True                # the connection ends with it
        self._timeout = timeout
        self._max_msg_size = max_msg_size
        self._queue: _WSQueue | None = None
        self._reader_task: asyncio.Task | None = None
        self._closed = False
        self._closing = False
        self._writer_closing = False
        self._close_code: int | None = None
        self._close_wait: asyncio.Future | None = None
        self._waiting = False
        self._conn_lost = 0
        self._eof_sent = False
        self._partial = bytearray()
        self._opcode: int | None = None

    # the handshake ----------------------------------------------------------------

    def _handshake(self, request: Request) -> dict:
        """aiohttp's checks, in its order, with its texts (no
        sub-protocol is offered)."""
        h = request.headers
        if h.get("Upgrade", "").lower().strip() != "websocket":
            raise HTTPBadRequest(
                text=f"No WebSocket UPGRADE hdr: {h.get('Upgrade')}\n Can "
                     f"\"Upgrade\" only to \"WebSocket\".")
        if "upgrade" not in h.get("Connection", "").lower():
            raise HTTPBadRequest(
                text=f"No CONNECTION upgrade hdr: {h.get('Connection')}")
        version = h.get("Sec-WebSocket-Version", "")
        if version not in ("13", "8", "7"):
            raise HTTPBadRequest(text=f"Unsupported version: {version}")
        key = h.get("Sec-WebSocket-Key")
        try:
            if not key or len(base64.b64decode(key)) != 16:
                raise HTTPBadRequest(text=f"Handshake error: {key!r}")
        except binascii.Error:
            raise HTTPBadRequest(text=f"Handshake error: {key!r}") from None
        return {"Upgrade": "websocket", "Connection": "upgrade",
                "Sec-WebSocket-Accept": accept_key(key)}

    def _head(self, request: Request) -> bytes:
        h = self._headers
        h.setdefault("Date", email.utils.formatdate(usegmt=True))
        h.setdefault("Server", _SERVER)
        lines = [f"HTTP/1.1 {self._status} {self._reason}"]
        lines += [f"{k}: {v}" for k, v in h.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def prepare(self, request: Request) -> None:
        if self._req is not None:
            return
        self._headers.update(self._handshake(request))
        await StreamResponse.prepare(self, request)
        self._queue = _WSQueue()
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_frames())
        runner = request._runner
        if runner is not None:
            runner._websockets.add(self)

    # state ------------------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def close_code(self) -> int | None:
        return self._close_code

    # the client's frames -------------------------------------------------------------

    async def _read_frames(self) -> None:
        r, q = self._req._reader, self._queue
        try:
            while True:
                await q.wait_room()
                b0, b1 = await r.readexactly(2)
                fin, opcode = b0 >> 7, b0 & 0x0F
                if b0 & 0x70:
                    raise WebSocketError(
                        WSCloseCode.PROTOCOL_ERROR,
                        "Received frame with non-zero reserved bits")
                if opcode > 0x7 and not fin:
                    raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                         "Received fragmented control frame")
                length = b1 & 0x7F
                if opcode > 0x7 and length > 125:
                    raise WebSocketError(
                        WSCloseCode.PROTOCOL_ERROR,
                        "Control frame payload cannot be larger than 125 "
                        "bytes")
                if length == 126:
                    length = struct.unpack("!H", await r.readexactly(2))[0]
                elif length == 127:
                    length = struct.unpack("!Q", await r.readexactly(8))[0]
                if not b1 & 0x80:
                    raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                         "Received unmasked frame")
                mask = await r.readexactly(4)
                if opcode <= 0x2 and self._max_msg_size \
                        and len(self._partial) + length >= self._max_msg_size:
                    # aiohttp reads the frame, then refuses it: drop it
                    # as it arrives instead of holding it
                    if length > 2 * self._max_msg_size:
                        raise WebSocketError(
                            WSCloseCode.MESSAGE_TOO_BIG,
                            f"Message size {len(self._partial) + length} "
                            f"exceeds limit {self._max_msg_size}")
                    await _discard_exactly(r, length)
                    raise WebSocketError(
                        WSCloseCode.MESSAGE_TOO_BIG,
                        f"Message size {len(self._partial) + length} "
                        f"exceeds limit {self._max_msg_size}")
                payload = _unmask(await r.readexactly(length), mask)
                self._handle_frame(bool(fin), opcode, payload)
        except WebSocketError as e:
            q.set_exception(e)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            q.feed_eof()
        except asyncio.CancelledError:
            q.set_exception(ConnectionResetError("Connection lost"))
            raise

    def _handle_frame(self, fin: bool, opcode: int, payload: bytes) -> None:
        q = self._queue
        if opcode in (WSMsgType.TEXT, WSMsgType.BINARY,
                      WSMsgType.CONTINUATION):
            if opcode == WSMsgType.CONTINUATION and self._opcode is None:
                raise WebSocketError(
                    WSCloseCode.PROTOCOL_ERROR,
                    "Continuation frame for non started message")
            if not fin:
                if opcode != WSMsgType.CONTINUATION:
                    self._opcode = opcode
                self._partial += payload
                return
            if opcode == WSMsgType.CONTINUATION:
                opcode, self._opcode = self._opcode, None
            elif self._partial:
                raise WebSocketError(
                    WSCloseCode.PROTOCOL_ERROR,
                    f"The opcode in non-fin frame is expected to be zero, "
                    f"got {opcode!r}")
            data = bytes(self._partial) + payload
            self._partial.clear()
            if opcode == WSMsgType.TEXT:
                try:
                    text = data.decode("utf-8")
                except UnicodeDecodeError as e:
                    raise WebSocketError(WSCloseCode.INVALID_TEXT,
                                         "Invalid UTF-8 text message") from e
                q.feed(WSMessage(WSMsgType.TEXT, text, ""), len(data))
            else:
                q.feed(WSMessage(WSMsgType.BINARY, data, ""), len(data))
        elif opcode == WSMsgType.CLOSE:
            if len(payload) >= 2:
                code = struct.unpack("!H", payload[:2])[0]
                if code < 3000 and code not in _ALLOWED_CLOSE_CODES:
                    raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                         f"Invalid close code: {code}")
                try:
                    reason = payload[2:].decode("utf-8")
                except UnicodeDecodeError as e:
                    raise WebSocketError(WSCloseCode.INVALID_TEXT,
                                         "Invalid UTF-8 text message") from e
                q.feed(WSMessage(WSMsgType.CLOSE, code, reason), 0)
            elif payload:
                raise WebSocketError(
                    WSCloseCode.PROTOCOL_ERROR,
                    f"Invalid close frame: {fin} {opcode} {payload!r}")
            else:
                q.feed(WSMessage(WSMsgType.CLOSE, 0, ""), 0)
        elif opcode == WSMsgType.PING:
            q.feed(WSMessage(WSMsgType.PING, payload, ""), len(payload))
        elif opcode == WSMsgType.PONG:
            q.feed(WSMessage(WSMsgType.PONG, payload, ""), len(payload))
        else:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 f"Unexpected opcode={opcode!r}")

    # sending -------------------------------------------------------------------------

    def _write_frame(self, opcode: int, payload: bytes) -> None:
        if self._req is None:
            raise RuntimeError("Call .prepare() first")
        if self._writer_closing and opcode != WSMsgType.CLOSE:
            raise ConnectionResetError("Cannot write to closing transport")
        tr = self._req._writer.transport
        if tr is None or tr.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        self._req._writer.write(_frame(opcode, payload))

    async def _send(self, opcode: int, payload: bytes) -> None:
        self._write_frame(opcode, payload)
        await self._req._writer.drain()

    async def send_str(self, data: str) -> None:
        if not isinstance(data, str):
            raise TypeError(f"data argument must be str ({type(data)!r})")
        await self._send(WSMsgType.TEXT, data.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(f"data argument must be byte-ish "
                            f"({type(data)!r})")
        await self._send(WSMsgType.BINARY, bytes(data))

    async def pong(self, message: bytes = b"") -> None:
        await self._send(WSMsgType.PONG, message)

    async def write(self, data: bytes) -> None:
        raise RuntimeError("Cannot call .write() for websocket")

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof_sent:
            return
        if self._req is None:
            raise RuntimeError("Response has not been started")
        await self.close()
        self._eof_sent = True

    # closing -------------------------------------------------------------------------

    def _close_transport(self) -> None:
        if self._req is not None and self._req._writer.transport is not None:
            self._req._writer.transport.close()

    def _write_close(self, code: int, message: bytes = b"") -> None:
        if isinstance(message, str):
            message = message.encode()
        try:
            self._write_frame(WSMsgType.CLOSE,
                              struct.pack("!H", code) + message)
        finally:
            self._writer_closing = True

    async def close(self, *, code: int = WSCloseCode.OK,
                    message: bytes = b"", drain: bool = True) -> bool:
        """Send a close frame, then wait up to `timeout` for the client's
        (a ``receive`` in progress returns CLOSING first), and close the
        transport, as aiohttp's ``close``."""
        if self._req is None:
            raise RuntimeError("Call .prepare() first")
        if self._closed:
            return False
        self._closed = True
        try:
            self._write_close(code, message)
            if drain:
                await self._req._writer.drain()
        except (asyncio.CancelledError, asyncio.TimeoutError):
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            raise
        except Exception:
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            return True
        if self._waiting:
            self._close_wait = asyncio.get_running_loop().create_future()
            self._queue.feed(WS_CLOSING_MESSAGE, 0)
            await self._close_wait
        if self._closing:
            self._close_transport()
            return True
        try:
            async with asyncio.timeout(self._timeout):
                while True:
                    msg = await self._queue.read()
                    if msg.type is WSMsgType.CLOSE:
                        self._close_code = msg.data
                        self._close_transport()
                        return True
        except asyncio.CancelledError:
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            raise
        except Exception:            # the reader's error, or its end
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            return True

    def _going_away(self) -> None:
        """Shutdown: a close frame with 1001, the handler then cancelled
        by ``AppRunner.cleanup``."""
        if self._closed or self._req is None:
            return
        self._closed = True
        self._close_code = WSCloseCode.GOING_AWAY
        try:
            self._write_close(WSCloseCode.GOING_AWAY)
        except ConnectionError:
            pass

    def _abort(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()

    # receiving -------------------------------------------------------------------------

    async def receive(self, timeout: float | None = None) -> WSMessage:
        if self._queue is None:
            raise RuntimeError("Call .prepare() first")
        while True:
            if self._waiting:
                raise RuntimeError(
                    "Concurrent call to receive() is not allowed")
            if self._closed:
                self._conn_lost += 1
                if self._conn_lost >= 5:
                    raise RuntimeError("WebSocket connection is closed.")
                return WS_CLOSED_MESSAGE
            if self._closing:
                return WS_CLOSING_MESSAGE
            try:
                self._waiting = True
                try:
                    if timeout:
                        async with asyncio.timeout(timeout):
                            msg = await self._queue.read()
                    else:
                        msg = await self._queue.read()
                finally:
                    self._waiting = False
                    if self._close_wait is not None \
                            and not self._close_wait.done():
                        self._close_wait.set_result(None)
            except asyncio.TimeoutError:
                raise
            except EOFError:
                self._close_code = WSCloseCode.OK
                await self.close()
                return WSMessage(WSMsgType.CLOSED, None, None)
            except WebSocketError as exc:
                self._close_code = exc.code
                await self.close(code=exc.code)
                return WSMessage(WSMsgType.ERROR, exc, None)
            except Exception as exc:
                self._closing = True
                self._close_code = WSCloseCode.ABNORMAL_CLOSURE
                await self.close()
                return WSMessage(WSMsgType.ERROR, exc, None)
            if msg.type is WSMsgType.CLOSE:
                self._closing = True
                self._close_code = msg.data
                if not self._closed:
                    await self.close(drain=False)
            elif msg.type is WSMsgType.CLOSING:
                self._closing = True
                self._close_code = WSCloseCode.OK
            elif msg.type is WSMsgType.PING:
                await self.pong(msg.data)
                continue
            elif msg.type is WSMsgType.PONG:
                continue
            return msg

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING,
                        WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(
        hashlib.sha1(key.encode() + WS_KEY).digest()).decode()


async def _discard_exactly(reader: asyncio.StreamReader, n: int) -> None:
    while n > 0:
        chunk = await reader.read(min(n, 65536))
        if not chunk:
            raise asyncio.IncompleteReadError(b"", n)
        n -= len(chunk)


# -- routing ---------------------------------------------------------------------------

_ROUTE_RE = re.compile(r"(\{[_a-zA-Z][^{}]*(?:\{[^{}]*\}[^{}]*)*\})")
_DYN = re.compile(r"\{(?P<var>[_a-zA-Z][_a-zA-Z0-9]*)\}")
_DYN_RE = re.compile(
    r"\{(?P<var>[_a-zA-Z][_a-zA-Z0-9]*):(?P<re>.+)\}")
_GOOD = r"[^{}/]+"


class Resource:
    """One path pattern and its handlers by method; ``canonical`` is the
    pattern as registered (the metrics middleware's route label)."""

    def __init__(self, path: str):
        self.canonical = path
        pattern = ""
        for part in _ROUTE_RE.split(path):
            if m := _DYN.fullmatch(part):
                pattern += f"(?P<{m['var']}>{_GOOD})"
            elif m := _DYN_RE.fullmatch(part):
                pattern += f"(?P<{m['var']}>{m['re']})"
            elif "{" in part or "}" in part:
                raise ValueError(f"Invalid path '{path}'['{part}']")
            else:
                pattern += re.escape(part)
        self._pattern = re.compile(pattern)
        self.routes: dict[str, Any] = {}

    @property
    def index_key(self) -> str:
        """aiohttp's ``UrlDispatcher._get_resource_index_key``."""
        key = self.canonical
        if "{" in key:
            key = key.partition("{")[0].rpartition("/")[0]
        return key.rstrip("/") or "/"

    def match(self, path_safe: str) -> dict | None:
        m = self._pattern.fullmatch(path_safe)
        if m is None:
            return None
        return {k: urllib.parse.unquote(v) for k, v in m.groupdict().items()}


class StaticResource(Resource):
    """``add_static``: GET and HEAD of the files under `directory` at
    ``<prefix>/<relative path>``; a path outside it 404, a directory 403,
    a missing file an empty 404 (aiohttp's ``FileResponse``)."""

    def __init__(self, prefix: str, directory: Path):
        self.canonical = prefix.rstrip("/") or "/"
        self._prefix = self.canonical.rstrip("/") + "/"
        self._directory = Path(directory).resolve()
        self.routes = {"GET": self._handle, "HEAD": self._handle}

    def match(self, path_safe: str) -> dict | None:
        if not path_safe.startswith(self._prefix):
            return None
        return {"filename": urllib.parse.unquote(
            path_safe[len(self._prefix):])}

    async def _handle(self, request: Request) -> StreamResponse:
        target = (self._directory / request.match_info["filename"]).resolve()
        if not target.is_relative_to(self._directory):
            raise HTTPNotFound()
        if target.is_dir():
            raise HTTPForbidden()
        return FileResponse(target)        # a missing file: 404, empty


class _Route:
    def __init__(self, resource: Resource | None):
        self.resource = resource


class MatchInfo(dict):
    """``request.match_info``: the pattern's values, and ``route`` (whose
    ``resource`` is None where nothing matched)."""

    def __init__(self, values: dict, resource: Resource | None):
        super().__init__(values)
        self.route = _Route(resource)


class UrlDispatcher:
    def __init__(self):
        self._resources: list[Resource] = []
        self._index: dict[str, list[Resource]] = {}

    def _resource(self, path: str) -> Resource:
        if not path.startswith("/"):
            raise ValueError("path should be started with / or be empty")
        # aiohttp reuses the last resource when its path is the same
        if self._resources and self._resources[-1].canonical == path \
                and not isinstance(self._resources[-1], StaticResource):
            return self._resources[-1]
        res = Resource(path)
        self._register(res)
        return res

    def _register(self, res: Resource) -> None:
        self._resources.append(res)
        self._index.setdefault(res.index_key, []).append(res)

    def add_route(self, method: str, path: str, handler) -> Resource:
        res = self._resource(path)
        method = method.upper()
        if method in res.routes:
            raise RuntimeError(f"Added route will never be executed, "
                               f"method {method} is already registered")
        res.routes[method] = handler
        return res

    def add_get(self, path: str, handler, *, allow_head: bool = True):
        res = self.add_route("GET", path, handler)
        if allow_head:
            self.add_route("HEAD", path, handler)
        return res

    def add_post(self, path: str, handler):
        return self.add_route("POST", path, handler)

    def add_put(self, path: str, handler):
        return self.add_route("PUT", path, handler)

    def add_patch(self, path: str, handler):
        return self.add_route("PATCH", path, handler)

    def add_delete(self, path: str, handler):
        return self.add_route("DELETE", path, handler)

    def add_static(self, prefix: str, path, *, append_version: bool = False,
                   **_kw) -> StaticResource:
        res = StaticResource(prefix, Path(path))
        self._register(res)
        return res

    def resolve(self, method: str, path_safe: str):
        """(handler, MatchInfo) for a request, the handler raising 404 or
        405 where nothing serves it."""
        allowed: set[str] = set()
        part = path_safe
        while part:
            for res in self._index.get(part, ()):
                values = res.match(path_safe)
                if values is None:
                    continue
                handler = res.routes.get(method)
                if handler is not None:
                    return handler, MatchInfo(values, res)
                allowed |= set(res.routes)
            if part == "/":
                break
            part = part.rpartition("/")[0] or "/"
        error = (HTTPMethodNotAllowed(method, allowed) if allowed
                 else HTTPNotFound())

        async def _raise(request):
            raise error

        return _raise, MatchInfo({}, None)


class Application:
    def __init__(self, *, middlewares=(),
                 client_max_size: int = CLIENT_MAX_SIZE):
        self._middlewares = list(middlewares)
        self._client_max_size = client_max_size
        self.router = UrlDispatcher()


# -- requests ---------------------------------------------------------------------------

_KEEP = re.compile(r"%(?:2[fF]|25)")


def _path_safe(raw: str) -> str:
    """The path percent-decoded but for %2F and %25 (aiohttp's
    ``path_safe``); dot segments stay, as in aiohttp (the static route
    resolves its files inside its directory)."""
    parts = _KEEP.split(raw)
    keep = _KEEP.findall(raw)
    out = urllib.parse.unquote(parts[0])
    for k, p in zip(keep, parts[1:]):
        out += k.upper() + urllib.parse.unquote(p)
    return out


class Request:
    def __init__(self, method: str, target: str, version: tuple[int, int],
                 headers: Headers, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, app: Application):
        self.method = method
        self.version = version
        self.headers = headers
        self.app = app
        self._reader, self._writer = reader, writer
        raw_path, _, qs = target.partition("?")
        self.query = Query(qs)
        self._path_safe = _path_safe(raw_path)
        self.path = urllib.parse.unquote(self._path_safe)
        self.match_info = MatchInfo({}, None)
        peer = writer.get_extra_info("peername")
        self.remote = peer[0] if isinstance(peer, tuple) else None
        conn = headers.get("Connection", "").lower()
        self.keep_alive = ("close" not in conn if version >= (1, 1)
                           else "keep-alive" in conn)
        self._body: bytes | None = None
        self._length = 0
        self._body_read = False
        self._runner: AppRunner | None = None

    @property
    def host(self) -> str:
        return self.headers.get("Host") or ""

    @property
    def content_type(self) -> str:
        raw = self.headers.get("Content-Type", "application/octet-stream")
        return raw.split(";", 1)[0].strip().lower()

    @property
    def charset(self) -> str | None:
        m = re.search(r"charset=([\w-]+)", self.headers.get("Content-Type",
                                                            ""))
        return m.group(1) if m else None

    @functools.cached_property
    def cookies(self) -> dict[str, str]:
        jar = http.cookies.SimpleCookie()
        try:
            jar.load(self.headers.get("Cookie", ""))
        except http.cookies.CookieError:
            return {}
        return {k: m.value for k, m in jar.items()}

    @property
    def can_read_body(self) -> bool:
        return self._length > 0 and not self._body_read

    async def read(self) -> bytes:
        self._body_read = True
        max_size = self.app._client_max_size
        if self._length > max_size:
            raise HTTPRequestEntityTooLarge(max_size, self._length)
        if self._body is None:
            self._body = await self._reader.readexactly(self._length) \
                if self._length > 0 else b""
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self, *, loads=json.loads) -> Any:
        return loads(await self.text())

    async def post(self) -> Query:
        if self.method not in ("POST", "PUT", "PATCH") \
                or self.content_type != "application/x-www-form-urlencoded":
            return Query("")
        return Query(await self.text())


# -- the server -------------------------------------------------------------------------

_LINE = re.compile(r"^([A-Z]+) (\S+) HTTP/(\d)\.(\d)$")


class AppRunner:
    """Serves one ``Application`` on the sites started with it."""

    def __init__(self, app: Application, *,
                 keepalive_timeout: float = KEEPALIVE_TIMEOUT):
        self.app = app
        self.keepalive_timeout = keepalive_timeout
        self._sites: list[TCPSite] = []
        self._conns: set[asyncio.Task] = set()
        self._websockets: set[WebSocketResponse] = set()
        self._closing = False

    async def setup(self) -> None:
        self._closing = False

    async def cleanup(self) -> None:
        """Stop listening, send each open WebSocket a close frame with
        1001, let the handlers run for ``SHUTDOWN_GRACE`` (an SSE pump
        sends the events already queued), then end every connection (open
        streams and sockets included) and wait up to ``SHUTDOWN_TIMEOUT``
        for their handlers."""
        for site in list(self._sites):
            await site.stop()
        for ws in list(self._websockets):
            ws._going_away()
        await asyncio.sleep(SHUTDOWN_GRACE)
        self._closing = True
        for ws in list(self._websockets):
            ws._abort()
        self._websockets.clear()
        tasks = [t for t in self._conns if not t.done()]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=SHUTDOWN_TIMEOUT)

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while not self._closing:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"),
                        timeout=self.keepalive_timeout)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionError):
                    break
                except asyncio.LimitOverrunError:
                    await self._error(writer, 431)
                    break
                request = self._parse(head, reader, writer)
                if request is None:
                    await self._error(writer, 400)
                    break
                if not await self._serve(request):
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(task)
            if self._closing:
                writer.transport.abort()
            else:
                writer.close()

    def _parse(self, head: bytes, reader, writer) -> Request | None:
        try:
            lines = head.decode("latin-1").split("\r\n")
            m = _LINE.match(lines[0])
            if m is None:
                return None
            headers = Headers()
            for ln in lines[1:]:
                if not ln:
                    continue
                name, sep, value = ln.partition(":")
                if not sep or not name or name != name.strip():
                    return None
                value = value.strip()
                headers[name] = (f"{headers[name]}, {value}"
                                 if name in headers else value)
            req = Request(m.group(1), m.group(2),
                          (int(m.group(3)), int(m.group(4))), headers,
                          reader, writer, self.app)
            req._runner = self
            if "chunked" in headers.get("Transfer-Encoding", "").lower():
                return None           # no chunked request bodies
            req._length = int(headers.get("Content-Length", "0") or 0)
            if req._length < 0:
                return None
            return req
        except (ValueError, UnicodeError):
            return None

    async def _error(self, writer, status: int) -> None:
        body = f"{status}: {_reason(status)}".encode()
        try:
            writer.write(
                f"HTTP/1.1 {status} {_reason(status)}\r\nContent-Type: "
                f"text/plain; charset=utf-8\r\nContent-Length: "
                f"{len(body)}\r\nConnection: close\r\n\r\n".encode()
                + body)
            await writer.drain()
        except ConnectionError:
            pass

    async def _serve(self, request: Request) -> bool:
        """Answer one request; whether the connection stays open."""
        handler, info = self.app.router.resolve(request.method,
                                                request._path_safe)
        request.match_info = info
        for mw in reversed(self.app._middlewares):
            handler = functools.partial(mw, handler=handler)
        if request._length and request._length <= \
                self.app._client_max_size and "100-continue" in \
                request.headers.get("Expect", "").lower():
            request._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        try:
            resp = await handler(request)
        except HTTPException as e:
            resp = e
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("Error handling request")
            resp = Response(status=500, text="500 Internal Server Error\n\n"
                            "Server got itself in trouble")
        if self._closing:
            return False
        try:
            if resp is None or not isinstance(resp, StreamResponse):
                log.error("Error handling request: %s returned %r",
                          request.path, resp)
                resp = Response(status=500, text="500 Internal Server "
                                "Error\n\nServer got itself in trouble")
            if resp.prepared and resp._req is not request:
                return False
            try:
                await resp.prepare(request)
            except HTTPException as e:     # a FileResponse's missing file
                if resp.prepared:
                    return False
                resp = e
                await resp.prepare(request)
            await resp.write_eof()
        except (ConnectionError, RuntimeError):
            return False
        finally:
            if isinstance(resp, WebSocketResponse):
                self._websockets.discard(resp)
                resp._abort()
        if request._length and not request._body_read \
                and request._length <= self.app._client_max_size:
            try:                            # an unread body: skip it
                await request._reader.readexactly(request._length)
            except (asyncio.IncompleteReadError, ConnectionError):
                return False
        elif request._length > self.app._client_max_size:
            # its body was never read: drain what the client still sends
            # before closing, for up to LINGER_S (aiohttp's lingering
            # close), or the unread bytes reset the connection and the
            # client may lose the response
            await _discard(request._reader, request._length, LINGER_S)
            return False
        return request.keep_alive and not resp._closes \
            and "close" not in resp.headers.get("Connection", "").lower()


async def _discard(reader: asyncio.StreamReader, n: int,
                   seconds: float) -> None:
    """Read and drop up to `n` bytes from `reader` for at most
    `seconds`."""
    deadline = asyncio.get_running_loop().time() + seconds
    try:
        while n > 0:
            left = deadline - asyncio.get_running_loop().time()
            if left <= 0:
                return
            chunk = await asyncio.wait_for(reader.read(min(n, 65536)), left)
            if not chunk:
                return
            n -= len(chunk)
    except (asyncio.TimeoutError, ConnectionError):
        return


class TCPSite:
    def __init__(self, runner: AppRunner, host: str | None = None,
                 port: int = 8080, *, ssl_context=None):
        self._runner = runner
        self._host = host or "0.0.0.0"
        self._port = port
        self._ssl = ssl_context
        self._server: asyncio.base_events.Server | None = None

    @property
    def port(self) -> int:
        """The port bound: the OS's choice where 0 was asked for."""
        if self._server is not None and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._runner._connection, self._host, self._port,
            ssl=self._ssl, reuse_address=True)
        self._runner._sites.append(self)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        if self in self._runner._sites:
            self._runner._sites.remove(self)
