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
- ``AppRunner`` and ``TCPSite``: ``cleanup()`` stops listening, lets
  the handlers send what they hold for a tenth of a second, then ends
  every open connection, streams included, so that it returns while an
  SSE client is still connected (aiohttp waits for such handlers up to
  its shutdown timeout). ``TCPSite.port`` is the port bound, which port 0 leaves to
  the OS.

Not offered: WebSockets, chunked request bodies (400), multipart bodies
(``post()`` reads url-encoded forms and answers an empty form otherwise),
and more than one request at a time per connection.
"""

from __future__ import annotations

import asyncio
import datetime
import email.utils
import functools
import http
import http.cookies
import json
import logging
import mimetypes
import os
import re
import sys
import urllib.parse
from collections.abc import MutableMapping
from pathlib import Path
from typing import Any

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
        self._closing = False

    async def setup(self) -> None:
        self._closing = False

    async def cleanup(self) -> None:
        """Stop listening, let the handlers run for ``SHUTDOWN_GRACE`` (an
        SSE pump sends the events already queued), then end every
        connection (open streams included) and wait up to
        ``SHUTDOWN_TIMEOUT`` for their handlers."""
        for site in list(self._sites):
            await site.stop()
        await asyncio.sleep(SHUTDOWN_GRACE)
        self._closing = True
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
