"""Shared outbound HTTP client: one pooled connection set, consistent
timeouts, a policy-compliant User-Agent, and observability hooks.

Reference: internal/httpclient (client.go/transport.go) — a reusable
client wrapping the stdlib with connection pooling, a default timeout,
User-Agent injection, and before/after hooks every integration
(webhooks, external APIs, health checks) goes through. Integrations take
a `session=` so tests inject fakes.

The User-Agent's leading token is intentionally "BirdNETGo" (no hyphen):
Wikimedia's edge hard-403s any UA whose first token is "birdnet-go",
case-insensitively (client.go:41-47 documents the trap) — keep the
unhyphenated form for anything that might ever touch their APIs.

A copy of ``birdnet_go_tpu/utils/httpclient.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_integrations.py``
holds it to the original. The JAX client's session is an
``httpx.Client``; the card's machine has no httpx, so the port's is
``UrllibSession``, the part of ``httpx.Client`` that the port's callers
use, on ``urllib.request``: ``get``, ``post``, ``delete``, ``request`` and
``stream`` (and ``head``) with ``params=`` (which replace the URL's own
query, as httpx's do), ``json=``, ``data=``, ``content=``, ``headers=``
and ``timeout=``; the client's ``verify`` as httpx's (``True``: the
default trust store, which ``SSL_CERT_FILE`` replaces; ``False``: no
check; a CA file or directory; an ``ssl.SSLContext``); redirects followed
as httpx follows them
(a 303, or a 302, becomes a GET without its body, as a POST's 301 does;
a 307 or 308 is sent again as it was); a ``Response`` with
``status_code``, ``headers``, ``content``, ``text``, ``json()`` and
``raise_for_status()``. Its errors carry httpx's names
(``HTTPStatusError``, ``ConnectError``, ``TimeoutException`` under
``TransportError`` and ``HTTPError``), so a caller's ``except`` treats
them as it treats httpx's. It is the port's one transport: the model
gallery's downloads (``models/catalog.py``) stream through it too.
Differences that no caller reads: urllib sends ``Accept-Encoding:
identity`` and ``Connection: close`` (one connection a request, where an
``httpx.Client`` keeps a pool), gives up after 10 redirects where httpx
gives up after 20, and with ``verify=True`` trusts the system's store
where httpx trusts certifi's (both read ``SSL_CERT_FILE`` first).
"""

from __future__ import annotations

import contextlib
import json as json_mod
import logging
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http import HTTPStatus
from typing import Any, Callable

log = logging.getLogger("birdnet_tpu.http")

DEFAULT_TIMEOUT = 30.0
_UA_NAME = "BirdNETGo"
_REPO_URL = "https://github.com/birdnet-go-tpu"


def default_user_agent() -> str:
    """Leading product token + contact URL (robot-policy convention)."""
    return f"{_UA_NAME} ({_REPO_URL})"


# -- the transport -----------------------------------------------------------------


class HTTPError(Exception):
    """Any failure of a request (httpx.HTTPError's role)."""


class TransportError(HTTPError):
    """The request did not get a response."""


class ConnectError(TransportError):
    """No connection to the server (refused, unreachable, unresolved)."""


class TimeoutException(TransportError):
    """The server did not answer within the timeout."""


class HTTPStatusError(HTTPError):
    """``raise_for_status()`` on a status outside 2xx."""

    def __init__(self, message: str, *, response: "Response"):
        super().__init__(message)
        self.response = response


class Headers(dict):
    """Response headers: a case-insensitive ``get`` and ``[]``, names as
    the server sent them; a repeated header's values joined by ", " as
    httpx's ``Headers`` reads them."""

    def __init__(self, items=()):
        super().__init__()
        self._lower: dict[str, str] = {}
        for k, v in items:
            key = self._lower.get(k.lower())
            if key is None:
                self._lower[k.lower()] = k
                dict.__setitem__(self, k, v)
            else:
                dict.__setitem__(self, key, f"{self[key]}, {v}")

    def __getitem__(self, key: str) -> str:
        return dict.__getitem__(self, self._lower.get(key.lower(), key))

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.lower() in self._lower

    def get(self, key: str, default=None):
        return self[key] if key in self else default


_REASONS = {c.value: c.phrase for c in HTTPStatus}


class Response:
    """A whole response: its status, headers and body read at once."""

    def __init__(self, status_code: int, headers: Headers, content: bytes,
                 url: str):
        self.status_code = status_code
        self.headers = headers
        self.content = content
        self.url = url

    @property
    def reason_phrase(self) -> str:
        return _REASONS.get(self.status_code, "")

    @property
    def is_success(self) -> bool:
        return 200 <= self.status_code < 300

    @property
    def encoding(self) -> str:
        ctype = self.headers.get("Content-Type", "")
        for part in ctype.split(";")[1:]:
            k, _, v = part.strip().partition("=")
            if k.lower() == "charset" and v:
                return v.strip('"')
        return "utf-8"

    @property
    def text(self) -> str:
        return self.content.decode(self.encoding, errors="replace")

    def json(self) -> Any:
        return json_mod.loads(self.content)

    def raise_for_status(self) -> "Response":
        """httpx's message and rule: anything but 2xx raises."""
        if self.is_success:
            return self
        kind = {1: "Informational response", 3: "Redirect response",
                4: "Client error", 5: "Server error"}.get(
                    self.status_code // 100, "Invalid status code")
        message = (f"{kind} '{self.status_code} {self.reason_phrase}' for "
                   f"url '{self.url}'\n")
        if 300 <= self.status_code < 400 and "Location" in self.headers:
            message += f"Redirect location: '{self.headers['Location']}'\n"
        message += ("For more information check: https://developer."
                    f"mozilla.org/en-US/docs/Web/HTTP/Status/"
                    f"{self.status_code}")
        raise HTTPStatusError(message, response=self)


class StreamResponse:
    """A response whose body is read as it arrives (``stream``)."""

    def __init__(self, resp, url: str):
        self._resp = resp
        self.status_code = resp.status
        self.headers = Headers(resp.headers.items())
        self.url = url

    def raise_for_status(self) -> "StreamResponse":
        if 200 <= self.status_code < 300:
            return self
        Response(self.status_code, self.headers, b"",
                 self.url).raise_for_status()

    def iter_bytes(self, chunk_size: int = 65536):
        while chunk := self._resp.read(chunk_size):
            yield chunk


def _primitive(v) -> str:
    """A query or form value as httpx writes it."""
    if v is True:
        return "true"
    if v is False:
        return "false"
    if v is None:
        return ""
    return str(v)


def _pairs(mapping) -> list[tuple[str, str]]:
    out = []
    for k, v in (mapping.items() if hasattr(mapping, "items")
                 else mapping):
        for item in (v if isinstance(v, (list, tuple)) else [v]):
            out.append((str(k), _primitive(item)))
    return out


class _Redirects(urllib.request.HTTPRedirectHandler):
    """Follows a redirect as httpx does: 303 (and 302) to a GET, a POST's
    301 to a GET, the body and its length dropped with the method change
    (its Content-Type kept, as httpx keeps it); 307 and 308 send the same
    method and body again. Authorization is dropped on a change of
    origin, and the Cookie header always."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        method = req.get_method()
        if (code in (302, 303) and method != "HEAD") \
                or (code == 301 and method == "POST"):
            new_method = "GET"
        else:
            new_method = method
        body = None if new_method != method else req.data
        old = urllib.parse.urlsplit(req.full_url)
        new = urllib.parse.urlsplit(newurl)
        same = (old.scheme, old.hostname, old.port) == (
            new.scheme, new.hostname, new.port)
        hdrs = {}
        for k, v in req.header_items():
            lk = k.lower()
            if lk in ("host", "cookie") or (lk == "authorization"
                                            and not same):
                continue
            if body is None and lk in ("content-length",
                                       "transfer-encoding"):
                continue
            hdrs[k] = v
        return urllib.request.Request(newurl, data=body, headers=hdrs,
                                      method=new_method)


class _HTTPHandler(urllib.request.HTTPHandler):
    """Sends no Content-Type that the caller did not set (urllib gives a
    body one of its own, form-encoded; httpx none)."""

    def http_request(self, req):
        req = super().http_request(req)
        if "Content-type" not in req.headers:
            req.unredirected_hdrs.pop("Content-type", None)
        return req


class _HTTPSHandler(urllib.request.HTTPSHandler):
    def https_request(self, req):
        req = super().https_request(req)
        if "Content-type" not in req.headers:
            req.unredirected_hdrs.pop("Content-type", None)
        return req


def _ssl_context(verify):
    """httpx's ``create_ssl_context`` for `verify` (but the default
    store: see the module's docstring)."""
    import os
    import ssl

    if verify is True:
        return ssl.create_default_context()
    if verify is False:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    if isinstance(verify, (str, os.PathLike)):
        if os.path.isdir(verify):
            return ssl.create_default_context(capath=verify)
        return ssl.create_default_context(cafile=verify)
    return verify




def _transport_error(e: BaseException) -> TransportError:
    reason = getattr(e, "reason", e)
    if isinstance(reason, (socket.timeout, TimeoutError)):
        return TimeoutException(str(reason) or "timed out")
    return ConnectError(str(reason))


class UrllibSession:
    """The part of ``httpx.Client`` the port's callers use, on
    ``urllib.request`` (see the module's docstring)."""

    def __init__(self, timeout: float = DEFAULT_TIMEOUT,
                 headers: dict | None = None, verify=True):
        self.timeout = timeout
        self.headers = dict(headers or {})
        self._verify = verify
        self._opener = None

    def _build(self, method: str, url: str, *, params=None, json=None,
               data=None, content=None, headers=None
               ) -> urllib.request.Request:
        if params:
            # httpx's rule: `params` replace the URL's own query
            url = urllib.parse.urlunsplit(urllib.parse.urlsplit(url)._replace(
                query=urllib.parse.urlencode(_pairs(params))))
        hdrs = {**self.headers}
        body = None
        if content is not None:
            body = content.encode() if isinstance(content, str) else \
                bytes(content)
        elif json is not None:
            body = json_mod.dumps(json, ensure_ascii=False,
                                  separators=(",", ":"),
                                  allow_nan=False).encode()
            hdrs["Content-Type"] = "application/json"
        elif data is not None:
            body = urllib.parse.urlencode(_pairs(data)).encode()
            hdrs["Content-Type"] = "application/x-www-form-urlencoded"
        for k, v in (headers or {}).items():
            for old in [h for h in hdrs if h.lower() == k.lower()]:
                del hdrs[old]
            hdrs[k] = v
        if body is not None:
            hdrs["Content-Length"] = str(len(body))
        elif method in ("POST", "PUT", "PATCH"):
            body, hdrs["Content-Length"] = b"", "0"
        return urllib.request.Request(url, data=body, headers=hdrs,
                                      method=method)

    def _open(self, req: urllib.request.Request, timeout):
        if self._opener is None:
            # the context at first use (``SSL_CERT_FILE`` read then, as
            # httpx reads it when its client is made)
            self._opener = urllib.request.build_opener(
                _Redirects, _HTTPHandler,
                _HTTPSHandler(context=_ssl_context(self._verify)))
        try:
            return self._opener.open(
                req, timeout=self.timeout if timeout is None else timeout)
        except urllib.error.HTTPError as e:
            return e                    # a status, not a transport error
        except (urllib.error.URLError, OSError) as e:
            raise _transport_error(e) from e

    def request(self, method: str, url: str, *, params=None, json=None,
                data=None, content=None, headers=None,
                timeout: float | None = None) -> Response:
        req = self._build(method.upper(), url, params=params, json=json,
                          data=data, content=content, headers=headers)
        resp = self._open(req, timeout)
        try:
            body = resp.read()
        except (urllib.error.URLError, OSError) as e:
            raise _transport_error(e) from e
        finally:
            resp.close()
        return Response(resp.status, Headers(resp.headers.items()), body,
                        resp.geturl())

    def get(self, url: str, **kw) -> Response:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> Response:
        return self.request("POST", url, **kw)

    def head(self, url: str, **kw) -> Response:
        return self.request("HEAD", url, **kw)

    def delete(self, url: str, **kw) -> Response:
        return self.request("DELETE", url, **kw)

    @contextlib.contextmanager
    def stream(self, method: str, url: str, **kw):
        """``with session.stream("GET", url) as r``: ``r.iter_bytes(n)``
        reads the body as it arrives."""
        timeout = kw.pop("timeout", None)
        req = self._build(method.upper(), url, **kw)
        resp = self._open(req, timeout)
        try:
            yield StreamResponse(resp, resp.geturl())
        finally:
            resp.close()

    def close(self) -> None:
        """Nothing to release: urllib opens a connection a request."""


# -- the client -----------------------------------------------------------------------


class HttpClient:
    """Thread-safe pooled client with per-request timeout override and
    metric hooks (Client struct role)."""

    def __init__(self, timeout: float = DEFAULT_TIMEOUT,
                 user_agent: str | None = None, session=None):
        self.user_agent = user_agent or default_user_agent()
        self.timeout = timeout
        self.session = session or UrllibSession(
            timeout=timeout, headers={"User-Agent": self.user_agent})
        self._lock = threading.Lock()
        self.before_request: Callable[[str, str], None] | None = None
        self.after_response: Callable[[str, str, int, float], None] | None \
            = None
        # simple aggregate stats for /system/diagnostics
        self.requests = 0
        self.errors = 0
        self.by_host: dict[str, int] = {}

    # -- core ---------------------------------------------------------------------

    def request(self, method: str, url: str, *,
                timeout: float | None = None, **kw):
        host = urllib.parse.urlparse(url).hostname or ""
        if self.before_request is not None:
            self.before_request(method, url)
        t0 = time.monotonic()
        status = 0
        try:
            r = self.session.request(
                method, url,
                timeout=timeout if timeout is not None else self.timeout,
                **kw)
            status = r.status_code
            return r
        except Exception:
            with self._lock:
                self.errors += 1
            raise
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self.requests += 1
                self.by_host[host] = self.by_host.get(host, 0) + 1
            if self.after_response is not None:
                try:
                    self.after_response(method, url, status, dt)
                except Exception:
                    log.exception("after_response hook failed")

    # -- convenience --------------------------------------------------------------

    def get(self, url: str, **kw):
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw):
        return self.request("POST", url, **kw)

    def get_json(self, url: str, **kw) -> Any:
        r = self.get(url, **kw)
        r.raise_for_status()
        return r.json()

    def post_json(self, url: str, payload: Any, **kw) -> Any:
        r = self.request("POST", url, json=payload, **kw)
        r.raise_for_status()
        return r.json() if r.content else None

    def stats(self) -> dict:
        with self._lock:
            return {"requests": self.requests, "errors": self.errors,
                    "by_host": dict(self.by_host)}

    def close(self) -> None:
        self.session.close()


_shared: HttpClient | None = None
_shared_lock = threading.Lock()


def shared_client() -> HttpClient:
    """Process-wide pooled client (the package-level default the reference
    hands to every integration)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = HttpClient()
        return _shared
