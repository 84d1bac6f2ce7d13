"""Shared outbound HTTP client: one pooled connection set, consistent
timeouts, a policy-compliant User-Agent, and observability hooks.

Reference: internal/httpclient (client.go/transport.go) — a reusable
client wrapping the stdlib with connection pooling, a default timeout,
User-Agent injection, and before/after hooks every integration
(webhooks, external APIs, health checks) goes through. Here the pool is
an httpx.Client; integrations take a `session=` so tests inject fakes.

The User-Agent's leading token is intentionally "BirdNETGo" (no hyphen):
Wikimedia's edge hard-403s any UA whose first token is "birdnet-go",
case-insensitively (client.go:41-47 documents the trap) — keep the
unhyphenated form for anything that might ever touch their APIs.

A copy of ``birdnet_go_tpu/utils/httpclient.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import importlib
import logging
import threading
import time
from typing import Any, Callable

log = logging.getLogger("birdnet_tpu.http")

DEFAULT_TIMEOUT = 30.0
_UA_NAME = "BirdNETGo"
_REPO_URL = "https://github.com/birdnet-go-tpu"


def default_user_agent() -> str:
    """Leading product token + contact URL (robot-policy convention)."""
    return f"{_UA_NAME} ({_REPO_URL})"


class HttpClient:
    """Thread-safe pooled client with per-request timeout override and
    metric hooks (Client struct role)."""

    def __init__(self, timeout: float = DEFAULT_TIMEOUT,
                 user_agent: str | None = None, session=None):
        self.user_agent = user_agent or default_user_agent()
        self.timeout = timeout
        # httpx is imported where a client is built, so that the module
        # imports on a machine without httpx
        self.session = session or importlib.import_module("httpx").Client(
            timeout=timeout, follow_redirects=True,
            headers={"User-Agent": self.user_agent})
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
        from urllib.parse import urlparse

        host = urlparse(url).hostname or ""
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
