"""Opt-in, privacy-scrubbed error telemetry.

Reference: internal/telemetry — Sentry-compatible reporting that is OFF by
default, deduplicates, scrubs secrets/URLs, and never blocks the pipeline
(async worker + bounded queue). This implementation posts Sentry envelope
events to a configured DSN using only the standard library; without a DSN
every call is a no-op.

A copy of ``birdnet_go_tpu/utils/telemetry.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original. Events go over the port's transport
(``utils/httpclient.py`` ``UrllibSession``), where JAX's builds an
``httpx.Client``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from urllib.parse import urlparse

from birdnet_go_tpu_torch.utils.httpclient import UrllibSession

log = logging.getLogger("birdnet_tpu.telemetry")

_worker: "_TelemetryWorker | None" = None
_lock = threading.Lock()


def configure(dsn: str | None, enabled: bool = False,
              session=None) -> None:
    """Install (or clear) the global telemetry worker."""
    global _worker
    with _lock:
        if _worker is not None:
            _worker.stop()
            _worker = None
        if enabled and dsn:
            _worker = _TelemetryWorker(dsn, session=session)
            _worker.start()
            log.info("telemetry enabled (scrubbed, deduplicated)")


def capture_error(err) -> bool:
    """Queue one error event (no-op unless configured). Deduplicates on
    (component, category, message-shape)."""
    w = _worker
    if w is None:
        return False
    return w.capture(err)


def _scrub(text: str) -> str:
    """Strip obvious secrets/addresses from messages (privacy pkg role)."""
    import re

    text = re.sub(r"(password|token|secret|api_key)\s*[=:]\s*\S+",
                  r"\1=***", text, flags=re.IGNORECASE)
    text = re.sub(r"[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+", "***@***", text)
    text = re.sub(r"//[^@/\s]+@", "//***@", text)       # URL credentials
    text = re.sub(r"\b\d{1,3}(\.\d{1,3}){3}\b", "x.x.x.x", text)
    return text


class _TelemetryWorker:
    def __init__(self, dsn: str, session=None, capacity: int = 100):
        self.session = session or UrllibSession(timeout=10.0)
        u = urlparse(dsn)
        self._key = u.username or ""
        project = u.path.strip("/")
        self._endpoint = f"{u.scheme}://{u.hostname}" \
            + (f":{u.port}" if u.port else "") \
            + f"/api/{project}/envelope/"
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._seen: dict[str, float] = {}
        self._seen_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.sent = 0
        self.dropped = 0
        self.deduplicated = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="telemetry",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)

    def capture(self, err) -> bool:
        component = getattr(err, "component", "")
        category = getattr(err, "category", "generic")
        message = _scrub(str(err))
        key = f"{component}:{category}:{message[:120]}"
        now = time.time()
        with self._seen_lock:
            if now - self._seen.get(key, 0) < 3600:
                self.deduplicated += 1
                return False
            self._seen[key] = now
            if len(self._seen) > 4096:        # bounded dedup memory
                cutoff = now - 3600
                self._seen = {k: v for k, v in self._seen.items()
                              if v >= cutoff}
                if len(self._seen) > 4096:    # all fresh: drop oldest
                    keep = sorted(self._seen.items(),
                                  key=lambda kv: kv[1])[-2048:]
                    self._seen = dict(keep)
        try:
            self._queue.put_nowait({
                "event_id": uuid.uuid4().hex,
                "timestamp": now,
                "level": "error",
                "message": message,
                "tags": {"component": component, "category": category},
            })
            return True
        except queue.Full:
            self.dropped += 1
            return False

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                event = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                header = json.dumps({"event_id": event["event_id"],
                                     "sent_at": _iso(event["timestamp"])})
                item_hdr = json.dumps({"type": "event"})
                body = json.dumps(event)
                envelope = f"{header}\n{item_hdr}\n{body}\n"
                self.session.post(
                    self._endpoint, content=envelope.encode(),
                    headers={
                        "Content-Type": "application/x-sentry-envelope",
                        "X-Sentry-Auth":
                            f"Sentry sentry_version=7, sentry_key={self._key}",
                    })
                self.sent += 1
            except Exception:  # noqa: BLE001 — telemetry must never break us
                self.dropped += 1


def _iso(ts: float) -> str:
    import datetime as dt

    return dt.datetime.fromtimestamp(ts, dt.timezone.utc).isoformat()


def stats() -> dict:
    w = _worker
    if w is None:
        return {"enabled": False}
    return {"enabled": True, "sent": w.sent, "dropped": w.dropped,
            "deduplicated": w.deduplicated}
