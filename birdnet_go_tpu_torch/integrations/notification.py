"""Notification service: templated webhooks with rate limiting + circuit
breakers (reference: internal/notification — shoutrrr providers, webhooks,
scripts; circuit breaker, rate limiting, burst tracking).

Providers here are generic JSON/text webhooks (covers ntfy, Gotify,
Discord/Slack-compatible endpoints via templates) plus a command runner.

A copy of ``birdnet_go_tpu/integrations/notification.py`` for the port,
which imports nothing of the JAX package; ``tests/test_torch_app.py``
holds it to the original. One divergence: ``NotificationService`` obtains
its HTTP client (the shared client on the port's transport,
``utils/httpclient.py``) at its first webhook, ntfy or push delivery,
where the JAX service builds it in ``__init__``.
"""

from __future__ import annotations

import dataclasses
import logging
import string
import subprocess
import threading
import time
from typing import Any

from birdnet_go_tpu_torch.utils.circuit import CircuitBreaker, CircuitOpenError

log = logging.getLogger("birdnet_tpu.notification")


@dataclasses.dataclass
class NotificationTarget:
    name: str
    kind: str                          # "webhook" | "ntfy" | "command" | "push"
    url: str = ""
    method: str = "POST"
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    # $-templates over the event payload keys, e.g.
    # '{"text": "Detected $common_name ($confidence)"}'
    body_template: str = ""
    command: list[str] = dataclasses.field(default_factory=list)
    min_interval_seconds: float = 0.0   # per-target rate limit


@dataclasses.dataclass
class Notification:
    title: str
    message: str
    priority: str = "normal"           # low|normal|high|critical
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StoredNotification:
    """Inbox entry (reference: notification store backing the CRUD API +
    the notifications SSE stream)."""

    id: int
    title: str
    message: str
    priority: str
    timestamp: float
    read: bool = False
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class NotificationInbox:
    """Bounded notification store (oldest dropped at capacity).

    With `store` (a Datastore), entries write through to the
    `notifications` table and the inbox is rehydrated from the active
    history at startup — the reference persists notification history the
    same way (datastore/interfaces.go SaveNotificationHistory /
    GetActiveNotificationHistory / DeleteExpiredNotificationHistory).
    """

    def __init__(self, capacity: int = 500, store=None,
                 ttl_seconds: float = 7 * 86400.0):
        from collections import OrderedDict

        self.capacity = capacity
        self.store = store
        self.ttl_seconds = ttl_seconds
        self._items: "OrderedDict[int, StoredNotification]" = OrderedDict()
        self._seq = 0
        self._lock = threading.Lock()
        if store is not None:
            self._rehydrate()

    def _rehydrate(self) -> None:
        import json

        try:
            if self.ttl_seconds > 0:
                self.store.delete_expired_notifications(
                    time.time() - self.ttl_seconds)
            for row in self.store.load_notifications(self.capacity):
                try:
                    payload = json.loads(row.get("payload") or "{}")
                except ValueError:
                    payload = {}
                sn = StoredNotification(
                    id=int(row["id"]), title=row["title"],
                    message=row["message"], priority=row["priority"],
                    timestamp=float(row["timestamp"]),
                    read=bool(row["is_read"]), payload=payload)
                self._items[sn.id] = sn
                self._seq = max(self._seq, sn.id)
        except Exception:
            log.exception("notification history rehydrate failed")

    def add(self, n: Notification, now: float | None = None
            ) -> StoredNotification:
        import json

        with self._lock:
            ts = now or time.time()
            payload = dict(n.payload)
            nid = None
            if self.store is not None:
                try:
                    nid = self.store.save_notification(
                        n.title, n.message, n.priority, ts,
                        json.dumps(payload, default=str))
                except Exception:
                    log.exception("notification persist failed")
            if nid is None:
                nid = self._seq + 1
            self._seq = max(self._seq, nid)
            sn = StoredNotification(
                id=nid, title=n.title, message=n.message,
                priority=n.priority, timestamp=ts, payload=payload)
            self._items[sn.id] = sn
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)
            return sn

    def list(self, limit: int = 100, unread_only: bool = False
             ) -> list[dict]:
        with self._lock:
            out = [sn.as_dict() for sn in reversed(self._items.values())
                   if not (unread_only and sn.read)]
            return out[:limit]

    def get(self, nid: int) -> dict | None:
        with self._lock:
            sn = self._items.get(nid)
            return sn.as_dict() if sn else None

    def mark_read(self, nid: int) -> bool:
        with self._lock:
            sn = self._items.get(nid)
            if sn is None:
                return False
            sn.read = True
            self._store_call("set_notification_read", nid, True)
            return True

    def mark_all_read(self) -> int:
        with self._lock:
            n = 0
            for sn in self._items.values():
                if not sn.read:
                    sn.read = True
                    n += 1
            if n:
                self._store_call("set_notification_read", None, True)
            return n

    def delete(self, nid: int) -> bool:
        with self._lock:
            ok = self._items.pop(nid, None) is not None
            if ok:
                self._store_call("delete_notification", nid)
            return ok

    def _store_call(self, method: str, *args) -> None:
        if self.store is None:
            return
        try:
            getattr(self.store, method)(*args)
        except Exception:
            log.exception("notification store %s failed", method)

    def unread_count(self) -> int:
        with self._lock:
            return sum(1 for sn in self._items.values() if not sn.read)


class NotificationService:
    def __init__(self, targets: list[NotificationTarget] | None = None,
                 session=None, burst_limit: int = 20,
                 burst_window_seconds: float = 60.0,
                 inbox: NotificationInbox | None = None,
                 on_stored=None):
        self.targets = targets or []
        # the HTTP client is obtained at the first webhook, ntfy or push
        # delivery (see _client), not here: a service without such a target
        # builds none
        self.session = session
        self._breakers = {t.name: CircuitBreaker() for t in self.targets}
        self._last_sent: dict[str, float] = {}
        self._burst: list[float] = []
        self.burst_limit = burst_limit
        self.burst_window = burst_window_seconds
        self._lock = threading.Lock()
        self.inbox = inbox
        self.on_stored = on_stored          # e.g. SSE broadcast hook
        self.sent = 0
        self.suppressed = 0
        self.failed = 0

    def add_target(self, target: NotificationTarget) -> None:
        self.targets.append(target)
        self._breakers[target.name] = CircuitBreaker()

    def notify(self, n: Notification) -> int:
        """Dispatch to every eligible target; returns delivery count.
        Every notification lands in the inbox (and SSE) even when no
        push target is configured or the burst cap suppresses pushes."""
        if self.inbox is not None:
            stored = self.inbox.add(n)
            if self.on_stored is not None:
                try:
                    self.on_stored(stored)
                except Exception:
                    log.exception("notification store hook failed")
        now = time.monotonic()
        with self._lock:
            # burst/DoS protection: global cap per window
            self._burst = [t for t in self._burst
                           if now - t < self.burst_window]
            if len(self._burst) >= self.burst_limit:
                self.suppressed += 1
                return 0
            self._burst.append(now)
        delivered = 0
        for t in self.targets:
            if t.min_interval_seconds > 0:
                with self._lock:
                    last = self._last_sent.get(t.name)
                    if last is not None and now - last < t.min_interval_seconds:
                        self.suppressed += 1
                        continue
                    self._last_sent[t.name] = now
            if self._send_one(t, n):
                delivered += 1
        return delivered

    def _send_one(self, t: NotificationTarget, n: Notification) -> bool:
        breaker = self._breakers.setdefault(t.name, CircuitBreaker())
        vars_ = {"title": n.title, "message": n.message,
                 "priority": n.priority,
                 **{k: str(v) for k, v in n.payload.items()}}
        try:
            if t.kind == "command":
                cmd = [string.Template(c).safe_substitute(vars_)
                       for c in t.command]
                breaker.call(subprocess.run, cmd, check=True, timeout=30,
                             capture_output=True)
            elif t.kind == "ntfy":
                from birdnet_go_tpu_torch.integrations.push_urls import (
                    _NTFY_PRIORITY,
                )

                # ntfy rejects 'normal'/'critical' — map to its 1-5 scale
                breaker.call(self._post, t.url, n.message.encode(),
                             {"Title": n.title,
                              "Priority": _NTFY_PRIORITY.get(
                                  n.priority, "3"),
                              **t.headers})
            elif t.kind == "push" or "://" in t.url \
                    and not t.url.startswith(("http://", "https://")):
                # shoutrrr-style provider URL (discord://, telegram://, …)
                from birdnet_go_tpu_torch.integrations.push_urls import (
                    build_push_requests,
                )

                for req in build_push_requests(t.url, n.title, n.message,
                                               n.priority):
                    breaker.call(self._post, req.url, req.body,
                                 {**req.headers, **t.headers}, req.method)
            else:                                   # generic webhook
                body = string.Template(
                    t.body_template or '{"title": "$title", '
                    '"message": "$message"}').safe_substitute(vars_)
                breaker.call(self._post, t.url, body.encode(),
                             {"Content-Type": "application/json",
                              **t.headers}, t.method)
            self.sent += 1
            return True
        except CircuitOpenError:
            self.suppressed += 1
            return False
        except Exception as e:  # noqa: BLE001
            self.failed += 1
            log.warning("notification to %s failed: %s", t.name, e)
            return False

    def _client(self):
        """The HTTP session: the one given, else the shared client, built
        at the first delivery that needs it."""
        if self.session is None:
            from birdnet_go_tpu_torch.utils.httpclient import shared_client

            self.session = shared_client()
        return self.session

    def _post(self, url: str, content: bytes, headers: dict,
              method: str = "POST") -> None:
        r = self._client().request(method, url, content=content,
                                   headers=headers)
        r.raise_for_status()
