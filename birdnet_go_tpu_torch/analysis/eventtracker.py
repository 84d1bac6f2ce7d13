"""Per-(species, action) rate limiting + log deduplication.

Reference: internal/analysis/processor/eventtracker.go:16-230 — each action
kind (database save, file log, notification, BirdWeather submit, MQTT
publish, SSE broadcast) has its OWN last-event map per species, so e.g. a
suppressed MQTT publish doesn't suppress the database save. Species keys
are lowercased; per-species interval overrides come from the species
config ("interval" seconds; negative values fall back to the default).
Lookup accepts common OR scientific name (TrackEventWithNames).

LogDeduplicator: internal/analysis/processor/log_deduplicator.go —
high-frequency stats lines log only on first sight, value change, or a
periodic health-check interval.

A copy of ``birdnet_go_tpu/analysis/eventtracker.py`` for the port,
which imports nothing of the JAX package; ``tests/test_torch_app.py``
holds it to the original.
"""

from __future__ import annotations

import threading
import time


class EventType:
    """Action kinds with independent rate-limit state (eventtracker.go:18-25)."""

    DATABASE_SAVE = "database_save"
    LOG_TO_FILE = "log_to_file"
    SEND_NOTIFICATION = "send_notification"
    BIRDWEATHER_SUBMIT = "birdweather_submit"
    MQTT_PUBLISH = "mqtt_publish"
    SSE_BROADCAST = "sse_broadcast"

    ALL = (DATABASE_SAVE, LOG_TO_FILE, SEND_NOTIFICATION,
           BIRDWEATHER_SUBMIT, MQTT_PUBLISH, SSE_BROADCAST)


class EventTracker:
    """Thread-safe per-(event type, species) interval gate."""

    def __init__(self, default_interval_seconds: float = 15.0,
                 species_config: dict[str, dict] | None = None,
                 clock=time.time):
        self.default_interval = default_interval_seconds
        # normalized (lowercased) species config for interval lookups
        self.species_config = {k.lower(): v
                               for k, v in (species_config or {}).items()}
        self.clock = clock
        self._last: dict[str, dict[str, float]] = {t: {}
                                                   for t in EventType.ALL}
        self._lock = threading.Lock()

    def _interval_for(self, common: str, scientific: str) -> float:
        for name in (common, scientific):
            cfg = self.species_config.get(name.lower()) if name else None
            if cfg is not None:
                iv = cfg.get("interval", 0)
                if iv and iv > 0:
                    return float(iv)
                break
        return self.default_interval

    def track(self, event_type: str, common: str = "",
              scientific: str = "", now: float | None = None) -> bool:
        """True (recording the event) if this action may run now
        (TrackEventWithNames). Unknown event types are refused; events with
        no species key at all are always allowed."""
        key = (common or scientific).lower()
        if not key:
            return True
        now = self.clock() if now is None else now
        interval = self._interval_for(common, scientific)
        with self._lock:
            handler = self._last.get(event_type)
            if handler is None:
                return False
            last = handler.get(key)
            if last is not None and now - last < interval:
                return False
            handler[key] = now
            return True

    # Back-compat shim for earlier call sites: (species, action_kind, now).
    def should_act(self, species: str, action_kind: str, now: float) -> bool:
        return self.track(action_kind, common=species, now=now)

    def reset_event(self, species: str, event_type: str) -> None:
        with self._lock:
            h = self._last.get(event_type)
            if h is not None:
                h.pop(species.lower(), None)

    def reset(self) -> None:
        with self._lock:
            for h in self._last.values():
                h.clear()

    def cleanup(self, stale_after_seconds: float = 3600.0,
                now: float | None = None) -> int:
        """Drop entries older than stale_after (bounds map growth)."""
        now = self.clock() if now is None else now
        removed = 0
        with self._lock:
            for h in self._last.values():
                stale = [k for k, t in h.items()
                         if now - t > stale_after_seconds]
                for k in stale:
                    del h[k]
                removed += len(stale)
        return removed


class LogDeduplicator:
    """Suppress repeated identical stats logs; re-log on change or every
    health_check_interval (log_deduplicator.go)."""

    def __init__(self, enabled: bool = True,
                 health_check_interval: float = 60.0, clock=time.time):
        self.enabled = enabled
        self.health_check_interval = health_check_interval or 60.0
        self.clock = clock
        self._states: dict[str, tuple[tuple, float]] = {}
        self._lock = threading.Lock()

    def should_log(self, source: str, *values) -> tuple[bool, str]:
        """(should_log, reason): dedup_disabled | first_log | values_changed
        | health_check | deduplicated."""
        if not self.enabled:
            return True, "dedup_disabled"
        now = self.clock()
        with self._lock:
            st = self._states.get(source)
            if st is None:
                self._states[source] = (values, now)
                return True, "first_log"
            last_values, last_time = st
            if last_values != values:
                self._states[source] = (values, now)
                return True, "values_changed"
            if now - last_time >= self.health_check_interval:
                self._states[source] = (values, now)
                return True, "health_check"
            return False, "deduplicated"
