"""Hot-reload control bus.

Reference: internal/analysis/control_monitor.go:320-349 — a channel of
string signals (reload_birdnet, rebuild_range_filter,
reconfigure_rtsp_sources, ...) that services subscribe to so settings
changes apply live, without restart.

A copy of ``birdnet_go_tpu/config/control.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import enum
import logging
import queue
import threading
from typing import Callable

log = logging.getLogger("birdnet_tpu.control")


class ControlSignal(str, enum.Enum):
    """Full signal set mirroring control_monitor.go:320-360 (names adapted
    to this codebase's vocabulary; the Go names are noted)."""

    RELOAD_MODEL = "reload_model"                       # reload_birdnet
    REBUILD_RANGE_FILTER = "rebuild_range_filter"
    RECONFIGURE_SOURCES = "reconfigure_sources"         # reconfigure_rtsp_sources + reconfigure_audio_sources
    RELOAD_SPECIES_CONFIG = "reload_species_config"
    RELOAD_THRESHOLDS = "reload_thresholds"
    RESTART_SERVER = "restart_server"
    RELOAD_EXPORT = "reload_export"
    RELOAD_PRIVACY = "reload_privacy"
    RECONFIGURE_MQTT = "reconfigure_mqtt"
    RECONFIGURE_BIRDWEATHER = "reconfigure_birdweather"
    RECONFIGURE_WEATHER = "reconfigure_weather"         # reconfigure_ebird analogue slot
    UPDATE_DETECTION_INTERVALS = "update_detection_intervals"
    RECONFIGURE_SOUND_LEVEL = "reconfigure_sound_level"
    RECONFIGURE_SPECIES_TRACKING = "reconfigure_species_tracking"
    RECONFIGURE_NOTIFICATIONS = "reconfigure_notifications"  # reconfigure_push_notifications
    RECONFIGURE_DYNAMIC_THRESHOLDS = "reconfigure_dynamic_thresholds"
    RECALCULATE_DYNAMIC_THRESHOLDS = "recalculate_dynamic_thresholds"
    RECONFIGURE_QUIET_HOURS = "reconfigure_quiet_hours"
    QUIET_HOURS_STOP_SOUNDCARD = "quiet_hours_stop_soundcard"
    QUIET_HOURS_START_SOUNDCARD = "quiet_hours_start_soundcard"
    REBUILD_EXTENDED_CAPTURE = "rebuild_extended_capture"
    RECONFIGURE_TELEMETRY = "reconfigure_telemetry"
    RECONFIGURE_ALERTING = "reconfigure_alerting"


class ControlBus:
    """Fan-out of control signals to registered handlers (thread-safe).

    Handlers run on the bus's dispatcher thread; they must be quick or
    hand off to their own workers (same contract as the reference's
    control monitor goroutine).
    """

    def __init__(self):
        self._handlers: dict[ControlSignal, list[Callable[[], None]]] = {}
        self._queue: queue.Queue[ControlSignal | None] = queue.Queue()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def subscribe(self, signal: ControlSignal,
                  handler: Callable[[], None]) -> None:
        with self._lock:
            self._handlers.setdefault(signal, []).append(handler)

    def send(self, signal: ControlSignal) -> None:
        self._queue.put(signal)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="control-bus",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._queue.put(None)
        self._thread.join(timeout=5)
        self._thread = None

    def _run(self) -> None:
        while True:
            sig = self._queue.get()
            if sig is None:
                return
            with self._lock:
                handlers = list(self._handlers.get(sig, ()))
            for h in handlers:
                try:
                    h()
                except Exception:
                    log.exception("control handler for %s failed", sig)

    def drain_sync(self) -> None:
        """Testing helper: process queued signals on the caller's thread."""
        while True:
            try:
                sig = self._queue.get_nowait()
            except queue.Empty:
                return
            if sig is None:
                return
            with self._lock:
                handlers = list(self._handlers.get(sig, ()))
            for h in handlers:
                h()
