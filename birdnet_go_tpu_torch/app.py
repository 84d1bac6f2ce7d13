"""Application assembly + lifecycle (reference: internal/app service
registry + the four services started in order — BirdNETAnalyzer,
DatabaseService, APIServerService, AudioPipelineService;
internal/analysis/*_service.go).

Startup order mirrors the reference (SURVEY.md §3.1): models/classifiers
first (with range-filter build), then datastore, then API, then the audio
pipeline (sources → engine → device loop → processor → flusher → jobqueue).
Shutdown reverses it.

A copy of ``birdnet_go_tpu/app.py`` for the port, which imports nothing
of the JAX package; ``tests/test_torch_app.py`` holds it to the original.
The app runs on `device`, the CUDA card unless the caller names another,
and raises without one. Where they differ from JAX:

- device work: ``TorchClassifier`` and ``TorchRangeFilter`` on `device`
  (``ShardedClassifier`` over ``make_mesh()`` when the device is CUDA and
  more than one card is visible), ``TorchModelBatcher`` in the loop, the
  ``PreRenderer`` on `device`;
- the API (``api/server.py``, on the standard library's ``asyncio``:
  ``api/web.py``, with its HTTPS, terminal and OIDC, GitHub and
  Cloudflare logins), the image providers, the
  integrations (MQTT, BirdWeather, weather, backup and MySQL, whose HTTP
  goes over the standard library's ``urllib``: ``utils/httpclient.py``)
  and the rtsp, http and audio_card sources (``audio/rtsp.py``,
  ``audio/ffmpeg.py``, ``audio/capture.py``, chosen by JAX's rules: the
  native RTSP client where the source says ``client: native`` or ffmpeg
  is missing, as on the card's machine) are built as in JAX;
- the malloc arena cap goes through the port's native library, which
  raises where it cannot be built (JAX passes silently), and ``setup``
  also caps numpy's OpenBLAS pool at one thread (``utils/blas.py``).
  What JAX logs and continues from (a failed warm-up, prewarm or source
  start) the port logs at ERROR as JAX does, so a caller can count it;
- the threshold-persistence thread binds its stop Event in its closure
  (JAX's re-reads the attribute, which ``stop()`` sets to None);
- ``unload_model_runtime`` serves the windows the model already holds
  (``DeviceLoop.remove_batcher``) where JAX drops them with the batcher;
- FLAC clips are encoded, and decoded for the API, in worker processes
  (``ClipEncoder``), so that the codec does not hold the GIL the served
  step's eager ops take;
- the device loop and the batchers hold the engine's ``SourceGate``
  closed while they tick or launch, so that the source threads do not
  take the GIL at each eager op and ring poll of theirs
  (``audio/engine.py``); a warm-up, at start or at a runtime load, runs
  beside the sources as JAX's does, and holds the gate open: a tick
  waits for it instead of closing the gate beside it.
"""

from __future__ import annotations

import datetime as _dt
import functools
import logging
import threading
import time
from pathlib import Path

import numpy as np
import torch

from birdnet_go_tpu_torch import native

from birdnet_go_tpu_torch.analysis import actions as actions_mod
from birdnet_go_tpu_torch.analysis.jobqueue import JobQueue, RetryConfig
from birdnet_go_tpu_torch.analysis.processor import (
    FlushLoop,
    PendingDetection,
    Processor,
    WindowPrediction,
)
from birdnet_go_tpu_torch.analysis.results import Detection
from birdnet_go_tpu_torch.audio.engine import AudioEngine
from birdnet_go_tpu_torch.audio.sources_file import FileLoopSource, ToneSource
from birdnet_go_tpu_torch.config.control import ControlBus, ControlSignal
from birdnet_go_tpu_torch.config.settings import Settings
from birdnet_go_tpu_torch.datastore.sqlite import Datastore
from birdnet_go_tpu_torch.inference.backend import (
    TorchClassifier,
    TorchRangeFilter,
)
from birdnet_go_tpu_torch.inference.loader import (
    apply_serving_options,
    load_geomodel,
    load_model,
)
from birdnet_go_tpu_torch.models.geomodel import birdnet_week
from birdnet_go_tpu_torch.scheduler.loop import DeviceLoop, TorchModelBatcher
from birdnet_go_tpu_torch.taxonomy.labels import load_labels
from birdnet_go_tpu_torch.utils import errors as errors_mod
from birdnet_go_tpu_torch.utils.blas import set_blas_threads

log = logging.getLogger("birdnet_tpu.app")


class ClipEncoder:
    """Encodes FLAC clips in worker processes, other formats on the
    calling thread; and decodes them there for the API (``decode``).

    The FLAC encoder is Python that holds the GIL for most of the time a
    clip takes to encode, while the served step's eager ops (about a
    thousand a batch for v2.4) each release the GIL and take it back: a
    clip encoded on a job-queue thread makes the tick thread wait at every
    op, and a batch's dispatch grows from 15 ms to seconds (JAX's jitted
    step takes the GIL once a batch). In another process the encoder holds
    no GIL of the app's. The workers are spawned (the app's process holds
    a CUDA context) at the first FLAC clip; ``shutdown`` ends them. As
    with any spawned pool, they import the main module again, so a script
    that runs the app keeps its entry under ``if __name__ ==
    "__main__":``. Encoding is ``encode_clip``'s, so the bytes are the
    same; decoding is ``load_clip_audio``'s (the FLAC decoder is Python
    too: a 6 s clip held the GIL about a second on the card's host)."""

    def __init__(self, workers: int = 2):
        self.workers = workers
        self._pool = None
        self._lock = threading.Lock()

    def _workers(self):
        with self._lock:
            if self._pool is None:
                import concurrent.futures
                import multiprocessing

                self._pool = concurrent.futures.ProcessPoolExecutor(
                    self.workers,
                    mp_context=multiprocessing.get_context("spawn"))
            return self._pool

    def encode(self, pcm_i16: np.ndarray, sample_rate: int,
               out_path: str | Path) -> Path:
        from birdnet_go_tpu_torch.audio.encode import encode_clip

        if Path(out_path).suffix.lower() != ".flac":
            return encode_clip(pcm_i16, sample_rate, out_path)
        return self._workers().submit(encode_clip, pcm_i16, sample_rate,
                                      out_path).result()

    def decode(self, path: str | Path) -> tuple[np.ndarray, int]:
        """A clip's float32 samples and rate, as ``load_clip_audio``
        returns them."""
        from birdnet_go_tpu_torch.audio.encode import load_clip_audio

        if Path(path).suffix.lower() != ".flac":
            return load_clip_audio(path)
        return self._workers().submit(load_clip_audio, path).result()

    def shutdown(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)




class Application:
    """Wires the full realtime stack from Settings."""

    # dynamic-threshold persistence interval (threshold_persistence.go
    # DefaultPersistInterval)
    THRESHOLD_PERSIST_SECONDS = 30.0

    def __init__(self, settings: Settings,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Application on {self.device} needs a CUDA card "
                f"(torch.cuda.is_available() is false); pass device='cpu' "
                f"(serve --device cpu) to run on the CPU")
        self.settings = settings
        self.control = ControlBus()
        self.datastore: Datastore | None = None
        self.engine: AudioEngine | None = None
        self.device_loop: DeviceLoop | None = None
        self.processor: Processor | None = None
        self.flusher: FlushLoop | None = None
        self.jobqueue: JobQueue | None = None
        self.prerenderer = None
        self.api = None
        self.mqtt = None
        self.birdweather = None
        self.weather_poller = None
        self.notifications = None
        self.diskmanager = None
        self.sysmonitor = None
        self.species_tracker = None
        self.watchdog = None
        self.quiet_hours = None
        self._quiet_gate_thread = None
        self._quiet_gate_stop = None
        self._quiet_gated: set[str] = set()   # sources we stopped for quiet
        self.backup = None
        self.alerting = None
        self.events = None
        self.health = None
        self.soundlevel = None
        self.pipeline_stats = None
        # reasons a restart is needed before config changes take effect
        # (internal/restart MarkRestartRequired; /system/restart-status)
        self.restart_required: list[str] = []
        self.classifiers: dict[str, TorchClassifier] = {}
        self.labels = {}
        self._sources: list = []
        self._source_cfgs: dict[str, dict] = {}
        self._range_filter: TorchRangeFilter | None = None
        self.clip_encoder = ClipEncoder()
        self._started = False

    # -- assembly ---------------------------------------------------------------

    def setup(self) -> None:
        s = self.settings
        # WARN+ log records feed the health error ring (/system/errors)
        # even when the app is embedded without the CLI's logging setup
        # (reference wires the slog tee in main.go:139-150)
        import logging as _logging

        from birdnet_go_tpu_torch.utils.health import GLOBAL_ERROR_BUFFER

        root_logger = _logging.getLogger()
        if GLOBAL_ERROR_BUFFER not in root_logger.handlers:
            root_logger.addHandler(GLOBAL_ERROR_BUFFER)
        warnings = s.validate()
        for w in warnings:
            log.warning("config: %s", w)
        self._config_warnings = warnings    # surfaced as notifications
                                            # once the inbox exists
                                            # (main.go:212-227)

        # memory policy (reference: analysis.ApplyMemoryPolicy at serve
        # startup — GOMEMLIMIT + glibc arena cap)
        native.set_malloc_arena_max(2)
        # and a thread policy: numpy's OpenBLAS pool at one thread, or the
        # source threads' resampling products each wake a pool and spin
        # every core (utils/blas.py)
        set_blas_threads(1)

        # 1. models (BirdNETAnalyzer service analogue). With >1 visible
        # card the classifiers shard over a ("data","model") mesh.
        self._mesh = None
        if self.device.type == "cuda" and torch.cuda.device_count() > 1:
            from birdnet_go_tpu_torch.parallel.mesh import make_mesh

            self._mesh = make_mesh()
            log.info("multi-chip serving: mesh %s", dict(self._mesh.shape))
        enabled = [m for m in s.models if m.enabled]
        specs = []
        for ms in enabled:
            try:
                model = load_model(ms.model_id, checkpoint=ms.checkpoint)
            except Exception as e:
                # tag, then fail startup as before — a missing model is
                # fatal here (the reference aborts too) but the operator
                # gets a categorized error in telemetry first
                errors_mod.new(e).component("orchestrator") \
                    .category(errors_mod.Category.MODEL) \
                    .context("model_id", ms.model_id).build()
                raise
            apply_serving_options(model, s.realtime)
            clf = self._make_classifier(model)
            self.classifiers[ms.model_id] = clf
            self.labels[ms.model_id] = load_labels(
                s.data_dir, locale=ms.locale, model_id=ms.model_id,
                expected_count=clf.num_species)
            specs.append(model.spec)

        # range filter (geomodel) — startup build (range_filter.go:100)
        included = None
        if s.range_filter.enabled and s.location.latitude is not None \
                and enabled:
            g = load_geomodel(
                num_species=len(self.labels[enabled[0].model_id]))
            self._range_filter = TorchRangeFilter(g, self.device)
            included = self._compute_included_species()
        elif s.range_filter.enabled and not enabled:
            log.warning("range filter enabled but no models are — skipped")

        # 2. datastore (sqlite default; mysql via the wire-level driver)
        if s.database.type == "mysql":
            from birdnet_go_tpu_torch.datastore.mysql import MySQLDatastore

            self.datastore = MySQLDatastore(
                host=s.database.host, port=s.database.port,
                user=s.database.user, password=s.database.password,
                database=s.database.name)
        else:
            self.datastore = Datastore(s.database.path)
        from birdnet_go_tpu_torch.analysis.species_tracker import SpeciesTracker

        self.species_tracker = SpeciesTracker(self.datastore)

        # species images (dashboard cards + thumbnail endpoint)
        self.images = None
        if s.imageprovider.enabled:
            from birdnet_go_tpu_torch.integrations.imageprovider import (
                AvicommonsProvider,
                ImageProviderService,
                WikipediaProvider,
            )

            providers = []
            for name in s.imageprovider.providers:
                try:
                    if name == "avicommons":
                        providers.append(AvicommonsProvider(
                            dataset_path=s.imageprovider.avicommons_dataset))
                    elif name == "wikimedia":
                        providers.append(WikipediaProvider())
                except Exception:
                    log.exception("image provider %s unavailable", name)
            self.images = ImageProviderService(providers,
                                               datastore=self.datastore)

        # 3. detection engine
        from birdnet_go_tpu_torch.analysis.eventtracker import EventTracker

        self.event_tracker = EventTracker(
            default_interval_seconds=s.realtime.interval_seconds,
            species_config=s.species.config)
        self.jobqueue = JobQueue()
        from birdnet_go_tpu_torch.analysis.spectrogram import PreRenderer

        self.prerenderer = PreRenderer(workers=2, device=self.device)
        self.processor = Processor(
            s, self.labels, on_approved=self._on_approved,
            included_species=included)
        if s.dynamic_threshold.enabled:
            self.processor.dynamic.restore(
                self.datastore.load_dynamic_thresholds())
            # level transitions → threshold_events table (BG-59 analogue)
            self.processor.dynamic.on_event = \
                self.datastore.save_threshold_event
        # pending-detection SSE broadcasts (pending_broadcast.go)
        self.processor.on_pending = lambda snap: (
            self.api.sse.publish("pending", "pending", snap)
            if self.api is not None else None)
        self.flusher = FlushLoop(self.processor)

        # 4. audio pipeline (+ liveness watchdog + quiet hours)
        from birdnet_go_tpu_torch.audio.liveness import (
            LivenessConfig,
            LivenessWatchdog,
            SourceState,
        )
        from birdnet_go_tpu_torch.audio.quiet_hours import QuietHoursScheduler

        self.quiet_hours = QuietHoursScheduler(
            lat=s.location.latitude, lon=s.location.longitude)
        self._apply_quiet_windows()

        def _notify_source(sid: str, state: SourceState) -> None:
            if self.notifications is not None:
                from birdnet_go_tpu_torch.integrations.notification import (
                    Notification,
                )

                self.notifications.notify(Notification(
                    title=f"Audio source {state.value}",
                    message=f"source {sid} entered state {state.value}",
                    priority="high"))

        self.watchdog = LivenessWatchdog(
            LivenessConfig(
                silence_timeout_seconds=s.liveness.silence_timeout_seconds,
                recovery_timeout_seconds=s.liveness.recovery_timeout_seconds,
                max_recovery_attempts=s.liveness.max_recovery_attempts),
            restart=self._restart_source,
            notify=_notify_source,
            is_quiet=self.quiet_hours.is_quiet)
        overlaps = {m.model_id: m.overlap for m in enabled}
        eq = s.audio_filters
        self.engine = AudioEngine(
            specs,
            capture_seconds=s.extended_capture.effective_capture_buffer_seconds(
                s.realtime.capture_buffer_seconds,
                s.export.clip_length_seconds, s.export.pre_capture_seconds),
            overlaps=overlaps, on_ingest=self.watchdog.data_received,
            eq_specs=eq.filters if eq.enabled else None)
        from birdnet_go_tpu_torch.audio.hlsmux import HlsManager

        self.hls = HlsManager(self.engine)
        self.device_loop = DeviceLoop(
            tick_seconds=s.realtime.tick_ms / 1000,
            max_dispatches_per_tick=s.realtime.max_dispatches_per_tick,
            min_tick_seconds=(getattr(s.realtime, "min_tick_ms", 0) or 0)
            / 1000 or None, gate=self.engine.gate)
        for ms in enabled:
            clf = self.classifiers[ms.model_id]
            self.device_loop.add_batcher(TorchModelBatcher(
                clf, max_batch=s.realtime.max_batch,
                sensitivity=ms.sensitivity,
                pipeline_depth=s.realtime.pipeline_depth,
                on_result=functools.partial(self._on_window_result,
                                            ms.model_id),
                gate=self.engine.gate))
        self.device_loop.add_provider(self.engine.collect_ready)

        # 5. API
        if s.webserver.enabled:
            from birdnet_go_tpu_torch.api.server import ApiServer

            self.api = ApiServer(self, host=s.webserver.host,
                                 port=s.webserver.port)

        # 6. integrations — constructed by the same _reconfigure_*
        # handlers the control bus uses, so setup and live reconfigure
        # can't drift (they no-op the .start() parts until _started)
        self._reconfigure_mqtt()
        self._reconfigure_birdweather()
        self._reconfigure_weather()
        from birdnet_go_tpu_torch.integrations.notification import (
            Notification,
            NotificationInbox,
        )

        self.notification_inbox = NotificationInbox(
            store=getattr(self, "datastore", None))
        self._reconfigure_notifications()
        # restore new-species notification suppression from the persisted
        # inbox (species/database.go:511-533 analogue)
        if self.species_tracker is not None:
            for n in self.notification_inbox.list(limit=500):
                sci = (n.get("payload") or {}).get("scientific_name")
                if sci and n.get("title") == "New species detected":
                    self.species_tracker.seed_notified(
                        sci, float(n.get("timestamp") or 0.0))
        # config validation warnings land in the inbox so the UI shows
        # them (reference surfaces them as notifications, main.go:212-227);
        # skip ones already in the (now persistent) inbox so restarts
        # don't accumulate duplicates
        existing = {(n["title"], n["message"])
                    for n in self.notification_inbox.list(limit=500)}
        for w in getattr(self, "_config_warnings", []):
            if ("Configuration warning", w) not in existing:
                self.notification_inbox.add(Notification(
                    title="Configuration warning", message=w,
                    priority="high"))
        self.diskmanager = None
        if s.retention.mode != "none":
            from birdnet_go_tpu_torch.utils.diskmanager import (
                DiskManager,
                RetentionPolicy,
            )

            self.diskmanager = DiskManager(
                s.export.path,
                RetentionPolicy(mode=s.retention.mode,
                                max_age_days=s.retention.max_age_days,
                                max_usage_percent=s.retention.max_usage_percent),
                datastore=self.datastore)

        # telemetry (opt-in, scrubbed; no-op without a DSN)
        from birdnet_go_tpu_torch.utils import telemetry as _telemetry

        _telemetry.configure(s.telemetry.dsn, enabled=s.telemetry.enabled)

        # event bus (detection + error events; alerting and future
        # consumers subscribe — internal/events analogue)
        from birdnet_go_tpu_torch.utils.events import EventBus

        self.events = EventBus()

        # alerting rules engine (detection events → rules → notifications)
        from birdnet_go_tpu_torch.analysis.alerting import AlertingEngine

        self.alerting = AlertingEngine(
            notification_service=self.notifications)
        self._load_alert_rules()

        # system resource monitor → alerting metric rules
        # (internal/monitor: pure collector; thresholds live in rules)
        self.sysmonitor = None
        if s.monitoring.enabled:
            from birdnet_go_tpu_torch.utils.monitor import SystemMonitor

            self.sysmonitor = SystemMonitor(self.alerting, s)

        # backup manager
        if s.backup.enabled:
            from birdnet_go_tpu_torch.utils.backup import (
                BackupConfig,
                BackupManager,
                build_target,
            )

            self.backup = BackupManager(
                BackupConfig(enabled=True, target_dir=s.backup.target_dir,
                             keep=s.backup.keep,
                             interval_hours=s.backup.interval_hours,
                             passphrase=getattr(s.backup, "passphrase", "")),
                db_path=s.database.path,
                target=build_target(s.backup))

        # health check registry (internal/health checks analogue)
        from birdnet_go_tpu_torch.utils.health import CheckResult, HealthRegistry

        self.health = HealthRegistry()

        def _check_database():
            n = self.datastore.count_detections()
            return CheckResult("database", True, f"{n} detections")

        def _check_jobqueue():
            st = self.jobqueue.stats
            ok = st.dropped < max(st.enqueued, 1) * 0.1
            return CheckResult("jobqueue", ok,
                               f"enqueued={st.enqueued} dropped={st.dropped}")

        def _check_streams():
            h = self.engine.stream_health()
            stale = [sid for sid, v in h.items()
                     if v["last_ingest_age_s"] is not None
                     and v["last_ingest_age_s"] >
                     self.settings.liveness.silence_timeout_seconds]
            return CheckResult("streams", not stale,
                               f"{len(h)} sources, stale: {stale}" if stale
                               else f"{len(h)} sources")

        def _check_inference():
            overruns = sum(b.stats.overruns
                           for b in self.device_loop.batchers.values())
            return CheckResult("inference", overruns == 0,
                               f"overruns={overruns}")

        def _check_range_filter():
            inc = self.processor.included_species
            return CheckResult(
                "range_filter", True,
                "inactive" if inc is None else f"{len(inc)} species")

        self.health.register("database", _check_database)
        self.health.register("jobqueue", _check_jobqueue)
        self.health.register("streams", _check_streams)
        self.health.register("inference", _check_inference)
        self.health.register("range_filter", _check_range_filter)

        # control signals (full set — control_monitor.go:320-360)
        self._wire_control_signals()

        # sources from config (same normalized path as live reconfigure)
        self._reconfigure_sources()

    # -- control-signal handlers (hot reload without restart) -----------------------

    def _wire_control_signals(self) -> None:
        c = self.control
        c.subscribe(ControlSignal.REBUILD_RANGE_FILTER,
                    lambda: self.rebuild_range_filter())
        c.subscribe(ControlSignal.RECONFIGURE_SOURCES,
                    self._reconfigure_sources)
        c.subscribe(ControlSignal.RELOAD_MODEL, self._reload_model_settings)
        c.subscribe(ControlSignal.RELOAD_THRESHOLDS,
                    self._reload_model_settings)
        c.subscribe(ControlSignal.RELOAD_SPECIES_CONFIG,
                    self._reload_species_config)
        c.subscribe(ControlSignal.UPDATE_DETECTION_INTERVALS,
                    self._update_detection_intervals)
        c.subscribe(ControlSignal.RECONFIGURE_MQTT, self._reconfigure_mqtt)
        c.subscribe(ControlSignal.RECONFIGURE_BIRDWEATHER,
                    self._reconfigure_birdweather)
        c.subscribe(ControlSignal.RECONFIGURE_WEATHER,
                    self._reconfigure_weather)
        c.subscribe(ControlSignal.RECONFIGURE_NOTIFICATIONS,
                    self._reconfigure_notifications)
        c.subscribe(ControlSignal.RECONFIGURE_SOUND_LEVEL,
                    self._reconfigure_sound_level)
        c.subscribe(ControlSignal.RECONFIGURE_DYNAMIC_THRESHOLDS,
                    self._reconfigure_dynamic_thresholds)
        c.subscribe(ControlSignal.RECALCULATE_DYNAMIC_THRESHOLDS,
                    lambda: self.processor.dynamic.clear())
        c.subscribe(ControlSignal.RECONFIGURE_QUIET_HOURS,
                    self._reconfigure_quiet_hours)
        c.subscribe(ControlSignal.QUIET_HOURS_STOP_SOUNDCARD,
                    lambda: self._gate_soundcards(False))
        c.subscribe(ControlSignal.QUIET_HOURS_START_SOUNDCARD,
                    lambda: self._gate_soundcards(True))
        c.subscribe(ControlSignal.RECONFIGURE_SPECIES_TRACKING,
                    self._reconfigure_species_tracking)
        # extended capture + telemetry: settings objects are shared, the
        # consumers read them per use — signals just log the reload.
        c.subscribe(ControlSignal.REBUILD_EXTENDED_CAPTURE,
                    self._rebuild_extended_capture)
        c.subscribe(ControlSignal.RECONFIGURE_TELEMETRY,
                    self._reconfigure_telemetry)
        c.subscribe(ControlSignal.RECONFIGURE_ALERTING,
                    self._reconfigure_alerting)

    def _reload_model_settings(self) -> None:
        """Apply per-model sensitivity/threshold/overlap changes live."""
        by_id = {m.model_id: m for m in self.settings.models}
        for model_id, batcher in self.device_loop.batchers.items():
            ms = by_id.get(model_id)
            if ms is not None:
                batcher.sensitivity = ms.sensitivity
        self.processor._model_settings = by_id
        log.info("model settings reloaded")

    def _reload_species_config(self) -> None:
        cfg = self.settings.species.config
        self.event_tracker.species_config = {k.lower(): v
                                             for k, v in cfg.items()}
        # include/exclude lists are read per detection from the shared
        # settings; the included set may need a rebuild
        if self._range_filter is not None:
            self.rebuild_range_filter()

    def _update_detection_intervals(self) -> None:
        self.event_tracker.default_interval = \
            self.settings.realtime.interval_seconds
        self._reload_species_config()

    def _reconfigure_mqtt(self) -> None:
        s = self.settings
        if self.mqtt is not None:
            try:
                self.mqtt.stop()
            except Exception:
                pass
            self.mqtt = None
        if s.mqtt.enabled:
            from birdnet_go_tpu_torch.integrations.mqtt import MqttClient

            self.mqtt = MqttClient(
                s.mqtt.host, s.mqtt.port, client_id="birdnet-tpu",
                username=s.mqtt.username, password=s.mqtt.password,
                tls=s.mqtt.tls)
            if self._started:
                self.mqtt.start()
        log.info("mqtt reconfigured (enabled=%s)", s.mqtt.enabled)

    def _reconfigure_birdweather(self) -> None:
        s = self.settings
        self.birdweather = None
        if s.birdweather.enabled and s.birdweather.station_token:
            from birdnet_go_tpu_torch.integrations.birdweather import (
                BirdWeatherClient,
                BirdWeatherConfig,
            )

            self.birdweather = BirdWeatherClient(BirdWeatherConfig(
                station_token=s.birdweather.station_token,
                latitude=s.location.latitude,
                longitude=s.location.longitude))
        log.info("birdweather reconfigured (enabled=%s)",
                 s.birdweather.enabled)

    def _reconfigure_weather(self) -> None:
        s = self.settings
        if self.weather_poller is not None:
            self.weather_poller.stop()
            self.weather_poller = None
        if s.weather.provider != "none" and s.location.latitude is not None:
            from birdnet_go_tpu_torch.integrations.weather import (
                OpenWeatherProvider,
                WeatherPoller,
                YrNoProvider,
            )

            if s.weather.provider == "openweather" \
                    and s.weather.openweather_api_key:
                provider = OpenWeatherProvider(
                    s.location.latitude, s.location.longitude,
                    s.weather.openweather_api_key)
            elif s.weather.provider == "wunderground" \
                    and s.weather.wunderground_api_key:
                from birdnet_go_tpu_torch.integrations.weather import (
                    WundergroundProvider,
                )

                provider = WundergroundProvider(
                    s.weather.wunderground_station_id,
                    s.weather.wunderground_api_key)
            else:
                provider = YrNoProvider(s.location.latitude,
                                        s.location.longitude)
            self.weather_poller = WeatherPoller(
                provider, self.datastore,
                interval_seconds=s.weather.poll_interval_hours * 3600)
            if self._started:
                self.weather_poller.start()
        log.info("weather reconfigured (provider=%s)", s.weather.provider)

    def _reconfigure_notifications(self) -> None:
        from birdnet_go_tpu_torch.integrations.notification import (
            NotificationService,
            NotificationTarget,
        )

        # the inbox survives reconfiguration (history is user data)
        self.notifications = NotificationService(
            [NotificationTarget(**t)
             for t in self.settings.notification.targets],
            inbox=self.notification_inbox,
            on_stored=self._on_notification_stored)
        # re-wire every holder of the old service: the alerting engine
        # captured it at construction and would otherwise keep delivering
        # to the removed targets until process restart
        if self.alerting is not None:
            self.alerting.notifications = self.notifications
        log.info("notifications reconfigured (%d targets)",
                 len(self.settings.notification.targets))

    def _on_notification_stored(self, stored) -> None:
        """Inbox entry → notifications SSE channel (reference:
        GET /notifications/stream)."""
        if self.api is not None:
            self.api.sse.publish("notifications", "notification",
                                 stored.as_dict())

    def _rebuild_extended_capture(self) -> None:
        """REBUILD_EXTENDED_CAPTURE: re-resolve the species filter and log
        the new ring requirement (a larger ring needs a restart — the
        capture buffers were sized at setup)."""
        if self.processor is not None:
            self.processor.rebuild_extended_capture()
            self.processor.rebuild_daylight_filter()
        s = self.settings
        need = s.extended_capture.effective_capture_buffer_seconds(
            s.realtime.capture_buffer_seconds,
            s.export.clip_length_seconds, s.export.pre_capture_seconds)
        if self.engine is not None and need > self.engine.capture_seconds:
            self.restart_required.append(
                "extended-capture ring size increase")
            log.warning("extended capture needs a %ds ring; restart "
                        "required to resize capture buffers", int(need))
        log.info("extended capture settings reloaded")

    def _reconfigure_sound_level(self) -> None:
        s = self.settings
        if self.soundlevel is not None:
            self.soundlevel.stop()
            self.soundlevel = None
        if s.soundlevel.enabled and self._started \
                and (self.api is not None or self.mqtt is not None):
            from birdnet_go_tpu_torch.analysis.soundlevel_worker import (
                SoundLevelWorker,
            )

            self.soundlevel = SoundLevelWorker(
                self.engine, sse=self.api.sse if self.api else None,
                mqtt=self.mqtt, mqtt_topic=s.mqtt.topic,
                interval_seconds=s.soundlevel.interval_seconds,
                device=self.device)
            self.soundlevel.start()
        log.info("sound level publication reconfigured (enabled=%s)",
                 s.soundlevel.enabled)

    def _reconfigure_dynamic_thresholds(self) -> None:
        dt = self.settings.dynamic_threshold
        dyn = self.processor.dynamic
        dyn.trigger = dt.trigger
        dyn.floor = dt.min
        dyn.valid_seconds = dt.valid_hours * 3600.0
        log.info("dynamic thresholds reconfigured (trigger=%.2f)",
                 dt.trigger)

    def _reconfigure_telemetry(self) -> None:
        from birdnet_go_tpu_torch.utils import telemetry

        t = self.settings.telemetry
        telemetry.configure(t.dsn, enabled=t.enabled)
        log.info("telemetry reconfigured (enabled=%s)", t.enabled)

    def _load_alert_rules(self) -> None:
        """(Re)build the live AlertingEngine rule set from settings —
        startup and the PATCH /settings/alerting hot-reload path."""
        from birdnet_go_tpu_torch.analysis.alerting import AlertRule

        rules = []
        for i, r in enumerate(self.settings.alerting.rules):
            rid = r.get("rule_id", f"rule{i}")
            kwargs = {k: v for k, v in r.items() if k != "rule_id"}
            kwargs.setdefault("name", rid)     # display name optional
            try:
                rules.append(AlertRule(rule_id=rid, **kwargs))
            except TypeError as e:
                log.warning("invalid alert rule %d: %s", i, e)
        if self.alerting is not None:
            self.alerting.replace_rules(rules)

    def _reconfigure_alerting(self) -> None:
        self._load_alert_rules()
        n = len(self.alerting.list_rules()) if self.alerting else 0
        log.info("alerting reconfigured (%d rules)", n)

    def _apply_quiet_windows(self) -> None:
        """Populate the scheduler from config: realtime.quiet_hours applies
        to every source, plus each source dict's own "quiet_hours" key
        (quiet_hours.go per-source windows). Malformed windows log and are
        skipped so one bad entry can't take down a reconfigure."""
        from birdnet_go_tpu_torch.audio.quiet_hours import parse_windows

        s = self.settings
        try:
            global_wins = parse_windows(s.realtime.quiet_hours)
        except ValueError:
            log.exception("bad realtime.quiet_hours config")
            global_wins = []
        for i, cfg in enumerate(s.realtime.sources):
            sid = cfg.get("id") or f"{cfg.get('type', 'file')}{i}"
            try:
                wins = global_wins + parse_windows(cfg.get("quiet_hours"))
            except ValueError:
                log.exception("bad quiet_hours on source %s", sid)
                wins = list(global_wins)
            self.quiet_hours.set_windows(sid, wins)

    def _reconfigure_quiet_hours(self) -> None:
        from birdnet_go_tpu_torch.audio.quiet_hours import QuietHoursScheduler

        s = self.settings
        self.quiet_hours = QuietHoursScheduler(
            lat=s.location.latitude, lon=s.location.longitude)
        self._apply_quiet_windows()
        if self.watchdog is not None:
            self.watchdog.is_quiet = self.quiet_hours.is_quiet
        self._apply_quiet_gates()
        # windows may appear/disappear at runtime: manage the gate thread
        if self.quiet_hours.has_windows():
            if self._started and self._quiet_gate_thread is None:
                self._start_quiet_gate()
        elif self._quiet_gate_stop is not None:
            self._quiet_gate_stop.set()
            self._quiet_gate_thread = None
            self._quiet_gate_stop = None
        log.info("quiet hours reconfigured")

    def _gate_soundcards(self, start: bool) -> None:
        """Manual quiet-hours override (QUIET_HOURS_*_SOUNDCARD signals):
        stop/start ALL soundcard sources now."""
        for src in self._sources:
            if getattr(src, "source", None) is not None \
                    and src.source.source_type.value == "audio_card":
                try:
                    (src.start if start else src.stop)()
                except Exception:
                    log.exception("soundcard gate failed")

    def _apply_quiet_gates(self) -> None:
        """Automatic quiet-hours capture gating: stop each soundcard source
        whose windows say quiet-now, restart it when the window ends
        (quiet_hours.go gates capture per source; the liveness watchdog
        already treats the gap as expected silence via is_quiet)."""
        if self.quiet_hours is None:
            return
        for src in list(self._sources):
            if getattr(src, "source", None) is None \
                    or src.source.source_type.value != "audio_card":
                continue
            sid = src.source.source_id
            quiet = self.quiet_hours.is_quiet(sid)
            try:
                if quiet and sid not in self._quiet_gated:
                    log.info("quiet hours: stopping capture on %s", sid)
                    src.stop()
                    self._quiet_gated.add(sid)
                elif not quiet and sid in self._quiet_gated:
                    log.info("quiet hours: resuming capture on %s", sid)
                    src.start()
                    self._quiet_gated.discard(sid)
            except Exception:
                log.exception("quiet gate failed for %s", sid)

    def _start_quiet_gate(self, interval_seconds: float = 30.0) -> None:
        import threading

        if self._quiet_gate_thread is not None \
                and self._quiet_gate_thread.is_alive():
            return                        # never two evaluators
        stop = threading.Event()
        self._quiet_gate_stop = stop

        def run() -> None:
            # own a local Event: reconfigure may replace/None the
            # attribute while this thread is mid-iteration
            while not stop.wait(interval_seconds):
                self._apply_quiet_gates()

        self._quiet_gate_thread = threading.Thread(
            target=run, name="quiet-gate", daemon=True)
        self._quiet_gate_thread.start()

    def _reconfigure_species_tracking(self) -> None:
        from birdnet_go_tpu_torch.analysis.species_tracker import SpeciesTracker

        self.species_tracker = SpeciesTracker(self.datastore)
        log.info("species tracking reconfigured")

    def _reconfigure_sources(self) -> None:
        """Live source reconfigure: diff config against running sources,
        stop removed/changed ones, start added ones (reference:
        reconfigure_rtsp_sources / reconfigure_audio_sources)."""
        want: dict[str, dict] = {}
        for i, cfg in enumerate(self.settings.realtime.sources):
            sid = cfg.get("id") or f"{cfg.get('type', 'file')}{i}"
            want[sid] = dict(cfg, id=sid)
        have = dict(self._source_cfgs)
        for sid, cfg in have.items():
            if sid not in want or want[sid] != cfg:
                self._remove_source(sid)
        for sid, cfg in want.items():
            if sid not in self._source_cfgs:
                src = self._add_source_from_config(cfg)
                if src is not None and self._started:
                    src.start()
                    if self.watchdog is not None \
                            and self.settings.liveness.enabled:
                        self.watchdog.track(src.source.source_id)
        if self.quiet_hours is not None:
            self._apply_quiet_windows()       # new ids need their windows
        log.info("sources reconfigured: %d running",
                 len(self._source_cfgs))

    def _remove_source(self, source_id: str) -> None:
        for src in list(self._sources):
            if getattr(src, "source", None) is not None \
                    and src.source.source_id == source_id:
                try:
                    src.stop()
                except Exception:
                    pass
                self._sources.remove(src)
        self._source_cfgs.pop(source_id, None)
        # a gated source that is being removed must not leave a stale
        # gate entry behind (a re-added source would capture straight
        # through its quiet window, then get a duplicate start())
        self._quiet_gated.discard(source_id)
        if self.engine is not None:
            self.engine.remove_source(source_id)
        if self.watchdog is not None:
            try:
                self.watchdog.untrack(source_id)
            except Exception:
                pass

    def _make_classifier(self, model):
        if self._mesh is not None:
            from birdnet_go_tpu_torch.parallel.serving import ShardedClassifier

            return ShardedClassifier(model, mesh=self._mesh)
        return TorchClassifier(model, self.device)

    # -- runtime model management (orchestrator LoadModel/UnloadModel) --------------

    def load_model_runtime(self, model_id: str,
                           checkpoint: str | None = None) -> bool:
        """Load + register a model while serving (orchestrator.go:1578)."""
        from birdnet_go_tpu_torch.config.settings import ModelSettings

        if model_id in self.classifiers:
            return False
        model = load_model(model_id, checkpoint=checkpoint)
        apply_serving_options(model, self.settings.realtime)
        clf = self._make_classifier(model)
        self.classifiers[model_id] = clf
        ms = next((m for m in self.settings.models
                   if m.model_id == model_id), None)
        if ms is None:
            ms = ModelSettings(model_id=model_id)
            self.settings.models.append(ms)
        # honor the model's configured locale, exactly like startup
        self.labels[model_id] = load_labels(
            self.settings.data_dir, model_id=model_id,
            locale=ms.locale, expected_count=clf.num_species)
        self.processor.labels_by_model[model_id] = self.labels[model_id]
        self.processor._model_settings[model_id] = ms
        # filter entries may resolve only against the NEW model's labels
        # (reference re-resolves against the orchestrator's label union)
        self.processor.rebuild_extended_capture()
        self.processor.rebuild_daylight_filter()
        batcher = TorchModelBatcher(
            clf, max_batch=self.settings.realtime.max_batch,
            sensitivity=ms.sensitivity,
            pipeline_depth=self.settings.realtime.pipeline_depth,
            on_result=functools.partial(self._on_window_result, model_id),
            gate=self.engine.gate)
        # Warm up BEFORE the batcher joins the device loop, so the first
        # real dispatch never stalls the tick thread (a first call builds
        # the kernels and tunes cuDNN) and starves the other models
        # (reference defers warm-up the same way — orchestrator.go
        # LoadModel). It runs on this thread while the tick thread serves.
        try:
            batcher.warmup()
        except Exception as e:
            errors_mod.new(e).component("orchestrator") \
                .category(errors_mod.Category.MODEL) \
                .context("model_id", model_id) \
                .context("during", "runtime warmup").build()
        self.device_loop.add_batcher(batcher)
        # Rewire existing streams last: every live source gets a resampler +
        # AnalysisBuffer tap for the new spec (buffer_manager UpdateMonitors
        # analogue) — without this the model would never receive windows.
        if self.engine is not None:
            # register the configured per-model overlap BEFORE the taps
            # are built, or the new model falls back to the 50% default
            # hop unlike the same model enabled at startup
            if ms.overlap:
                self.engine.overlaps[model_id] = ms.overlap
            self.engine.add_model(model.spec)
        log.info("model %s loaded at runtime", model_id)
        return True

    def unload_model_runtime(self, model_id: str) -> bool:
        """Unregister a model while serving (orchestrator.go:1689). The
        engine stops making its windows first; then the device loop hands
        over its batcher with what it holds, which is served here
        (``DeviceLoop.remove_batcher``; JAX drops the batcher and those
        windows with it)."""
        if model_id not in self.classifiers:
            return False
        if self.engine is not None:
            self.engine.remove_model(model_id)
        self.device_loop.remove_batcher(model_id)
        self.classifiers.pop(model_id, None)
        # labels stay for any pending detections still flushing
        log.info("model %s unloaded", model_id)
        return True

    def _restart_source(self, source_id: str) -> None:
        """Tiered recovery callback: stop/start the matching source."""
        for src in self._sources:
            if getattr(src, "source", None) is not None \
                    and src.source.source_id == source_id:
                log.info("watchdog restarting source %s", source_id)
                try:
                    src.stop()
                finally:
                    src.start()
                return

    def _add_source_from_config(self, cfg: dict) -> None:
        stype = cfg.get("type", "file")
        # a malformed entry must not abort startup or leave a live
        # reconfigure half-applied — skip it with a log instead
        if stype == "file" and not cfg.get("path"):
            log.warning("file source %r missing 'path': skipped",
                        cfg.get("id", "?"))
            return None
        if stype in ("rtsp", "http") and not cfg.get("url"):
            log.warning("%s source %r missing 'url': skipped", stype,
                        cfg.get("id", "?"))
            return None
        if stype == "file":
            src = FileLoopSource(self.engine, cfg["path"],
                                 source_id=cfg.get("id"),
                                 speed=float(cfg.get("speed", 1.0)))
        elif stype == "tone":
            src = ToneSource(self.engine, source_id=cfg.get("id", "tone0"),
                             freq_hz=float(cfg.get("freq", 1000.0)),
                             rate=int(cfg.get("rate", 48000)),
                             pulse_hz=float(cfg.get("pulse", 0.0)),
                             speed=float(cfg.get("speed", 1.0)))
        elif stype in ("rtsp", "http"):
            from birdnet_go_tpu_torch.audio.ffmpeg import (
                FfmpegSource,
                ffmpeg_available,
            )

            if stype == "rtsp" and (cfg.get("client") == "native"
                                    or not ffmpeg_available()):
                # native RTSP/RTP client: uncompressed + G.711 audio works
                # without the ffmpeg binary (audio/rtsp.py)
                from birdnet_go_tpu_torch.audio.rtsp import RtspSource

                src = RtspSource(self.engine, cfg["url"],
                                 source_id=cfg.get("id"))
            else:
                src = FfmpegSource(self.engine, cfg["url"],
                                   source_id=cfg.get("id"),
                                   transport=cfg.get("transport", "tcp"))
        elif stype == "audio_card":
            from birdnet_go_tpu_torch.audio.capture import SoundcardSource

            src = SoundcardSource(self.engine,
                                  device=cfg.get("device", "default"),
                                  source_id=cfg.get("id"),
                                  rate=int(cfg.get("rate", 48000)),
                                  channels=int(cfg.get("channels", 1)))
        else:
            log.warning("unknown source type %r", stype)
            return None
        self._sources.append(src)
        self._source_cfgs[src.source.source_id] = dict(
            cfg, id=src.source.source_id)
        return src

    # -- lifecycle -----------------------------------------------------------------

    def start(self, warmup: bool = True) -> None:
        self._started = True
        self.control.start()
        self.jobqueue.start()
        self.prerenderer.start()
        self.flusher.start()
        # Periodic dynamic-threshold persistence (reference
        # threshold_persistence.go DefaultPersistInterval = 30 s): a
        # crash must lose at most one interval of learned thresholds,
        # not everything since boot (shutdown-only persistence did).
        if self.settings.dynamic_threshold.enabled:
            # the thread owns its Event: stop() sets it and then drops the
            # attribute, which the thread must not re-read (JAX's does,
            # and dies on None between iterations)
            stop = self._threshold_persist_stop = threading.Event()

            def _persist_loop() -> None:
                while not stop.wait(self.THRESHOLD_PERSIST_SECONDS):
                    try:
                        self.datastore.save_dynamic_thresholds(
                            self.processor.dynamic.snapshot())
                    except Exception:
                        log.exception("threshold persistence failed")

            self._threshold_persist_thread = threading.Thread(
                target=_persist_loop, name="threshold-persist",
                daemon=True)
            self._threshold_persist_thread.start()
        # Always prewarm the processor's fast gates + lazy taxonomy tables
        # (cheap vs the device warm-up; skipping it stalls the first harvested
        # batch for seconds on large label sets — see Processor.prewarm).
        try:
            self.processor.prewarm()
        except Exception:
            log.exception("processor prewarm failed")
        if warmup:
            # Run every model's device step once so the tick loop never
            # stalls on first dispatch: the first call builds the kernels
            # (ops/_build.py) and tunes cuDNN.
            for b in self.device_loop.batchers.values():
                try:
                    b.warmup()
                except Exception:
                    log.exception("warmup failed for %s", b.spec.model_id)
        self.device_loop.start()
        if self.mqtt is not None:
            self.mqtt.start()
            if self.settings.mqtt.ha_discovery:
                from birdnet_go_tpu_torch.integrations.mqtt import (
                    ha_discovery_payloads,
                )

                if self.mqtt.wait_connected(5):
                    for topic, cfg in ha_discovery_payloads(
                            self.settings.mqtt.topic).items():
                        self.mqtt.publish(topic, cfg, retain=True)
        if self.weather_poller is not None:
            self.weather_poller.start()
        if self.sysmonitor is not None:
            self.sysmonitor.start()
        if self.diskmanager is not None:
            self.diskmanager.start(
                self.settings.retention.check_interval_hours * 3600)
        if self.api is not None:
            self.api.start()
        for src in self._sources:
            try:
                src.start()
            except Exception as e:
                # degrade per source (one unopenable soundcard must not
                # abort a half-started app); tagged → error ring/telemetry
                sid = getattr(getattr(src, "source", None),
                              "source_id", "?")
                errors_mod.new(e).component("audio-capture") \
                    .category(errors_mod.Category.AUDIO) \
                    .context("source_id", sid) \
                    .context("during", "source start").build()
            if self.watchdog is not None and self.settings.liveness.enabled:
                self.watchdog.track(src.source.source_id)
        if self.watchdog is not None and self.settings.liveness.enabled:
            self.watchdog.start(self.settings.liveness.check_interval_seconds)
        # quiet-hours capture gating (only worth a thread when any source
        # actually has windows); gate once immediately so a start inside a
        # quiet window doesn't capture until the first tick
        if self.quiet_hours is not None and self.quiet_hours.has_windows():
            self._apply_quiet_gates()
            self._start_quiet_gate()
        if self.backup is not None:
            self.backup.start()
        # rolling resource samples for the System page charts
        from birdnet_go_tpu_torch.utils.sysmonitor import MetricsHistory

        self.metrics_history = MetricsHistory(
            clip_dir=self.settings.export.path)
        self.metrics_history.start()
        self._reconfigure_sound_level()
        from birdnet_go_tpu_torch.analysis.pipeline_stats import PipelineStatsLogger

        self.pipeline_stats = PipelineStatsLogger(self.device_loop,
                                                  self.processor)
        self.pipeline_stats.start()
        log.info("application started: %d model(s), %d source(s)",
                 len(self.classifiers), len(self._sources))

    def stop(self) -> None:
        self._started = False
        if getattr(self, "pipeline_stats", None) is not None:
            self.pipeline_stats.stop()
        if getattr(self, "hls", None) is not None:
            self.hls.stop()
        if self.soundlevel is not None:
            self.soundlevel.stop()
        if self.watchdog is not None:
            self.watchdog.stop()
        if self._quiet_gate_stop is not None:
            self._quiet_gate_stop.set()
            self._quiet_gate_thread = None
            self._quiet_gate_stop = None
        if getattr(self, "metrics_history", None) is not None:
            self.metrics_history.stop()
        if self.backup is not None:
            self.backup.stop()
        for src in self._sources:
            try:
                src.stop()
            except Exception:
                # one wedged source must not abort the rest of shutdown
                # (final flush, threshold persistence, datastore close)
                log.exception("source %s stop failed",
                              getattr(getattr(src, "source", None),
                                      "source_id", "?"))
        self.device_loop.stop()
        self.flusher.stop()
        if getattr(self, "_threshold_persist_stop", None) is not None:
            self._threshold_persist_stop.set()
            self._threshold_persist_thread.join(timeout=5)
            self._threshold_persist_thread = None
            self._threshold_persist_stop = None
        self.processor.flush(now=time.time() + 1e6)   # final drain
        if self.settings.dynamic_threshold.enabled and self.datastore:
            self.datastore.save_dynamic_thresholds(
                self.processor.dynamic.snapshot())
        self.jobqueue.stop()
        self.clip_encoder.shutdown()
        self.prerenderer.stop()
        if self.events is not None:
            self.events.stop()
        if self.mqtt is not None:
            self.mqtt.stop()
        if self.weather_poller is not None:
            self.weather_poller.stop()
        if self.sysmonitor is not None:
            self.sysmonitor.stop()
        if self.diskmanager is not None:
            self.diskmanager.stop()
        if self.api is not None:
            self.api.stop()
        self.control.stop()
        if self.datastore is not None:
            self.datastore.close()
        log.info("application stopped")

    # -- pipeline callbacks ------------------------------------------------------------

    def _on_window_result(self, model_id: str, w, vals: np.ndarray,
                          idx: np.ndarray) -> None:
        """Device loop → processor (the ResultsQueue hand-off); bound
        per-batcher so the window carries its model identity."""
        self.processor.submit(WindowPrediction(
            source_id=w.source_id,
            model_id=model_id,
            start_time=w.start_time, end_time=w.end_time,
            indices=[int(i) for i in idx],
            confidences=[float(v) for v in vals],
            pcm=w.pcm, pcm_rate=w.pcm_rate,
            ultrasonic_cv=w.ultrasonic_cv))

    def _custom_species_actions(self, d: Detection
                                ) -> tuple[list, bool, bool]:
        """(actions, run_defaults, has_custom) — per-species custom
        actions from the species config (getActionsForItem analogue:
        custom actions replace the defaults unless any entry sets
        execute_defaults; a BROKEN ExecuteCommand with
        execute_defaults=false must NOT silently restore the defaults,
        processor.go:1899-1930)."""
        from birdnet_go_tpu_torch.analysis.processor import Processor

        cfg = self.settings.species.config or {}
        cfg_l = {k.lower(): v for k, v in cfg.items()} if cfg else {}
        sc = None
        # same resolution chain as the threshold lookup: scientific,
        # label, common, legacy taxonomy aliases (processor._name_variants)
        for name in Processor._name_variants(d.species):
            sc = cfg.get(name) or cfg_l.get(name.lower())
            if sc:
                break
        entries = (sc or {}).get("actions") or []
        if not entries:
            return [], True, False
        actions: list = []
        run_defaults = False
        broken_skipped = False
        for e in entries:
            if e.get("execute_defaults"):
                run_defaults = True
            if str(e.get("type", "")).lower() != "executecommand":
                # unimplemented action types fall through to the default
                # set — they must not flip the "custom only" intent
                continue
            act = actions_mod.ExecuteCommandAction(
                command=e.get("command", ""),
                params=self._command_params(e.get("parameters") or [], d))
            err = act.validate()
            if err:
                log.warning("custom command for %s skipped: %s",
                            d.species.scientific, err)
                broken_skipped = True
                continue
            actions.append(act)
        if not actions and not broken_skipped:
            # only unimplemented types configured: defaults keep flowing
            return [], True, True
        if not actions and broken_skipped and not run_defaults:
            # user opted out of defaults and their script is broken —
            # honor the opt-out (no silent DB/SSE/MQTT fallback)
            return [], False, True
        return actions, run_defaults, True

    @staticmethod
    def _command_params(names: list, d: Detection) -> dict:
        when = d.timestamp or _dt.datetime.now()
        values = {
            "CommonName": d.species.common,
            "ScientificName": d.species.scientific,
            "Confidence": d.confidence * 100.0,   # 0-100 (execute.go)
            "Time": when.strftime("%H:%M:%S"),
            "Date": when.strftime("%Y-%m-%d"),
            "Source": d.source_id,
            "ModelID": d.model_id,
        }
        return {n: values.get(n, "") for n in names}

    def _on_approved(self, d: Detection, item: PendingDetection) -> None:
        """Build + enqueue the action chain (getDefaultActions analogue).

        Every action kind is gated by its OWN per-species interval in the
        event tracker (eventtracker.go TrackEvent) — a suppressed MQTT
        publish must not suppress the database save and vice versa."""
        from birdnet_go_tpu_torch.analysis.eventtracker import EventType

        s = self.settings
        tr = self.event_tracker
        common, sci = d.species.common, d.species.scientific
        # per-species custom actions (ExecuteCommand) may replace the
        # default chain entirely
        custom, run_defaults, has_custom = self._custom_species_actions(d)
        for act in custom:
            self.jobqueue.enqueue(
                act.execute, f"command {d.species.common}",
                retry=RetryConfig(enabled=False), category="command")
        if has_custom and not run_defaults:
            return
        labels = self.labels.get(d.model_id)
        if labels is not None and not d.species_code:
            d.species_code = labels.code_for(d.species)

        chain: list = []
        if tr.track(EventType.LOG_TO_FILE, common, sci):
            chain.append(actions_mod.LogAction(d))
        # the database gate decides ONCE: a suppressed save must not leave
        # orphan clip/PNG files on disk either (the reference ties clip
        # export to the database action)
        db_allowed = tr.track(EventType.DATABASE_SAVE, common, sci)
        clip_name = None
        if db_allowed and s.export.enabled and self.engine is not None:
            cb = self.engine.capture_buffer(d.source_id)
            if cb is not None:
                # name the clip with the suffix the encoder will REALLY
                # produce (aac→.m4a; lossy→flac fallback without ffmpeg)
                from birdnet_go_tpu_torch.audio.encode import resolve_format

                # bird detections captured through a shared high-rate
                # (bat-microphone) source downsample to 48 kHz for export;
                # raw-rate (bat) model detections keep the native rate so
                # the echolocation content survives (export.go)
                spec = next((sp for sp in self.engine.specs
                             if sp.model_id == d.model_id), None)
                is_raw_rate = bool(spec and spec.raw_sample_rate)
                export_rate = cb.sample_rate
                downsample_to = 0
                if not is_raw_rate and cb.sample_rate > 48000:
                    downsample_to = export_rate = 48000
                _, suffix = resolve_format(s.export.format, export_rate)
                clip_start = d.begin_seconds - s.export.pre_capture_seconds
                if item.extended:
                    # one clip spanning the whole calling session
                    # (normalizeDetectionTimes: end = last hit + window)
                    clip_end = d.end_seconds
                else:
                    clip_end = clip_start + s.export.clip_length_seconds
                clip_name = actions_mod.clip_filename(
                    d, suffix.lstrip("."),
                    # duration suffix marks session clips
                    # (generateClipNameWithDuration)
                    duration_seconds=(int(round(clip_end - clip_start))
                                      if item.extended else 0))
                self.jobqueue.enqueue(
                    actions_mod.SaveAudioAction(
                        capture_buffer=cb, start_time=clip_start,
                        end_time=clip_end,
                        out_path=Path(s.export.path) / clip_name,
                        sample_rate=cb.sample_rate,
                        fallback_pcm=item.pcm,
                        fallback_rate=item.pcm_rate,
                        downsample_to=downsample_to,
                        gain_db=s.export.gain_db,
                        normalization=s.export.normalization,
                        encoder=self.clip_encoder.encode).execute,
                    f"save clip {clip_name}",
                    retry=RetryConfig(enabled=True, max_retries=10,
                                      initial_delay=1.0, max_delay=10.0),
                    category="clip")
                # spectrogram pre-render from the same wall-clock span
                # (reference: DatabaseAction → PreRenderer.Submit); the
                # PNG mirrors the clip's year/month subpath
                png_name = str(Path(clip_name).with_suffix(".png"))
                self.jobqueue.enqueue(
                    functools.partial(self._prerender_clip, cb, clip_start,
                                      clip_end, Path(s.export.path) / png_name),
                    f"prerender {png_name}",
                    retry=RetryConfig(enabled=True, max_retries=10,
                                      initial_delay=1.0, max_delay=10.0),
                    category="spectrogram")

        payload = {
            "scientific_name": d.species.scientific,
            "common_name": d.species.common,
            "confidence": d.confidence,
            "model_id": d.model_id,
            "source_id": d.source_id,
            "timestamp": d.timestamp,
            "clip_name": clip_name,
        }

        # DB → SSE → MQTT ordering (CompositeAction contract): the
        # broadcast payloads carry the DB-assigned id. SSE/MQTT have their
        # own per-species gates.
        def _broadcast(det_id: int) -> None:
            msg = {"id": det_id, **payload}
            if self.api is not None \
                    and tr.track(EventType.SSE_BROADCAST, common, sci):
                self.api.sse.publish("detections", "detection", msg)
            if self.mqtt is not None \
                    and tr.track(EventType.MQTT_PUBLISH, common, sci):
                self.mqtt.publish(
                    f"{s.mqtt.topic}/detections", msg,
                    retain=s.mqtt.retain)
            if self.events is not None:
                from birdnet_go_tpu_torch.utils.events import Event

                self.events.publish(Event("detection", msg))

        if db_allowed:
            chain.append(actions_mod.DatabaseAction(
                d, self.datastore, contributions=item.contributions,
                clip_name=clip_name, results=item.topk,
                on_saved=_broadcast))
        if chain:
            self.jobqueue.enqueue(
                actions_mod.CompositeAction(chain,
                                            f"detection {d.label}").execute,
                f"composite {d.label}",
                retry=RetryConfig(enabled=True, max_retries=3,
                                  initial_delay=2.0),
                category="composite")

        if self.birdweather is not None \
                and tr.track(EventType.BIRDWEATHER_SUBMIT, common, sci):
            ts_iso = (d.timestamp or _dt.datetime.now()).isoformat()
            self.jobqueue.enqueue(
                functools.partial(self.birdweather.post_detection, d, None,
                                  ts_iso),
                f"birdweather {d.species.common}",
                retry=RetryConfig(enabled=True, max_retries=3,
                                  initial_delay=5.0),
                category="birdweather")

        # new-species notification (species tracker) + alerting rules
        novelty = None
        if self.species_tracker is not None and s.species_tracking.enabled:
            when = (d.timestamp or _dt.datetime.now()).date()
            novelty = self.species_tracker.observe(
                d.species.scientific, when,
                window_days=s.species_tracking.new_species_window_days)
        if getattr(self, "alerting", None) is not None \
                and self.alerting.rules:
            self.jobqueue.enqueue(
                functools.partial(
                    self.alerting.on_detection,
                    {k: v for k, v in payload.items()},
                    novelty.is_new_lifetime if novelty else False),
                f"alert rules {d.species.common}", category="alert")
        if novelty is not None:
            # with window semantics a species stays "new" for days — the
            # notification itself is suppressed per suppression hours
            # (NotificationSuppressionHours, default 168)
            if novelty.is_new_lifetime and self.notifications is not None \
                    and s.notification.notify_new_species \
                    and self.species_tracker.should_notify(
                        d.species.scientific, time.time(),
                        s.species_tracking.notification_suppression_hours):
                from birdnet_go_tpu_torch.integrations.notification import (
                    Notification,
                )

                self.jobqueue.enqueue(
                    functools.partial(self.notifications.notify, Notification(
                        title="New species detected",
                        message=(f"{d.species.common} "
                                 f"({d.species.scientific}) — first ever "
                                 f"detection, confidence {d.confidence:.2f}"),
                        priority="high", payload=payload)),
                    f"notify new species {d.species.common}",
                    category="notify")

    def export_clip_for_detection(self, det_id: int) -> tuple[int, dict]:
        """On-demand clip (re)export for a stored detection — the
        POST /audio/:id/clip contract: returns (http_status, payload).
        Pulls from the source's CaptureBuffer when the span is still in
        the ring; 410 once it has been overwritten."""
        from birdnet_go_tpu_torch.audio.encode import encode_clip, resolve_format

        row = self.datastore.get_detection(det_id)
        if row is None:
            return 404, {"error": "not found"}
        s = self.settings
        clip_dir = Path(s.export.path)
        existing = row.get("clip_name") or ""
        if existing and (clip_dir / existing).is_file():
            return 200, {"clip_name": existing, "status": "exists"}
        if self.engine is None:
            return 409, {"error": "audio engine not running"}
        cb = self.engine.capture_buffer(row["source_id"])
        if cb is None:
            return 409, {"error": f"source {row['source_id']} not live"}
        start = float(row["begin_time"]) - s.export.pre_capture_seconds
        # extended-capture sessions persist end_time past the normal clip
        # window — an on-demand re-export must span the whole session
        end = max(start + s.export.clip_length_seconds,
                  float(row["end_time"] or 0))
        win = cb.window()
        if win is None or start < win[0]:
            return 410, {"error": "audio no longer in the capture buffer"}
        pcm = cb.read_segment(start, min(end, win[1]))
        if not len(pcm):
            return 410, {"error": "audio no longer in the capture buffer"}
        fmt, suffix = resolve_format(s.export.format, cb.sample_rate)
        sci = str(row["scientific_name"]).replace(" ", "_").lower()
        conf_pct = int(round(float(row["confidence"]) * 100))
        clip_name = f"{sci}_{conf_pct}p_{det_id}{suffix}"
        clip_dir.mkdir(parents=True, exist_ok=True)
        out = encode_clip(pcm, cb.sample_rate, clip_dir / clip_name, fmt)
        self.datastore.set_clip_name(det_id, out.name)
        return 200, {"clip_name": out.name, "status": "generated",
                     "duration_seconds": len(pcm) / cb.sample_rate}

    def _prerender_clip(self, capture_buffer, start: float, end: float,
                        out_path: Path) -> None:
        """Jobqueue job: wait for the span, then queue a PNG render."""
        if time.time() < end:
            raise RuntimeError("clip span not fully captured yet")
        pcm = capture_buffer.read_segment(start, end)
        samples = pcm.astype(np.float32) / 32768.0
        self.prerenderer.submit(samples, capture_buffer.sample_rate,
                                out_path)

    # -- range filter ---------------------------------------------------------------------

    def _compute_included_species(self) -> set[str] | None:
        s = self.settings
        if self._range_filter is None or s.location.latitude is None:
            return None
        week = birdnet_week(_dt.date.today())
        scores = self._range_filter.predict(
            s.location.latitude, s.location.longitude, week)
        primary = next(iter(self.labels.values()))
        included = {primary[i].scientific
                    for i in np.nonzero(scores >= s.range_filter.threshold)[0]
                    if i < len(primary)}
        included.update(s.species.include)
        # detections are canonicalized (openfauna) before the range check,
        # so the set must contain the canonical form of every label too
        from birdnet_go_tpu_torch.taxonomy.openfauna import canonical_name

        included |= {canonical_name(n) for n in included}
        return included

    def rebuild_range_filter(self) -> int:
        inc = self._compute_included_species()
        if self.processor is not None:
            self.processor.set_included_species(inc)
        n = len(inc) if inc is not None else 0
        log.info("range filter rebuilt: %d species included", n)
        return n

    def range_filter_scores(self, lat: float, lon: float,
                            week: int) -> np.ndarray:
        if week <= 0:
            week = birdnet_week(_dt.date.today())
        return self._ensure_range_filter().predict(lat, lon, week)

    def range_filter_scores_batch(self, coords: np.ndarray) -> np.ndarray:
        """[N, 3] (lat, lon, week) grid → [N, S] (range heatmap)."""
        # copy: np.asarray is a no-op view for float32 input and the
        # week-default fill below must not clobber the caller's grid
        coords = np.array(coords, np.float32, copy=True)
        week_default = float(birdnet_week(_dt.date.today()))
        coords[:, 2] = np.where(coords[:, 2] <= 0, week_default,
                                coords[:, 2])
        return self._ensure_range_filter().predict_batch(coords)

    def _ensure_range_filter(self) -> TorchRangeFilter:
        if self._range_filter is None:
            if not self.labels:
                raise RuntimeError(
                    "range filter needs at least one loaded model's labels")
            g = load_geomodel(
                num_species=len(next(iter(self.labels.values()))))
            self._range_filter = TorchRangeFilter(g, self.device)
        return self._range_filter
