"""The port's realtime app (``app.py``), ``serve`` and the host planes the
app builds at start, against the JAX package's, on the CPU.

Each case runs once through the JAX package's modules and once through the
port's copies from the same inputs, with injected clocks where the module
takes one, and records what it observes; ``_both`` asserts the two records
equal after ``_plain``. Bit for bit: the control bus, the liveness
watchdog, quiet hours (fixed and sun-relative), the event tracker and the
log deduplicator, the species tracker, the alerting rules, the
notification inbox and service, the event bus, the health registry and
error ring, the equalizer's filter chains, the tone and file-loop sources'
PCM, and the audio engine's windows and capture buffers (48 and 256 kHz
sources, a runtime ``add_model``/``remove_model``; resampled windows
within one int16 step, the port's resampler rounding its sums
differently), and the rtsp, http and audio_card sources the app builds.

The app as a whole is driven without its threads: a tiny float32 v2.4 in
both packages on the same JAX ``init`` weights (``inference/params.py``),
the same settings (WAV export, a range filter through a stand-in
Geomodel), the same PCM at fixed past timestamps through
``engine.ingest``, ticks until the loop is empty and a ``flush`` every
3 s, the job queue and the renderer drained. The rows are equal (confidence within
``CONF_TOL``), the clips byte for byte, the spectrogram PNGs within PR 12's
image tolerance (``RGB_MAX_STEP`` at no more than ``INDEX_MAX_SHARE`` of
the pixels), the included species and the health checks equal.

The port's own behaviour has tests of its own, each stating what JAX does
instead: runtime load and unload (the port serves what the unloaded model
already holds), the engine's gate (closed for ticks and launches, open
for a warm-up), a native RTSP source served by the app, the quiet-hours
gates on a ``SoundcardSource``, the mesh choice, the
threshold-persistence stop race (JAX's closure re-reads the attribute),
the lazy HTTP client of ``NotificationService``, the probe that raises
rather than degrade, ``serve`` with the API on, the ``ApiServer`` and the
image service built in ``setup``, and ``load_settings`` reading JSON
where yaml is missing.
"""

import contextlib
import copy
import dataclasses
import datetime
import importlib
import itertools
import json
import logging
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.ops.melspec import MelConfig as JMel
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import BlockSpec as TBlock
from birdnet_go_tpu_torch.models.efficientnet import EfficientNetConfig as TNet
from birdnet_go_tpu_torch.ops.melspec import MelConfig as TMel

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("birdnet_go_tpu", "birdnet_go_tpu_torch")
CONF_TOL = 1e-5              # confidences of the tiny float32 v2.4
INDEX_MAX_SHARE = 1e-3       # PR 12's spectrogram tolerance: a pixel's
RGB_MAX_STEP = 3             # colour may step by 3 at 1e-3 of the pixels


def _pkg(name: str) -> SimpleNamespace:
    mod = {k: importlib.import_module(f"{name}.{path}") for k, path in (
        ("app", "app"),
        ("health", "utils.health"),
        ("errors", "utils.errors"),
        ("control", "config.control"),
        ("settings", "config.settings"),
        ("source", "audio.source"),
        ("equalizer", "audio.equalizer"),
        ("sources_file", "audio.sources_file"),
        ("engine", "audio.engine"),
        ("resampler", "audio.resampler"),
        ("wav", "audio.wav"),
        ("liveness", "audio.liveness"),
        ("quiet", "audio.quiet_hours"),
        ("eventtracker", "analysis.eventtracker"),
        ("species", "analysis.species_tracker"),
        ("pipeline_stats", "analysis.pipeline_stats"),
        ("events", "utils.events"),
        ("circuit", "utils.circuit"),
        ("alerting", "analysis.alerting"),
        ("notification", "integrations.notification"),
        ("monitor", "utils.monitor"),
        ("sysmonitor", "utils.sysmonitor"),
        ("sqlite", "datastore.sqlite"),
        ("registry", "models.registry"))}
    return SimpleNamespace(**mod)


J, T = _pkg(PACKAGES[0]), _pkg(PACKAGES[1])


def _plain(x):
    """A comparable value: dataclasses by class name and fields, enums by
    value, dicts with sorted items, arrays as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if hasattr(x, "value") and type(x).__module__.startswith(PACKAGES):
        return x.value
    if isinstance(x, dict):
        return sorted((repr(_plain(k)), _plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _both(case, *args):
    """`case` through both packages: the two records, asserted equal."""
    want, got = case(J, *args), case(T, *args)
    assert _plain(got) == _plain(want)
    return got


def _dir(tmp_path: Path, P) -> Path:
    d = tmp_path / P.app.__name__.split(".")[0]
    d.mkdir(parents=True, exist_ok=True)
    return d


@pytest.fixture(autouse=True)
def _blas_pool_kept():
    """The port's ``Application.setup`` caps OpenBLAS at one thread for
    the process; each test gives the pool its size back."""
    from birdnet_go_tpu_torch.utils.blas import blas_threads, set_blas_threads

    before = blas_threads()
    yield
    if before:
        set_blas_threads(before[0])


def _wait(cond, seconds: float = 5.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cond()


# -- control bus -----------------------------------------------------------------

def test_control_bus_dispatch_in_order():
    """Handlers run in subscription order for each signal, queued signals
    in send order, on the caller's thread (``drain_sync``) and on the
    bus's thread, where a failing handler is logged and the rest run."""
    def case(P):
        C = P.control
        calls = []
        bus = C.ControlBus()
        for i, sig in enumerate((C.ControlSignal.RELOAD_MODEL,
                                 C.ControlSignal.RECONFIGURE_SOURCES,
                                 C.ControlSignal.RELOAD_MODEL)):
            bus.subscribe(sig, lambda i=i, sig=sig: calls.append(
                ("sync", sig.value, i)))
        for sig in (C.ControlSignal.RECONFIGURE_SOURCES,
                    C.ControlSignal.RELOAD_MODEL,
                    C.ControlSignal.RECONFIGURE_MQTT):
            bus.send(sig)
        bus.drain_sync()

        def boom():
            raise RuntimeError("handler fails")

        threaded = C.ControlBus()
        threaded.subscribe(C.ControlSignal.RELOAD_THRESHOLDS, boom)
        threaded.subscribe(C.ControlSignal.RELOAD_THRESHOLDS,
                           lambda: calls.append(("thread", "after boom")))
        threaded.start()
        threaded.send(C.ControlSignal.RELOAD_THRESHOLDS)
        threaded.send(C.ControlSignal.REBUILD_RANGE_FILTER)
        threaded.stop()
        return calls, sorted(s.value for s in C.ControlSignal)

    calls, signals = _both(case)
    assert calls[-1] == ("thread", "after boom") and len(signals) == 23


# -- liveness watchdog -------------------------------------------------------------

LIVENESS_SCRIPTS = {
    # (clock step, action) pairs; "data" feeds the source, "check" runs
    # one watchdog pass, "quiet"/"loud" flip the quiet-hours answer
    "recovers": [(0, "track"), (61, "check"), (1, "check"), (1, "data"),
                 (1, "check")],
    "fails": [(0, "track")] + [(31, "check")] * 10,
    "quiet": [(0, "track"), (0, "quiet"), (100, "check"), (0, "loud"),
              (30, "check"), (31, "check"), (1, "check")],
}


@pytest.mark.parametrize("script", sorted(LIVENESS_SCRIPTS))
@pytest.mark.parametrize("attempts", [1, 3])
def test_liveness_watchdog_transitions(script, attempts):
    """The watchdog's states, restarts and notifications on a fake clock:
    healthy → alarmed → recovering → escalated/failed, recovery on data,
    and quiet hours as expected silence."""
    def case(P):
        L = P.liveness
        clock = {"t": 1000.0}
        quiet = {"on": False}
        events = []
        wd = L.LivenessWatchdog(
            L.LivenessConfig(silence_timeout_seconds=60.0,
                             recovery_timeout_seconds=30.0,
                             max_recovery_attempts=attempts),
            restart=lambda sid: events.append(("restart", sid)),
            notify=lambda sid, st: events.append(("notify", sid, st.value)),
            is_quiet=lambda sid: quiet["on"],
            clock=lambda: clock["t"])
        for step, action in LIVENESS_SCRIPTS[script]:
            clock["t"] += step
            if action == "track":
                wd.track("s1")
                wd.track("s2")
            elif action == "data":
                wd.data_received("s1")
            elif action in ("quiet", "loud"):
                quiet["on"] = action == "quiet"
            else:
                wd.check()
            events.append((action, wd.state_of("s1").value,
                           wd.state_of("s2").value))
        wd.untrack("s2")
        events.append(wd.state_of("s2"))
        return events

    _both(case)


# -- quiet hours -------------------------------------------------------------------

QUIET_SPECS = [["22:00-06:00"], ["sunset+30m to sunrise-30m"],
               [{"start": "sunrise-1h", "end": "sunrise+2h"}],
               ["12:15-12:45", "sunset to 23:59"]]


@pytest.mark.parametrize("where", [(60.17, 24.94), (-33.9, 18.4),
                                   (78.2, 15.6), None])
@pytest.mark.parametrize("spec", range(len(QUIET_SPECS)))
def test_quiet_hours_windows(spec, where):
    """Parsed windows and ``is_quiet`` every 20 minutes over two days
    (one in polar summer at 78 N), fixed and sun-relative; without a
    location the sun-relative windows are never quiet."""
    lat, lon = where or (None, None)

    def case(P):
        Q = P.quiet
        wins = Q.parse_windows(QUIET_SPECS[spec])
        sched = Q.QuietHoursScheduler(lat=lat, lon=lon)
        sched.set_windows("s1", wins)
        t0 = datetime.datetime(2025, 6, 20, tzinfo=datetime.timezone.utc)
        days = [t0, t0 + datetime.timedelta(days=180)]
        return wins, sched.has_windows(), [
            sched.is_quiet("s1", d + datetime.timedelta(minutes=20 * k))
            for d in days for k in range(72)]

    _both(case)


@pytest.mark.parametrize("bad", [["25:00-06:00"], ["noon-06:00"], ["22:00"],
                                 [{"start": "", "end": "06:00"}]])
def test_quiet_hours_malformed_windows_raise(bad):
    def case(P):
        with pytest.raises(ValueError) as e:
            P.quiet.parse_windows(bad)
        return str(e.value)

    _both(case)


# -- event tracker and log deduplication -------------------------------------------

def test_event_tracker_intervals():
    """Per-(event type, species) gates over a scripted clock, a species
    interval override (and a negative one falling back), unknown event
    types refused, ``reset_event`` and ``cleanup``."""
    def case(P):
        E = P.eventtracker
        clock = {"t": 100.0}
        tr = E.EventTracker(default_interval_seconds=15.0,
                            species_config={"Great Tit": {"interval": 60},
                                            "strix aluco": {"interval": -5}},
                            clock=lambda: clock["t"])
        out = []
        for step in (0, 5, 10, 20, 45, 5):
            clock["t"] += step
            for et in (*E.EventType.ALL, "nope"):
                out.append((clock["t"], et,
                            tr.track(et, "Great Tit", "Parus major"),
                            tr.track(et, "Tawny Owl", "Strix aluco"),
                            tr.track(et, "", "")))
        tr.reset_event("great tit", E.EventType.MQTT_PUBLISH)
        out.append(tr.track(E.EventType.MQTT_PUBLISH, "Great Tit"))
        out.append(tr.should_act("Robin", E.EventType.LOG_TO_FILE, 500.0))
        out.append(tr.cleanup(stale_after_seconds=30.0, now=520.0))
        dedup = E.LogDeduplicator(health_check_interval=30.0,
                                  clock=lambda: clock["t"])
        for step, vals in ((0, (1, 2)), (1, (1, 2)), (1, (1, 3)), (40, (1, 3)),
                           (1, (1, 3))):
            clock["t"] += step
            out.append(dedup.should_log("pipeline", *vals))
        out.append(E.LogDeduplicator(enabled=False).should_log("x", 1))
        return out

    _both(case)


# -- species tracker ---------------------------------------------------------------

class _FirstSeenStore:
    """The two datastore queries the tracker's startup sync reads."""

    def new_species_first_seen(self):
        return [{"scientific_name": "Parus major", "first_date": "2023-05-01"},
                {"scientific_name": "Strix aluco", "first_date": "2025-01-10"},
                {"scientific_name": "Parus major", "first_date": "2022-04-01"}]

    def species_first_seen_since(self, since):
        rows = [("Strix aluco", "2025-01-10"), ("Turdus merula", "2025-03-20"),
                ("Parus major", "2025-06-02")]
        return [{"scientific_name": s, "first_date": d} for s, d in rows
                if d >= since]


@pytest.mark.parametrize("window", [0, 7])
def test_species_tracker_novelty_and_suppression(window):
    def case(P):
        S = P.species
        tr = S.SpeciesTracker()
        n = tr.sync_from_datastore(_FirstSeenStore(),
                                   today=datetime.date(2025, 6, 15))
        out = [n, tr.species_count()]
        day = datetime.date(2025, 6, 15)
        for k, sci in enumerate(["Parus major", "Erithacus rubecula",
                                 "Erithacus rubecula", "Turdus merula",
                                 "Strix aluco", "Erithacus rubecula"]):
            when = day + datetime.timedelta(days=3 * k)
            out.append(tr.observe(sci, when, window_days=window))
        tr.seed_notified("Parus major", 1000.0)
        for sci, now in (("Parus major", 1000.0 + 3600), ("Parus major",
                          1000.0 + 200 * 3600), ("Strix aluco", 5.0),
                         ("Strix aluco", 6.0)):
            out.append(tr.should_notify(sci, now, 168.0))
        out.append(tr.first_seen("Erithacus rubecula", day))
        out.append([S.season_of(datetime.date(2025, m, 1))
                    for m in range(1, 13)])
        return out

    _both(case)


# -- alerting ----------------------------------------------------------------------

DET = {"scientific_name": "Strix aluco", "common_name": "Tawny Owl",
       "confidence": 0.91, "source_id": "garden"}


class _Inbox:
    def __init__(self):
        self.sent = []

    def notify(self, n):
        self.sent.append(n)
        return 1


def test_alerting_rules():
    """Detection rules (species globs, confidence, sources, novelty,
    active windows, throttle, templates) and metric rules (thresholds,
    sustained windows, recovery notices, per-path state) on a fake clock;
    the history, the notifications sent and ``test_rule``."""
    def case(P):
        A = P.alerting
        clock = {"t": datetime.datetime(2025, 6, 1, 12, 0).timestamp()}
        inbox = _Inbox()
        eng = A.AlertingEngine(notification_service=inbox,
                               clock=lambda: clock["t"])
        eng.replace_rules([
            A.AlertRule(rule_id="owls", name="owls", species=["Strix *"],
                        min_confidence=0.8, sources=["garden"],
                        min_interval_seconds=60,
                        message_template="{common_name} {confidence:.2f}"),
            A.AlertRule(rule_id="new", name="new", only_new_species=True,
                        min_interval_seconds=0, priority="high"),
            A.AlertRule(rule_id="noon", name="noon", active_window="11:00-13:00",
                        min_interval_seconds=0,
                        message_template="{missing} key"),
            A.AlertRule(rule_id="night", name="night",
                        active_window="22:00-02:00", min_interval_seconds=0),
            A.AlertRule(rule_id="cpu", name="cpu", metric="cpu",
                        threshold=80.0, sustained_seconds=120.0,
                        min_interval_seconds=0),
            A.AlertRule(rule_id="disk", name="disk", metric="disk",
                        threshold=90.0, path="/data",
                        min_interval_seconds=300),
        ])
        out = []
        for step, det, new in ((0, DET, False), (30, DET, True),
                               (31, {**DET, "confidence": 0.5}, False),
                               (0, {**DET, "source_id": "roof"}, True),
                               (3600 * 11, DET, False)):
            clock["t"] += step
            out.append([(e.rule_id, e.message) for e in
                        eng.on_detection(det, is_new_species=new)])
        for step, metric, value, path in ((0, "cpu", 95.0, ""),
                                          (60, "cpu", 96.0, ""),
                                          (61, "cpu", 97.0, ""),
                                          (60, "cpu", 50.0, ""),
                                          (0, "disk", 95.0, "/data"),
                                          (10, "disk", 96.0, "/data"),
                                          (0, "disk", 99.0, "/boot"),
                                          (400, "disk", 10.0, "/data")):
            clock["t"] += step
            out.append([(e.rule_id, e.message) for e in
                        eng.publish_metric(metric, value, path)])
        out.append([(e.rule_id, e.fired_at, e.message) for e in eng.history])
        out.append([(n.title, n.message, n.priority, n.payload)
                    for n in inbox.sent])
        out.append(eng.test_rule("owls"))
        out.append(eng.remove_rule("owls"))
        out.append(sorted(r.rule_id for r in eng.list_rules()))
        return out

    _both(case)


# -- notifications -----------------------------------------------------------------

class _Response:
    status_code = 200

    def raise_for_status(self):
        pass


class _Session:
    def __init__(self, fail_hosts=()):
        self.requests = []
        self.fail_hosts = fail_hosts

    def request(self, method, url, content=None, headers=None):
        self.requests.append((method, url, content, headers))
        if any(h in url for h in self.fail_hosts):
            raise ConnectionError(f"{url} refused")
        return _Response()


def test_notification_inbox_round_trip(tmp_path):
    """An inbox persisted in the package's datastore: add, list, read
    marks, delete, and a second inbox rehydrated from the same store."""
    ts = time.time() - 3600.0        # inside the 7-day time to live

    def case(P):
        store = P.sqlite.Datastore(str(_dir(tmp_path, P) / "n.db"))
        N = P.notification
        inbox = N.NotificationInbox(capacity=3, store=store)
        for k in range(5):
            inbox.add(N.Notification(title=f"t{k}", message=f"m{k}",
                                     priority="high" if k % 2 else "normal",
                                     payload={"k": k}), now=ts + k)
        out = [inbox.list(), inbox.unread_count(), inbox.mark_read(4),
               inbox.mark_read(99), inbox.get(4), inbox.delete(3),
               inbox.delete(3), inbox.list(unread_only=True),
               inbox.mark_all_read(), inbox.unread_count()]
        again = N.NotificationInbox(capacity=10, store=store)
        out.append(again.list())
        store.close()
        return out

    _both(case)


def test_notification_service_delivery():
    """Webhook templates, ntfy headers, shoutrrr push URLs, a per-target
    rate limit, the burst cap, a failing target's circuit breaker and a
    command target, through one fake session; the inbox's hook."""
    def case(P):
        N = P.notification
        session = _Session(fail_hosts=("down.example",))
        stored = []
        targets = [
            N.NotificationTarget(
                name="hook", kind="webhook", url="http://hook.example/x",
                body_template='{"t": "$title", "c": "$common_name"}',
                min_interval_seconds=100.0),
            N.NotificationTarget(name="ntfy", kind="ntfy",
                                 url="https://ntfy.example/birds"),
            N.NotificationTarget(name="disc", kind="push",
                                 url="discord://tok@12345"),
            N.NotificationTarget(name="down", kind="webhook",
                                 url="http://down.example/"),
            N.NotificationTarget(name="cmd", kind="command",
                                 command=[sys.executable, "-c", "pass",
                                          "$title"]),
        ]
        svc = N.NotificationService(
            targets, session=session, burst_limit=8,
            inbox=N.NotificationInbox(), on_stored=stored.append)
        out = []
        for k in range(10):
            out.append(svc.notify(N.Notification(
                title=f"New {k}", message="a bird", priority="critical",
                payload={"common_name": "Great Tit"})))
        out.append((svc.sent, svc.suppressed, svc.failed,
                    svc._breakers["down"].state))
        out.append([(m, u, c, h) for m, u, c, h in session.requests])
        out.append([s.title for s in stored])
        return out

    _both(case)


def test_notification_service_builds_no_http_client_without_a_target(
        monkeypatch):
    """The port's divergence: JAX's ``NotificationService`` builds its
    shared HTTP client in ``__init__``; the port's obtains it at its first
    webhook, ntfy or push delivery. With httpx blocked (the port's
    transport is ``urllib``), a service without such a target delivers
    (inbox, command) and builds no client; a webhook delivery builds the
    shared client and, against a loopback port that refuses connections,
    fails as any delivery error does, counted by the target's circuit
    breaker, with nothing falling back."""
    import birdnet_go_tpu.utils.httpclient as jhttp

    monkeypatch.setattr(jhttp, "_shared", None)
    J.notification.NotificationService([])
    assert jhttp._shared is not None            # JAX: built in __init__

    import birdnet_go_tpu_torch.utils.httpclient as thttp

    monkeypatch.setattr(thttp, "_shared", None)
    monkeypatch.setitem(sys.modules, "httpx", None)
    N = T.notification
    svc = N.NotificationService(
        [N.NotificationTarget(name="cmd", kind="command",
                              command=[sys.executable, "-c", "pass"])],
        inbox=N.NotificationInbox())
    assert svc.notify(N.Notification(title="t", message="m")) == 1
    assert svc.session is None and thttp._shared is None
    with socket.socket() as s:                # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        refused = f"http://127.0.0.1:{s.getsockname()[1]}/hook"
    svc.add_target(N.NotificationTarget(name="hook", kind="webhook",
                                        url=refused))
    for _ in range(5):
        assert svc.notify(N.Notification(title="t", message="m")) == 1
    assert svc.failed == 5 and svc._breakers["hook"].state == "open"
    assert svc.notify(N.Notification(title="t", message="m")) == 1
    assert svc.suppressed == 1 and svc.session is thttp._shared
    assert isinstance(svc.session.session, thttp.UrllibSession)


# -- event bus, health, circuit breaker ------------------------------------------------

def test_event_bus_fan_out_and_dedup():
    """Fan-out to two consumers (one filtered by kind, one failing on odd
    payloads), dedup within the window, the history and counters."""
    def case(P):
        E = P.events
        bus = E.EventBus(dedup_window_seconds=30.0)
        got = {"all": [], "det": []}

        def sink_all(ev):
            got["all"].append(ev.payload)
            if ev.payload % 2:
                raise RuntimeError("odd")

        bus.subscribe("all", sink_all)
        bus.subscribe("det", lambda ev: got["det"].append(ev.payload),
                      kinds={"detection"})
        sent = [bus.publish(E.Event("detection" if k % 3 else "health", k,
                                    dedup_key=f"k{k % 4}"))
                for k in range(8)]
        _wait(lambda: len(got["all"]) == 4 and len(got["det"]) == 2)
        bus.stop()
        return (sent, got, bus.published, bus.deduped, bus.dropped,
                [(e["kind"], e["payload"]) for e in bus.recent(kind=None)],
                [e["payload"] for e in bus.recent(limit=2, kind="detection")])

    _both(case)


def test_health_registry_and_error_ring():
    """Checks (one crashing) and the overall verdict; the WARN+ ring with
    a plain record, an EnhancedError built by the package's taxonomy and
    a record below its level."""
    def case(P):
        H = P.health
        reg = H.HealthRegistry()
        reg.register("db", lambda: H.CheckResult("db", True, "3 detections"))
        reg.register("streams", lambda: H.CheckResult("streams", False,
                                                      "stale: ['s1']"))
        reg.register("boom", lambda: 1 / 0)
        results = [(r.name, r.healthy, r.detail) for r in reg.run_all()]
        ring = H.ErrorRingBuffer(capacity=3)
        logger = logging.getLogger("test_torch_app.ring")
        logger.addHandler(ring)
        try:
            logger.info("below the ring's level")
            logger.warning("disk at %d%%", 91)
            err = P.errors.new("card lost").component("inference") \
                .category(P.errors.Category.MODEL).context("card", 0)
            logging.getLogger("birdnet_tpu.inference").addHandler(ring)
            try:
                err.build()
            finally:
                logging.getLogger("birdnet_tpu.inference").removeHandler(ring)
        finally:
            logger.removeHandler(ring)
        recent = [{k: v for k, v in e.items() if k != "time"}
                  for e in ring.recent()]
        return results, reg.overall(), recent

    _both(case)


def test_circuit_breaker():
    def case(P):
        C = P.circuit
        br = C.CircuitBreaker(failure_threshold=2, cooldown_seconds=0.05)
        out = []

        def fail():
            raise OSError("down")

        for fn in (fail, fail, lambda: 1):
            try:
                out.append(br.call(fn))
            except (OSError, C.CircuitOpenError) as e:
                out.append(type(e).__name__)
            out.append(br.state)
        time.sleep(0.06)
        out += [br.state, br.call(lambda: 2), br.state]
        return out

    _both(case)


# -- equalizer and sources ---------------------------------------------------------

EQ_KINDS = ["lowpass", "highpass", "bandpass", "bandreject", "allpass",
            "peaking", "lowshelf", "highshelf"]


@pytest.mark.parametrize("kind", EQ_KINDS)
def test_filter_chain_output(kind):
    """A chain of the filter and a high-pass at 48 kHz, on seeded noise in
    uneven chunks (streaming state carried): bit for bit."""
    x = np.random.default_rng(3).standard_normal(9000).astype(np.float32)

    def case(P):
        chain = P.equalizer.FilterChain.from_config(48000, [
            {"type": kind, "frequency": 2500, "q": 1.2, "gain": 6.0},
            {"type": "highpass", "frequency": 150}])
        chain.gain = 0.8
        out = [chain.process(x[a:b]) for a, b in ((0, 100), (100, 4097),
                                                  (4097, 9000))]
        c = P.equalizer.design_biquad(kind, 32000, 1000.0, 0.9, -3.0)
        return out, c

    _both(case)


def test_filter_chain_rejects_unknown_kind():
    def case(P):
        with pytest.raises(ValueError) as e:
            P.equalizer.design_biquad("comb", 48000, 100.0)
        return str(e.value)

    _both(case)


class _RecordingEngine:
    def __init__(self, limit=None):
        self.chunks = []
        self.added = []
        self.limit = limit
        self.full = threading.Event()

    def add_source(self, source):
        self.added.append(source)

    def remove_source(self, source_id):
        self.added.append(("removed", source_id))

    def ingest(self, source_id, pcm, timestamp=None):
        if self.limit is None or len(self.chunks) < self.limit:
            self.chunks.append((source_id, pcm.copy()))
        else:
            self.full.set()


@pytest.mark.parametrize("pulse", [0.0, 7.0])
@pytest.mark.parametrize("rate", [48000, 256000])
def test_tone_source_pcm(rate, pulse):
    def case(P):
        eng = _RecordingEngine()
        src = P.sources_file.ToneSource(eng, source_id="t", rate=rate,
                                        freq_hz=1234.5, pulse_hz=pulse)
        for s in (0.1, 0.25, 1.0):
            src.push_seconds(s)
        return src.source, src.chunk, eng.chunks

    _both(case)


class _Pacer:
    """A fake clock for a source's pacing loop: ``wait`` advances it and
    the engine's ingest costs `push_s` of it; the clock jumps `lag_s` at
    the second push, as a stalled host would. Records each push's samples
    and the clock when it began."""

    def __init__(self, push_s: float, lag_s: float, pushes: int):
        self.t, self.push_s, self.lag_s = 100.0, push_s, lag_s
        self.pushes, self.limit, self.waits = 0, pushes, []
        self.pushed = []

    def monotonic(self):
        return self.t

    def ingest(self, source_id, pcm, timestamp=None):
        self.pushed.append((self.t, len(pcm)))
        self.pushes += 1
        self.t += self.push_s + (self.lag_s if self.pushes == 2 else 0.0)

    def is_set(self):
        return self.pushes >= self.limit

    def wait(self, delay):
        self.waits.append(round(delay, 6))
        self.t += delay


def test_tone_source_does_not_burst_after_a_stall(monkeypatch):
    """The port's divergence: a ``ToneSource`` 1 s behind its pace (a
    stalled host) pushes the ten 0.1 s chunks it owes in one push, then
    keeps its pace; JAX's pushes them back to back, ten pushes without a
    wait. Neither drops audio: by the last push both have pushed what
    the clock says is due, one chunk ahead of it."""
    pacers = {}
    for P in (J, T):
        pacer = _Pacer(push_s=0.001, lag_s=1.0, pushes=16)
        monkeypatch.setattr(P.sources_file, "time", types.SimpleNamespace(
            monotonic=pacer.monotonic))
        src = P.sources_file.ToneSource(pacer, source_id="t")
        src._stop = pacer
        src._run()
        pacers[P.app.__name__] = pacer
    jax, port = pacers["birdnet_go_tpu.app"], pacers["birdnet_go_tpu_torch.app"]
    # JAX: after the stall, ten pushes without a wait (the backlog)
    assert len(jax.waits) == 16 - 10
    # the port: the backlog in the third push, then a wait every push
    assert [n for _, n in port.pushed[:4]] == [4800, 4800, 48000, 4800]
    assert len(port.waits) == 16 - 1
    assert port.waits[2:] == [0.099] * 13
    # no audio dropped: each has pushed through the clock plus one chunk
    for pacer in (jax, port):
        t_last, _ = pacer.pushed[-1]
        pushed_s = sum(n for _, n in pacer.pushed) / 48000
        assert abs(pushed_s - (t_last - 100.0) - 0.1) < 0.01, pacer.pushed


@pytest.mark.parametrize("loop", [True, False])
def test_file_loop_source_pcm(tmp_path, loop):
    """A short 44.1 kHz WAV (shorter than two chunks) replayed at 200x by
    the source's thread: the first chunks, gapless across the wrap."""
    rng = np.random.default_rng(4)
    path = tmp_path / "clip.wav"
    J.wav.write_wav(path, (0.2 * rng.standard_normal(6000)).astype(
        np.float32), 44100)

    def case(P):
        eng = _RecordingEngine(limit=12)
        src = P.sources_file.FileLoopSource(eng, path, speed=200.0,
                                            loop=loop)
        src.start()
        if loop:
            assert eng.full.wait(10)
        else:
            _wait(lambda: src._thread is not None
                  and not src._thread.is_alive(), 10)
        src.stop()
        return src.source, src.rate, src.pcm, eng.chunks, eng.added

    _both(case)


# -- audio engine ------------------------------------------------------------------

def _engine_specs(P):
    R = P.registry
    return [R.BIRDNET_V24, R.PERCH_V2, R.BAT]


@pytest.mark.parametrize("eq", [False, True])
@pytest.mark.parametrize("rate", [48000, 256000])
def test_engine_windows_and_capture(rate, eq, monkeypatch):
    """The same PCM at fixed timestamps into both engines (two sources,
    v2.4 at 48 kHz, Perch at 32 kHz resampled, the bat model raw at
    256 kHz, a 1.5 s overlap on v2.4): the same ``collect_ready`` windows
    and capture-buffer contents; a model added and one removed at runtime
    rewire the live streams alike. With JAX's ``StreamingResampler`` in
    the port's engine, everything is equal bit for bit. With the port's
    own, a window that was resampled may differ from JAX's by one int16
    step at no more than 1e-3 of its samples: the contract of the
    resampler's accepted divergence (it rounds its float32 sums
    differently: ``audio/resampler.py``, held to the
    resampler's float64 definition in ``tests/test_torch_aux.py``); every
    other window, and everything else, is equal."""
    rng = np.random.default_rng(5)
    chunks = [np.clip(3000 * rng.standard_normal(rate // 10), -32768,
                      32767).astype(np.int16) for _ in range(70)]

    def case(P):
        v24, perch, bat = _engine_specs(P)
        eng = P.engine.AudioEngine(
            [v24, bat], capture_seconds=8.0, overlaps={v24.model_id: 1.5},
            eq_specs=[{"type": "highpass", "frequency": 200}] if eq else None)
        for sid in ("a", "b"):
            eng.add_source(P.source.AudioSource(
                source_id=sid, source_type=P.source.SourceType.FILE,
                display_name=sid, sample_rate=rate))
        out = []
        for k, c in enumerate(chunks):
            for j, sid in enumerate(("a", "b")):
                eng.ingest(sid, c if j == 0 else c[::-1].copy(),
                           timestamp=1000.0 + 0.1 * k)
            if k == 20:
                eng.add_model(perch)
                eng.add_model(perch)             # a second add: no-op
            if k == 50:
                eng.remove_model(bat.model_id)
            if k % 7 == 0:
                out.append(eng.collect_ready())
        out.append(eng.collect_ready())
        for sid in ("a", "b"):
            cb = eng.capture_buffer(sid)
            out.append((cb.window(), cb.read_segment(1001.0, 1006.5)))
        out.append([s.model_id for s in eng.specs])
        health = eng.stream_health()
        out.append({sid: (h["capture_seconds_buffered"],
                          sorted(h["overwrite_rates"]))
                    for sid, h in health.items()})
        eng.remove_source("a")
        out.append([s.source_id for s in eng.sources()])
        return out

    want = case(J)
    with monkeypatch.context() as m:
        m.setattr(T.engine, "StreamingResampler",
                  J.resampler.StreamingResampler)
        assert _plain(case(T)) == _plain(want)
    got = case(T)
    windows = [(w, g) for a, b in zip(want, got)
               if isinstance(a, list) and a and isinstance(a[0], tuple)
               and len(a[0]) == 5 for w, g in zip(a, b)]
    assert windows and len(want) == len(got)
    for w, g in windows:
        assert _plain(g[:1] + g[2:]) == _plain(w[:1] + w[2:])
        step = np.abs(g[1].astype(np.int32) - w[1].astype(np.int32))
        if w[4] == rate:                      # not resampled
            assert step.max() == 0
        else:
            assert step.max() <= 1 and (step > 0).mean() <= 1e-3
        g[1][:] = w[1]
    assert _plain(got) == _plain(want)


def test_source_gate_holds_ingest_off_during_a_launch():
    """The port's divergence: ``AudioEngine.ingest`` takes a turn of the
    engine's ``SourceGate``, and a launch (``closed``) waits for the
    turns already running, then holds new ones off until it ends. Four
    threads ingest in a loop around three launches of 30 ms."""
    v24 = T.registry.BIRDNET_V24
    eng = T.engine.AudioEngine([v24], capture_seconds=2.0)
    ids = [f"s{k}" for k in range(4)]
    for sid in ids:
        eng.add_source(T.source.AudioSource(
            source_id=sid, source_type=T.source.SourceType.FILE,
            display_name=sid, sample_rate=48000))
    events, stop = [], threading.Event()
    real = eng._ingest

    def ingest(source_id, pcm, timestamp):
        events.append(("in", source_id))
        time.sleep(0.002)
        real(source_id, pcm, timestamp)
        events.append(("out", source_id))

    eng._ingest = ingest
    chunk = np.zeros(4800, np.int16)

    def source(sid):
        while not stop.is_set():
            eng.ingest(sid, chunk, timestamp=T0)

    threads = [threading.Thread(target=source, args=(sid,)) for sid in ids]
    for th in threads:
        th.start()
    try:
        for _ in range(3):
            _wait(lambda: len(events) > 40)
            with eng.gate.closed():
                events.append(("launch", None))
                assert eng.gate._turns == 0
                time.sleep(0.03)
                events.append(("end", None))
            time.sleep(0.01)
    finally:
        stop.set()
        for th in threads:
            th.join(5)
    inside, running = False, set()
    for kind, sid in events:
        if kind == "launch":
            assert not running, running      # every turn ended first
            inside = True
        elif kind == "end":
            inside = False
        else:
            assert not inside, events        # no turn began in a launch
            (running.add if kind == "in" else running.discard)(sid)
    assert [k for k, _ in events].count("launch") == 3
    assert sum(k == "in" for k, _ in events) > 20


def test_app_closes_the_engine_gate_for_ticks_and_launches(
        tmp_path, monkeypatch, tiny_v24):
    """The app's device loop holds its engine's gate closed for each tick,
    and every batcher, the one loaded at runtime too, while it launches a
    step (the port only: JAX's jitted step takes the GIL once a batch).
    A warm-up leaves the gate open: its first call's set-up would hold a
    live source's audio (JAX's load holds no gate either)."""
    v3 = _tiny_v3(tiny_v24)
    monkeypatch.setattr(T.app, "load_model",
                        lambda model_id, checkpoint=None, **kw:
                        copy.deepcopy(tiny_v24[1]) if model_id ==
                        "BirdNET_V2.4" else copy.deepcopy(v3))
    monkeypatch.setattr(T.app, "load_geomodel",
                        lambda num_species=6, **kw: _TorchGeomodel())
    steps = []
    real_step = T.app.TorchModelBatcher._step

    def step(self, *a):
        steps.append((self.spec.model_id, self.gate._closings))
        return real_step(self, *a)

    monkeypatch.setattr(T.app.TorchModelBatcher, "_step", step)
    app = T.app.Application(_app_settings(T, tmp_path), device="cpu")
    app.setup()
    gate = app.engine.gate
    assert app.device_loop.gate is gate
    for src in app._sources:
        app.engine.add_source(src.source)
    assert app.load_model_runtime("BirdNET_V3.0") is True
    batchers = app.device_loop.batchers
    assert set(batchers) == {"BirdNET_V2.4", "BirdNET_V3.0"}
    assert all(b.gate is gate for b in batchers.values())
    # the runtime load's warm-up, then one warm-up of each: never closed
    for b in batchers.values():
        b.warmup()
    assert [n for _, n in steps] == [0, 0, 0], steps
    polls = []
    collect = app.device_loop._providers[0]
    app.device_loop._providers[0] = lambda: (polls.append(gate._closings),
                                             collect())[1]
    del steps[:]
    _ingest(app, _app_pcm(12.0), T0, 12.0)
    _run_ticks(app)
    # a tick's polls inside its closing; its launches nested in it
    assert polls and set(polls) == {1}, polls
    assert {m for m, _ in steps} == {"BirdNET_V2.4", "BirdNET_V3.0"}
    assert {n for _, n in steps} == {2}, steps
    assert gate._closings == 0 and gate._turns == 0
    app.datastore.close()


def test_a_source_ingests_while_a_warmup_runs(tmp_path, monkeypatch,
                                              tiny_v24):
    """Repair of the warm-up stall: a source's ``gate.turn()`` completes
    while ``warmup()`` runs a slow step, and a launch still holds the
    gate closed against it."""
    _patch_models(T, monkeypatch, tiny_v24)
    app = T.app.Application(_app_settings(T, tmp_path), device="cpu")
    app.setup()
    gate, b = app.engine.gate, app.device_loop.batchers["BirdNET_V2.4"]
    in_step, release = threading.Event(), threading.Event()
    real_step = b._step

    def slow_step(*a):
        in_step.set()
        assert release.wait(10)
        return real_step(*a)

    b._step = slow_step

    def turn_when(started, done):
        assert started.wait(10)
        with gate.turn():
            done.set()

    for kind, run in (("warmup", b.warmup),
                      ("launch", lambda: b._launch(b._staged, 1))):
        in_step.clear()
        release.clear()
        done = threading.Event()
        src = threading.Thread(target=turn_when, args=(in_step, done))
        step = threading.Thread(target=run)
        src.start()
        step.start()
        assert in_step.wait(10)
        if kind == "warmup":
            assert done.wait(5), "a warm-up held the source off"
        else:
            time.sleep(0.2)
            assert not done.is_set(), "a launch let the source in"
        release.set()
        step.join(10)
        src.join(10)
        assert done.is_set() and not step.is_alive()
    assert gate._closings == 0 and gate._turns == 0
    app.datastore.close()



def test_no_gate_closing_overlaps_a_warmup(tmp_path, monkeypatch,
                                           tiny_v24):
    """Repair of phase 18's stall (a tick closed the gate for 397.8 ms
    beside v3.0's warm-up and traded the GIL with it): a 0.3 s warm-up
    on one thread and ticks on the device loop's own thread. No closing
    of the gate, measured from inside it, meets the warm-up's hold; a
    source ingests throughout; and a warm-up on the loop's own thread,
    between two ticks and inside one, ends (no deadlock)."""
    _patch_models(T, monkeypatch, tiny_v24)
    app = T.app.Application(_app_settings(T, tmp_path), device="cpu")
    app.setup()
    gate, loop = app.engine.gate, app.device_loop
    b = loop.batchers["BirdNET_V2.4"]
    real_step = b._step

    def slow_step(*a):
        time.sleep(0.3)
        return real_step(*a)

    b._step = slow_step
    closings, holds = [], []
    real_closed, real_warming = gate.closed, gate.warming

    @contextlib.contextmanager
    def closed():
        with real_closed():
            a = time.monotonic()
            yield
            closings.append((threading.get_ident(), a, time.monotonic()))

    @contextlib.contextmanager
    def warming():
        with real_warming():
            a = time.monotonic()
            yield
            holds.append((threading.get_ident(), a, time.monotonic()))

    gate.closed, gate.warming = closed, warming
    turns, stop = [], threading.Event()

    def source():
        while not stop.is_set():
            with gate.turn():
                turns.append(time.monotonic())
            time.sleep(0.005)

    def ticks():
        while not stop.is_set():
            loop.run_tick()
            time.sleep(0.01)

    threads = [threading.Thread(target=f) for f in (source, ticks)]
    for th in threads:
        th.start()
    try:
        _wait(lambda: len(closings) > 3)
        warm = threading.Thread(target=b.warmup)
        warm.start()
        warm.join(10)
        assert not warm.is_alive(), "the warm-up never ended"
        _wait(lambda: closings and closings[-1][1] > holds[-1][2])
    finally:
        stop.set()
        for th in threads:
            th.join(10)
    assert not any(th.is_alive() for th in threads), "a deadlock"
    (_, h0, h1), = holds
    assert h1 - h0 >= 0.3
    assert not [c for c in closings if c[1] < h1 and c[2] > h0], closings
    # sources ingested throughout the hold: no gap of 0.1 s
    inside = [h0] + [t for t in turns if h0 < t < h1] + [h1]
    assert max(y - x for x, y in zip(inside, inside[1:])) < 0.1, inside

    # a warm-up on the loop's own thread, between ticks and inside one
    done = []
    collect = loop._providers[0]

    def warm_in_tick():
        if not done:
            done.append(b.warmup())
        return collect()

    loop._providers[0] = warm_in_tick

    def on_loop_thread():
        b.warmup()
        loop.run_tick()

    th = threading.Thread(target=on_loop_thread)
    th.start()
    th.join(10)
    assert not th.is_alive() and len(done) == 1, "a deadlock"
    assert gate._closings == 0 and gate._turns == 0
    assert not gate._closers and not gate._warmers
    app.datastore.close()


LIVE_SOURCES = {
    "rtsp_native": ({"type": "rtsp", "id": "cam", "client": "native",
                     "url": "rtsp://u:p@cam/live"}, True),
    "rtsp_ffmpeg": ({"type": "rtsp", "id": "cam", "url": "rtsp://cam/live",
                     "transport": "udp"}, True),
    "rtsp_no_ffmpeg": ({"type": "rtsp", "url": "rtsp://cam/live"}, False),
    "http": ({"type": "http", "id": "web", "url": "http://x/a.mp3"}, True),
    "http_no_url": ({"type": "http", "id": "web"}, True),
    "audio_card": ({"type": "audio_card", "device": "hw:1,0", "rate": 32000,
                    "channels": 2}, True),
}


@pytest.mark.parametrize("name", sorted(LIVE_SOURCES))
def test_live_sources_build_as_jax(name, tmp_path, monkeypatch, tiny_v24):
    """``rtsp``, ``http`` and ``audio_card`` entries: the same source
    classes, ids, rates and types as JAX's app builds in ``setup`` (the
    native RTSP client where the entry asks for it or ffmpeg is missing,
    else ffmpeg; an entry without its url skipped), not started."""
    cfg, ffmpeg = LIVE_SOURCES[name]

    def case(P):
        _patch_models(P, monkeypatch, tiny_v24)
        ff = importlib.import_module(f"{P.app.__name__[:-4]}.audio.ffmpeg")
        monkeypatch.setattr(ff, "ffmpeg_available", lambda: ffmpeg)
        s = _app_settings(P, _dir(tmp_path, P))
        s.realtime.sources = [dict(cfg)]
        app = (P.app.Application(s) if P is J
               else P.app.Application(s, device="cpu"))
        app.setup()
        out = [(type(x).__name__, x.source, getattr(x, "transport", None),
                getattr(x, "channels", None)) for x in app._sources]
        app.datastore.close()
        return out, sorted(app._source_cfgs)

    got = _both(case)
    assert len(got[0]) == (0 if name == "http_no_url" else 1)


def test_app_serves_a_native_rtsp_source(tmp_path, monkeypatch, tiny_v24):
    """A tiny v2.4 app on the CPU with one ``rtsp`` source on the native
    client, against ``tests/test_torch_sources.py``'s small RTSP server
    (L16 at 48 kHz, sent as fast as the socket takes it): the source
    started by ``start`` as the app starts its sources, its windows served
    by the loop, none dropped."""
    from tests.test_torch_sources import _MiniRtsp, _tone

    _patch_models(T, monkeypatch, tiny_v24)
    srv = _MiniRtsp(_tone(48000 * 8, 48000), rates=(48000,), packet=960)
    srv.start()
    s = _app_settings(T, tmp_path)
    s.realtime.sources = [{"type": "rtsp", "id": "cam", "client": "native",
                           "url": srv.url()}]
    app = T.app.Application(s, device="cpu")
    served = []
    real = app._on_window_result
    app._on_window_result = lambda model_id, w, vals, idx: (
        served.append((model_id, w.source_id)), real(model_id, w, vals, idx))
    app.setup()
    (src,) = app._sources
    assert type(src).__name__ == "RtspSource"
    try:
        src.start()
        _wait(lambda: src.packets >= 400, 20)
        _run_ticks(app)          # before stop() removes the source
    finally:
        src.stop()
        srv.stop()
    assert len(served) >= 4 and set(served) == {("BirdNET_V2.4", "cam")}
    assert app.device_loop.windows_dropped == 0
    app.datastore.close()


class _Capture:
    """``AlsaCapture``'s stand-in for the app: silence until closed."""

    opened: list = []

    def __init__(self, device="default", rate=48000, channels=1,
                 latency_us=100000):
        self.closed = False
        _Capture.opened.append(self)

    def read(self, frames):
        if self.closed:
            raise RuntimeError("closed")
        time.sleep(0.01)
        return np.zeros(frames, np.int16)

    def close(self):
        self.closed = True


def test_soundcard_gates_act_on_soundcard_sources(tmp_path, monkeypatch,
                                                  tiny_v24):
    """The port's ``SoundcardSource`` has the ``audio_card`` type the
    app's quiet-hours gates test: ``_gate_soundcards`` stops and starts
    it (and leaves the tone source alone), and ``_apply_quiet_gates``
    stops it inside its quiet window and starts it after."""
    from birdnet_go_tpu_torch import native

    _patch_models(T, monkeypatch, tiny_v24)
    monkeypatch.setattr(native, "alsa_available", lambda: True)
    monkeypatch.setattr(native, "AlsaCapture", _Capture)
    _Capture.opened = []
    s = _app_settings(T, tmp_path)
    s.realtime.sources = [{"type": "audio_card", "id": "mic"},
                          {"type": "tone", "id": "tone0"}]
    app = T.app.Application(s, device="cpu")
    app.setup()
    mic, tone = app._sources
    assert mic.source.source_type.value == "audio_card"
    calls = []
    monkeypatch.setattr(tone, "start", lambda: calls.append("start"))
    monkeypatch.setattr(tone, "stop", lambda: calls.append("stop"))
    app._gate_soundcards(True)
    assert len(_Capture.opened) == 1 and mic._thread is not None
    app._gate_soundcards(False)
    assert _Capture.opened[0].closed and mic._thread is None
    quiet = {"now": True}
    app.quiet_hours = SimpleNamespace(is_quiet=lambda sid: quiet["now"])
    app._gate_soundcards(True)
    app._apply_quiet_gates()
    assert _Capture.opened[1].closed and app._quiet_gated == {"mic"}
    quiet["now"] = False
    app._apply_quiet_gates()
    assert len(_Capture.opened) == 3 and not _Capture.opened[2].closed
    assert app._quiet_gated == set() and calls == []
    mic.stop()
    app.datastore.close()


# -- the app, deterministic ------------------------------------------------------------

T0 = 1_750_000_000.0        # the PCM's fixed past wall clock (June 2025)
APP_SOURCES = [("tone0", 1800.0), ("tone1", 3100.0)]


@pytest.fixture(scope="module")
def tiny_v24():
    """A tiny float32 v2.4 in both packages on the same JAX ``init``
    weights: the model of ``tests/test_app_integration.py``."""
    jm = JBirdNETv24(num_species=6, mel=JMel(sample_rate=48000, n_fft=256,
                                             hop=8192, n_mels=16),
                     compute_dtype=jnp.float32)
    jm.net = JNet(blocks=(JBlock(1, 8, 3, 2, 1),), embedding_dim=16,
                  num_classes=6)
    params = jm.init(jax.random.PRNGKey(0))
    return (jm, params), _torch_twin(jm, params, jm.spec)


def _torch_twin(jm, params, spec):
    tm = MelCnnModel(jm.num_species, TMel(**dataclasses.asdict(jm.mel)),
                     TNet(blocks=tuple(TBlock(*dataclasses.astuple(b))
                                       for b in jm.net.blocks),
                          embedding_dim=jm.net.embedding_dim,
                          num_classes=jm.net.num_classes), torch.float32)
    tm.spec = spec
    load_jax_params(tm.backbone, jax.tree_util.tree_map(np.asarray, params))
    return tm


class _JaxGeomodel:
    """JAX's stand-in Geomodel (``tests/test_app_integration.py``):
    species 0 and 2 occur, the rest do not."""

    def apply(self, params, coords):
        n = coords.shape[0]
        return jnp.zeros((n, 6), jnp.float32).at[:, 0].set(0.9) \
            .at[:, 2].set(0.8)


class _TorchGeomodel(torch.nn.Module):
    """The same stand-in as a module for ``TorchRangeFilter``."""

    def forward(self, coords):
        out = torch.zeros(coords.shape[0], 6)
        out[:, 0], out[:, 2] = 0.9, 0.8
        return out


def _patch_models(P, monkeypatch, tiny_v24, extra=None):
    """The package's app serves the tiny v2.4 (and `extra`: model id →
    (JAX model and params, port model)) and the stand-in Geomodel."""
    (jm, params), tm = tiny_v24
    models = {"BirdNET_V2.4": ((jm, params), tm), **(extra or {})}
    if P is J:
        monkeypatch.setattr(P.app, "load_model",
                            lambda model_id, checkpoint=None, **kw:
                            models[model_id][0])
        monkeypatch.setattr(P.app, "load_geomodel",
                            lambda num_species=6, **kw: (_JaxGeomodel(), {}))
    else:
        monkeypatch.setattr(P.app, "load_model",
                            lambda model_id, checkpoint=None, **kw:
                            copy.deepcopy(models[model_id][1]))
        monkeypatch.setattr(P.app, "load_geomodel",
                            lambda num_species=6, **kw: _TorchGeomodel())


def _app_settings(P, d: Path, fmt: str = "wav"):
    s = P.settings.Settings()
    s.models = [P.settings.ModelSettings(model_id="BirdNET_V2.4",
                                         threshold=0.0)]
    s.database.path = str(d / "app.db")
    s.export.path = str(d / "clips")
    s.export.format = fmt
    s.export.clip_length_seconds = 4.0
    s.export.pre_capture_seconds = 1.0
    s.webserver.enabled = False
    s.imageprovider.enabled = False
    s.range_filter.enabled = True
    s.location.latitude = 60.2
    s.location.longitude = 24.9
    s.realtime.max_batch = 8
    s.realtime.sources = [{"type": "tone", "id": sid, "freq": f}
                          for sid, f in APP_SOURCES]
    return s


def _make_app(P, d: Path, fmt: str = "wav"):
    app = (P.app.Application(_app_settings(P, d, fmt)) if P is J
           else P.app.Application(_app_settings(P, d, fmt), device="cpu"))
    app.setup()
    # the per-species action gates on a clock that steps 4 s a call: an
    # approval right after one of the same species is suppressed
    clock = itertools.count(T0 + 100.0, 4.0)
    app.event_tracker.clock = lambda: next(clock)
    for src in app._sources:              # registered, not started
        app.engine.add_source(src.source)
    for b in app.device_loop.batchers.values():
        b.warmup()                        # JAX compiles here, not in a tick
    return app


def _app_pcm(seconds: float) -> dict:
    rng = np.random.default_rng(6)
    out = {}
    for sid, f in APP_SOURCES:
        t = np.arange(int(48000 * seconds)) / 48000
        x = 0.3 * np.sin(2 * np.pi * f * t) * (np.sin(2 * np.pi * 0.7 * t)
                                               > 0) \
            + 0.02 * rng.standard_normal(len(t))
        out[sid] = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    return out


def _ingest(app, pcm: dict, t_start: float, seconds: float) -> float:
    """Feed `seconds` of each source's PCM from `t_start` in 0.1 s chunks
    stamped with their end; returns the end time."""
    n = 4800
    k0 = int(round((t_start - T0) * 10))
    for k in range(k0, k0 + int(round(seconds * 10))):
        for sid, x in pcm.items():
            app.engine.ingest(sid, x[k * n:(k + 1) * n],
                              timestamp=T0 + 0.1 * (k + 1))
    return T0 + 0.1 * (k0 + int(round(seconds * 10)))


def _run_ticks(app) -> None:
    while app.device_loop.run_tick():
        pass
    app.device_loop.drain()


def _drain_actions(app) -> None:
    """Run every queued action: the job queue's workers, then the
    renderer's, each drained and stopped."""
    app.jobqueue.start()
    app.prerenderer.start()
    app.jobqueue.stop(drain=True, timeout=30.0)
    app.prerenderer.stop()


def _rows(app) -> list:
    return [tuple(r) for r in app.datastore._conn.execute(
        "SELECT scientific_name, common_name, species_code, source_id, "
        "model_id, timestamp, date, time, begin_time, end_time, clip_name, "
        "confidence FROM detections ORDER BY begin_time, source_id, "
        "scientific_name")]


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_app_serves_like_jax(fmt, tmp_path, monkeypatch, tiny_v24):
    """Setup, 12 s of two tone sources at fixed past timestamps through
    ``engine.ingest``, ticks until empty and a flush every 3 s, the
    actions drained: the same rows (confidence within ``CONF_TOL``), clips
    byte for byte (the port's FLAC encoded in its ``ClipEncoder``'s
    worker processes), PNGs within PR 12's tolerance, included species
    and health."""
    pcm = _app_pcm(12.0)
    recs = {}
    for P in (J, T):
        _patch_models(P, monkeypatch, tiny_v24)
        d = _dir(tmp_path, P)
        app = _make_app(P, d, fmt)
        end = T0
        for _ in range(4):                # a flush every 3 s of audio
            end = _ingest(app, pcm, end, 3.0)
            _run_ticks(app)
            app.processor.flush(now=end + 1e6)
        _drain_actions(app)
        rows = _rows(app)
        clips = {r[10]: (d / "clips" / r[10]).read_bytes() for r in rows
                 if r[10]}
        pngs = {n: np.asarray(Image.open(
            (d / "clips" / n).with_suffix(".png")).convert("RGB"))
            for n in clips}
        health = [(r.name, r.healthy, r.detail)
                  for r in app.health.run_all()]
        recs[P.app.__name__] = (
            rows, clips, pngs, sorted(app.processor.included_species),
            health, app.jobqueue.stats.dropped, app.prerenderer.rendered,
            app.prerenderer.dropped)
        if P is T:
            app.clip_encoder.shutdown()
        app.datastore.close()
    (jrows, jclips, jpngs, jinc, jhealth, *jrest), \
        (trows, tclips, tpngs, tinc, thealth, *trest) = recs.values()
    # a clip's name has no source: two sources' detections of one
    # species at one instant share it, as in JAX, and their two jobs
    # write it in either order, so only the bytes of a name one row holds
    # are compared (and so for the PNGs)
    names = [r[10] for r in jrows]
    own = {n for n in names if names.count(n) == 1}
    assert len(jrows) >= 8 and len(jclips) == len(set(names)) and own
    assert [r[:-1] for r in trows] == [r[:-1] for r in jrows]
    np.testing.assert_allclose([r[-1] for r in trows],
                               [r[-1] for r in jrows], rtol=0, atol=CONF_TOL)
    assert tclips.keys() == jclips.keys()
    assert {n: tclips[n] for n in own} == {n: jclips[n] for n in own}
    assert tpngs.keys() == jpngs.keys()
    for name in own:
        want, got = jpngs[name], tpngs[name]
        assert got.shape == want.shape
        step = np.abs(got.astype(int) - want).max(axis=-1)
        assert step.max() <= RGB_MAX_STEP
        assert (step > 0).mean() <= INDEX_MAX_SHARE
    assert tinc == jinc and len([n for n in tinc
                                 if n.startswith("Synthetica")]) == 2
    assert thealth == jhealth
    for dropped, rendered, render_dropped in (jrest, trest):
        # a shared name renders once or twice, as the jobs interleave
        assert dropped == render_dropped == 0
        assert len(set(names)) <= rendered <= len(names)


def _tiny_v3(tiny_v24):
    """The tiny net with BirdNET v3.0's spec and a 32 kHz mel (the port
    only)."""
    (jm, _), tm = tiny_v24
    from birdnet_go_tpu_torch.models import registry

    v3 = MelCnnModel(6, TMel(sample_rate=32000, n_fft=256, hop=8192,
                             n_mels=16), tm.net, torch.float32)
    v3.spec = registry.BIRDNET_V3
    return v3.init(torch.Generator().manual_seed(1))


def test_runtime_load_and_unload(tmp_path, monkeypatch, tiny_v24):
    """``load_model_runtime`` warms the new model and taps the live
    streams: its windows are served. ``unload_model_runtime`` stops them:
    what the model already held (a staged batch and a batch in flight) is
    served before the batcher goes (its staged batch and the loop's
    backlog for it), none dropped (JAX drops the batcher with those
    windows), and nothing after."""
    v3 = _tiny_v3(tiny_v24)
    monkeypatch.setattr(T.app, "load_model",
                        lambda model_id, checkpoint=None, **kw:
                        copy.deepcopy(tiny_v24[1]) if model_id ==
                        "BirdNET_V2.4" else copy.deepcopy(v3))
    monkeypatch.setattr(T.app, "load_geomodel",
                        lambda num_species=6, **kw: _TorchGeomodel())
    served = []
    app = T.app.Application(_app_settings(T, tmp_path), device="cpu")
    real = app._on_window_result
    app._on_window_result = lambda model_id, w, vals, idx: (
        served.append((model_id, w.end_time)), real(model_id, w, vals, idx))
    app.setup()
    for src in app._sources:
        app.engine.add_source(src.source)
    pcm = _app_pcm(60.0)
    t = _ingest(app, pcm, T0, 6.0)
    _run_ticks(app)
    assert {m for m, _ in served} == {"BirdNET_V2.4"}
    assert app.load_model_runtime("BirdNET_V3.0") is True
    assert app.load_model_runtime("BirdNET_V3.0") is False
    assert set(app.device_loop.batchers) == {"BirdNET_V2.4", "BirdNET_V3.0"}
    t = _ingest(app, pcm, t, 12.0)
    _run_ticks(app)
    v3_served = [e for m, e in served if m == "BirdNET_V3.0"]
    assert v3_served and min(v3_served) > T0 + 6.0
    # leave windows in the model's hands: staged and in the backlog
    t = _ingest(app, pcm, t, 25.0)
    app.device_loop.max_dispatches_per_tick = 1
    app.device_loop.run_tick()
    b3 = app.device_loop.batchers["BirdNET_V3.0"]
    held = len(b3._meta) + sum(len(e[1]) for e in b3._inflight) \
        + len(app.device_loop._backlog.get("BirdNET_V3.0", []))
    assert held > 0
    before = len([m for m, _ in served if m == "BirdNET_V3.0"])
    assert app.unload_model_runtime("BirdNET_V3.0") is True
    assert app.unload_model_runtime("BirdNET_V3.0") is False
    assert len([m for m, _ in served if m == "BirdNET_V3.0"]) == \
        before + held
    assert "BirdNET_V3.0" not in app.device_loop.batchers
    n_v3 = len([m for m, _ in served if m == "BirdNET_V3.0"])
    app.device_loop.max_dispatches_per_tick = 11
    _ingest(app, pcm, t, 6.0)
    _run_ticks(app)
    assert len([m for m, _ in served if m == "BirdNET_V3.0"]) == n_v3
    assert served[-1][0] == "BirdNET_V2.4"
    assert app.device_loop.windows_dropped == 0
    app.datastore.close()


def test_mesh_choice_builds_sharded_classifier(tmp_path, monkeypatch,
                                               tiny_v24):
    """With the device CUDA and more than one card visible (both
    patched), the app serves a ``ShardedClassifier`` over ``make_mesh()``
    (here a mesh that lists the CPU twice); with one card, a
    ``TorchClassifier`` on the app's device (built here on the CPU, the
    device it was asked for recorded)."""
    from birdnet_go_tpu_torch.inference.backend import TorchClassifier
    from birdnet_go_tpu_torch.parallel import mesh as tmesh
    from birdnet_go_tpu_torch.parallel.serving import ShardedClassifier

    _patch_models(T, monkeypatch, tiny_v24)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    real_mesh = tmesh.make_mesh
    monkeypatch.setattr(tmesh, "make_mesh",
                        lambda: real_mesh(devices=["cpu", "cpu"]))
    asked = []
    monkeypatch.setattr(T.app, "TorchClassifier", lambda model, device: (
        asked.append(str(device)), TorchClassifier(model, "cpu"))[1])
    for count, kind in ((2, ShardedClassifier), (1, TorchClassifier)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        s = _app_settings(T, tmp_path / str(count))
        s.range_filter.enabled = False
        app = T.app.Application(s, device="cuda")
        app.setup()
        clf = app.classifiers["BirdNET_V2.4"]
        assert isinstance(clf, kind)
        assert (app._mesh is None) == (count == 1)
        b = app.device_loop.batchers["BirdNET_V2.4"]
        assert b.classifier is clf and b.device.type == "cpu"
        app.datastore.close()
    assert app._mesh is None and asked == ["cuda"]


def _mysql_on(port: int):
    def enable(s):
        d = s.database
        d.type, d.host, d.port = "mysql", "127.0.0.1", port
        d.user, d.password, d.name = "bird", "sekret", ""
    return enable


def _built(app, name: str):
    """What `app` built for the integration `name`: its class and the
    settings it took, comparable across the packages."""
    if name == "mqtt":
        m = app.mqtt
        return m and (type(m).__name__, m.host, m.port, m.client_id,
                      m.username, m.password, m.keepalive, m.tls)
    if name == "birdweather":
        b = app.birdweather
        return b and (type(b).__name__, dataclasses.asdict(b.config),
                      type(b.breaker).__name__)
    if name == "weather":
        w = app.weather_poller
        return w and (type(w).__name__, type(w.provider).__name__,
                      sorted((k, v) for k, v in vars(w.provider).items()
                             if k != "session"), w.interval,
                      w.datastore is app.datastore)
    if name == "backup":
        b = app.backup
        return b and (type(b).__name__, dataclasses.asdict(b.config),
                      b.db_path, type(b.target).__name__,
                      str(getattr(b.target, "dir", "")))
    ds = app.datastore
    return (type(ds).__name__, ds.path.split("@")[1].split(":")[0],
            ds.count_detections())


INTEGRATIONS = {
    "mqtt": (lambda s: (setattr(s.mqtt, "enabled", True),
                        setattr(s.mqtt, "port", 1),
                        setattr(s.mqtt, "username", "u")),
             "_reconfigure_mqtt"),
    "birdweather": (lambda s: (setattr(s.birdweather, "enabled", True),
                               setattr(s.birdweather, "station_token", "x")),
                    "_reconfigure_birdweather"),
    "weather": (lambda s: (setattr(s.weather, "provider", "openweather"),
                           setattr(s.weather, "openweather_api_key", "k"),
                           setattr(s.weather, "poll_interval_hours", 2.0)),
                "_reconfigure_weather"),
    "backup": (lambda s: (setattr(s.backup, "enabled", True),
                          setattr(s.backup, "passphrase", "pw"),
                          setattr(s.backup, "keep", 3)), None),
    "mysql": (None, None),
}


@pytest.mark.parametrize("name", sorted(INTEGRATIONS))
def test_integration_built_as_jax(name, tmp_path, monkeypatch, tiny_v24):
    """Each integration of ROADMAP item 8 is built by ``setup`` as JAX's
    app builds it, and, where JAX reconfigures it live, by its
    ``_reconfigure_*`` handler on a running configuration (nothing is
    started: ``_started`` is off). MySQL against the port's test server,
    which both packages' datastores use."""
    from birdnet_go_tpu_torch.diag.mysql_server import MySQLServer

    enable, handler = INTEGRATIONS[name]
    server = None
    if name == "mysql":
        server = MySQLServer(password="sekret")
        server.start()
        enable = _mysql_on(server.port)
    built = {}
    try:
        for P in (J, T):
            _patch_models(P, monkeypatch, tiny_v24)
            d = _dir(tmp_path, P)
            s = _app_settings(P, d)
            s.backup.target_dir = str(tmp_path / "backups")
            s.database.path = str(tmp_path / "app.db")
            enable(s)
            app = (P.app.Application(s) if P is J
                   else P.app.Application(s, device="cpu"))
            app.setup()
            rec = [_built(app, name)]
            app.datastore.close()
            if handler is not None:
                live = _app_settings(P, d / "live")
                live.database.path = str(tmp_path / "live.db")
                app = (P.app.Application(live) if P is J
                       else P.app.Application(live, device="cpu"))
                app.setup()
                rec.append(_built(app, name))
                enable(app.settings)
                getattr(app, handler)()
                rec.append(_built(app, name))
                app.datastore.close()
            built[P.app.__name__] = rec
    finally:
        if server is not None:
            server.stop()
    assert built[T.app.__name__] == built[J.app.__name__]
    rec = built[T.app.__name__]
    assert rec[0] and (handler is None or (rec[1] is None and rec[2]))


@pytest.mark.parametrize("name", ["webserver", "imageprovider"])
def test_setup_builds_the_api_and_the_image_service(name, tmp_path,
                                                    monkeypatch, tiny_v24):
    """``webserver.enabled`` and ``imageprovider.enabled`` (both on by
    default) build the ``ApiServer`` and the image service in ``setup``,
    as JAX's app does; neither is refused any more."""
    from birdnet_go_tpu_torch.api.server import ApiServer
    from birdnet_go_tpu_torch.integrations.imageprovider import (
        ImageProviderService,
    )

    _patch_models(T, monkeypatch, tiny_v24)
    s = _app_settings(T, tmp_path)
    getattr(s, name).enabled = True
    s.imageprovider.providers = ["avicommons"]
    s.webserver.host, s.webserver.port = "127.0.0.1", 0
    app = T.app.Application(s, device="cpu")
    app.setup()
    if name == "webserver":
        assert isinstance(app.api, ApiServer) and app.api.ctx is app
        assert app.images is None
    else:
        assert isinstance(app.images, ImageProviderService)
        assert [p.name for p in app.images.providers] == ["avicommons"]
        assert app.api is None
    assert (app.api is not None) == (name == "webserver")
    app.datastore.close()


def test_application_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.app.Application(_app_settings(T, tmp_path))


class _FastEvent(threading.Event):
    """An Event whose waits last 10 ms whatever the timeout asked."""

    def wait(self, timeout=None):
        return super().wait(0.01 if timeout is not None else None)


def test_threshold_persist_stop_race(tmp_path, monkeypatch, tiny_v24):
    """``stop()`` sets the persistence thread's Event and then sets the
    attribute to None. JAX's thread re-reads the attribute at every wait,
    so nulled while it persists, it dies with AttributeError; the port's
    thread owns its Event and ends cleanly. (JAX's ``app.py`` uses
    ``threading`` in ``start`` without importing it; the test lends it
    a module with a 10 ms Event, the port a 10 ms interval.)"""
    died = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: died.append(a.exc_type))
    monkeypatch.setattr(J.app, "threading", types.SimpleNamespace(
        Event=_FastEvent, Thread=threading.Thread), raising=False)
    monkeypatch.setattr(T.app.Application, "THRESHOLD_PERSIST_SECONDS",
                        0.01)
    outcome = {}
    for P in (J, T):
        _patch_models(P, monkeypatch, tiny_v24)
        s = _app_settings(P, _dir(tmp_path, P))
        s.dynamic_threshold.enabled = True
        s.realtime.sources = []
        app = (P.app.Application(s) if P is J
               else P.app.Application(s, device="cpu"))
        app.setup()
        entered, release = threading.Event(), threading.Event()
        saves = []

        def slow_save(snap, saves=saves, entered=entered, release=release):
            saves.append(snap)
            entered.set()
            assert release.wait(10)

        app.datastore.save_dynamic_thresholds = slow_save
        app.start(warmup=False)
        thread = app._threshold_persist_thread
        assert entered.wait(10)
        # what stop() does to the attribute, while the thread persists
        app._threshold_persist_stop.set()
        app._threshold_persist_stop = None
        release.set()
        thread.join(10)
        outcome[P.app.__name__] = (thread.is_alive(), list(died))
        died.clear()
        app._threshold_persist_thread = None
        app.datastore.save_dynamic_thresholds = lambda snap: None
        app.stop()
    assert outcome == {"birdnet_go_tpu.app": (False, [AttributeError]),
                       "birdnet_go_tpu_torch.app": (False, [])}


# -- serve --------------------------------------------------------------------------

def _serve_config(tmp_path: Path, sources: int = 2, **extra) -> Path:
    cfg = {"models": [{"model_id": "BirdNET_V2.4", "threshold": 0.0}],
           "database": {"path": str(tmp_path / "serve.db")},
           "export": {"path": str(tmp_path / "clips"), "format": "wav",
                      "clip_length_seconds": 4.0,
                      "pre_capture_seconds": 1.0},
           "realtime": {"max_batch": 4, "sources": [
               {"type": "tone", "id": f"tone{k}", "freq": 1000 + 700 * k}
               for k in range(sources)]},
           **extra}
    path = tmp_path / "app.json"
    path.write_text(json.dumps(cfg))
    return path


def test_serve_headless_in_process(tmp_path, monkeypatch, capsys, tiny_v24):
    """``serve --device cpu --config app.json`` with the tiny model, which
    now serves with the API on (the name is from when ``serve`` ran
    headless): it serves, answers ``/api/v2/health`` and
    ``/api/v2/system/info`` in the process at the port it prints, and on
    SIGTERM stops with exit 0, its windows in the pipeline stats."""
    import urllib.request

    from birdnet_go_tpu_torch.cli import main as tcli

    _patch_models(T, monkeypatch, tiny_v24)
    handlers = {}
    monkeypatch.setattr(signal, "signal",
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    apps = []
    real_start = T.app.Application.start

    def start(self, warmup=True):
        apps.append(self)
        real_start(self, warmup)

    monkeypatch.setattr(T.app.Application, "start", start)

    answers = {}

    def terminate():
        _wait(lambda: signal.SIGTERM in handlers and apps
              and apps[0].device_loop.batchers["BirdNET_V2.4"]
              .stats.windows_processed > 0, 60)
        base = f"http://127.0.0.1:{apps[0].api.port}/api/v2"
        for route in ("health", "system/info"):
            with urllib.request.urlopen(f"{base}/{route}", timeout=30) as r:
                answers[route] = (r.status, json.loads(r.read()))
        handlers[signal.SIGTERM](signal.SIGTERM, None)

    killer = threading.Thread(target=terminate)
    killer.start()
    rc = tcli.main(["serve", "--device", "cpu", "--config",
                    str(_serve_config(tmp_path, webserver={
                        "host": "127.0.0.1", "port": 0}))])
    killer.join()
    out = capsys.readouterr().out
    assert rc == 0
    app = apps[0]
    assert f"serving on http://127.0.0.1:{app.api.port} on cpu: 1 model(s)" \
        f", 2 source(s)" in out
    assert "headless" not in out
    assert answers["health"][0] == 200
    assert answers["health"][1]["version"] == "0.1.0"
    assert answers["system/info"][1]["devices"] == ["cpu"]
    assert answers["system/info"][1]["sources"] == ["tone0", "tone1"]
    assert app.settings.webserver.enabled and app.images is not None
    assert app.device_loop.batchers["BirdNET_V2.4"].stats.windows_processed


def test_serve_subprocess_stops_on_sigterm(tmp_path):
    """``python -m birdnet_go_tpu_torch serve --device cpu --config
    app.json`` (the full-width v2.4 on seeded weights, batch 4, two tone
    sources, the API at a port the OS picks): it prints the serving line
    with the API's address, answers ``/api/v2/health`` there, and exits 0
    on SIGTERM with no traceback."""
    import re
    import urllib.request

    cfg = _serve_config(tmp_path, webserver={"host": "127.0.0.1",
                                             "port": 0})
    proc = subprocess.Popen(
        [sys.executable, "-m", "birdnet_go_tpu_torch", "serve", "--device",
         "cpu", "--config", str(cfg)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on"):
                break
        url = re.search(r"http://[\d.]+:\d+", lines[-1]).group(0)
        with urllib.request.urlopen(f"{url}/api/v2/health",
                                    timeout=30) as r:
            health = (r.status, json.loads(r.read())["version"])
        time.sleep(4.0)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = "".join(lines) + out
    assert proc.returncode == 0, err[-3000:]
    assert re.search(r"serving on http://127\.0\.0\.1:\d+ on cpu: "
                     r"1 model\(s\), 2 source\(s\)", out), out
    assert health == (200, "0.1.0")
    assert "Traceback" not in err and "application stopped" in err


def test_serve_without_a_card_names_device_cpu(monkeypatch, capsys, tmp_path):
    from birdnet_go_tpu_torch.cli import main as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(T.app, "Application",
                        lambda *a, **k: built.append(a))
    for argv in (["serve"], ["serve", "--config",
                             str(_serve_config(tmp_path))]):
        assert tcli.main(argv) == 1
        assert "pass --device cpu to run serve" in capsys.readouterr().err
    assert built == []


class _Ran:
    def __init__(self, returncode=0, stdout="", stderr=""):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def test_probe_raises_and_does_not_degrade(monkeypatch):
    """The port's probe returns the card's name from its child, and raises
    ``BackendUnavailable`` (naming ``--device cpu``) when the child fails
    or times out; JAX's returns "cpu" and pins its process there. Where
    torch sees no card, the real child fails too."""
    from birdnet_go_tpu.utils import backendprobe as jprobe
    from birdnet_go_tpu_torch.utils import backendprobe as tprobe

    if not torch.cuda.is_available():
        with pytest.raises(tprobe.BackendUnavailable,
                           match="is_available.*--device cpu"):
            tprobe.probe_backend(timeout_s=120)
    calls = []

    def timeout(*a, **k):
        calls.append(k.get("env"))
        raise subprocess.TimeoutExpired("probe", 1)

    monkeypatch.setattr(tprobe.subprocess, "run", timeout)
    with pytest.raises(tprobe.BackendUnavailable, match="within 1 s"):
        tprobe.probe_backend(timeout_s=1, env={"CUDA_VISIBLE_DEVICES": ""})
    assert calls == [{"CUDA_VISIBLE_DEVICES": ""}]
    monkeypatch.setattr(tprobe.subprocess, "run", lambda *a, **k: _Ran(
        1, "", "Traceback...\nAssertionError: no card"))
    with pytest.raises(tprobe.BackendUnavailable, match="no card"):
        tprobe.probe_backend()
    monkeypatch.setattr(tprobe.subprocess, "run", lambda *a, **k: _Ran(
        0, "DEVICE=NVIDIA H100 80GB HBM3\n"))
    assert tprobe.probe_backend() == "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jprobe.subprocess, "run", timeout)
    monkeypatch.setattr(jprobe, "_degrade", lambda reason: None)
    assert jprobe.probe_backend(timeout_s=1) == "cpu"   # JAX degrades


# -- settings from JSON ---------------------------------------------------------------

JSON_CONFIGS = [
    {},
    {"models": [{"model_id": "BirdNET_V3.0", "threshold": 0.4,
                 "overlap": 1.5}],
     "birdnet": {"latitude": 60.17, "longitude": 24.94},
     "realtime": {"max_batch": 64, "sources": [
         {"type": "tone", "id": "t0", "freq": 1200},
         {"type": "file", "id": "f0", "path": "/tmp/x.wav"}]},
     "export": {"enabled": True, "format": "flac"},
     "dynamic_threshold": {"enabled": True, "trigger": 0.8}},
    {"webserver": {"enabled": False, "port": 9090},
     "deep_detection": {"level": 2}, "range_filter": {"threshold": 0.03},
     "database": {"path": "x.db"}, "species": {"include": ["Parus major"],
                                               "config": {"Parus major": {
                                                   "threshold": 0.5}}},
     "log": {"level": "debug"}},
]


@pytest.mark.parametrize("k", range(len(JSON_CONFIGS)))
def test_load_settings_reads_json_without_yaml(k, tmp_path, monkeypatch):
    """With yaml blocked, the port's ``load_settings`` reads a JSON config
    as JAX's (with yaml) reads it; a file that is not JSON then raises
    ``ImportError`` naming yaml."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps(JSON_CONFIGS[k]))
    want = J.settings.load_settings(str(path), env={})
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = T.settings.load_settings(str(path), env={})
    assert _plain(got) == _plain(want)
    path.write_text("models:\n  - model_id: BirdNET_V2.4\n")
    with pytest.raises(ImportError, match="yaml"):
        T.settings.load_settings(str(path), env={})


def test_setup_caps_the_blas_pool(tmp_path, monkeypatch, tiny_v24):
    """The port's ``setup`` sets numpy's OpenBLAS pool to one thread (the
    source threads' resampling products would each wake a pool); a
    product's result is the same at either size."""
    from birdnet_go_tpu_torch.utils.blas import blas_threads, set_blas_threads

    if not blas_threads():
        pytest.skip("numpy is not built on OpenBLAS here")
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3200, 72)).astype(np.float32)
    h = rng.standard_normal(72).astype(np.float32)
    set_blas_threads(4)
    pooled = a @ h
    _patch_models(T, monkeypatch, tiny_v24)
    app = T.app.Application(_app_settings(T, tmp_path), device="cpu")
    app.setup()
    assert blas_threads() == [1] * len(blas_threads())
    np.testing.assert_array_equal(a @ h, pooled)
    app.datastore.close()


# -- monitors and the pipeline stats -------------------------------------------------

def test_system_monitor_and_metrics_history(tmp_path):
    """The resource monitor's critical paths (deduplicated by mount) and
    one sample into an alerting engine; the metrics history's ring. The
    values are the machine's own, so the record keeps their kinds."""
    def case(P):
        s = P.settings.Settings()
        s.database.path = str(tmp_path / "db" / "x.db")
        s.export.path = str(tmp_path / "clips")
        s.data_dir = str(tmp_path)
        eng = P.alerting.AlertingEngine()
        mon = P.monitor.SystemMonitor(eng, s, extra_paths=[str(tmp_path)])
        paths = mon.critical_paths()
        mon._cpu_percent()
        time.sleep(0.05)      # a jiffy of /proc/stat, or no CPU delta yet
        n = mon.sample_once()
        hist = P.sysmonitor.MetricsHistory(clip_dir=str(tmp_path), keep=2)
        for _ in range(3):
            hist.sample_once()
        return (paths, n, sorted(eng._metric_samples),
                [sorted(h) for h in hist.history()],
                P.monitor.dedupe_by_mount([str(tmp_path), str(tmp_path / "a"),
                                           "", "/nonexistent/x/y"]))

    _both(case)


class _Batcher:
    def __init__(self):
        self.stats = SimpleNamespace(windows_processed=0, overruns=0,
                                     windows_deferred=0, last_batch_fill=0.5,
                                     last_latency_ms=12.0)


def test_pipeline_stats_lines():
    """The stats logger's lines over scripted deltas: idle silence, dedup
    of a steady rate, unhealthy intervals always logged, the back-to-normal
    line, drops and a pending backlog."""
    def case(P):
        b = _Batcher()
        loop = SimpleNamespace(batchers={"m": b}, windows_dropped=0)
        proc = SimpleNamespace(_pending={})
        ps = P.pipeline_stats.PipelineStatsLogger(loop, proc,
                                                  interval_seconds=10.0)
        clock = {"t": 0.0}
        ps.dedup.clock = lambda: clock["t"]
        out = []
        for dw, over, drop, pending in ((0, 0, 0, 0), (500, 0, 0, 0),
                                        (505, 0, 0, 0), (500, 2, 0, 0),
                                        (500, 0, 0, 0), (0, 0, 3, 40),
                                        (500, 0, 0, 0)):
            clock["t"] += 10
            b.stats.windows_processed += dw
            b.stats.overruns += over
            loop.windows_dropped += drop
            proc._pending = dict.fromkeys(range(pending))
            out.append(ps.tick())
        return out, ps.lines_emitted

    _both(case)
