"""The port's API (``birdnet_go_tpu_torch/api/``: the handlers copied from
the JAX package over ``api/web.py``, the standard library's ``asyncio``
under aiohttp's names) against the JAX package's aiohttp server, on the
CPU.

Both apps are built as ``tests/test_torch_app.py``'s ``_make_app`` builds
them: the same settings (here with the webserver on, a password, no local
bypass, and the image provider on Avicommons' local dataset), the same
tiny v2.4 on the same JAX ``init`` weights, and the same PCM through
``engine.ingest``, ticks and flushes, so both databases hold the same
rows. Each app's ``ApiServer`` is started alone (the app's threads stay
off), each client logs in, and ``REQUESTS`` (every route group of JAX's
``server.py`` and ``handlers_ext.py``, and the auth flow) goes to both
in order. The status codes, the content types and the JSON bodies are
equal, confidences within ``CONF_TOL``, but for the fields of
``DIFFER``, each with its reason. The files the clients receive differ
only in the two apps' directories, which the comparison names ``<dir>``.

Also here: the behaviours of ``api/web.py`` that the handlers depend on,
each against aiohttp on the same small app or on the same request to
both servers; the routes it serves as JAX does without the subsystem
(the terminal, TLS and logins have files of their own:
``tests/test_torch_terminal.py``, ``test_torch_tls.py``,
``test_torch_logins.py``); ``stop()`` with SSE clients connected; an SSE client
receiving the detections ``_run_ticks`` approves; the SPA files byte for
byte; ``auth reset`` against JAX's command; and the helper modules the
handlers reach (metrics, sysinfo, insights, speciesdict, the update
check, the image providers) through both packages.

No request leaves the machine: the image providers have Avicommons'
local dataset only, the update check's cache is filled beforehand, and
no redirect is followed.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import datetime
import email.utils
import errno
import http.client
import importlib
import json
import math
import socket
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tests import test_torch_app as A
from tests.test_torch_app import tiny_v24  # noqa: F401  (fixture)

J, T = A.J, A.T
REPO = Path(__file__).resolve().parents[1]
PASSWORD = "correct horse"
CONF_TOL = A.CONF_TOL
V2 = "/api/v2"

# fields that may differ between the two servers' JSON, and why
DIFFER = {
    "devices": "the torch devices the app serves on (cpu) against "
               "jax.devices() (this machine's 8 virtual CPU devices)",
    "backend": "the port's torch-cpu against JAX's jax-tpu",
    "jax_backend": "JAX's diagnostics name its backend; the port's "
                   "name theirs under backend",
    "uptime_seconds": "the time since each server started",
    "latency_ms": "a health check's wall time",
    "time": "the wall clock when the request was answered",
    "checked_at": "the wall clock of the update check",
    "modified": "a clip file's mtime: each app wrote its own",
    "csrf": "a session's random CSRF token",
    "token": "a random bearer token",
    "code": "a random OAuth2 authorization code",
    "access_token": "a random OAuth2 access token",
    "created_at": "the wall clock a notification or rule was stored",
    "timestamp_wall": "the wall clock of an operational event",
    "last_data": "the wall clock a source last delivered",
    "last_data_at": "the wall clock a source last delivered",
    "cached_at": "the wall clock of an image lookup",
    "process_rss_bytes": "the process's memory when each answered",
    "last_latency_ms": "the wall time of the app's last batch",
    "tick_busy_ms": "the wall time of the app's ticks",
    "tick_busy_ms_max": "the wall time of the app's longest tick",
    "stall_ms_max": "the wall time of the app's longest tick stall",
    "retried": "a job retried where the job queue's workers raced the "
               "drain (either app, now and then)",
}

# a spectrogram PNG's bytes: its pixels agree to tests/test_torch_app.py's
# image tolerance, not bit for bit, so its size may differ
PNG_SIZE = "size_bytes"


# -- the two servers ------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


API_START_TRIES = 5


def _start_api(app) -> None:
    """The app's API server started on ``127.0.0.1``. The port's binds port
    0 and reports the port the OS gave it; JAX's ``ApiServer`` cannot
    report one, so it is given a free port, and a fresh one where another
    process took that port before the server bound it (EADDRINUSE), up to
    API_START_TRIES times."""
    api = app.api
    if type(api).__module__.startswith("birdnet_go_tpu_torch."):
        api.start()
        return
    run = api._run
    for _ in range(API_START_TRIES):
        failed = []

        def guarded():
            try:
                run()
            except OSError as e:          # the bind: no loop runs yet
                failed.append(e)
                api._started.set()

        api._run = guarded
        api.port = _free_port()
        api.start()
        if not failed:
            return
        if failed[0].errno != errno.EADDRINUSE:
            raise failed[0]
        api._started.clear()
    raise RuntimeError(f"no free port in {API_START_TRIES} tries")


def _api_settings(P, d: Path):
    s = A._app_settings(P, d)
    s.data_dir = str(d)
    ws = s.webserver
    ws.enabled, ws.host, ws.port = True, "127.0.0.1", 0
    ws.password = PASSWORD
    ws.allow_local_bypass = False
    ws.token_file = str(d / "tokens.json")
    s.imageprovider.enabled = True
    s.imageprovider.providers = ["avicommons"]
    s.imageprovider.avicommons_dataset = str(d / "avicommons.json")
    return s


def _avicommons(d: Path) -> None:
    (d / "avicommons.json").write_text(json.dumps([
        {"sciName": f"Synthetica speciei{i:04d}", "code": f"syn{i}",
         "key": f"k{i}", "by": "tester", "license": "cc-by"}
        for i in range(3)]))


def _build(P, d: Path, configure=None):
    """``_make_app`` with the API's settings (changed by `configure`, where
    given) and one job-queue worker, 6 s of both tones ingested, ticked
    and flushed, the actions drained, and one detection of this morning:
    the app, not started."""
    _avicommons(d)
    s = _api_settings(P, d)
    if configure is not None:
        configure(P, s)
    app = (J.app.Application(s) if P is J
           else T.app.Application(s, device="cpu"))
    app.setup()
    # one job-queue worker: rows are saved, and numbered, in the order the
    # processor approved them, the same in both apps
    app.jobqueue._workers = 1
    clock = iter(np.arange(A.T0 + 100.0, A.T0 + 1e6, 4.0))
    app.event_tracker.clock = lambda: next(clock)
    for src in app._sources:
        app.engine.add_source(src.source)
    for b in app.device_loop.batchers.values():
        b.warmup()
    end = A._ingest(app, A._app_pcm(6.0), A.T0, 6.0)
    A._run_ticks(app)
    app.processor.flush(now=end + 1e6)
    A._drain_actions(app)
    results = importlib.import_module(f"{P.app.__name__[:-4]}.analysis."
                                      f"results")
    labels = importlib.import_module(f"{P.app.__name__[:-4]}.taxonomy."
                                     f"labels")
    morning = datetime.datetime.combine(datetime.date.today(),
                                        datetime.time(6, 30))
    app.datastore.insert_detection(results.Detection(
        species=labels.Species("Synthetica speciei0001",
                               "Synthetic Species 0001"),
        confidence=0.75, begin_seconds=morning.timestamp(),
        end_seconds=morning.timestamp() + 3, model_id="BirdNET_V2.4",
        source_id="tone0", timestamp=morning, species_code="syn1"))
    return app


class Client:
    """HTTP/1.1 to one server, one connection a request, no redirect
    followed; after ``login`` it sends the session cookie, and the CSRF
    token with every mutation."""

    def __init__(self, port: int, root: Path):
        self.port, self.root = port, str(root)
        self.cookie = self.csrf = None

    def call(self, method: str, path: str, body=None, headers=None,
             raw: bytes | None = None, auth: bool = True):
        h = dict(headers or {})
        data = raw
        if body is not None:
            data = json.dumps(body).encode()
            h.setdefault("Content-Type", "application/json")
        if auth and self.cookie:
            h.setdefault("Cookie", self.cookie)
            if method not in ("GET", "HEAD"):
                h.setdefault("X-CSRF-Token", self.csrf)
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            c.request(method, path, body=data, headers=h)
            r = c.getresponse()
            return r.status, {k.lower(): v for k, v in r.getheaders()}, \
                r.read()
        finally:
            c.close()

    def login(self) -> None:
        st, h, b = self.call("POST", f"{V2}/auth/login",
                             {"password": PASSWORD}, auth=False)
        assert st == 200, b
        self.cookie = h["set-cookie"].split(";", 1)[0]
        self.csrf = json.loads(b)["csrf"]


@pytest.fixture(scope="module")
def pair(tiny_v24, tmp_path_factory):  # noqa: F811
    """The JAX app and the port's, each with its API server started and a
    logged-in client: {"jax": ..., "torch": ...}."""
    with pytest.MonkeyPatch.context() as mp:
        sides = {}
        for P in (J, T):
            A._patch_models(P, mp, tiny_v24)
            pkg = P.app.__name__.split(".")[0]
            d = tmp_path_factory.mktemp(pkg)
            # the update check answers from its cache: nothing leaves
            upd = importlib.import_module(f"{pkg}.utils.update")
            mp.setattr(upd, "_cache", (time.time() + 1e6, {
                "current": "0.1.0", "latest": "0.1.0",
                "update_available": False, "url": None,
                "checked_at": 0.0}))
            app = _build(P, d)
            _start_api(app)
            client = Client(app.api.port, d)
            client.login()
            sides["jax" if P is J else "torch"] = SimpleNamespace(
                app=app, client=client, dir=d)
        yield sides
        for side in sides.values():
            side.app.api.stop()
            if hasattr(side.app, "clip_encoder"):
                side.app.clip_encoder.shutdown()
            side.app.datastore.close()


# -- comparison -------------------------------------------------------------------------

def _drop(x):
    if isinstance(x, dict):
        png = str(x.get("name", "")).endswith(".png")
        return {k: _drop(v) for k, v in x.items()
                if k not in DIFFER and not (png and k == PNG_SIZE)}
    if isinstance(x, list):
        return [_drop(v) for v in x]
    return x


def _same(a, b, where="") -> None:
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (where, a, b)
        assert math.isclose(a, b, rel_tol=CONF_TOL, abs_tol=CONF_TOL), \
            (where, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _text(side, body: bytes) -> str:
    """The body with the app's directory and the server's port named."""
    return body.decode("utf-8", "replace").replace(
        side.client.root, "<dir>").replace(
        f'"port": {side.client.port}', '"port": "<port>"')


def _json_of(side, body: bytes):
    return _drop(json.loads(_text(side, body)))


# -- the requests -------------------------------------------------------------------------

D1 = "Synthetica%20speciei0000"
TODAY = datetime.date.today().isoformat()

# (method, path, JSON body, how to compare): "json" the bodies after
# DIFFER; "keys" the top-level keys (this machine's state: processes,
# disks, memory); "text" the bodies as text; "status" the status and the
# content type only (a zip, a rendered PNG, the metrics text)
REQUESTS = [
    # health / ping / PWA / SPA
    ("GET", f"{V2}/health", None, "json"),
    ("GET", f"{V2}/ping", None, "json"),
    ("GET", "/manifest.json", None, "json"),
    ("GET", "/", None, "text"),
    ("GET", "/ui", None, "text"),
    ("GET", "/ui/detections/1", None, "text"),
    ("GET", "/sw.js", None, "text"),
    ("GET", "/static/app.js", None, "text"),
    ("GET", "/static/views/dashboard.js", None, "text"),
    ("GET", "/static/nope.js", None, "text"),
    ("GET", "/login", None, "text"),
    ("GET", "/.well-known/acme-challenge/abc", None, "text"),
    # auth
    ("GET", f"{V2}/auth/status", None, "json"),
    ("GET", f"{V2}/auth/oidc/login", None, "json"),
    ("GET", f"{V2}/auth/oidc/callback?code=x&state=y", None, "json"),
    ("GET", f"{V2}/auth/github/login", None, "json"),
    ("GET", f"{V2}/auth/github/callback", None, "json"),
    ("GET", f"{V2}/oauth2/authorize?client_id=birdnet-client", None,
     "json"),
    ("GET", f"{V2}/oauth2/authorize?client_id=other", None, "json"),
    ("POST", f"{V2}/oauth2/token", {"grant_type": "bogus"}, "json"),
    ("POST", f"{V2}/oauth2/token", {"grant_type": "client_credentials",
                                    "client_id": "birdnet-client",
                                    "client_secret": "x"}, "json"),
    ("POST", f"{V2}/auth/tokens", {"name": "ci"}, "json"),
    ("DELETE", f"{V2}/auth/tokens", {"token": "unknown"}, "json"),
    # detections
    ("GET", f"{V2}/detections", None, "json"),
    ("GET", f"{V2}/detections?species=Synthetica&limit=2&order=asc", None,
     "json"),
    ("GET", f"{V2}/detections/recent?limit=3", None, "json"),
    ("GET", f"{V2}/detections/new?since=0", None, "json"),
    ("GET", f"{V2}/detections/pending", None, "json"),
    ("GET", f"{V2}/detections/1", None, "json"),
    ("GET", f"{V2}/detections/999", None, "json"),
    ("GET", f"{V2}/detections/1/time-of-day", None, "json"),
    ("GET", f"{V2}/detections/1/results", None, "json"),
    ("GET", f"{V2}/detections/1/reviews", None, "json"),
    ("POST", f"{V2}/detections/1/review", {"verdict": "correct"}, "json"),
    ("POST", f"{V2}/detections/1/review", {"verdict": "maybe"}, "json"),
    ("GET", f"{V2}/detections/1/reviews", None, "keys"),
    ("POST", f"{V2}/detections/1/comments", {"text": "nice"}, "json"),
    ("POST", f"{V2}/detections/1/comments", {"text": " "}, "json"),
    ("GET", f"{V2}/detections/1/comments", None, "keys"),
    ("PUT", f"{V2}/comments/1", {"text": "nicer"}, "json"),
    ("DELETE", f"{V2}/comments/1", None, "json"),
    ("DELETE", f"{V2}/comments/99", None, "json"),
    ("POST", f"{V2}/detections/2/lock", {"locked": True}, "json"),
    ("DELETE", f"{V2}/detections/2", None, "json"),
    ("DELETE", f"{V2}/detections/2/lock", None, "json"),
    ("POST", f"{V2}/detections/search", {"species": "Synthetica",
                                         "sort_by": "confidence"}, "json"),
    ("POST", f"{V2}/detections/search", {"sort_by": "nope"}, "json"),
    ("POST", f"{V2}/detections/search", {"time_of_day": ["noon"]}, "json"),
    ("POST", f"{V2}/search", {"limit": 2}, "json"),
    ("GET", f"{V2}/detections/export", None, "text"),
    ("GET", f"{V2}/detections/export?format=xml", None, "json"),
    ("POST", f"{V2}/detections/batch/review", {"ids": [1, 3],
                                               "verified": "correct"},
     "json"),
    ("POST", f"{V2}/detections/batch/review", {"ids": [1]}, "json"),
    ("POST", f"{V2}/detections/batch/lock", {"ids": [3, "x", 3]}, "json"),
    ("POST", f"{V2}/detections/batch/resolve", {"species": "Synthetica"},
     "json"),
    ("POST", f"{V2}/detections/batch/resolve", {"hour": "25"}, "json"),
    ("POST", f"{V2}/detections/batch/delete", {"ids": []}, "json"),
    ("POST", f"{V2}/detections/batch/delete", {"ids": [3, 99]}, "json"),
    # analytics
    ("GET", f"{V2}/analytics/summary", None, "json"),
    ("GET", f"{V2}/analytics/daily?from=2025-06-01&to=2025-06-30", None,
     "json"),
    ("GET", f"{V2}/analytics/hourly?date=2025-06-15", None, "json"),
    ("GET", f"{V2}/analytics/distribution/hourly", None, "json"),
    ("GET", f"{V2}/analytics/distribution/species?limit=2", None, "json"),
    ("GET", f"{V2}/analytics/heatmap?from=2025-06-01&to=2025-06-30", None,
     "json"),
    ("GET", f"{V2}/analytics/heatmap?from=2025-06-01&to=2025-06-30"
     f"&format=csv", None, "text"),
    ("GET", f"{V2}/analytics/confidence", None, "json"),
    ("GET", f"{V2}/analytics/species/first-seen", None, "json"),
    ("GET", f"{V2}/analytics/phenology/{D1}", None, "json"),
    ("GET", f"{V2}/analytics/phenology/{D1}?year=2025", None, "json"),
    ("GET", f"{V2}/analytics/year-over-year", None, "json"),
    ("GET", f"{V2}/analytics/accumulation?from=2025-01-01", None, "json"),
    ("GET", f"{V2}/analytics/diversity?from=2025-01-01", None, "json"),
    ("GET", f"{V2}/analytics/time-of-day?from=2025-01-01&top=3", None,
     "json"),
    ("GET", f"{V2}/analytics/time-of-day?top=x", None, "json"),
    ("GET", f"{V2}/analytics/species-daily-trend?from=2025-01-01", None,
     "json"),
    ("GET", f"{V2}/analytics/dawn-onset", None, "json"),
    ("GET", f"{V2}/analytics/dawn-chorus?date=2025-06-15", None, "json"),
    ("GET", f"{V2}/analytics/database/stats", None, "json"),
    ("GET", f"{V2}/analytics/daily-events/2025-06-15", None, "json"),
    ("GET", f"{V2}/analytics/species/daily?date=2025-06-15", None, "json"),
    ("GET", f"{V2}/analytics/species/daily?min_confidence=x", None, "json"),
    ("GET", f"{V2}/analytics/trends?days=7", None, "json"),
    ("GET", f"{V2}/analytics/dashboard/kpis", None, "json"),
    ("GET", f"{V2}/analytics/succession?from=2025-01-01", None, "json"),
    # insights
    ("GET", f"{V2}/insights/expected-today", None, "json"),
    ("GET", f"{V2}/insights/expected-today/regional", None, "json"),
    ("GET", f"{V2}/insights/phantom-species", None, "json"),
    ("GET", f"{V2}/insights/dawn-chorus", None, "json"),
    ("GET", f"{V2}/insights/migration", None, "json"),
    ("GET", f"{V2}/dashboard/kpis", None, "json"),
    # weather, sun, moon
    ("GET", f"{V2}/sun/2025-06-15", None, "json"),
    ("GET", f"{V2}/sun/june", None, "json"),
    ("GET", f"{V2}/weather/hourly/2025-06-15", None, "json"),
    ("GET", f"{V2}/weather/daily/2025-06-15", None, "json"),
    ("GET", f"{V2}/weather/sun/2025-06-15", None, "json"),
    ("GET", f"{V2}/weather/moon/2025-06-15", None, "json"),
    # streams, sources, quiet hours, devices
    ("GET", f"{V2}/streams/health", None, "keys"),
    ("GET", f"{V2}/streams/health/tone0", None, "keys"),
    ("GET", f"{V2}/streams/health/nope", None, "json"),
    ("POST", f"{V2}/streams/test", {"url": "ftp://x"}, "json"),
    ("POST", f"{V2}/streams/test", {"url": "http://127.0.0.1:9/"}, "json"),
    ("POST", f"{V2}/restart-source/nope", None, "json"),
    ("GET", f"{V2}/quiet-hours/status", None, "json"),
    ("GET", f"{V2}/devices", None, "json"),
    ("GET", f"{V2}/system/audio/active", None, "keys"),
    ("GET", f"{V2}/system/audio/sources", None, "json"),
    ("GET", f"{V2}/system/audio/equalizer/config", None, "json"),
    ("PUT", f"{V2}/system/audio/equalizer/config", {"filters": "x"},
     "json"),
    ("PUT", f"{V2}/system/audio/equalizer/config",
     {"enabled": False, "filters": []}, "json"),
    # system
    ("GET", f"{V2}/system/info", None, "json"),
    ("GET", f"{V2}/system/inference", None, "json"),
    ("GET", f"{V2}/system/inference/spans?limit=5", None, "keys"),
    ("GET", f"{V2}/system/scheduler", None, "json"),
    ("GET", f"{V2}/system/processes?limit=3", None, "keys"),
    ("GET", f"{V2}/system/disks", None, "keys"),
    ("GET", f"{V2}/system/temperature/cpu", None, "keys"),
    ("GET", f"{V2}/system/jobs", None, "json"),
    ("GET", f"{V2}/system/control/signals", None, "json"),
    ("POST", f"{V2}/system/control", {"signal": "nope"}, "json"),
    ("POST", f"{V2}/system/control", {"signal": "reload_thresholds"},
     "json"),
    ("GET", f"{V2}/system/diagnostics", None, "json"),
    ("POST", f"{V2}/system/diagnostics/run", None, "json"),
    ("GET", f"{V2}/system/database", None, "json"),
    ("GET", f"{V2}/system/database/overview", None, "json"),
    ("POST", f"{V2}/system/storage/reconcile", None, "json"),
    ("GET", f"{V2}/system/resources", None, "keys"),
    ("GET", f"{V2}/system/errors?limit=1", None, "status"),
    ("GET", f"{V2}/system/restart-status", None, "json"),
    ("GET", f"{V2}/system/metrics/history", None, "json"),
    ("GET", f"{V2}/system/network-interfaces", None, "json"),
    ("GET", f"{V2}/system/events/operational", None, "json"),
    ("GET", f"{V2}/system/update-check", None, "json"),
    ("GET", f"{V2}/system/telemetry", None, "json"),
    ("GET", f"{V2}/debug/profile?seconds=0.05", None, "status"),
    ("GET", f"{V2}/system/database/backup/jobs", None, "json"),
    ("POST", f"{V2}/system/database/backup", None, "json"),
    ("POST", f"{V2}/system/database/backup/verify", None, "json"),
    ("GET", "/metrics", None, "status"),
    # settings
    ("GET", f"{V2}/settings", None, "json"),
    ("GET", f"{V2}/settings/schema", None, "json"),
    ("PATCH", f"{V2}/settings/range_filter", {"threshold": 0.02}, "json"),
    ("PATCH", f"{V2}/settings/location", "hello", "json"),
    ("PATCH", f"{V2}/settings/nope", {}, "json"),
    ("PATCH", f"{V2}/settings/models", {"x": 1}, "json"),
    ("PATCH", f"{V2}/settings/realtime", {"max_batch": "many"}, "json"),
    ("PUT", f"{V2}/settings", {"species": {"include": []}}, "json"),
    ("GET", f"{V2}/app/config", None, "json"),
    ("POST", f"{V2}/app/wizard/dismiss", None, "json"),
    ("GET", f"{V2}/app/config", None, "json"),
    ("GET", f"{V2}/control/actions", None, "json"),
    ("GET", f"{V2}/sse/status", None, "json"),
    # range filter (the stand-in Geomodel on each app's device)
    ("GET", f"{V2}/range/status", None, "json"),
    ("GET", f"{V2}/range/species/list", None, "json"),
    ("GET", f"{V2}/range/species/count", None, "json"),
    ("GET", f"{V2}/range/species/csv", None, "text"),
    ("GET", f"{V2}/range/species/scores?limit=4", None, "json"),
    ("POST", f"{V2}/range/species/test", {"latitude": 10, "longitude": 20,
                                          "week": 12}, "json"),
    ("POST", f"{V2}/range/species/test", {"latitude": 10}, "json"),
    ("GET", f"{V2}/range/heatmap?resolution=6&week=20", None, "json"),
    ("GET", f"{V2}/range/heatmap?resolution=4&species_index=2", None,
     "json"),
    ("GET", f"{V2}/range/heatmap?resolution=x", None, "json"),
    ("POST", f"{V2}/range/rebuild", None, "json"),
    # alerts
    ("GET", f"{V2}/alerts/rules", None, "json"),
    ("POST", f"{V2}/alerts/rules", {"nope": 1}, "json"),
    ("DELETE", f"{V2}/alerts/rules/nope", None, "json"),
    ("POST", f"{V2}/alerts/rules/nope/test", None, "json"),
    ("GET", f"{V2}/alerts/history", None, "json"),
    ("GET", f"{V2}/alerts/rules/export", None, "json"),
    ("POST", f"{V2}/alerts/rules/import", {"rules": [{"nope": 1}]}, "json"),
    # notifications
    ("POST", f"{V2}/notifications/test", {"title": "hi"}, "json"),
    ("GET", f"{V2}/notifications", None, "json"),
    ("GET", f"{V2}/notifications/unread/count", None, "json"),
    ("GET", f"{V2}/notifications/999", None, "json"),
    ("PUT", f"{V2}/notifications/999/read", None, "json"),
    ("PUT", f"{V2}/notifications/read-all", None, "json"),
    ("DELETE", f"{V2}/notifications/999", None, "json"),
    # dynamic thresholds
    ("GET", f"{V2}/dynamic-thresholds", None, "json"),
    ("GET", f"{V2}/dynamic-thresholds/stats", None, "json"),
    ("GET", f"{V2}/dynamic-thresholds/events", None, "json"),
    ("DELETE", f"{V2}/dynamic-thresholds/{D1}", None, "json"),
    ("DELETE", f"{V2}/dynamic-thresholds", None, "json"),
    # media, spectrograms, clips
    ("GET", f"{V2}/spectrogram/1/status", None, "json"),
    ("GET", f"{V2}/spectrogram/999/status", None, "json"),
    ("GET", f"{V2}/spectrogram/1", None, "status"),
    ("POST", f"{V2}/spectrogram/1/generate", None, "json"),
    ("POST", f"{V2}/spectrogram/999/generate", None, "json"),
    ("GET", f"{V2}/spectrogram/999", None, "json"),
    ("GET", f"{V2}/audio/1", None, "status"),
    ("GET", f"{V2}/audio/999", None, "json"),
    ("POST", f"{V2}/audio/1/clip", None, "json"),
    ("POST", f"{V2}/audio/1/process", {"gain_db": -6.0}, "status"),
    ("GET", f"{V2}/media/audio/..%2F..%2Fetc%2Fpasswd", None, "json"),
    ("GET", f"{V2}/media/audio/nope.wav", None, "json"),
    ("GET", f"{V2}/media/spectrogram/nope.png", None, "json"),
    ("GET", f"{V2}/filesystem/clips", None, "json"),
    # live audio and HLS (HLS: the playlist and segments need a session's
    # segmenter thread, see test_hls_routes)
    ("GET", f"{V2}/audio/live/nope", None, "json"),
    ("POST", f"{V2}/audio/hls/nope/start", None, "json"),
    ("POST", f"{V2}/audio/hls/nope/heartbeat", None, "json"),
    ("GET", f"{V2}/audio/hls/nope/playlist.m3u8", None, "json"),
    ("GET", f"{V2}/audio/hls/nope/init.mp4", None, "json"),
    ("GET", f"{V2}/audio/hls/nope/seg1.m4s", None, "json"),
    ("POST", f"{V2}/audio/hls/nope/stop", None, "json"),
    # species, taxonomy, images
    ("GET", f"{V2}/species", None, "json"),
    ("GET", f"{V2}/species/all?limit=3&offset=1", None, "json"),
    ("GET", f"{V2}/species/search?q=s", None, "json"),
    ("GET", f"{V2}/species/search?q=speciei0002", None, "json"),
    ("GET", f"{V2}/species/taxonomy?name=Synthetica%20speciei0000", None,
     "json"),
    ("GET", f"{V2}/species/taxonomy", None, "json"),
    ("GET", f"{V2}/taxonomy/tree", None, "json"),
    ("GET", f"{V2}/taxonomy/genus/Synthetica", None, "json"),
    ("GET", f"{V2}/taxonomy/genus/Nope", None, "json"),
    ("GET", f"{V2}/taxonomy/family/nope", None, "json"),
    ("GET", f"{V2}/species/info?name=Synthetica%20speciei0000", None,
     "json"),
    ("GET", f"{V2}/species/locales", None, "json"),
    ("GET", f"{V2}/species/dictionary/en", None, "json"),
    ("GET", f"{V2}/species/first-seen/{D1}", None, "json"),
    ("GET", f"{V2}/species/nope/thumbnail", None, "json"),
    ("GET", f"{V2}/media/species-image?name=Synthetica%20speciei0000", None,
     "json"),
    ("GET", f"{V2}/media/species-image?name=Nope%20nope", None, "json"),
    ("GET", f"{V2}/media/species-image", None, "json"),
    ("GET", f"{V2}/species/thumbnail?name=Synthetica%20speciei0001", None,
     "text"),
    ("GET", f"{V2}/species/thumbnail?name=Nope%20nope", None, "json"),
    ("GET", f"{V2}/media/species-image/stats", None, "json"),
    # models
    ("GET", f"{V2}/models", None, "json"),
    ("GET", f"{V2}/models/catalog", None, "json"),
    ("GET", f"{V2}/models/installed", None, "json"),
    ("POST", f"{V2}/models/load/BirdNET_V2.4", None, "json"),
    ("POST", f"{V2}/models/load/NoSuchModel", None, "json"),
    ("POST", f"{V2}/models/unload/NoSuchModel", None, "json"),
    ("POST", f"{V2}/models/install/NoSuchModel", None, "json"),
    ("GET", f"{V2}/models/install/NoSuchModel/progress", None, "json"),
    ("DELETE", f"{V2}/models/installed/NoSuchModel", None, "json"),
    # migration, support, integrations
    ("GET", f"{V2}/migration/status", None, "json"),
    ("POST", f"{V2}/migration/start", {"path": "/nonexistent.db"}, "json"),
    ("POST", f"{V2}/migration/pause", None, "json"),
    ("GET", f"{V2}/support/dump", None, "status"),
    ("POST", f"{V2}/support/generate", None, "status"),
    ("GET", f"{V2}/integrations/mqtt/status", None, "json"),
    ("POST", f"{V2}/integrations/mqtt/homeassistant/discovery", None,
     "json"),
    ("POST", f"{V2}/integrations/birdweather/test", None, "json"),
    ("POST", f"{V2}/integrations/weather/test", None, "json"),
    ("POST", f"{V2}/integrations/ebird/test", None, "json"),
    ("GET", f"{V2}/ebird/taxonomy", None, "json"),
    ("GET", f"{V2}/ebird/observations", None, "json"),
    # method and route misses, through the security middleware
    ("DELETE", f"{V2}/health", None, "text"),
    ("GET", f"{V2}/no/such/route", None, "text"),
    ("POST", f"{V2}/detections/1", {}, "text"),
]


def _compare(pair, method, path, body, how, **kw):
    out = {}
    for name, side in pair.items():
        out[name] = (side, *side.client.call(method, path, body, **kw))
    (js, jst, jh, jb), (ts, tst, th, tb) = out["jax"], out["torch"]
    where = f"{method} {path}"
    assert tst == jst, (where, jst, tst, jb[:300], tb[:300])
    assert th.get("content-type") == jh.get("content-type"), where
    assert th.get("location") == jh.get("location"), where
    if how == "json":
        _same(_json_of(ts, tb), _json_of(js, jb), where)
    elif how == "keys":
        got, want = json.loads(tb), json.loads(jb)
        assert type(got) is type(want), where
        if isinstance(want, dict):
            assert got.keys() == want.keys(), where
    elif how == "text":
        assert _text(ts, tb) == _text(js, jb), where
    return out


def test_every_route_group_answers_as_jax(pair):
    """``REQUESTS`` in order to both servers, each logged in: the same
    status codes, content types and bodies but for ``DIFFER``."""
    seen, wrong = set(), []
    for method, path, body, how in REQUESTS:
        try:
            _compare(pair, method, path, body, how)
        except (AssertionError, ValueError) as e:
            wrong.append(f"{method} {path}: {str(e).splitlines()[0][:400]}")
        seen.add(path.split("?")[0].removeprefix(V2).split("/")[1])
    assert not wrong, "\n".join(wrong)
    # every route group of server.py and handlers_ext.py
    assert {"health", "detections", "analytics", "insights", "weather",
            "streams", "system", "settings", "range", "alerts",
            "notifications", "dynamic-thresholds", "spectrogram", "audio",
            "media", "species", "taxonomy", "models", "migration",
            "support", "integrations", "ebird", "auth", "oauth2",
            "comments", "filesystem", "quiet-hours", "restart-source",
            "app", "control", "sse", "debug", "search", "sun",
            "dashboard", "devices"} <= seen


def test_auth_flow_answers_as_jax(pair):
    """Without a session: 401 on an API route, the public routes open; a
    wrong password 401; a session's mutation without its CSRF token 403;
    a bearer token from ``auth/tokens`` and HTTP Basic let a client in,
    and a revoked token no more; the OAuth2 code grant."""
    anon = {"auth": False}
    _compare(pair, "GET", f"{V2}/detections", None, "json", **anon)
    _compare(pair, "GET", f"{V2}/health", None, "keys", **anon)
    _compare(pair, "GET", f"{V2}/auth/status", None, "json", **anon)
    _compare(pair, "POST", f"{V2}/auth/login", {"password": "no"}, "json",
             **anon)
    fresh = {}
    for name, side in pair.items():
        c = Client(side.client.port, side.dir)
        c.login()
        fresh[name] = c
    tokens = {}
    for name, c in fresh.items():
        st, h, b = c.call("POST", f"{V2}/settings/nope", {},
                          headers={"X-CSRF-Token": "wrong"})
        assert (st, json.loads(b)) == (403, {"error": "CSRF token missing"})
        st, _, b = c.call("POST", f"{V2}/auth/tokens", {"name": "ci"})
        assert st == 200
        tokens[name] = json.loads(b)["token"]
        bearer = {"Authorization": f"Bearer {tokens[name]}"}
        st, _, _ = c.call("GET", f"{V2}/detections/1", headers=bearer,
                          auth=False)
        assert st == 200
        basic = base64.b64encode(f"u:{PASSWORD}".encode()).decode()
        st, _, _ = c.call("GET", f"{V2}/detections/1", auth=False,
                          headers={"Authorization": f"Basic {basic}"})
        assert st == 200
        st, _, b = c.call("DELETE", f"{V2}/auth/tokens",
                          {"token": tokens[name]})
        assert (st, json.loads(b)) == (200, {"revoked": True})
        st, _, b = c.call("GET", f"{V2}/detections/1", headers=bearer,
                          auth=False)
        assert (st, json.loads(b)) == (401, {"error": "invalid token"})
        st, _, b = c.call("GET", f"{V2}/oauth2/authorize?client_id="
                          f"birdnet-client")
        code = json.loads(b)["code"]
        st, _, b = c.call("POST", f"{V2}/oauth2/token", auth=False,
                          raw=f"grant_type=authorization_code&code={code}"
                              f"&client_id=birdnet-client".encode(),
                          headers={"Content-Type":
                                   "application/x-www-form-urlencoded"})
        assert st == 200 and json.loads(b)["token_type"] == "Bearer"
        st, h, _ = c.call("GET", f"{V2}/oauth2/authorize?client_id="
                          f"birdnet-client&redirect_uri=http://evil/")
        assert st == 400
        st, h, b = c.call("POST", f"{V2}/auth/logout")
        assert (st, json.loads(b)) == (200, {"authenticated": False})
        assert "Max-Age=0" in h["set-cookie"]
        assert c.call("GET", f"{V2}/detections")[0] == 401


# -- api/web.py against aiohttp ---------------------------------------------------------

def _webs():
    from aiohttp import web as aio

    from birdnet_go_tpu_torch.api import web as port
    return {"aiohttp": aio, "port": port}


@contextlib.contextmanager
def _serve(web, build, **runner_kw):
    """`build(web)`'s app on a loop thread of its own: its port."""
    loop = asyncio.new_event_loop()
    ready, box = threading.Event(), {}

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(build(web), **runner_kw)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        # the port the OS gave it: aiohttp's runner lists the addresses
        port = site.port if hasattr(type(site), "port") else \
            runner.addresses[0][1]
        box.update(runner=runner, port=port)
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10)
    try:
        yield box["port"], box
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(15)


def _raw(port: int, method: str, path: str, headers=None, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def _routes_app(web):
    app = web.Application()
    r = app.router

    def answer(tag):
        async def h(request):
            return web.json_response({"h": tag, **request.match_info})
        return h

    r.add_get("/x/{a}", answer("dyn"))
    r.add_get("/x/{b:\\d+}", answer("regex"))       # never: first wins
    r.add_get("/x/new", answer("plain"))            # a longer prefix
    r.add_get("/p/{rest:.+}", answer("tail"))
    r.add_post("/p/{rest:.+}", answer("tail-post"))
    r.add_get("/y/{n}/z", answer("inner"))
    r.add_get("/q", answer("q"))
    return app


@pytest.mark.parametrize("method,path", [
    ("GET", "/x/5"), ("GET", "/x/new"), ("GET", "/x/a%20b"),
    ("GET", "/p/a/b%2Fc"), ("POST", "/p/a/b"), ("GET", "/y/3/z"),
    ("GET", "/y/3/w"), ("PUT", "/x/5"), ("DELETE", "/p/a"),
    ("GET", "/q/"), ("HEAD", "/x/5"), ("GET", "/x/../q"),
])
def test_routing_as_aiohttp(method, path):
    """The first registered route of a prefix wins, a longer plain prefix
    before it, ``match_info`` percent-decoded, ``HEAD`` on ``add_get``,
    405 with ``Allow`` for a path that matches with the wrong method and
    404 otherwise: status, headers that matter and body as aiohttp's."""
    got = {}
    for name, web in _webs().items():
        with _serve(web, _routes_app) as (port, _):
            st, h, b = _raw(port, method, path)
            got[name] = (st, h.get("content-type"), h.get("allow"),
                         h.get("content-length"), b)
    assert got["port"] == got["aiohttp"]


def _misc_app(web):
    app = web.Application()
    r = app.router
    log = []

    async def boom(request):
        raise RuntimeError("boom")

    async def echo(request):
        body = await request.read()
        return web.json_response({"remote": request.remote,
                                  "host": request.host, "len": len(body),
                                  "q": dict(request.query),
                                  "ct": request.content_type,
                                  "cookies": dict(request.cookies)})

    async def stream(request):
        resp = web.StreamResponse(headers={"Content-Type": "text/plain"})
        await resp.prepare(request)
        try:
            for _ in range(2000):
                await resp.write(b"x" * 4096)
                await asyncio.sleep(0.005)
            log.append("finished")
        except Exception as e:       # the client went away
            log.append(isinstance(e, ConnectionResetError))
        return resp

    async def log_view(request):
        return web.json_response(log)

    async def text(request):
        return web.Response(text="hello", headers={"X-A": "1"})

    async def cookie(request):
        resp = web.json_response({"ok": True})
        resp.set_cookie("sid", "v1", httponly=True, samesite="Lax",
                        max_age=60)
        resp.del_cookie("old")
        return resp

    async def found(request):
        raise web.HTTPFound("/q")

    async def bad(request):
        raise web.HTTPBadRequest(text='{"error": "x"}',
                                 content_type="application/json")

    r.add_get("/boom", boom)
    r.add_route("POST", "/echo", echo)
    r.add_get("/echo", echo)
    r.add_get("/stream", stream)
    r.add_get("/log", log_view)
    r.add_get("/text", text)
    r.add_get("/cookie", cookie)
    r.add_get("/found", found)
    r.add_get("/bad", bad)
    return app


@pytest.mark.parametrize("method,path,headers,body", [
    ("GET", "/boom", {}, None),
    ("GET", "/text", {}, None),
    ("HEAD", "/text", {}, None),
    ("GET", "/found", {}, None),
    ("GET", "/bad", {}, None),
    ("GET", "/cookie", {}, None),
    ("GET", "/echo?a=1&a=2&b=%20x", {"Cookie": "sid=v; other=2",
                                     "Content-Type": "text/csv; charset=x"},
     None),
    ("POST", "/echo", {"Content-Type": "application/json"}, b'{"k": 1}'),
    ("POST", "/echo", {}, b"y" * (1024 ** 2 + 1)),
])
def test_responses_as_aiohttp(method, path, headers, body):
    """An unhandled exception answers 500 (and the next request is
    served), text and JSON responses, HEAD, a raised redirect and error,
    cookies set and deleted, the request's ``remote``, ``host``,
    ``query``, ``cookies`` and ``content_type``, and a body over 1 MiB
    read by the handler (413): as aiohttp answers them."""
    got = {}
    for name, web in _webs().items():
        with _serve(web, _misc_app) as (port, _):
            st, h, b = _raw(port, method, path, headers, body)
            after = _raw(port, "GET", "/text")[0]
            b = b.replace(str(port).encode(), b"<port>")
            got[name] = (st, h.get("content-type"), h.get("location"),
                         h.get("content-length"),
                         sorted(h.get("set-cookie", "").split(", ")), b,
                         after)
    assert got["port"] == got["aiohttp"]


def test_write_to_a_closed_stream_raises_connection_reset():
    """A handler writing into a stream whose client has gone gets
    ``ConnectionResetError`` (the SSE pumps end on it), as in aiohttp."""
    got = {}
    for name, web in _webs().items():
        with _serve(web, _misc_app) as (port, _):
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
            assert s.recv(4096)
            s.close()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                log = json.loads(_raw(port, "GET", "/log")[2])
                if log:
                    break
                time.sleep(0.05)
            got[name] = log
    assert got["port"] == got["aiohttp"] == [True]


def test_keep_alive_and_idle_timeout():
    """Two requests over one connection, then the server closes it after
    its idle timeout: as aiohttp."""
    got = {}
    for name, web in _webs().items():
        with _serve(web, _misc_app, keepalive_timeout=0.5) as (port, _):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            c.request("GET", "/text")
            first = c.getresponse().read()
            sock = c.sock
            c.request("GET", "/echo")
            second = json.loads(c.getresponse().read())["len"]
            same = c.sock is sock
            time.sleep(2.5)
            closed = c.sock.recv(1) == b""
            c.close()
            got[name] = (first, second, same, closed)
    assert got["port"] == got["aiohttp"] == (b"hello", 0, True, True)


def test_file_response_ranges_and_conditionals(pair):
    """A clip through ``media/audio``: the whole file, a Range (206 with
    its Content-Range), a suffix Range, an unsatisfiable and a multiple
    Range (416), If-Modified-Since after and before its mtime (304, 200),
    its own ETag in If-None-Match (304), HEAD: as JAX's aiohttp."""
    jax, port = pair["jax"], pair["torch"]
    name = next(p for p in sorted((jax.dir / "clips").rglob("*.wav")))
    rel = name.relative_to(jax.dir / "clips").as_posix()
    assert (port.dir / "clips" / rel).read_bytes() == name.read_bytes()
    url = f"{V2}/media/audio/{rel}"
    later = email.utils.formatdate(time.time() + 86400, usegmt=True)
    cases = [{}, {"Range": "bytes=0-99"}, {"Range": "bytes=-50"},
             {"Range": "bytes=100-"}, {"Range": "bytes=99999999-"},
             {"Range": "bytes=0-1,5-6"}, {"Range": "bytes=5-2"},
             {"If-Modified-Since": later},
             {"If-Modified-Since": "Mon, 01 Jan 2001 00:00:00 GMT"}]
    for headers in cases:
        out = {}
        for side in (jax, port):
            st, h, b = side.client.call("GET", url, headers=headers)
            out[side is port] = (st, h.get("content-type"),
                                 h.get("content-range"),
                                 h.get("accept-ranges"), b)
        assert out[True] == out[False], headers
    for side in (jax, port):
        st, h, b = side.client.call("GET", url)
        st2, _, b2 = side.client.call("GET", url,
                                      headers={"If-None-Match": h["etag"]})
        assert (st, st2, b2) == (200, 304, b"")
        st3, h3, b3 = side.client.call("HEAD", url)
        assert (st3, b3, h3["content-length"]) == (200, b"", str(len(b)))


class _Ran:
    def __init__(self, stdout: bytes):
        self.returncode, self.stdout, self.stderr = 0, stdout, b""


def _fake_tools(cmd, **kw):
    """ffprobe's JSON for a probe, else two channels of PCM, one silent."""
    if "-show_streams" in cmd:
        return _Ran(json.dumps({
            "streams": [{"codec_type": "audio", "codec_name": "pcm_s16be",
                         "sample_rate": "48000", "channels": 2}],
            "format": {"format_name": "rtsp"}}).encode())
    pcm = np.zeros((4800, 2), np.int16)
    pcm[:, 1] = np.where(np.arange(4800) % 2 == 0, 9000, -9000)
    return _Ran(pcm.tobytes())


@pytest.mark.parametrize("tools", ["missing", "present"])
def test_stream_probe_routes_answer_as_jax(pair, tools, monkeypatch):
    """``POST streams/probe`` and ``POST streams/analyze-channels`` answer
    as JAX's handlers do: 503 with the helper's body without ffprobe and
    ffmpeg (the card's machine has neither), 200 with it when the
    binaries answer (faked here through the helpers' ``run``)."""
    import functools
    import shutil

    monkeypatch.setattr(shutil, "which", lambda n: (
        None if tools == "missing" else f"/usr/bin/{n}"))
    for P in (J, T):
        ff = importlib.import_module(f"{P.app.__name__[:-4]}.audio.ffmpeg")
        monkeypatch.setattr(ff, "ffmpeg_available",
                            lambda: tools == "present")
        for name in ("probe_stream", "analyze_channels"):
            monkeypatch.setattr(ff, name, functools.partial(
                getattr(ff, name), run=_fake_tools))
    for route, body in (("streams/probe", {"url": "rtsp://cam/1"}),
                        ("streams/analyze-channels",
                         {"url": "rtsp://cam/1", "seconds": 0.1,
                          "channels": 2})):
        out = _compare(pair, "POST", f"{V2}/{route}", body, "json")
        assert out["torch"][1] == (503 if tools == "missing" else 200)
        assert json.loads(out["torch"][3])["ok"] is (tools == "present")


def test_absent_subsystem_routes_answer_as_jax(pair):
    """The integrations' routes (``diag/api_walk.INTEGRATION_ROUTES``) on
    apps that run none of them answer as JAX's: MQTT's test tries a
    transient client (here to a port that refuses) and answers 502, the
    others 503 or their empty answers."""
    from birdnet_go_tpu_torch.diag.api_walk import INTEGRATION_ROUTES

    refused = _free_port()
    for side in pair.values():
        side.app.settings.mqtt.port = refused
    try:
        statuses = []
        for method, route, _ in INTEGRATION_ROUTES:
            out = _compare(pair, method, f"{V2}/{route}",
                           {} if method == "POST" else None, "json")
            statuses.append(out["torch"][1])
    finally:
        for side in pair.values():
            side.app.settings.mqtt.port = 1883
    assert statuses == [200, 502, 502, 503, 503, 503, 503, 503, 200, 503,
                        200, 503]


def _with_integrations(services, out: Path):
    """`configure` for ``_build``: the integrations of ROADMAP item 8 on,
    against `services` (``diag/fake_services.Services``): MQTT with
    retained messages, yr.no weather, eBird, and encrypted backups to a
    local directory under `out`. BirdWeather is turned on after the build
    (``_birdweather_on``): its client's base URL can only be pointed at
    the fake once it exists, and ``_build`` posts its detections."""
    ports = services.ports()

    def configure(P, s):
        s.mqtt.enabled, s.mqtt.host = True, "127.0.0.1"
        s.mqtt.port, s.mqtt.topic, s.mqtt.retain = ports["mqtt"], "bn", True
        s.weather.provider = "yrno"
        s.ebird.enabled, s.ebird.api_token = True, ports["ebird_token"]
        s.backup.enabled, s.backup.passphrase = True, "pass"
        s.backup.target_dir = str(out / P.app.__name__.split(".")[0])
    return configure


def _birdweather_on(app, token: str, base_url: str) -> None:
    """BirdWeather turned on in a built app through its control-signal
    handler, its client pointed at `base_url` before anything posts."""
    s = app.settings.birdweather
    s.enabled, s.station_token = True, token
    app._reconfigure_birdweather()
    app.birdweather.config.base_url = base_url


@pytest.fixture(scope="module")
def ipair(tiny_v24, tmp_path_factory):  # noqa: F811
    """Both apps as ``pair`` builds them, with every integration on
    against one set of fake services (the MQTT clients started; nothing
    else of the apps' threads runs): {"jax": ..., "torch": ...,
    "services": ...}."""
    from birdnet_go_tpu_torch.diag import fake_services as FS

    services = FS.Services(tmp_path_factory.mktemp("services"),
                           topic="bn").start()
    urls = FS.urls(services.ports())
    sides = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for P in (J, T):
                A._patch_models(P, mp, tiny_v24)
                pkg = P.app.__name__.split(".")[0]
                mp.setattr(importlib.import_module(
                    f"{pkg}.integrations.weather").YrNoProvider, "BASE",
                    urls["yrno"])
                mp.setattr(importlib.import_module(
                    f"{pkg}.integrations.ebird"), "API_BASE", urls["ebird"])
                upd = importlib.import_module(f"{pkg}.utils.update")
                mp.setattr(upd, "_cache", (time.time() + 1e6, {
                    "current": "0.1.0", "latest": "0.1.0",
                    "update_available": False, "url": None,
                    "checked_at": 0.0}))
                d = tmp_path_factory.mktemp(f"i_{pkg}")
                app = _build(P, d, _with_integrations(services, d))
                _birdweather_on(app, services.ports()["station_token"],
                                urls["birdweather"])
                app.mqtt.start()
                assert app.mqtt.wait_connected(10)
                _start_api(app)
                client = Client(app.api.port, d)
                client.login()
                sides["jax" if P is J else "torch"] = SimpleNamespace(
                    app=app, client=client, dir=d)
            yield {**sides, "services": services}
    finally:
        for side in sides.values():
            side.app.api.stop()
            side.app.mqtt.stop()
            if hasattr(side.app, "clip_encoder"):
                side.app.clip_encoder.shutdown()
            side.app.datastore.close()
        services.stop()


def test_integration_routes_answer_as_jax(ipair):
    """``diag/api_walk.integrations_walk`` (what ``chip_smoke.py`` phase 20
    walks on the card) on both apps with every integration on: each
    status is the walk's, and JAX's; the bodies are JAX's but for a
    backup's name and its files' bytes (each app's database holds its
    own wall clocks). The fakes received the same: HA configs retained,
    a test message on the topic each, the BirdWeather probe, yr.no's
    forecast, eBird's queries."""
    from birdnet_go_tpu_torch.diag.api_walk import (
        Client as WalkClient,
        integrations_walk,
    )

    services = ipair["services"]
    bodies, statuses = {}, {}
    for name in ("jax", "torch"):
        side = ipair[name]
        walker = WalkClient(side.app.api.port, PASSWORD)
        walker.login()
        records, bodies[name] = integrations_walk(walker, backup=True)
        statuses[name] = [(r["route"], r["status"], r["want"])
                          for r in records]
    assert statuses["torch"] == statuses["jax"]
    assert all(st == want for _, st, want in statuses["torch"]), statuses
    for route in bodies["torch"]:
        got, want = (json.loads(bodies[n][route]) for n in ("torch", "jax"))
        if route.startswith("system/database/backup"):
            for b in (got, want):
                b.pop("backup", None), b.pop("archive", None)
                if "files" in b:
                    b["files"] = sorted(b["files"])
        _same(_drop(got), _drop(want), route)
    assert json.loads(bodies["torch"]["system/database/backup/verify"])[
        "encrypted"] is True
    from birdnet_go_tpu_torch.integrations.mqtt import ha_discovery_payloads

    assert sorted(services.broker.retained) == sorted(
        ha_discovery_payloads("bn"))
    assert [t for t, _, _ in services.received] == ["bn/test", "bn/test"]
    paths = {k: [r["path"] for r in v.requests]
             for k, v in services.http.items()}
    assert paths["birdweather"] == [
        f"/api/v1/stations/{services.ports()['station_token']}"] * 2
    # eBird: the test's taxonomy query, cached for the taxonomy route; the
    # observations, then the regional insight's (14 days back)
    assert len(paths["yrno"]) == 2 and paths["ebird"] == [
        "/v2/ref/taxonomy/ebird", "/v2/data/obs/geo/recent",
        "/v2/data/obs/geo/recent"] * 2


def test_system_info_names_the_device(pair):
    """``system/info`` lists the app's torch devices by name (``cpu``
    here) and ``system/inference`` its backend."""
    c = pair["torch"].client
    assert json.loads(c.call("GET", f"{V2}/system/info")[2])["devices"] \
        == ["cpu"]
    inf = json.loads(c.call("GET", f"{V2}/system/inference")[2])
    assert [m["backend"] for m in inf] == ["torch-cpu"]


def _sse_events(sock, n: int, timeout: float = 20.0,
                quiet: float | None = None) -> list:
    """The first `n` events (name, data) read off an SSE response; with
    `quiet`, every event until none came for `quiet` seconds."""
    sock.settimeout(quiet or timeout)
    buf, events = b"", []
    while len(events) < n:
        try:
            chunk = sock.recv(65536)
        except TimeoutError:
            if quiet:
                return events
            raise
        assert chunk, "the stream ended"
        buf += chunk
        for block in buf.split(b"\n\n")[:-1]:
            lines = dict(ln.split(b": ", 1) for ln in block.split(b"\n")
                         if b": " in ln and not ln.startswith(b":"))
            if b"event" in lines:
                events.append((lines[b"event"].decode(),
                               lines[b"data"].decode()))
        buf = buf.split(b"\n\n")[-1]
        # chunk-size lines of the chunked framing sit between blocks
    return events


def _open_sse(side, path: str) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", side.client.port))
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\nCookie: "
              f"{side.client.cookie}\r\n\r\n".encode())
    return s


def test_sse_client_receives_what_run_ticks_approves(pair):
    """An SSE client on ``detections/stream`` in each app: 4 s more of
    both tones ingested, ticked and flushed, the actions drained; the
    client receives a ``detection`` event for rows the ticks approved
    (each species' broadcasts gated by the event tracker, as its saves
    are), with the row's id and species; the same species in both apps."""
    got = {}
    for name, side in pair.items():
        app = side.app
        s = _open_sse(side, f"{V2}/detections/stream")
        try:
            assert _sse_events(s, 1)[0][0] == "connected"
            before = app.datastore.count_detections()
            end = A._ingest(app, A._app_pcm(10.0), A.T0 + 6.0, 4.0)
            A._run_ticks(app)
            app.processor.flush(now=end + 1e6)
            A._drain_actions(app)
            rows = {r["id"]: r["scientific_name"] for r in
                    app.datastore.search_detections(limit=1000)}
            events = _sse_events(s, 10 ** 6, quiet=2.0)
        finally:
            s.close()
        sent = [(json.loads(d)["id"], json.loads(d)["scientific_name"])
                for e, d in events if e == "detection"]
        assert sent and all(i > before and rows[i] == sci
                            for i, sci in sent), sent
        # the job queue's workers save in either order: ids may differ
        got[name] = sorted(sci for _, sci in sent)
    assert got["torch"] == got["jax"]


def test_stop_returns_with_sse_clients_connected(tiny_v24, tmp_path,  # noqa: F811
                                                 monkeypatch):
    """The port's ``ApiServer.stop()`` with clients on two SSE streams
    returns within a second, and both clients see their stream end."""
    A._patch_models(T, monkeypatch, tiny_v24)
    app = T.app.Application(_api_settings(T, tmp_path), device="cpu")
    app.settings.webserver.password = None
    app.setup()
    app.api.start()
    side = SimpleNamespace(client=SimpleNamespace(port=app.api.port,
                                                  cookie=""))
    socks = [_open_sse(side, f"{V2}/detections/stream"),
             _open_sse(side, f"{V2}/soundlevels/stream")]
    try:
        for s in socks:
            assert _sse_events(s, 1)[0][0] == "connected"
        t0 = time.monotonic()
        app.api.stop()
        assert time.monotonic() - t0 < 1.0
        for s in socks:
            s.settimeout(5)
            while s.recv(65536):
                pass
    finally:
        for s in socks:
            s.close()
        app.datastore.close()


def test_hls_routes(pair):
    """HLS through both servers: start a session on a source, its
    playlist, its init segment, a heartbeat, stop. The init segments are
    equal byte for byte: AAC where both packages' codec libraries have
    it, as here; the port's FLAC one where only JAX's has it (as JAX
    muxes without it)."""
    from birdnet_go_tpu.audio import aacenc as jaac
    from birdnet_go_tpu.audio.hlsmux import init_segment
    from birdnet_go_tpu_torch.audio import aacenc as taac

    inits = {}
    for name, side in pair.items():
        c = side.client
        st, _, b = c.call("POST", f"{V2}/audio/hls/tone0/start")
        assert st == 200 and json.loads(b)["playlist"].endswith(
            "playlist.m3u8")
        st, h, _ = c.call("GET", f"{V2}/audio/hls/tone0/playlist.m3u8")
        assert st == 200 and h["content-type"].startswith(
            "application/vnd.apple.mpegurl")
        st, h, inits[name] = c.call("GET", f"{V2}/audio/hls/tone0/init.mp4")
        assert st == 200 and h["content-type"] == "video/mp4"
        assert c.call("POST", f"{V2}/audio/hls/tone0/heartbeat")[0] == 200
        st, _, b = c.call("POST", f"{V2}/audio/hls/tone0/stop")
        assert (st, json.loads(b)) == (200, {"stopped": True})
    if taac.available() == jaac.available():
        assert inits["torch"] == inits["jax"]
    else:
        assert inits["torch"] == init_segment(48000, "flac")
    assert (b"mp4a" in inits["torch"]) == taac.available()


def _dechunk(head: bytes, body: bytes) -> bytes:
    """The payload of a response body read so far: its chunks joined
    where the head says ``Transfer-Encoding: chunked`` (a chunk cut off
    at the end is left out)."""
    if b"chunked" not in head.lower():
        return body
    out, off = b"", 0
    while True:
        eol = body.find(b"\r\n", off)
        if eol < 0:
            return out
        size = int(body[off:eol].split(b";")[0], 16)
        if size == 0 or eol + 2 + size > len(body):
            return out
        out += body[eol + 2:eol + 2 + size]
        off = eol + 2 + size + 2


def _live(side, query: str, pages: int = 3) -> tuple[bytes, bytes]:
    """The head and the payload read first of ``audio/live/tone0`` +
    `query`: through the WAV header, or through `pages` Ogg pages."""
    s = socket.create_connection(("127.0.0.1", side.client.port))
    s.sendall(f"GET {V2}/audio/live/tone0{query} HTTP/1.1\r\nHost: x\r\n"
              f"Cookie: {side.client.cookie}\r\n\r\n".encode())
    s.settimeout(10)
    data = b""
    try:
        while True:
            head, _, body = data.partition(b"\r\n\r\n")
            payload = _dechunk(head, body)
            if b"WAVE" in payload or payload.count(b"OggS") > pages:
                return head, payload
            chunk = s.recv(4096)
            assert chunk and len(data) < 1 << 20, (query, data[:300])
            data += chunk
    finally:
        s.close()


def _pages(blob: bytes) -> bytes:
    """The whole Ogg pages at the start of `blob` (their CRCs checked)."""
    from birdnet_go_tpu_torch.audio.opusogg import parse_ogg_pages

    off = 0
    while off + 27 <= len(blob):
        nsegs = blob[off + 26]
        end = off + 27 + nsegs + sum(blob[off + 27:off + 27 + nsegs])
        if end > len(blob):
            break
        off = end
    parse_ogg_pages(blob[:off])
    return blob[:off]


def test_live_audio_serves_wav(pair):
    """``audio/live/{source}``: a WAV stream, its header as JAX's; with
    ``format=opus`` an Ogg Opus stream where the package's codec library
    has libopus, else WAV, in both, whose header pages are JAX's byte for
    byte where both have it (the audio pages are
    ``test_live_audio_opus_equal_jax``'s)."""
    from birdnet_go_tpu.audio import opusogg as jopus
    from birdnet_go_tpu_torch.audio import opusogg as topus

    heads = {}
    for name, side in pair.items():
        for q in ("", "?format=opus"):
            head, payload = _live(side, q)
            kind = b"audio/ogg" if payload.startswith(b"OggS") \
                else b"audio/wav"
            assert kind in head, head
            heads[name, q] = (kind, payload[:12] if kind == b"audio/wav"
                              else topus.parse_ogg_pages(
                                  _pages(payload))[:2])
    assert heads["torch", ""] == heads["jax", ""]
    assert heads["torch", ""][0] == b"audio/wav"
    assert heads["torch", "?format=opus"][0] == (
        b"audio/ogg" if topus.opus_available() else b"audio/wav")
    if topus.opus_available() == jopus.opus_available():
        assert heads["torch", "?format=opus"] == heads["jax", "?format=opus"]


class _Chunks:
    """A capture buffer whose every ``read_segment`` returns the next
    0.25 s of a seeded tone over noise, whatever the span asked for."""

    def __init__(self, rate: int = 48000):
        rng = np.random.default_rng(11)
        t = np.arange(rate * 4) / rate
        self.pcm = np.clip(9000 * np.sin(2 * np.pi * 1500 * t)
                           + 600 * rng.standard_normal(len(t)),
                           -32768, 32767).astype(np.int16)
        self.sample_rate, self.k = rate, 0

    def read_segment(self, a: float, b: float) -> np.ndarray:
        n = self.sample_rate // 4
        out = self.pcm[self.k * n % len(self.pcm):][:n]
        self.k += 1
        return out


def test_live_audio_opus_equal_jax(pair, monkeypatch):
    """``audio/live/{source}?format=opus``: the port's bytes are JAX's
    handler's, header and audio pages, for the same PCM (each server's
    capture buffer handing out the same chunks in turn), where both
    codec libraries have libopus."""
    from birdnet_go_tpu.audio import opusogg as jopus
    from birdnet_go_tpu_torch.audio import opusogg as topus

    if not (jopus.opus_available() and topus.opus_available()):
        pytest.skip("libopus is missing from a package's codec library")
    streams = {}
    for name, side in pair.items():
        monkeypatch.setattr(side.app.engine, "capture_buffer",
                            lambda sid, cb=_Chunks(): cb)
        head, payload = _live(side, "?format=opus", pages=8)
        assert b"audio/ogg" in head, head
        streams[name] = _pages(payload)
    t, j = (topus.parse_ogg_pages(streams[k]) for k in ("torch", "jax"))
    n = min(len(t), len(j))
    assert n >= 6 and t[:n] == j[:n]
    assert t[0]["packets"][0][:8] == b"OpusHead"


# -- the SPA, auth reset, the helper modules ------------------------------------------------

def test_spa_files_are_byte_equal_to_the_originals():
    src = REPO / "birdnet_go_tpu" / "api" / "static"
    dst = REPO / "birdnet_go_tpu_torch" / "api" / "static"
    want = sorted(p.relative_to(src) for p in src.rglob("*") if p.is_file())
    got = sorted(p.relative_to(dst) for p in dst.rglob("*") if p.is_file())
    assert got == want and len(got) >= 20
    for rel in got:
        assert (dst / rel).read_bytes() == (src / rel).read_bytes(), rel


@pytest.mark.parametrize("cfg", [
    {"webserver": {"password": "pw", "auth_token": "tok", "port": 9},
     "models": [{"model_id": "BirdNET_V2.4"}]},
    {"webserver": {"oidc_client_secret": "s", "github_client_secret": "g",
                   "oauth_client_secret": ""}},
    {"database": {"path": "x.db"}},
])
def test_auth_reset_as_jax(cfg, tmp_path, capsys):
    """``auth reset --config`` clears the same secrets as JAX's command
    and writes the same YAML; where yaml is missing the port reads and
    writes the config as JSON."""
    import yaml

    from birdnet_go_tpu.cli import main as jcli
    from birdnet_go_tpu_torch.cli import main as tcli

    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        d = tmp_path / name
        d.mkdir()
        path = d / "app.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        assert cli.main(["auth", "reset", "--config", str(path)]) == 0
        said = capsys.readouterr().out.strip().rsplit(" backup at ", 1)[0]
        backups = list(d.glob("app.yaml.bak-*"))
        assert len(backups) == 1 and yaml.safe_load(
            backups[0].read_text()) == cfg
        out[name] = (said, path.read_text())
    assert out["torch"] == out["jax"]
    # JSON, with yaml blocked
    path = tmp_path / "app.json"
    path.write_text(json.dumps(cfg))
    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None
    try:
        assert tcli.main(["auth", "reset", "--config", str(path)]) == 0
    finally:
        sys.modules["yaml"] = saved
    assert json.loads(path.read_text()) == yaml.safe_load(out["jax"][1])
    assert tcli.main(["auth", "reset", "--config",
                      str(tmp_path / "none.json")]) == 2


def _mods(sub: str):
    return (importlib.import_module(f"birdnet_go_tpu.{sub}"),
            importlib.import_module(f"birdnet_go_tpu_torch.{sub}"))


def test_metrics_registry_renders_as_jax():
    recs = []
    for m in _mods("utils.metrics"):
        reg = m.MetricsRegistry()
        reg.counter("http_requests_total", "HTTP requests").inc(
            labels={"method": "GET", "route": "/x", "status": "200"})
        reg.counter("http_requests_total").inc(
            2, labels={"method": "GET", "route": "/x", "status": "200"})
        reg.gauge("birdnet_batch_latency_ms").set(
            12.5, labels={"model": "m"})
        h = reg.histogram("http_request_duration_seconds", "latency")
        for v in (0.001, 0.02, 0.3, 7.0):
            h.observe(v, labels={"route": "/x"})
        recs.append(reg.render())
    assert recs[0] == recs[1] and "http_requests_total" in recs[0]


def test_sysinfo_as_jax(tmp_path):
    (tmp_path / "proc").mkdir()
    (tmp_path / "proc" / "cpuinfo").write_text(
        "processor : 0\nmodel name : Test CPU\nflags : fpu hypervisor\n")
    (tmp_path / ".dockerenv").write_text("")
    recs = []
    for m in _mods("utils.sysinfo"):
        recs.append((m.detect_environment(str(tmp_path)),
                     m.cpu_model(str(tmp_path)), m.environment_summary(),
                     m.is_container_env("docker")))
    assert recs[0] == recs[1]


def test_insights_as_jax():
    recs = []
    today = datetime.date(2026, 3, 1)
    raw = [{"scientific_name": sci, "common_name": sci[0],
            "earliest_time": f"05:{m:02d}:00"}
           for sci, m in (("A a", 10), ("A a", 20), ("A a", 5), ("B b", 1))]
    for m in _mods("analysis.insights"):
        recs.append([m.build_year_ranges(today),
                     m.calculate_streak(["2026-03-01", "2026-02-28",
                                         "2026-02-26"], "2026-03-01"),
                     m.aggregate_dawn_chorus(raw, min_days=2),
                     m.time_to_seconds("05:06:07"),
                     m.seconds_to_hhmm(3725)])
    assert recs[0] == recs[1]


def test_speciesdict_as_jax():
    recs = []
    for m in _mods("taxonomy.speciesdict"):
        locales = m.available_locales()
        recs.append((locales, [m.compressed_dictionary(loc)
                               for loc in locales[:3] + ["xx"]]))
    assert recs[0] == recs[1]


class _FakeHttp:
    def __init__(self, payload, fail=False):
        self.payload, self.fail, self.calls = payload, fail, []

    def get(self, url, **kw):
        self.calls.append(url)
        if self.fail:
            raise OSError("offline")
        return SimpleNamespace(raise_for_status=lambda: None,
                               json=lambda: self.payload)


@pytest.mark.parametrize("payload,fail", [
    ({"tag_name": "v0.2.0", "html_url": "u"}, False),
    ({"tag_name": "v0.0.9"}, False), ({}, True)])
def test_update_check_as_jax(payload, fail, monkeypatch):
    recs = []
    for m in _mods("utils.update"):
        monkeypatch.setattr(m, "_cache", None)
        rec = m.check_for_update(session=_FakeHttp(payload, fail),
                                 clock=lambda: 5.0)
        recs.append((rec, m.is_newer("1.0"), m.parse_version("v2.3.4-rc1")))
    assert recs[0] == recs[1]


def test_image_providers_as_jax(tmp_path):
    """The provider chain with Avicommons' dataset and a Wikipedia
    provider on a fake session, the datastore cache, negative caching,
    non-bird names; the port's Wikipedia provider builds its client at
    its first lookup."""
    ds_path = tmp_path / "avi.json"
    _avicommons(tmp_path)
    ds_path.write_text((tmp_path / "avicommons.json").read_text())
    wiki = {"query": {"pages": {"1": {"thumbnail": {"source": "t.jpg"},
                                      "original": {"source": "o.jpg"}}}}}
    recs = []
    for m, sq in zip(_mods("integrations.imageprovider"),
                     _mods("datastore.sqlite")):
        ds = sq.Datastore(":memory:")
        wp = m.WikipediaProvider(session=_FakeHttp(wiki),
                                 rate_per_second=1e6)
        svc = m.ImageProviderService(
            [m.AvicommonsProvider(dataset_path=ds_path), wp], datastore=ds,
            clock=lambda: 100.0)
        names = ["Synthetica speciei0000", "Turdus merula", "Engine",
                 "Synthetica speciei0000"]
        rec = [dataclasses.asdict(i) if i else None
               for i in (svc.get_image(n) for n in names)]
        recs.append((rec, svc.stats(), ds.get_image_cache("turdus merula")))
        ds.close()
    assert recs[0] == recs[1]
    assert T.app.__name__ and _mods("integrations.imageprovider")[1] \
        .WikipediaProvider()._session is None


def test_the_card_leg_walk_on_the_cpu(tiny_v24, tmp_path,  # noqa: F811
                                      monkeypatch):
    """``diag/api_walk.walk``, the walk ``chip_smoke.py`` phase 18 sends to
    the app it serves on the card, against the port's app started on the
    CPU (two tone sources, the tiny v2.4, a tiny v3.0 to load at runtime,
    a password): every request answers the status the walk holds it to,
    with clients on the detection and sound-level streams meanwhile."""
    from birdnet_go_tpu_torch.diag.api_walk import (
        Client as WalkClient,
        SseReader,
        route_times,
        walk,
    )

    A._patch_models(T, monkeypatch, tiny_v24,
                    extra={"BirdNET_V3.0": (None, A._tiny_v3(tiny_v24))})
    s = _api_settings(T, tmp_path)
    s.realtime.tick_ms = 20
    s.soundlevel.interval_seconds = 0.5
    _avicommons(tmp_path)
    app = T.app.Application(s, device="cpu")
    app.setup()
    app.start(warmup=False)
    try:
        client = WalkClient(app.api.port, PASSWORD)
        client.login()
        readers = [SseReader(client, f"{V2}/{p}")
                   for p in ("detections/stream", "soundlevels/stream")]
        for r in readers:
            r.start()
        deadline = time.monotonic() + 60
        row = None
        while row is None and time.monotonic() < deadline:
            row = next((r for r in app.datastore.recent_detections(50)
                        if r.get("clip_name") and (Path(s.export.path)
                                                   / r["clip_name"]).is_file()),
                       None)
            time.sleep(0.2)
        assert row is not None, "no clip written"
        records, bodies = walk(
            client, detection_id=row["id"], clip=row["clip_name"],
            source="tone0", unload_after_s=1.0, heatmap_resolution=90,
            png_path=(Path(s.export.path) / row["clip_name"]).with_suffix(
                ".png"))
        assert [(r["route"], r["status"]) for r in records] == \
            [(r["route"], r["want"]) for r in records]
        assert len(route_times(records)) == 22
        heat = json.loads(bodies["heatmap"])
        assert np.isfinite(heat["values"]).all()
        assert np.array(heat["values"]).shape == (90, 180)
        assert json.loads(bodies["system_info"])["devices"] == ["cpu"]
        assert bodies["spectrogram"][:8] == b"\x89PNG\r\n\x1a\n"
        clip = (Path(s.export.path) / row["clip_name"]).read_bytes()
        assert bodies["clip_range"] == clip[:4096]
        time.sleep(1.0)
        assert all(r.status == 200 and r.named("connected") for r in readers)
        assert readers[0].named("detection") and readers[1].named(
            "soundlevel")
    finally:
        app.stop()
    for r in readers:
        assert r.ended.wait(5)
        r.close()


def test_clip_encoder_decodes_flac_in_its_workers(tmp_path):
    """``ClipEncoder.decode``, which the API's spectrogram and clip
    processing use: a FLAC clip decoded in the spawned workers, a WAV on
    the calling thread, each equal to ``load_clip_audio``'s."""
    from birdnet_go_tpu_torch.app import ClipEncoder
    from birdnet_go_tpu_torch.audio.encode import encode_clip, load_clip_audio

    pcm = (np.random.default_rng(3).standard_normal(48000) * 3000).astype(
        np.int16)
    enc = ClipEncoder(workers=1)
    try:
        for name in ("a.flac", "a.wav"):
            encode_clip(pcm, 48000, tmp_path / name)
            got, want = enc.decode(tmp_path / name), load_clip_audio(
                tmp_path / name)
            assert got[1] == want[1] == 48000
            assert np.array_equal(got[0], want[0])
        assert enc._pool is not None
    finally:
        enc.shutdown()
