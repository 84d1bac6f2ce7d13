"""A walk through the port's API as a user's browser makes it, each
request timed and held to the status it must answer: what
``chip_smoke.py`` phase 18 sends, twice, to the app it serves on the card,
and ``tests/test_torch_api.py`` once to the app on the CPU.

    client = Client(port, password)
    client.login()
    records, bodies = walk(client, detection_id=7, clip="2026/10/x.flac",
                           source="tone0")

A walk loads a model at runtime first (``POST models/load/{id}``, whose
warm-up runs the mel kernel on the card), then asks for health, the
system's and the scheduler's state, an HLS session's playlist, init
segment and newest media segment, the recent detections and a summary,
a range heatmap (one Geomodel call over up to 90 x 180 points, its scores
copied back), a range test and rebuild, a detection's spectrogram (which
the server renders where its PNG is missing), a Range of its clip, a
settings PATCH that sends a control signal, the metrics, the SPA's index
and script, and unloads the model `unload_after_s` after it loaded. Every
request stays on ``127.0.0.1``; no redirect is followed.

``integrations_walk`` asks each route of the integrations once (MQTT's
status, test and Home Assistant discovery, the BirdWeather, weather and
eBird tests, eBird's taxonomy, observations and regional insight, the
database backup's run, jobs and verification): what phase 20 sends, and
``tests/test_torch_api.py`` to both packages' apps on the CPU.
"""

from __future__ import annotations

import http.client
import json
import re
import socket
import threading
import time

V2 = "/api/v2"


class Client:
    """HTTP/1.1 to the API on ``127.0.0.1:port``, a connection a request;
    after ``login`` every request carries the session cookie, and every
    mutation the session's CSRF token."""

    def __init__(self, port: int, password: str | None = None,
                 host: str = "127.0.0.1"):
        self.host, self.port, self.password = host, port, password
        self.cookie = self.csrf = None

    def call(self, method: str, path: str, body=None, headers=None,
             timeout: float = 120.0):
        """(status, headers with lower-case names, body bytes, ms)."""
        h = dict(headers or {})
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            h["Content-Type"] = "application/json"
        if self.cookie:
            h["Cookie"] = self.cookie
            if method not in ("GET", "HEAD"):
                h["X-CSRF-Token"] = self.csrf
        t0 = time.perf_counter()
        c = http.client.HTTPConnection(self.host, self.port, timeout=timeout)
        try:
            c.request(method, path, body=data, headers=h)
            r = c.getresponse()
            out = r.read()
            return (r.status, {k.lower(): v for k, v in r.getheaders()},
                    out, (time.perf_counter() - t0) * 1e3)
        finally:
            c.close()

    def login(self) -> None:
        st, h, b, _ = self.call("POST", f"{V2}/auth/login",
                                {"password": self.password})
        if st != 200:
            raise RuntimeError(f"login answered {st}: {b[:200]!r}")
        self.cookie = h["set-cookie"].split(";", 1)[0]
        self.csrf = json.loads(b)["csrf"]


class SseReader(threading.Thread):
    """A client held on one SSE stream: every event (name, data, the wall
    clock it arrived) until the server ends the stream or ``close``."""

    def __init__(self, client: Client, path: str):
        super().__init__(daemon=True, name=f"sse{path}")
        self.events: list[tuple[str, str, float]] = []
        self.ended = threading.Event()
        self._sock = socket.create_connection((client.host, client.port))
        cookie = f"Cookie: {client.cookie}\r\n" if client.cookie else ""
        self._sock.sendall(f"GET {path} HTTP/1.1\r\nHost: {client.host}\r\n"
                           f"{cookie}\r\n".encode())
        line = b""
        while not line.endswith(b"\r\n"):
            line += self._sock.recv(1)
        self.status = int(line.split()[1])

    def run(self) -> None:
        buf = b""
        try:
            while True:
                chunk = self._sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                *blocks, buf = buf.split(b"\n\n")
                for block in blocks:
                    fields = dict(ln.split(b": ", 1)
                                  for ln in block.split(b"\n")
                                  if b": " in ln and not ln.startswith(b":"))
                    if b"event" in fields:
                        self.events.append((fields[b"event"].decode(),
                                            fields.get(b"data", b"").decode(),
                                            time.time()))
        except OSError:
            pass
        finally:
            self.ended.set()

    def named(self, name: str) -> list[tuple[str, str, float]]:
        return [e for e in self.events if e[0] == name]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def walk(client: Client, *, detection_id: int, clip: str, source: str,
         model: str = "BirdNET_V3.0", unload_after_s: float = 10.0,
         heatmap_resolution: int = 90, heatmap_week: int = 20,
         range_point: tuple[float, float] = (60.17, 24.94),
         range_threshold: float = 0.01, hls_wait_s: float = 10.0,
         png_path=None) -> tuple[list, dict]:
    """One walk: its records (route, status, the status it must answer,
    ms, bytes, the wall clock at its start and end) and the bodies the
    caller checks (``heatmap``, ``spectrogram``, ``clip_range``,
    ``hls_init``, ``hls_segment``, ``system_info``, ``range_test``).
    `png_path`, the detection's cached PNG, is removed before its request
    so that the server renders it."""
    records, bodies = [], {}

    def req(name, method, path, want, body=None, headers=None, keep=None):
        t0 = time.time()
        st, h, b, ms = client.call(method, path, body, headers)
        records.append({"route": name, "status": st, "want": want,
                        "ms": ms, "bytes": len(b), "t0": t0,
                        "t1": time.time()})
        if keep:
            bodies[keep] = b
        return st, h, b

    t_load = time.time()
    req("POST models/load/{id}", "POST", f"{V2}/models/load/{model}", 200)
    for route in ("health", "system/info", "system/inference",
                  "system/scheduler", "system/inference/spans"):
        req(f"GET {route}", "GET", f"{V2}/{route}", 200,
            keep="system_info" if route == "system/info" else None)
    base = f"{V2}/audio/hls/{source}"
    req("POST audio/hls/{source}/start", "POST", f"{base}/start", 200)
    deadline, segs = time.monotonic() + hls_wait_s, []
    while not segs:
        _, _, b = req("GET audio/hls/{source}/playlist.m3u8", "GET",
                      f"{base}/playlist.m3u8", 200)
        segs = re.findall(r"seg\d+\.m4s", b.decode())
        if not segs:
            if time.monotonic() > deadline:
                raise RuntimeError("no HLS segment within "
                                   f"{hls_wait_s} s")
            time.sleep(0.5)
    req("GET audio/hls/{source}/init.mp4", "GET", f"{base}/init.mp4", 200,
        keep="hls_init")
    req("GET audio/hls/{source}/{seg}.m4s", "GET", f"{base}/{segs[-1]}",
        200, keep="hls_segment")
    req("GET detections/recent", "GET", f"{V2}/detections/recent", 200)
    req("GET analytics/summary", "GET", f"{V2}/analytics/summary", 200)
    req("GET range/heatmap", "GET", f"{V2}/range/heatmap?resolution="
        f"{heatmap_resolution}&week={heatmap_week}", 200, keep="heatmap")
    lat, lon = range_point
    req("POST range/species/test", "POST", f"{V2}/range/species/test", 200,
        {"latitude": lat, "longitude": lon, "week": heatmap_week},
        keep="range_test")
    req("POST range/rebuild", "POST", f"{V2}/range/rebuild", 200)
    if png_path is not None:
        png_path.unlink(missing_ok=True)
    req("GET spectrogram/{id}", "GET", f"{V2}/spectrogram/{detection_id}",
        200, keep="spectrogram")
    req("GET media/audio/{clip} Range", "GET", f"{V2}/media/audio/{clip}",
        206, headers={"Range": "bytes=0-4095"}, keep="clip_range")
    req("PATCH settings/range_filter", "PATCH",
        f"{V2}/settings/range_filter", 200,
        {"threshold": range_threshold})
    req("GET /metrics", "GET", "/metrics", 200)
    req("GET /", "GET", "/", 200)
    req("GET /static/app.js", "GET", "/static/app.js", 200)
    time.sleep(max(0.0, t_load + unload_after_s - time.time()))
    req("POST models/unload/{id}", "POST", f"{V2}/models/unload/{model}",
        200)
    return records, bodies


# the integrations' routes (ROADMAP.md queue 1 item 8), each with the
# status it answers where the integration runs against the fake services
# of diag/fake_services.py; the backup routes' where backup is off
INTEGRATION_ROUTES = (
    ("GET", "integrations/mqtt/status", 200),
    ("POST", "integrations/mqtt/test", 200),
    ("POST", "integrations/mqtt/homeassistant/discovery", 200),
    ("POST", "integrations/birdweather/test", 200),
    ("POST", "integrations/weather/test", 200),
    ("POST", "integrations/ebird/test", 200),
    ("GET", "ebird/taxonomy?species=houspa", 200),
    ("GET", "ebird/observations", 200),
    ("GET", "insights/expected-today/regional", 200),
    ("POST", "system/database/backup", 503),
    ("GET", "system/database/backup/jobs", 200),
    ("POST", "system/database/backup/verify", 503),
)
BACKUP_ON = {"system/database/backup": 200,
             "system/database/backup/verify": 200}


def integrations_walk(client: Client, *, backup: bool = False
                      ) -> tuple[list, dict]:
    """One request to each route of INTEGRATION_ROUTES, in order, held to
    its status (with backup on, a run and its verification answer 200):
    the records, as ``walk``'s, and each body by route."""
    records, bodies = [], {}
    for method, route, want in INTEGRATION_ROUTES:
        if backup:
            want = BACKUP_ON.get(route, want)
        t0 = time.time()
        st, _, b, ms = client.call(method, f"{V2}/{route}",
                                   {} if method == "POST" else None)
        records.append({"route": f"{method} {route}", "status": st,
                        "want": want, "ms": ms, "bytes": len(b), "t0": t0,
                        "t1": time.time()})
        bodies[route] = b
    return records, bodies


def route_times(records: list) -> dict:
    """Each route's request count and its p50, p95 and largest time,
    ms."""
    import numpy as np

    out: dict[str, dict] = {}
    for r in records:
        out.setdefault(r["route"], []).append(r["ms"])
    return {k: {"n": len(v), "p50": round(float(np.percentile(v, 50)), 2),
                "p95": round(float(np.percentile(v, 95)), 2),
                "max": round(max(v), 2)} for k, v in out.items()}
