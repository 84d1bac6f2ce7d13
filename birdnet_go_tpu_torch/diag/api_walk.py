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

``logins_walk`` is phase 20's second leg over HTTPS (a ``Client`` with an
``ssl_context``): an OIDC login through the provider to an authenticated
session, a Cloudflare Access token (and a forged one) on an API route,
GitHub's redirect and a wrong state, each TLS certificate route once,
and the terminal over ``wss://`` (``terminal_session``: a resize, a
marker echoed back and timed, the close, a cross-origin attempt).
"""

from __future__ import annotations

import http.client
import json
import os
import re
import socket
import threading
import time
import urllib.parse
import urllib.request

V2 = "/api/v2"


class Client:
    """HTTP/1.1 to the API on ``127.0.0.1:port`` (HTTPS with an
    `ssl_context`, whose name check then reads `host`), a connection a
    request; after ``login`` every request carries the session cookie,
    and every mutation the session's CSRF token."""

    def __init__(self, port: int, password: str | None = None,
                 host: str = "127.0.0.1", ssl_context=None):
        self.host, self.port, self.password = host, port, password
        self.ssl_context = ssl_context
        self.cookie = self.csrf = None

    @property
    def origin(self) -> str:
        scheme = "https" if self.ssl_context is not None else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def connection(self, timeout: float = 120.0):
        if self.ssl_context is not None:
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=timeout,
                context=self.ssl_context)
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)

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
        c = self.connection(timeout)
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
        if client.ssl_context is not None:
            self._sock = client.ssl_context.wrap_socket(
                self._sock, server_hostname=client.host)
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


# -- phase 20's second leg: HTTPS, the logins, the terminal ------------------------------

def _no_redirect_get(url: str, ssl_context=None, headers=None):
    """(status, Location) of a GET whose redirect is not followed."""
    class Stop(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **kw):
            return None

    handlers = [Stop()]
    if ssl_context is not None:
        handlers.append(urllib.request.HTTPSHandler(context=ssl_context))
    opener = urllib.request.build_opener(*handlers)
    try:
        with opener.open(urllib.request.Request(url, headers=headers or {}),
                         timeout=30) as r:
            return r.status, r.headers.get("Location")
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Location")


def oidc_login(client: Client) -> dict:
    """The browser's OIDC round trip: ``auth/oidc/login`` (302 to the
    provider), the provider's authorize (302 back with a code), the
    callback (302 with a session cookie), then ``auth/status`` with that
    cookie. Its statuses, whether it ended authenticated, and its wall
    time, ms."""
    browser = Client(client.port, host=client.host,
                     ssl_context=client.ssl_context)
    t0 = time.perf_counter()
    st1, h1, _, _ = browser.call("GET", f"{V2}/auth/oidc/login")
    st2, back = _no_redirect_get(h1.get("location", ""))
    u = urllib.parse.urlsplit(back or "")
    st3, h3, _, _ = browser.call("GET", f"{u.path}?{u.query}")
    cookie = (h3.get("set-cookie") or "").split(";", 1)[0]
    st4, _, b4, _ = browser.call("GET", f"{V2}/auth/status",
                                 headers={"Cookie": cookie})
    ms = (time.perf_counter() - t0) * 1e3
    status = json.loads(b4) if st4 == 200 else {}
    return {"statuses": [st1, st2, st3, st4], "ms": round(ms, 1),
            "to_provider": (h1.get("location") or "").split("?")[0],
            "back_to": f"{u.scheme}://{u.netloc}{u.path}",
            "authenticated": status.get("authenticated") is True
            and status.get("method") == "session" and bool(cookie)}


def _tampered(token: str) -> str:
    """`token` with its claims changed and its signature kept."""
    import base64

    h, p, sig = token.split(".")
    claims = json.loads(base64.urlsafe_b64decode(p + "=" * (-len(p) % 4)))
    claims["email"] = "mallory@example.org"
    p2 = base64.urlsafe_b64encode(json.dumps(claims).encode()).rstrip(
        b"=").decode()
    return f"{h}.{p2}.{sig}"


def terminal_session(client: Client, *, marker: str = "birdnet",
                     rounds: int = 5, leave_open: bool = False):
    """The terminal over ``wss://`` with the session cookie and a matching
    Origin: a resize to 100x40 (read back by ``stty size``), `rounds`
    markers echoed back (each timed from send to arrival), then the close
    handshake, unless `leave_open` (the socket is returned then). Its
    record: the handshake's status, whether the size was read back, the
    round trips, ms, and the close code."""
    from birdnet_go_tpu_torch.diag.ws_client import WsClient

    scheme = "wss" if client.ssl_context is not None else "ws"
    ws = WsClient(f"{scheme}://{client.host}:{client.port}{V2}/system/ws",
                  headers={"Cookie": client.cookie, "Origin": client.origin},
                  ssl_context=client.ssl_context, timeout=30)
    rec = {"status": ws.status}
    if ws.status != 101:
        return rec, None
    ws.send_text("\x00resize:100x40")
    ws.send_text("stty size; printf '%s%s\\n' ready 0\n")
    rec["resized"] = b"40 100" in ws.read_until(b"ready0", 30)
    rtts = []
    for k in range(1, rounds + 1):
        t0 = time.perf_counter()
        ws.send_text(f"printf '%s%s\\n' {marker} {k}\n")
        ws.read_until(f"{marker}{k}\r\n".encode(), 30)
        rtts.append(round((time.perf_counter() - t0) * 1e3, 2))
    rec["echo_ms"] = rtts
    if leave_open:
        return rec, ws
    rec["close_code"] = ws.close()
    return rec, None


def shell_children() -> set[int]:
    """This process's children that are not Python (the terminal's shells;
    the clip encoder's workers are Python), zombies included."""
    out = set()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            stat = open(f"/proc/{pid}/stat").read()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        if ppid == os.getpid() and not name.startswith("python"):
            out.add(int(pid))
    return out


def wait_reaped(before: set[int], seconds: float = 5.0) -> list[int]:
    """The shells born since `before` still there after `seconds`."""
    deadline = time.monotonic() + seconds
    while True:
        left = sorted(shell_children() - before)
        if not left or time.monotonic() >= deadline:
            return left
        time.sleep(0.1)


# (route, status) of the TLS certificate routes, in order, as JAX's
# handlers answer them on an empty tls_dir/webserver
TLS_ROUTES = (("GET", "tls/certificate", 200),
              ("POST", "tls/certificate/generate", 200),
              ("GET", "tls/certificate/download", 200),
              ("POST", "tls/certificate", 200),
              ("DELETE", "tls/certificate", 200),
              ("GET", "tls/certificate", 200))


def logins_walk(client: Client, *, cf_mint, github_authorize: str
                ) -> tuple[list, dict]:
    """Phase 20's second-leg walk (see the module's docstring), the client
    logged in by password: `cf_mint()` returns a token the Cloudflare
    team's key signed. The records (route, status, the status JAX
    answers, ms) and what each part found."""
    from birdnet_go_tpu_torch.utils.tlscert import generate_self_signed

    records, found = [], {}

    def rec(route, st, want, ms, t0):
        records.append({"route": route, "status": st, "want": want,
                        "ms": ms, "t0": t0, "t1": time.time()})

    t0 = time.time()
    found["oidc"] = oidc_login(client)
    rec("OIDC login", found["oidc"]["statuses"], [302, 302, 302, 200],
        found["oidc"]["ms"], t0)
    anon = Client(client.port, host=client.host,
                  ssl_context=client.ssl_context)
    token = cf_mint()
    for name, tok, want in (("Cloudflare token", token, 200),
                            ("Cloudflare forged", _tampered(token), 401)):
        t0 = time.time()
        st, _, b, ms = anon.call("GET", f"{V2}/detections?limit=1",
                                 headers={"Cf-Access-Jwt-Assertion": tok})
        rec(name, st, want, ms, t0)
        found[name] = b[:200].decode("utf-8", "replace")
    t0 = time.time()
    st, h, _, ms = anon.call("GET", f"{V2}/auth/github/login")
    loc = h.get("location", "")
    q = urllib.parse.parse_qs(urllib.parse.urlsplit(loc).query)
    rec("GitHub login", st, 302, ms, t0)
    found["github_redirect"] = loc.startswith(github_authorize + "?")         and bool(q.get("state"))
    t0 = time.time()
    st, _, b, ms = anon.call("GET", f"{V2}/auth/github/callback?"
                                    f"state=wrong&code=x")
    rec("GitHub wrong state", st, 401, ms, t0)
    found["github_wrong_state"] = json.loads(b)
    cert, key = generate_self_signed(sans=["localhost", "127.0.0.1"])
    bodies = {"POST tls/certificate/generate": {"validity": "720h"},
              "POST tls/certificate": {"certificate": cert,
                                       "privateKey": key}}
    for method, route, want in TLS_ROUTES:
        t0 = time.time()
        st, h, b, ms = client.call(method, f"{V2}/{route}",
                                   bodies.get(f"{method} {route}"))
        rec(f"{method} {route}", st, want, ms, t0)
        if route.endswith("download"):
            found["tls_download_pem"] = b.startswith(b"-----BEGIN CERT")
    t0 = time.time()
    before = shell_children()
    found["terminal"], _ = terminal_session(client)
    found["terminal"]["left"] = wait_reaped(before)
    rec("terminal", found["terminal"]["status"], 101,
        sum(found["terminal"].get("echo_ms", [0.0])), t0)
    t0 = time.time()
    st, _, b, ms = client.call("GET", f"{V2}/system/ws", headers={
        "Origin": "https://evil.example", "Upgrade": "websocket",
        "Connection": "Upgrade", "Sec-WebSocket-Version": "13",
        "Sec-WebSocket-Key": "dGhlIHNhbXBsZSBub25jZQ=="})
    rec("terminal cross-origin", st, 403, ms, t0)
    found["terminal_cross_origin"] = json.loads(b)
    return records, found


def handshake_ms(client: Client, n: int = 20) -> list[float]:
    """`n` TLS handshakes with the server, each timed, ms."""
    out = []
    for _ in range(n):
        sock = socket.create_connection((client.host, client.port),
                                        timeout=30)
        t0 = time.perf_counter()
        tls = client.ssl_context.wrap_socket(sock,
                                             server_hostname=client.host)
        out.append((time.perf_counter() - t0) * 1e3)
        tls.close()
    return out
