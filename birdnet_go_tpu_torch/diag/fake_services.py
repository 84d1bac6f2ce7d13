"""The services a station's integrations talk to, as loopback fakes: an
MQTT broker with a subscriber that records what it receives, the MySQL
server of ``diag/mysql_server.py``, and HTTP servers in the place of
BirdWeather, yr.no (met.no's locationforecast) and eBird, each recording
the requests it gets. Not a feature of the port: ``chip_smoke.py`` phase
20 runs them in a process of their own beside the app, and the port's
tests run them in theirs. Nothing here leaves ``127.0.0.1``.

    python -m birdnet_go_tpu_torch.diag.fake_services --out DIR

writes ``DIR/services.json`` (each service's port, the MySQL password and
the BirdWeather station token) once every service listens, serves until
SIGTERM or SIGINT, then writes ``DIR/services_record.json`` (what each
service received, with the wall clock of its arrival) and exits 0. The
MySQL database is the file ``DIR/mysql.db``.

In a process of one's own, ``Services(out).start()`` does the same;
``urls()`` gives the bases to point the integrations at.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import http.server
import json
import re
import signal
import threading
import time
import urllib.parse
from pathlib import Path

from birdnet_go_tpu_torch.diag.mysql_server import MySQLServer
from birdnet_go_tpu_torch.integrations.mqtt import MiniBroker, MqttClient

TOPIC = "birdnet"
MYSQL_USER = "birdnet"
MYSQL_PASSWORD = "chip-smoke-mysql"
STATION_TOKEN = "station-token-0"
EBIRD_TOKEN = "ebird-token-0"
YRNO_PATH = "/weatherapi/locationforecast/2.0/compact"

# eBird's taxonomy rows and recent observations, a few of each
TAXONOMY = [
    {"sciName": "Passer domesticus", "comName": "House Sparrow",
     "speciesCode": "houspa", "category": "species"},
    {"sciName": "Parus major", "comName": "Great Tit",
     "speciesCode": "gretit1", "category": "species"},
    {"sciName": "Turdus merula", "comName": "Eurasian Blackbird",
     "speciesCode": "eurbla", "category": "species"},
]
OBSERVATIONS = [
    {"speciesCode": "gretit1", "comName": "Great Tit",
     "sciName": "Parus major", "locName": "Kaivopuisto",
     "obsDt": "2026-05-01 06:10", "howMany": 2},
    {"speciesCode": "eurbla", "comName": "Eurasian Blackbird",
     "sciName": "Turdus merula", "locName": "Kaivopuisto",
     "obsDt": "2026-05-01 06:20", "howMany": 1},
]


def yrno_forecast(hours: int = 24, start: float | None = None) -> dict:
    """A locationforecast/2.0/compact body: `hours` hourly entries from
    the hour of `start` (now by default), their values a function of the
    hour."""
    t0 = int((time.time() if start is None else start) // 3600 * 3600)
    symbols = ("clearsky_day", "fair_night", "partlycloudy_day", "cloudy",
               "lightrainshowers_day", "rain", "heavyrainandthunder",
               "lightsleet", "snow", "fog")
    series = []
    for h in range(hours):
        when = _dt.datetime.fromtimestamp(t0 + 3600 * h, _dt.timezone.utc)
        series.append({
            "time": when.strftime("%Y-%m-%dT%H:%M:%SZ"),
            "data": {"instant": {"details": {
                "air_temperature": 10.0 + 0.5 * h,
                "relative_humidity": 60.0 + h,
                "air_pressure_at_sea_level": 1013.25 - 0.25 * h,
                "wind_speed": 1.5 + 0.1 * h,
                "wind_from_direction": float(15 * h % 360),
                "cloud_area_fraction": float(4 * h % 100)}},
                "next_1_hours": {"summary": {
                    "symbol_code": symbols[h % len(symbols)]}}}})
    return {"type": "Feature", "properties": {"timeseries": series}}


class FakeHttp:
    """A ThreadingHTTPServer on ``127.0.0.1`` whose `routes` answer: each
    ``(method, path regex, fn(request) -> (status, body[, headers]))``,
    the body JSON-encoded unless it is bytes (then sent as
    ``application/octet-stream`` unless the headers name a type); no route
    answers 404. Every request
    is recorded (``requests``: method, path, query, headers with lower-case
    names, body as text and as bytes, wall clock)."""

    def __init__(self, name: str, routes: list):
        self.name = name
        self.routes = [(m, re.compile(p), fn) for m, p, fn in routes]
        self.requests: list[dict] = []
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _answer(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                parts = urllib.parse.urlsplit(self.path)
                req = {"method": self.command, "path": parts.path,
                       "query": parts.query,
                       "headers": {k.lower(): v
                                   for k, v in self.headers.items()},
                       "body": body.decode("utf-8", "replace"),
                       "raw": body, "t": time.time()}
                with outer._lock:
                    outer.requests.append(req)
                answer = (404, {"error": "no route"})
                for m, pat, fn in outer.routes:
                    if m == self.command and pat.fullmatch(parts.path):
                        answer = fn(req)
                        break
                status, out = answer[:2]
                headers = dict(answer[2]) if len(answer) > 2 else {}
                if isinstance(out, bytes):
                    data = out
                    headers.setdefault("Content-Type",
                                       "application/octet-stream")
                else:
                    data = json.dumps(out).encode()
                    headers.setdefault("Content-Type", "application/json")
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = _answer

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                    Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name=f"fake-{name}", daemon=True)

    def start(self) -> "FakeHttp":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def birdweather_server(token: str = STATION_TOKEN) -> FakeHttp:
    """BirdWeather's station API under ``/api/v1``: the station (the
    connection probe), soundscape uploads and detection posts; another
    token answers 404."""
    base = f"/api/v1/stations/{re.escape(token)}"
    ids = iter(range(1, 1 << 30))
    return FakeHttp("birdweather", [
        ("GET", base, lambda r: (200, {"success": True, "station": {
            "token": token, "name": "chip smoke"}})),
        ("POST", base + "/soundscapes", lambda r: (201, {
            "success": True, "soundscape": {"id": next(ids)}})),
        ("POST", base + "/detections", lambda r: (201, {"success": True})),
    ])


def yrno_server(start: float | None = None) -> FakeHttp:
    """met.no's locationforecast: a forecast for any lat/lon from the hour
    of `start` (of each request by default), 403 without a User-Agent
    (met.no's terms refuse anonymous clients)."""
    def forecast(r):
        if not r["headers"].get("user-agent"):
            return 403, {"error": "User-Agent required"}
        return 200, yrno_forecast(start=start)
    return FakeHttp("yrno", [("GET", YRNO_PATH, forecast)])


def ebird_server(token: str = EBIRD_TOKEN) -> FakeHttp:
    """eBird API v2 under ``/v2``: the taxonomy (``?species=`` filters)
    and recent nearby observations; 401 without the token."""
    def authed(fn):
        def answer(r):
            if r["headers"].get("x-ebirdapitoken") != token:
                return 401, {"errors": [{"title": "no token"}]}
            return fn(urllib.parse.parse_qs(r["query"]))
        return answer

    def taxonomy(q):
        code = (q.get("species") or [None])[0]
        return 200, [t for t in TAXONOMY
                     if code is None or t["speciesCode"] == code]

    return FakeHttp("ebird", [
        ("GET", "/v2/ref/taxonomy/ebird", authed(taxonomy)),
        ("GET", "/v2/data/obs/geo/recent",
         authed(lambda q: (200, OBSERVATIONS)))])


class Services:
    """Every fake, started together: the broker (and its recording
    subscriber on ``<topic>/#``), MySQL on ``out/mysql.db`` (caching_sha2
    with full RSA auth on the first connection) and the three HTTP
    servers."""

    def __init__(self, out: Path, topic: str = TOPIC):
        self.out = Path(out)
        self.out.mkdir(parents=True, exist_ok=True)
        self.topic = topic
        self.received: list[tuple[str, bytes, float]] = []
        self.broker = MiniBroker()
        self.mysql = MySQLServer(str(self.out / "mysql.db"),
                                 password=MYSQL_PASSWORD,
                                 plugin="caching_sha2_password",
                                 sha2_full_auth=True)
        self.http = {"birdweather": birdweather_server(),
                     "yrno": yrno_server(), "ebird": ebird_server()}
        self.subscriber = None

    def start(self) -> "Services":
        self.broker.start()
        self.mysql.start()
        for srv in self.http.values():
            srv.start()
        sub = MqttClient("127.0.0.1", self.broker.port,
                         client_id="services-recorder")
        sub.start()
        if not sub.wait_connected(10):
            raise RuntimeError("the recording subscriber did not connect")
        sub.subscribe(f"{self.topic}/#", lambda t, p: self.received.append(
            (t, p, time.time())))
        deadline = time.monotonic() + 10
        while not any(f"{self.topic}/#" in subs
                      for _, subs in list(self.broker._clients)):
            if time.monotonic() > deadline:
                raise RuntimeError("the recording subscription never landed")
            time.sleep(0.01)
        self.subscriber = sub
        return self

    def ports(self) -> dict:
        return {"mqtt": self.broker.port, "mysql": self.mysql.port,
                **{k: v.port for k, v in self.http.items()},
                "topic": self.topic, "mysql_user": MYSQL_USER,
                "mysql_password": MYSQL_PASSWORD,
                "station_token": STATION_TOKEN, "ebird_token": EBIRD_TOKEN}

    def stop(self) -> None:
        if self.subscriber is not None:
            self.subscriber.stop()
        for srv in self.http.values():
            srv.stop()
        self.mysql.stop()
        self.broker.stop()

    def record(self) -> dict:
        def text(b: bytes) -> str:
            return b.decode("utf-8", "replace")

        return {
            "mqtt": {"received": [(t, text(p), at)
                                  for t, p, at in self.received],
                     "published": len(self.broker.messages),
                     "retained": {t: text(p) for t, p in
                                  self.broker.retained.items()}},
            "mysql": {"committed": self.mysql.committed,
                      "full_auths": self.mysql.full_auths,
                      "statements": len(self.mysql.queries)},
            "http": {k: [{f: x for f, x in r.items() if f != "raw"}
                         for r in v.requests]
                     for k, v in self.http.items()},
        }


def urls(ports: dict) -> dict:
    """The bases to point the integrations at: BirdWeather's client
    ``base_url``, ``YrNoProvider.BASE`` and eBird's ``API_BASE``."""
    return {"birdweather": f"http://127.0.0.1:{ports['birdweather']}/api/v1",
            "yrno": f"http://127.0.0.1:{ports['yrno']}{YRNO_PATH}",
            "ebird": f"http://127.0.0.1:{ports['ebird']}/v2"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    services = Services(out).start()
    tmp = out / "services.json.tmp"
    tmp.write_text(json.dumps(services.ports()))
    tmp.rename(out / "services.json")
    while not done.wait(0.5):
        pass
    services.stop()
    (out / "services_record.json").write_text(json.dumps(services.record()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
