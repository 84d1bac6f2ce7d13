"""The port's integrations against the JAX package's, on the CPU: the
HTTP transport (``utils/httpclient.py``: ``urllib`` where JAX's client
is httpx), MQTT (``integrations/mqtt.py``), BirdWeather, the weather
providers and eBird, and the fake services ``chip_smoke.py`` phase 20
serves them with (``diag/fake_services.py``).

The transport: the same requests from JAX's ``HttpClient`` (over httpx)
and the port's (over urllib) to one loopback echo server, which records
what arrives; the statuses, bodies, headers, redirects, the requests the
server saw and the error each raises are equal. MQTT: each package's
client against each package's broker (JAX's cases of
``tests/test_integrations.py``), the backoff cases, wildcards and the
Home Assistant payloads. BirdWeather, weather and eBird: the same fake
sessions, then each package's default transport against the loopback
fakes, the rows, observations and requests equal (floats exactly).
Nothing leaves ``127.0.0.1``.
"""

from __future__ import annotations

import datetime
import importlib
import io
import json
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from birdnet_go_tpu_torch.diag import fake_services as FS

REPO = Path(__file__).resolve().parents[1]


def _pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{path}") for k, path in (
            ("http", "utils.httpclient"), ("mqtt", "integrations.mqtt"),
            ("bw", "integrations.birdweather"),
            ("weather", "integrations.weather"),
            ("ebird", "integrations.ebird"), ("errors", "utils.errors"),
            ("sqlite", "datastore.sqlite"), ("wav", "audio.wav"),
            ("results", "analysis.results"), ("labels", "taxonomy.labels"))})


J, T = _pkg("birdnet_go_tpu"), _pkg("birdnet_go_tpu_torch")
BOTH = (J, T)


def _wait(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# -- the transport ---------------------------------------------------------------------

def _echo(req):
    h = req["headers"]
    return 200, {"method": req["method"], "path": req["path"],
                 "query": req["query"], "body": req["body"],
                 "content_type": h.get("content-type"),
                 "content_length": h.get("content-length"),
                 "user_agent": h.get("user-agent"),
                 "x_token": h.get("x-token"),
                 "authorization": h.get("authorization")}


def _redirect(req):
    code = int(req["path"].rsplit("/", 1)[1])
    return code, {"moved": True}, {"Location": "/echo?from=" + str(code)}


@pytest.fixture(scope="module")
def echo():
    srv = FS.FakeHttp("echo", [
        (m, "/echo", _echo) for m in ("GET", "POST", "PUT", "DELETE")] + [
        (m, r"/redirect/\d+", _redirect) for m in ("GET", "POST", "PUT")] + [
        ("GET", r"/status/\d+", lambda r: (
            int(r["path"].rsplit("/", 1)[1]), {"error": "as asked"})),
        ("GET", "/latin1", lambda r: (
            200, "café".encode("latin-1"),
            {"Content-Type": "text/plain; charset=iso-8859-1"})),
        ("GET", "/repeat", lambda r: (200, b"x", [
            ("X-Many", "a"), ("X-Many", "b")])),
        ("GET", "/slow", lambda r: (time.sleep(1.0), (200, {}))[1]),
    ]).start()
    yield srv
    srv.stop()


def _refused_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}/x"


TRANSPORT_CASES = {
    "get": ("GET", "/echo", {}),
    "params": ("GET", "/echo?keep=1", {"params": {
        "a": 1, "b": True, "c": None, "d": [1, 2], "e": "x y/ü", "f": 2.5}}),
    "json": ("POST", "/echo", {"json": {"k": "ü", "n": [1, 2.5], "z": None}}),
    "data": ("POST", "/echo", {"data": {"grant_type": "refresh_token",
                                        "x": "a b&c"}}),
    "content-bytes": ("POST", "/echo", {"content": b"\x00\x01raw",
                                        "headers": {"Content-Type":
                                                    "application/x-raw"}}),
    "content-no-type": ("PUT", "/echo", {"content": b"payload"}),
    "content-str": ("PUT", "/echo", {"content": "text body"}),
    "post-empty": ("POST", "/echo", {}),
    "delete": ("DELETE", "/echo", {"headers": {"Authorization": "Bearer t"}}),
    "headers": ("GET", "/echo", {"headers": {"X-Token": "t",
                                             "User-Agent": "custom/1"}}),
    "404": ("GET", "/status/404", {}),
    "500": ("GET", "/status/500", {}),
    "301-get": ("GET", "/redirect/301", {}),
    "301-post": ("POST", "/redirect/301", {"json": {"a": 1}}),
    "302-post": ("POST", "/redirect/302", {"content": b"x"}),
    "303-put": ("PUT", "/redirect/303", {"content": b"x"}),
    "307-post": ("POST", "/redirect/307", {"json": {"kept": True}}),
    "308-put": ("PUT", "/redirect/308", {"content": b"kept",
                                         "headers": {"Authorization": "a"}}),
    "latin1": ("GET", "/latin1", {}),
    "repeated-header": ("GET", "/repeat", {}),
    "no-route": ("GET", "/nowhere", {}),
    "timeout": ("GET", "/slow", {"timeout": 0.3}),
}
# the families of error both transports name alike
_FAMILIES = ("HTTPStatusError", "TimeoutException", "ConnectError",
             "TransportError")


def _error(e: BaseException) -> tuple:
    names = {c.__name__ for c in type(e).__mro__}
    return ("raised", [f for f in _FAMILIES if f in names],
            str(e).splitlines()[0] if isinstance(e, Exception) and
            "HTTPStatusError" in names else None)


def _transport(P, url: str, method: str, kw: dict) -> tuple:
    client = P.http.HttpClient(timeout=10.0)
    try:
        r = client.request(method, url, **kw)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return _error(e)
    try:
        r.raise_for_status()
        raised = None
    except Exception as e:  # noqa: BLE001
        raised = _error(e)
    ctype = r.headers.get("content-type", "")
    body = r.json() if ctype == "application/json" else r.text
    if isinstance(body, dict) and "user_agent" in body:
        ua = body["user_agent"]
        body["user_agent"] = "<default>" if ua == P.http.default_user_agent() \
            else ua
    return (r.status_code, ctype, r.headers.get("X-Many"), str(r.url)
            .replace(url.rsplit("/", 1)[0], "<base>"), body, raised,
            client.stats()["requests"], client.stats()["errors"])


@pytest.mark.parametrize("case", sorted(TRANSPORT_CASES))
def test_transport_as_httpx(case, echo):
    """One request through JAX's client (httpx) and the port's (urllib):
    the same status, content type, repeated header, final URL, body (what
    the echo server saw: method, path, query, body, Content-Type,
    Content-Length, User-Agent, custom headers) and error."""
    method, path, kw = TRANSPORT_CASES[case]
    url = f"http://127.0.0.1:{echo.port}{path}"
    got = [_transport(P, url, method, kw) for P in BOTH]
    assert got[1] == got[0]


def test_transport_errors_as_httpx(echo):
    """A refused connection and a timeout raise errors of httpx's names,
    counted by the client as failed requests."""
    for url, kw, family in ((_refused_url(), {}, "ConnectError"),
                            (f"http://127.0.0.1:{echo.port}/slow",
                             {"timeout": 0.3}, "TimeoutException")):
        got = [_transport(P, url, "GET", kw) for P in BOTH]
        assert got[0] == got[1] and family in got[1][1], got


def test_transport_stream_and_hooks(echo):
    """``stream`` (the model gallery's downloads) reads the body in
    chunks; the hooks see what JAX's see."""
    sess = T.http.UrllibSession(timeout=5.0)
    with sess.stream("GET", f"http://127.0.0.1:{echo.port}/latin1") as r:
        assert r.raise_for_status() is r
        assert b"".join(r.iter_bytes(2)) == "café".encode("latin-1")
    with sess.stream("GET", f"http://127.0.0.1:{echo.port}/status/404") as r:
        with pytest.raises(T.http.HTTPStatusError):
            r.raise_for_status()
    seen = {}
    for P in BOTH:
        c = P.http.HttpClient(timeout=5.0)
        calls = []
        c.before_request = lambda m, u: calls.append(("before", m, u))
        c.after_response = lambda m, u, st, dt: calls.append(
            ("after", m, u, st))
        c.get_json(f"http://127.0.0.1:{echo.port}/echo")
        assert c.post_json(f"http://127.0.0.1:{echo.port}/echo",
                           {"a": 1})["body"] == '{"a":1}'
        with pytest.raises(Exception):
            c.get_json(f"http://127.0.0.1:{echo.port}/status/503")
        seen[P.name] = (calls, c.stats())
    assert seen[T.name] == seen[J.name]


def test_the_port_has_no_httpx_transport(monkeypatch):
    """With httpx blocked the port's clients build (the shared one, the
    S3 and Drive targets, the update check's) over urllib."""
    monkeypatch.setitem(sys.modules, "httpx", None)
    monkeypatch.setattr(T.http, "_shared", None)
    from birdnet_go_tpu_torch.utils import backup

    assert isinstance(T.http.shared_client().session, T.http.UrllibSession)
    assert isinstance(backup.S3Target("b", "k", "s").session,
                      T.http.UrllibSession)
    assert isinstance(backup.GDriveTarget("c", "s", "r").session,
                      T.http.UrllibSession)


# -- MQTT ----------------------------------------------------------------------------------

@pytest.fixture(params=["jax", "port"])
def broker(request):
    b = (J if request.param == "jax" else T).mqtt.MiniBroker()
    b.start()
    yield b
    b.stop()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_mqtt_publish_subscribe_roundtrip(client, broker):
    """tests/test_integrations.py's round trip, each client against each
    broker: a subscriber on a wildcard and an exact topic receives what a
    publisher sends, the broker records it."""
    P = J if client == "jax" else T
    sub = P.mqtt.MqttClient("127.0.0.1", broker.port, client_id="sub")
    sub.start()
    assert sub.wait_connected(5)
    got = []
    sub.subscribe("birdnet/detections", lambda t, p: got.append((t, p)))
    sub.subscribe("birdnet/+/levels", lambda t, p: got.append(("+", t, p)))
    assert _wait(lambda: sum(len(s) for _, s in broker._clients) == 2)
    pub = P.mqtt.MqttClient("127.0.0.1", broker.port, client_id="pub")
    pub.start()
    assert pub.wait_connected(5)
    assert pub.publish("birdnet/detections",
                       {"common_name": "Great Tit", "confidence": 0.92})
    assert pub.publish("birdnet/x/levels", "text")
    assert pub.publish("other/topic", b"no")
    assert _wait(lambda: len(got) == 2)
    time.sleep(0.1)
    pub.stop()
    sub.stop()
    assert got == [("birdnet/detections",
                    b'{"common_name": "Great Tit", "confidence": 0.92}'),
                   ("+", "birdnet/x/levels", b"text")]
    assert [t for t, _ in broker.messages] == [
        "birdnet/detections", "birdnet/x/levels", "other/topic"]
    assert (pub.published, pub.errors) == (3, 0)


@pytest.mark.parametrize("client", ["jax", "port"])
def test_mqtt_qos1_puback(client, broker):
    P = J if client == "jax" else T
    pub = P.mqtt.MqttClient("127.0.0.1", broker.port)
    pub.start()
    assert pub.wait_connected(5)
    assert pub.publish("a/b", b"x", qos=1)
    assert pub.publish("a/c", {"k": 1}, qos=1, retain=True)
    assert _wait(lambda: len(broker.messages) == 2)
    pub.stop()
    assert broker.messages == [("a/b", b"x"), ("a/c", b'{"k": 1}')]


def test_mqtt_publish_without_a_connection_as_jax():
    """A publish before the connection counts an error and returns False;
    stop on a client never started is a no-op."""
    out = []
    for P in BOTH:
        c = P.mqtt.MqttClient("127.0.0.1", 1)
        out.append((c.publish("t", b"x"), c.errors, c.is_connected))
        c.stop()
    assert out[0] == out[1] == (False, 1, False)


def _backoff_run(P, monkeypatch, slow: bool):
    """tests/test_integrations.py's two backoff cases through P: the
    flapping session (connect succeeds, the read loop dies) or the slow
    failing connect (every clock read jumps 31 s)."""
    c = P.mqtt.MqttClient("127.0.0.1", 1, client_id="flap")
    if slow:
        fake = {"t": 0.0}

        def fake_monotonic():
            fake["t"] += 31.0
            return fake["t"]

        monkeypatch.setattr(P.mqtt.time, "monotonic", fake_monotonic)

        def dead_connect():
            raise OSError("getaddrinfo blocked 40 s then failed")

        monkeypatch.setattr(c, "_connect_once", dead_connect)
    else:
        monkeypatch.setattr(c, "_connect_once", lambda: None)

        def dead_read():
            raise ConnectionError("session killed after CONNACK")

        monkeypatch.setattr(c, "_read_loop", dead_read)
    laps, backoffs, tagged = {"n": 0}, [], []

    def fast_wait(timeout=None):
        laps["n"] += 1
        backoffs.append(timeout)
        if laps["n"] >= 8:
            c._stop.set()
        return c._stop.is_set()

    monkeypatch.setattr(c._stop, "wait", fast_wait)
    monkeypatch.setattr(P.errors, "from_exception",
                        lambda e, comp, cat=None: tagged.append((comp, cat)))
    c._run()
    return c._consec_errors, tagged, backoffs, c.errors, c.reconnects


@pytest.mark.parametrize("slow", [False, True], ids=["flapping",
                                                     "slow-failing"])
def test_mqtt_backoff_as_jax(slow, monkeypatch):
    """The persistent-failure count and the backoff: tagged once, at the
    fifth lap, and backing off 1, 2, 4 ... 60 s; the same in both."""
    got = [_backoff_run(P, monkeypatch, slow) for P in BOTH]
    assert got[0] == got[1]
    consec, tagged, backoffs, _, _ = got[1]
    assert consec >= 5 and [c for c, _ in tagged] == ["mqtt"]
    assert backoffs == sorted(backoffs) and backoffs[-1] > 1.0


TOPICS = [("a/+/c", "a/b/c"), ("a/+/c", "a/b/d"), ("a/#", "a/b/c/d"),
          ("#", "anything/at/all"), ("a/b", "a/b/c"), ("a/b/#", "a/b"),
          ("+/+", "a/b"), ("+", "a/b"), ("birdnet/#", "birdnet"),
          ("a//c", "a//c"), ("", "")]


def test_topic_wildcards_and_ha_payloads_as_jax():
    for P in BOTH:
        assert P.mqtt._encode_remaining(321) == b"\xc1\x02"
    assert [T.mqtt._topic_matches(p, t) for p, t in TOPICS] == \
        [J.mqtt._topic_matches(p, t) for p, t in TOPICS]
    for args in ((), ("station", "Yard", "yard_node")):
        assert T.mqtt.ha_discovery_payloads(*args) == \
            J.mqtt.ha_discovery_payloads(*args)


@pytest.mark.parametrize("client", ["jax", "port"])
def test_port_broker_keeps_retained_messages(client):
    """The port's broker keeps the last retained message of each topic
    (an empty one clears it) and sends those that match to a new
    subscription, as MQTT 3.1.1 says; JAX's test broker keeps none."""
    P = J if client == "jax" else T
    b = T.mqtt.MiniBroker()
    b.start()
    try:
        pub = P.mqtt.MqttClient("127.0.0.1", b.port, client_id="pub")
        pub.start()
        assert pub.wait_connected(5)
        for topic, cfg in P.mqtt.ha_discovery_payloads().items():
            assert pub.publish(topic, cfg, retain=True)
        pub.publish("x/gone", b"a", retain=True)
        pub.publish("x/gone", b"", retain=True)
        pub.publish("x/plain", b"p")
        assert _wait(lambda: len(b.messages) == 5)
        assert sorted(b.retained) == sorted(P.mqtt.ha_discovery_payloads())
        sub = P.mqtt.MqttClient("127.0.0.1", b.port, client_id="late")
        sub.start()
        assert sub.wait_connected(5)
        got = []
        sub.subscribe("homeassistant/#", lambda t, p: got.append(t))
        assert _wait(lambda: len(got) == 2)
        pub.stop()
        sub.stop()
        assert sorted(got) == sorted(b.retained)
    finally:
        b.stop()


# -- BirdWeather ---------------------------------------------------------------------------

class _Resp:
    def __init__(self, status=200, body=None):
        self.status_code = status
        self._body = {} if body is None else body
        self.content = json.dumps(self._body).encode()

    def raise_for_status(self):
        if self.status_code >= 400:
            raise RuntimeError(f"HTTP {self.status_code}")

    def json(self):
        return self._body


class _Session:
    """Records each call; answers from `answers` (url part → body)."""

    def __init__(self, answers=None, status=200):
        self.requests, self.answers, self.status = [], answers or {}, status

    def _answer(self, url):
        for part, body in self.answers.items():
            if part in url:
                return _Resp(self.status, body)
        return _Resp(self.status)

    def get(self, url, **kw):
        self.requests.append(("GET", url, kw))
        return self._answer(url)

    def post(self, url, **kw):
        self.requests.append(("POST", url, kw))
        return self._answer(url)


def _detection(P, sci="Parus major", common="Great Tit", conf=0.87):
    ts = datetime.datetime(2026, 5, 1, 6, 30)
    return P.results.Detection(
        species=P.labels.Species(sci, common), confidence=conf,
        begin_seconds=ts.timestamp(), end_seconds=ts.timestamp() + 3,
        model_id="BirdNET_V2.4", source_id="s1", timestamp=ts,
        species_code="gretit1")


def test_birdweather_upload_and_detection_as_jax():
    """tests/test_integrations.py's BirdWeather case through both: the
    soundscape's WAV (normalised to -23 LUFS) byte for byte, the detection
    payload, the ids; then a failing session trips the breaker alike."""
    pcm = (np.sin(np.linspace(0, 1000, 48000 * 3)) * 1000).astype(np.int16)
    out = []
    for P in BOTH:
        s = _Session({"soundscapes": {"soundscape": {"id": 77}}})
        c = P.bw.BirdWeatherClient(P.bw.BirdWeatherConfig(
            station_token="tok123", latitude=60.0, longitude=24.0),
            session=s)
        sid = c.upload_soundscape(pcm, 48000, "2026-08-16T12:00:00Z")
        ok = c.post_detection(_detection(P), sid, "2026-08-16T12:00:00Z")
        probe = c.probe()
        bad = P.bw.BirdWeatherClient(P.bw.BirdWeatherConfig(
            station_token="t"), session=_Session(status=500))
        fails = [bad.post_detection(_detection(P), None, "x")
                 for _ in range(7)]
        out.append((sid, ok, probe, s.requests, c.uploads, c.failures,
                    fails, bad.failures, bad.breaker.state))
    assert out[1] == out[0]
    y, info = T.wav.read_wav(io.BytesIO(out[1][3][0][2]["content"]))
    assert info.sample_rate == 48000 and np.abs(y).max() > 1000 / 32768


def test_birdweather_over_each_transport_as_jax():
    """Each package's client on its default transport (the shared client:
    httpx in JAX, urllib in the port) against the loopback BirdWeather:
    the probe, a soundscape and a detection arrive alike."""
    pcm = (np.sin(np.linspace(0, 500, 48000)) * 3000).astype(np.int16)
    out = []
    for P in BOTH:
        srv = FS.birdweather_server().start()
        try:
            base = f"http://127.0.0.1:{srv.port}/api/v1"
            c = P.bw.BirdWeatherClient(P.bw.BirdWeatherConfig(
                station_token=FS.STATION_TOKEN, latitude=60.17,
                longitude=24.94, base_url=base))
            wrong = P.bw.BirdWeatherClient(P.bw.BirdWeatherConfig(
                station_token="other", base_url=base))
            rec = [c.probe(), wrong.probe(),
                   c.upload_soundscape(pcm, 48000, "2026-05-01T06:30:00"),
                   c.post_detection(_detection(P), 1, "2026-05-01T06:30:00")]
            rec.append([(r["method"], r["path"], r["query"],
                         r["headers"].get("content-type"), len(r["body"]),
                         json.loads(r["body"]) if r["path"].endswith(
                             "detections") else None)
                        for r in srv.requests])
            out.append(rec)
        finally:
            srv.stop()
    assert out[1] == out[0]
    assert out[1][:4] == [True, False, 1, True]


# -- weather -------------------------------------------------------------------------------

YR = {"properties": {"timeseries": [{
    "time": "2026-08-16T12:00:00Z",
    "data": {"instant": {"details": {
        "air_temperature": 18.5, "relative_humidity": 72.0,
        "wind_speed": 3.2}},
        "next_1_hours": {"summary": {"symbol_code": "cloudy"}}}}]}}
OPENWEATHER = {"dt": 1789000000, "main": {"temp": 21.37, "humidity": 40,
                                          "pressure": 1011},
               "wind": {"speed": 4.1, "deg": 250}, "clouds": {"all": 75},
               "weather": [{"description": "broken clouds", "icon": "04n"}]}
WUNDERGROUND = {"observations": [{
    "epoch": 1789000100, "humidity": 93.0, "solarRadiation": 2.0,
    "winddir": 190, "metric": {"temp": 3.4, "precipRate": 0.0,
                               "pressure": 1002.1, "windSpeed": 12.6,
                               "windGust": 30.6}}]}


def _weather_rows(P, provider) -> list:
    ds = P.sqlite.Datastore(":memory:")
    poller = P.weather.WeatherPoller(provider, ds)
    n = poller.poll_once()
    with ds._lock:
        rows = [tuple(r) for r in ds._conn.execute(
            "SELECT * FROM hourly_weather ORDER BY time")]
    ds.close()
    return [n, poller.polls, rows]


def test_weather_providers_parse_and_poll_as_jax():
    """yr.no, OpenWeather and Wunderground through both packages' parsers
    on the same bodies: the observations and the rows the poller writes
    are equal, floats exactly, and so are the requests."""
    out = []
    for P in BOTH:
        rec = []
        for make, body in (
                (lambda s: P.weather.YrNoProvider(60.17, 24.94, session=s),
                 YR),
                (lambda s: P.weather.OpenWeatherProvider(
                    60.17, 24.94, "key", session=s), OPENWEATHER),
                (lambda s: P.weather.WundergroundProvider(
                    "IHELSINK1", "key", session=s), WUNDERGROUND)):
            s = _Session({"": body})
            provider = make(s)
            obs = [tuple(vars(o).values()) for o in provider.fetch()]
            rec += [obs, _weather_rows(P, provider), s.requests]
        out.append(rec)
    assert out[1] == out[0]
    assert out[1][1][2][0][-1] == "04"


def test_weather_icon_tables_as_jax():
    symbols = ["clearsky_day", "clearsky_night", "clearsky_polartwilight",
               "fair_day", "partlycloudy_night", "cloudy", "fog",
               "lightrainshowers_day", "heavyrainshowers_night", "lightrain",
               "rain", "heavyrain", "rainshowersandthunder_day",
               "heavyrainandthunder", "lightssleetshowersandthunder_day",
               "lightssnowshowersandthunder_night", "lightsleet",
               "heavysleetshowers_polartwilight", "snow",
               "heavysnowshowers_day", "snowandthunder", "", "martian_dust",
               "  Rain_Day "]
    assert [T.weather.yrno_symbol_icon(s) for s in symbols] == \
        [J.weather.yrno_symbol_icon(s) for s in symbols]
    codes = [f"{n:02d}{dn}" for n in range(0, 60) for dn in "dn"] + \
        ["99x", "", "04"]
    assert [T.weather.openweather_icon(c) for c in codes] == \
        [J.weather.openweather_icon(c) for c in codes]
    grid = [(t, p, h, sr, g) for t in (None, -3, 2, 15, 25)
            for p in (None, 0, 1, 12) for h in (None, 40, 70, 90, 95)
            for sr in (None, 1, 100, 300, 700) for g in (None, 2, 20)]
    assert [T.weather.infer_wunderground_icon(*a) for a in grid] == \
        [J.weather.infer_wunderground_icon(*a) for a in grid]
    assert T.weather.ICON_DESCRIPTION == J.weather.ICON_DESCRIPTION


def test_weather_poller_over_each_transport_as_jax(monkeypatch):
    """Each package's yr.no provider on its default transport against the
    loopback met.no: 24 rows, equal to the float, in a datastore of each
    package; the poller's thread polls once at start."""
    start = time.time()
    out = []
    for P in BOTH:
        srv = FS.yrno_server(start).start()
        try:
            monkeypatch.setattr(P.weather.YrNoProvider, "BASE",
                                f"http://127.0.0.1:{srv.port}{FS.YRNO_PATH}")
            provider = P.weather.YrNoProvider(60.17, 24.94)
            rows = _weather_rows(P, provider)
            ds = P.sqlite.Datastore(":memory:")
            poller = P.weather.WeatherPoller(provider, ds,
                                             interval_seconds=3600)
            poller.start()
            assert _wait(lambda: poller.polls == 1)
            poller.stop()
            latest = ds.latest_hourly_weather()
            ds.close()
            out.append((rows, srv.requests[0]["query"],
                        srv.requests[0]["headers"]["user-agent"],
                        {k: v for k, v in latest.items() if k != "id"}))
        finally:
            srv.stop()
    assert out[1] == out[0]
    assert out[1][0][0] == 24 and len(out[1][0][2]) == 24


# -- eBird -----------------------------------------------------------------------------------

def test_ebird_over_each_transport_as_jax(monkeypatch):
    """Each package's eBird client on its default transport against the
    loopback eBird: the taxonomy (by code and by name), the species code,
    recent observations, the TTL cache (no second request), and without
    the token nothing, after the breaker opens no request at all."""
    out = []
    for P in BOTH:
        srv = FS.ebird_server().start()
        try:
            monkeypatch.setattr(P.ebird, "API_BASE",
                                f"http://127.0.0.1:{srv.port}/v2")
            clock = [1000.0]
            c = P.ebird.EBirdClient(api_token=FS.EBIRD_TOKEN,
                                    clock=lambda: clock[0])
            rec = [c.taxonomy(species_code="houspa"),
                   c.taxonomy(scientific="parus MAJOR"),
                   c.species_code("Turdus merula"),
                   c.recent_observations(60.1699, 24.9384, back_days=14),
                   c.recent_observations(60.1699, 24.9384, back_days=14)]
            n_cached = len(srv.requests)
            clock[0] += 7 * 3600
            rec.append(c.taxonomy(species_code="houspa"))
            anon = P.ebird.EBirdClient(clock=lambda: clock[0])
            rec.append([anon.taxonomy() for _ in range(7)])
            rec.append((n_cached, len(srv.requests),
                        [(r["path"], r["query"],
                          r["headers"].get("x-ebirdapitoken"))
                         for r in srv.requests], anon.breaker.state))
            out.append(rec)
        finally:
            srv.stop()
    assert out[1] == out[0]
    assert out[1][0] == [FS.TAXONOMY[0]] and out[1][2] == "eurbla"


# -- the fake services ---------------------------------------------------------------------

def test_fake_services_process(tmp_path):
    """``python -m birdnet_go_tpu_torch.diag.fake_services``: every service
    listens, a retained HA config, a detection on the topic, a MySQL row
    and a BirdWeather post are recorded, and SIGTERM ends it with its
    record written."""
    from birdnet_go_tpu_torch.datastore.mysql import MySQLDatastore

    proc = subprocess.Popen([sys.executable, "-m",
                             "birdnet_go_tpu_torch.diag.fake_services",
                             "--out", str(tmp_path)], cwd=REPO)
    try:
        assert _wait(lambda: (tmp_path / "services.json").exists(), 60)
        ports = json.loads((tmp_path / "services.json").read_text())
        pub = T.mqtt.MqttClient("127.0.0.1", ports["mqtt"])
        pub.start()
        assert pub.wait_connected(5)
        for topic, cfg in T.mqtt.ha_discovery_payloads(
                ports["topic"]).items():
            pub.publish(topic, cfg, retain=True)
        pub.publish(f"{ports['topic']}/detections", {"id": 1})
        ds = MySQLDatastore(port=ports["mysql"], user=ports["mysql_user"],
                            password=ports["mysql_password"], database="")
        ds.insert_detection(_detection(T))
        ds.close()
        bw = T.bw.BirdWeatherClient(T.bw.BirdWeatherConfig(
            station_token=ports["station_token"],
            base_url=FS.urls(ports)["birdweather"]))
        assert bw.post_detection(_detection(T), None, "2026-05-01T06:30")
        time.sleep(0.3)
        pub.stop()
    finally:
        proc.terminate()
        assert proc.wait(30) == 0
    rec = json.loads((tmp_path / "services_record.json").read_text())
    assert [t for t, _, _ in rec["mqtt"]["received"]] == [
        f"{ports['topic']}/detections"]
    assert sorted(rec["mqtt"]["retained"]) == sorted(
        T.mqtt.ha_discovery_payloads(ports["topic"]))
    assert [i for i, _ in rec["mysql"]["committed"]] == [1]
    assert rec["mysql"]["full_auths"] == 1
    assert [r["path"] for r in rec["http"]["birdweather"]] == [
        f"/api/v1/stations/{FS.STATION_TOKEN}/detections"]
