"""The port's WebSocket (``api/web.py`` ``WebSocketResponse``) and browser
terminal (``api/terminal.py``) against aiohttp's and the JAX package's, on
the CPU.

The codec: RFC 6455's own handshake example, then one echo handler on
both servers (aiohttp's ``WebSocketResponse`` and the port's) and a raw
socket that sends each case of ``FRAMES`` (crafted frames, then a close
frame) and reads every byte the server sends until it closes: the bytes,
close codes included, are aiohttp's, but where ``PINNED`` says why they
differ. Handshakes that lack a part get aiohttp's 400 and its text.

The terminal: ``tests/test_torch_api.py``'s ``pair`` (both apps behind a
password, each client logged in), driven by the same aiohttp
``ws_connect`` client: a resize, then ``stty size`` and a marker read
back, a cross-origin request refused, and the shell reaped once the
socket closes. Without security (``_mini_api``: an ``ApiServer`` over a
context that holds its settings only, as JAX's
``tests/test_tls.py::test_https_serving`` builds one) a proxied request
is refused. The port's own: ``stop()`` with a terminal open, and a
socket over TLS.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import os
import ssl
import struct
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from birdnet_go_tpu_torch.diag.ws_client import (
    OP_BINARY,
    OP_CLOSE,
    OP_CONT,
    OP_PING,
    OP_TEXT,
    WsClient,
    client_frame,
)
from tests.test_torch_api import _serve, _start_api, _webs, pair  # noqa: F401
from tests.test_torch_app import tiny_v24  # noqa: F401  (fixture)

V2 = "/api/v2"


def test_accept_key_is_rfc_6455s_example():
    from birdnet_go_tpu_torch.api.web import accept_key

    assert accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


# -- the codec against aiohttp ----------------------------------------------------------

def _echo_app(web):
    async def echo(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == web.WSMsgType.TEXT:
                await ws.send_str(msg.data)
            elif msg.type == web.WSMsgType.BINARY:
                await ws.send_bytes(msg.data)
        return ws

    app = web.Application()
    app.router.add_get("/ws", echo)
    return app


def _close(code: int = 1000) -> bytes:
    return client_frame(OP_CLOSE, struct.pack("!H", code))


# name -> the bytes the client sends after the handshake (a close frame
# follows each)
FRAMES = {
    "empty": client_frame(OP_BINARY, b""),
    "len_125": client_frame(OP_BINARY, b"a" * 125),
    "len_126": client_frame(OP_BINARY, b"b" * 126),
    "len_65535": client_frame(OP_BINARY, b"c" * 65535),
    "len_65536": client_frame(OP_BINARY, b"d" * 65536),
    "text": client_frame(OP_TEXT, "grüße".encode()),
    "three_fragments": (client_frame(OP_TEXT, b"one ", fin=False)
                        + client_frame(OP_CONT, b"two ", fin=False)
                        + client_frame(OP_CONT, b"three")),
    "ping_between_fragments": (client_frame(OP_TEXT, b"a", fin=False)
                               + client_frame(OP_PING, b"p")
                               + client_frame(OP_CONT, b"b")),
    "ping": client_frame(OP_PING, b"ping!"),
    "unmasked": client_frame(OP_TEXT, b"hi", mask=False),
    "invalid_utf8": client_frame(OP_TEXT, b"\xff\xfe"),
    "over_4_mib": client_frame(OP_BINARY, b"x" * (4 * 1024 ** 2 + 1)),
    "control_over_125": client_frame(OP_PING, b"p" * 126),
    "fragmented_ping": client_frame(OP_PING, b"p", fin=False),
    "orphan_continuation": client_frame(OP_CONT, b"x"),
    "reserved_bits": bytes([0xA2]) + client_frame(OP_BINARY, b"r")[1:],
    "new_message_mid_fragments": (client_frame(OP_TEXT, b"a", fin=False)
                                  + client_frame(OP_BINARY, b"b")),
    "close_1001": b"",
    "close_invalid_code": b"",
    "http_after_upgrade": b"GET / HTTP/1.1\r\nHost: x\r\n\r\n",
}
CLOSES = {"close_1001": _close(1001),
          "close_invalid_code": _close(1005)}
# where the port answers otherwise, and why: RFC 6455 §5.1 has a server
# close the connection on a client frame that is not masked (1002);
# aiohttp reads it
PINNED = {"unmasked": (b"\x81\x02hi\x88\x02\x03\xe8", b"\x88\x02\x03\xea")}


@pytest.fixture(scope="module")
def echo_servers():
    with contextlib.ExitStack() as stack:
        yield {name: stack.enter_context(_serve(web, _echo_app))[0]
               for name, web in _webs().items()}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frames_answered_as_aiohttp(echo_servers, case):
    """Each case's frames, then a close, to both echo servers: every byte
    each sends back until it closes (the echoes with 7, 16 and 64-bit
    lengths, a fragmented message joined, pongs, the close codes: 1000,
    1002, 1007, 1009) is aiohttp's, but for ``PINNED``."""
    got = {}
    for name, port in echo_servers.items():
        c = WsClient(f"ws://127.0.0.1:{port}/ws")
        assert c.status == 101, (name, c.body)
        c.send_raw(FRAMES[case] + CLOSES.get(case, _close()))
        got[name] = c.read_to_eof(30)
    if case in PINNED:
        assert (got["aiohttp"], got["port"]) == PINNED[case]
    else:
        assert got["port"] == got["aiohttp"], case
    assert got["port"][-4:-2] == b"\x88\x02"        # ends with a close


HANDSHAKES = {
    "no_key": {"Sec-WebSocket-Key": None},
    "short_key": {"Sec-WebSocket-Key": "c2hvcnQ="},
    "not_base64_key": {"Sec-WebSocket-Key": "***"},
    "no_upgrade": {"Upgrade": None},
    "no_connection_upgrade": {"Connection": "keep-alive"},
    "version_12": {"Sec-WebSocket-Version": "12"},
}


@pytest.mark.parametrize("case", sorted(HANDSHAKES))
def test_handshake_refusals_as_aiohttp(echo_servers, case):
    """A handshake that lacks a part: aiohttp's 400 and its text."""
    got = {}
    for name, port in echo_servers.items():
        c = WsClient(f"ws://127.0.0.1:{port}/ws", headers=HANDSHAKES[case])
        got[name] = (c.status, c.headers.get("content-type"), c.body)
    assert got["port"] == got["aiohttp"]
    assert got["port"][0] == 400


def test_switching_protocols_head_as_aiohttp(echo_servers):
    got = {}
    for name, port in echo_servers.items():
        c = WsClient(f"ws://127.0.0.1:{port}/ws", headers={
            "Sec-WebSocket-Key": "dGhlIHNhbXBsZSBub25jZQ=="})
        got[name] = (c.status, {k: v for k, v in c.headers.items()
                                if k not in ("date", "server")})
        assert c.close() == 1000
    assert got["port"] == got["aiohttp"]
    assert got["port"][1]["sec-websocket-accept"] == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def _ws_app_with_log(web, log: list):
    async def hold(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        try:
            async for msg in ws:
                await ws.send_str(msg.data)
        finally:
            log.append("handler done")
        return ws

    app = web.Application()
    app.router.add_get("/ws", hold)
    return app


def test_cleanup_closes_open_sockets_with_1001():
    """``AppRunner.cleanup`` with a socket open: the client gets a close
    frame with 1001 (going away), the handler ends, and cleanup returns
    within a second."""
    from birdnet_go_tpu_torch.api import web

    log: list = []
    with _serve(web, lambda w: _ws_app_with_log(w, log)) as (port, box):
        c = WsClient(f"ws://127.0.0.1:{port}/ws")
        c.send_text("x")
        assert c.recv_message(5) == (OP_TEXT, b"x")
        runner = box["runner"]
        loop = runner._sites[0]._server.get_loop()
        fut = asyncio.run_coroutine_threadsafe(runner.cleanup(), loop)
        t0 = time.monotonic()
        fut.result(5)
        took = time.monotonic() - t0
        op, data = c.recv_message(5)
        assert (op, struct.unpack("!H", data[:2])[0]) == (OP_CLOSE, 1001)
        assert took < 1.0 and log == ["handler done"]


def test_socket_over_tls(tmp_path):
    """``TCPSite`` with an ``ssl_context`` serves the same socket over
    TLS (the terminal's ``wss://`` on the card)."""
    from birdnet_go_tpu_torch.api import web
    from birdnet_go_tpu_torch.utils.tlscert import generate_self_signed

    cert, key = generate_self_signed(sans=["localhost", "127.0.0.1"])
    (tmp_path / "c.pem").write_text(cert)
    (tmp_path / "k.pem").write_text(key)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(tmp_path / "c.pem", tmp_path / "k.pem")
    loop = asyncio.new_event_loop()
    box, ready = {}, threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(_echo_app(web))
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0, ssl_context=server_ctx)
        loop.run_until_complete(site.start())
        box.update(port=site.port, runner=runner)
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10)
    try:
        client_ctx = ssl.create_default_context(cafile=tmp_path / "c.pem")
        c = WsClient(f"wss://127.0.0.1:{box['port']}/ws",
                     ssl_context=client_ctx)
        assert c.status == 101
        c.send_binary(b"z" * 70000)
        assert c.recv_message(10) == (OP_BINARY, b"z" * 70000)
        assert c.close() == 1000
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(15)


# -- the terminal ----------------------------------------------------------------------------

def _children() -> set[int]:
    """The pids whose parent is this process (zombies included)."""
    out = set()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == os.getpid():
            out.add(int(pid))
    return out


async def _session(port: int, headers: dict) -> bytes:
    """aiohttp's client on the terminal: a resize to 100x40, then ``stty
    size`` and a marker the shell prints (its command line, echoed by the
    pty, does not hold it); every byte read until the marker."""
    import aiohttp

    async with aiohttp.ClientSession() as sess:
        async with sess.ws_connect(
                f"http://127.0.0.1:{port}{V2}/system/ws",
                headers=headers) as ws:
            await ws.send_str("\x00resize:100x40")
            await ws.send_str("stty size; printf 'mark%s\\n' 42\n")
            out = b""
            deadline = time.monotonic() + 20
            while b"mark42" not in out:
                msg = await ws.receive(timeout=max(0.1, deadline
                                                   - time.monotonic()))
                assert msg.type == aiohttp.WSMsgType.BINARY, msg
                out += msg.data
            return out


def _reaped(before: set[int], timeout: float = 8.0) -> set[int]:
    """The children born since `before` still there after `timeout`."""
    deadline = time.monotonic() + timeout
    while True:
        left = _children() - before
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.1)


def test_terminal_echo_resize_and_reap_as_jax(pair):  # noqa: F811
    """Both terminals through the same aiohttp client with the session
    cookie: the resize reaches the pty (``stty size`` reads 40 100), the
    marker comes back, and once the socket closes no child of this
    process is left (the shell SIGHUPed and reaped off-thread)."""
    for name, side in pair.items():
        before = _children()
        out = asyncio.new_event_loop().run_until_complete(
            _session(side.client.port, {"Cookie": side.client.cookie}))
        text = out.decode("utf-8", "replace")
        assert "40 100" in text and "mark42" in text, (name, text[-400:])
        assert not _reaped(before), name


def test_terminal_with_a_matching_origin(pair):  # noqa: F811
    side = pair["torch"]
    port = side.client.port
    before = _children()
    out = asyncio.new_event_loop().run_until_complete(
        _session(port, {"Cookie": side.client.cookie,
                        "Origin": f"http://127.0.0.1:{port}"}))
    assert b"mark42" in out
    assert not _reaped(before)


@pytest.mark.parametrize("headers", [
    {"Origin": "https://evil.example"},
    {},
], ids=["cross_origin", "no_session"])
def test_terminal_refusals_as_jax(pair, headers):  # noqa: F811
    """Cross-origin with a session (403 ``cross-origin terminal access
    denied``) and no session at all (the middleware's 401): both
    servers' statuses and bodies."""
    got = {}
    for name, side in pair.items():
        auth = "Origin" in headers
        st, h, b = side.client.call(
            "GET", f"{V2}/system/ws", auth=auth,
            headers={**headers, "Upgrade": "websocket",
                     "Connection": "Upgrade", "Sec-WebSocket-Version": "13",
                     "Sec-WebSocket-Key": "dGhlIHNhbXBsZSBub25jZQ=="})
        got[name] = (st, h.get("content-type"), b)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (403 if headers else 401)


def _mini_api(pkg: str, d: Path, configure=None):
    """``pkg``'s ``ApiServer`` over a context holding its settings (and a
    notification inbox, the TLS routes' restart note), started on
    ``127.0.0.1``: JAX's ``tests/test_tls.py::test_https_serving`` builds
    its server so. ``configure(settings)`` runs first."""
    server = importlib.import_module(f"{pkg}.api.server")
    settings = importlib.import_module(f"{pkg}.config.settings")
    notification = importlib.import_module(f"{pkg}.integrations."
                                           f"notification")
    ctx = SimpleNamespace(settings=settings.Settings(),
                          notification_inbox=notification.NotificationInbox(),
                          restart_required=[])
    ws = ctx.settings.webserver
    ws.host, ws.port = "127.0.0.1", 0
    ws.tls_dir = str(d / "tls")
    ws.token_file = str(d / "tokens.json")
    ws.auth_token = None
    ws.password = None
    if configure is not None:
        configure(ctx.settings)
    srv = server.ApiServer.__new__(server.ApiServer)
    srv.ctx, srv.host, srv.port = ctx, "127.0.0.1", 0
    srv.sse = importlib.import_module(f"{pkg}.api.sse").SseBroadcaster()
    srv._thread = srv._loop = srv._runner = None
    srv._started = threading.Event()
    srv.started_at = time.time()
    _start_api(SimpleNamespace(api=srv))
    return srv


@contextlib.contextmanager
def mini_pair(d: Path, configure=None):
    """``_mini_api`` of both packages: {"jax": server, "torch": server}."""
    servers = {}
    try:
        for name, pkg in (("jax", "birdnet_go_tpu"),
                          ("torch", "birdnet_go_tpu_torch")):
            (d / name).mkdir(parents=True, exist_ok=True)
            servers[name] = _mini_api(pkg, d / name, configure)
        yield servers
    finally:
        for srv in servers.values():
            srv.stop()


def _raw_get(port: int, path: str, headers: dict):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path, headers=headers)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


@pytest.mark.parametrize("proxy", ["X-Forwarded-For", "X-Real-IP",
                                   "Forwarded"])
def test_terminal_proxied_without_security_refused_as_jax(tmp_path, proxy):
    """Security off: a request that came through a proxy gets 403
    ``terminal requires authentication`` on both servers (a direct local
    one is served, ``test_terminal_direct_without_security``)."""
    with mini_pair(tmp_path) as servers:
        got = {name: _raw_get(srv.port, f"{V2}/system/ws",
                              {proxy: "203.0.113.7"})
               for name, srv in servers.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 403
    assert b"terminal requires authentication" in got["torch"][2]


def test_terminal_direct_without_security(tmp_path):
    """Security off, a direct local client: both terminals serve it."""
    with mini_pair(tmp_path) as servers:
        for name, srv in servers.items():
            before = _children()
            out = asyncio.new_event_loop().run_until_complete(
                _session(srv.port, {}))
            assert b"mark42" in out, name
            assert not _reaped(before), name


def test_stop_returns_with_a_terminal_open(tmp_path):
    """The port's ``stop()`` with a terminal open: the client gets 1001,
    ``stop`` returns within a second and a half, the shell is reaped."""
    srv = _mini_api("birdnet_go_tpu_torch", tmp_path)
    before = _children()
    try:
        c = WsClient(f"ws://127.0.0.1:{srv.port}{V2}/system/ws")
        assert c.status == 101
        c.send_text("printf 'up%s\\n' 1\n")
        c.read_until(b"up1", 20)
    finally:
        t0 = time.monotonic()
        srv.stop()
        took = time.monotonic() - t0
    op, data = c.recv_message(5)
    while op != OP_CLOSE:
        op, data = c.recv_message(5)
    assert struct.unpack("!H", data[:2])[0] == 1001
    assert took < 1.5, took
    assert not _reaped(before)
