"""The port's TLS (``utils/tlscert.py``), ACME (``utils/acme.py``), HTTPS
serving (``api/server.py`` ``_ssl_context``) and ``UrllibSession``'s
``verify`` against the JAX package's, on the CPU.

Each package generates a pair that the other's ``validate_key_pair``
accepts and whose ``parse_certificate_info`` reads the same; the SAN,
validity and hostname helpers agree on JAX's test inputs; the
certificate store keeps the same files through the same steps. The five
``tls/certificate`` routes are walked on both servers (``_mini_api`` of
``tests/test_torch_terminal.py``) as JAX's
``tests/test_tls.py::test_tls_api_endpoints`` walks them: the same
statuses, and the same bodies but for dates, serials and fingerprints,
whose shape is compared. Both ACME clients run against
``tests/test_acme.py``'s ``PebbleAnalogue`` (a real RFC 8555 subset with
JWS checks and an HTTP-01 fetch), and the port's running app serves the
challenge from ``GLOBAL_RESPONDER``. ``UrllibSession(verify=...)`` is held
to ``httpx.Client(verify=...)`` on a loopback HTTPS server with a
throwaway CA.
"""

from __future__ import annotations

import datetime
import http.client
import importlib
import json
import logging
import socket
import ssl
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import pytest

from tests.test_acme import ChallengeHttp, PebbleAnalogue
from tests.test_torch_terminal import _mini_api, mini_pair

J = importlib.import_module("birdnet_go_tpu.utils.tlscert")
T = importlib.import_module("birdnet_go_tpu_torch.utils.tlscert")
JA = importlib.import_module("birdnet_go_tpu.utils.acme")
TA = importlib.import_module("birdnet_go_tpu_torch.utils.acme")
V2 = "/api/v2"


# -- certificates ----------------------------------------------------------------------

@pytest.mark.parametrize("maker,reader", [(T, J), (J, T)],
                         ids=["port_pair_read_by_jax", "jax_pair_read_by_port"])
def test_each_side_reads_the_others_pair(maker, reader):
    cert, key = maker.generate_self_signed(
        validity=datetime.timedelta(days=30),
        sans=["localhost", "127.0.0.1", "bird.example.org"])
    reader.validate_key_pair(cert, key)            # no raise
    maker.validate_key_pair(cert, key)
    got, own = reader.parse_certificate_info(cert), \
        maker.parse_certificate_info(cert)
    assert got == own
    assert set(got["sans"]) == {"localhost", "127.0.0.1", "bird.example.org"}
    assert 28 <= got["daysUntilExpiry"] <= 30
    assert len(got["fingerprint"]) == 64


def test_mismatched_pair_refused_alike():
    cert, _ = T.generate_self_signed()
    _, other = J.generate_self_signed()
    errors = []
    for side in (J, T):
        with pytest.raises(ValueError) as e:
            side.validate_key_pair(cert, other)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("certificate/key pair invalid:")


@pytest.mark.parametrize("name", [
    "a-b.example.org", "192.168.1.7", "-bad.example", "ex ample.com",
    "x" * 300, "", "host.", "a" * 63 + ".com", "a" * 64 + ".com", "::1",
    "under_score.example"])
def test_is_valid_hostname_as_jax(name):
    assert T.is_valid_hostname(name) == J.is_valid_hostname(name)


def _validity(side, value):
    try:
        return side.parse_validity(value)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("value", [
    None, "", "8760h", "365d", "1h", "90000h", "eternal", "-5d", "24h",
    "87600h", "87601h", "48", " 30D "])
def test_parse_validity_as_jax(value):
    assert _validity(T, value) == _validity(J, value)


@pytest.mark.parametrize("host,base_url", [
    ("birdhost", "https://birds.example.com:8443/ui"), ("0.0.0.0", ""),
    ("", ""), ("bad host", "http://x y/"), ("::", "https://[::1]:8443/"),
    ("127.0.0.1", "http://127.0.0.1:8080")])
def test_collect_sans_as_jax(host, base_url, caplog):
    with caplog.at_level(logging.WARNING):
        jax_sans = J.collect_sans(host, base_url)
        port_sans = T.collect_sans(host, base_url)
    assert port_sans == jax_sans
    assert "localhost" in port_sans and "127.0.0.1" in port_sans


def _store_steps(side, d: Path) -> list:
    """tests/test_tls.py's store walk, recorded."""
    mgr = side.TLSManager(d)
    rec = [mgr.exists(), mgr.info()]
    mgr.ensure_self_signed(host="h1")
    first = mgr.cert_path().read_text()
    mgr.ensure_self_signed(host="h1")
    rec += [mgr.exists(), mgr.cert_path().read_text() == first]
    short_cert, short_key = side.generate_self_signed(
        validity=datetime.timedelta(seconds=1))
    mgr.save(short_cert, short_key)
    rec.append(oct(mgr.key_path().stat().st_mode & 0o777))
    time.sleep(1.1)
    mgr.ensure_self_signed(host="h1")
    rec += [mgr.cert_path().read_text() != short_cert,
            mgr.cert_path().with_suffix(".pem.bak").read_text()
            == short_cert,
            mgr.info()["daysUntilExpiry"] > 1800,
            sorted(p.name for p in (d / "webserver").iterdir())]
    ctx = mgr.ssl_context()
    rec += [ctx.minimum_version == ssl.TLSVersion.TLSv1_2,
            mgr.delete(), mgr.exists(), mgr.delete()]
    return rec


def test_manager_store_backup_and_expiry_regen_as_jax(tmp_path):
    got = {name: _store_steps(side, tmp_path / name)
           for name, side in (("jax", J), ("port", T))}
    assert got["port"] == got["jax"]
    assert got["port"][:2] == [False, {"installed": False}]


# -- the five routes ------------------------------------------------------------------------

def _call(port: int, method: str, path: str, body=None, prefix=V2):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        data = json.dumps(body).encode() if body is not None else None
        c.request(method, prefix + path, body=data,
                  headers={"Content-Type": "application/json"} if data
                  else {})
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


_VOLATILE = {"notBefore", "notAfter", "serialNumber", "fingerprint"}


def _shape(ctype, body: bytes):
    if ctype and "json" in ctype:
        doc = json.loads(body)
        if isinstance(doc, dict):
            return {k: (type(v).__name__ if k in _VOLATILE else v)
                    for k, v in doc.items()}
        return doc
    return body.decode()[:27] if b"BEGIN CERTIFICATE" in body else body


def test_tls_routes_answer_as_jax(tmp_path):
    """JAX's walk of the routes on both servers, each the same requests:
    status, content type and body (dates, serial and fingerprint by
    type); the restart notification in each inbox."""
    cert, key = J.generate_self_signed()
    cert2, _ = J.generate_self_signed()
    walk = [("GET", "/tls/certificate", None),
            ("GET", "/tls/certificate/download", None),
            ("DELETE", "/tls/certificate", None),
            ("POST", "/tls/certificate/generate", {"validity": "1h"}),
            ("POST", "/tls/certificate/generate", {"validity": "720h"}),
            ("GET", "/tls/certificate", None),
            ("GET", "/tls/certificate/download", None),
            ("POST", "/tls/certificate", {"certificate": cert2,
                                          "privateKey": key}),
            ("POST", "/tls/certificate", {"certificate": "",
                                          "privateKey": key}),
            ("POST", "/tls/certificate", {"certificate": cert,
                                          "privateKey": key}),
            ("GET", "/tls/certificate", None),
            ("DELETE", "/tls/certificate", None),
            ("GET", "/tls/certificate", None),
            ("POST", "/tls/certificate/generate", None)]
    got = {}
    with mini_pair(tmp_path) as servers:
        for name, srv in servers.items():
            rec = []
            for method, path, body in walk:
                st, ct, b = _call(srv.port, method, path, body)
                rec.append((method, path, st, ct, _shape(ct, b)))
            titles = [n["title"] for n in
                      srv.ctx.notification_inbox.list(50, False)]
            got[name] = (rec, titles.count("Restart required"),
                         srv.ctx.restart_required)
    assert got["torch"] == got["jax"]
    statuses = [r[2] for r in got["torch"][0]]
    assert statuses == [200, 404, 404, 400, 200, 200, 200, 400, 400, 200,
                        200, 200, 200, 200]
    assert got["torch"][1] == 4 and got["torch"][2] == ["tlsCertificate"]


# -- HTTPS serving ---------------------------------------------------------------------------

def _https_get(port: int, path: str, cafile: Path):
    ctx = ssl.create_default_context(cafile=str(cafile))
    ctx.check_hostname = False           # the SANs name this host, not the IP
    req = urllib.request.Request(f"https://127.0.0.1:{port}{V2}{path}")
    with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
        return r.status, json.loads(r.read())


def test_https_serving_and_plain_http_refused(tmp_path):
    """``tls_enabled``: the port's server generates its self-signed pair
    under ``tls_dir`` and serves HTTPS that verifies against it; plain
    HTTP to the same port fails, as JAX's ``test_https_serving`` holds
    JAX's."""
    def tls_on(s):
        s.webserver.tls_enabled = True

    srv = _mini_api("birdnet_go_tpu_torch", tmp_path, tls_on)
    try:
        cert = tmp_path / "tls" / "webserver" / "cert.pem"
        st, body = _https_get(srv.port, "/settings", cert)
        assert st == 200 and body["webserver"]["tls_enabled"] is True
        with pytest.raises(Exception):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}{V2}/settings", timeout=5)
        assert _https_get(srv.port, "/ping", cert)[1]["pong"] is True
    finally:
        srv.stop()


def _acme_settings(directory: str, domain: str = "localhost"):
    def configure(s):
        ws = s.webserver
        ws.tls_enabled, ws.tls_mode = True, "acme"
        ws.acme_domain, ws.acme_directory = domain, directory
    return configure


def test_https_on_a_cached_acme_certificate(tmp_path, pebble_both):
    """``tls_mode: acme`` with the certificate already in ``tls_dir/acme``
    (obtained by the port's ``AutoTlsManager`` while nothing served): the
    server starts on it without a new order, and a client that trusts
    only the directory's CA verifies it by name."""
    srv_acme, responder, _ = pebble_both["torch"]
    directory = f"{srv_acme.url}/directory"
    mgr = TA.AutoTlsManager(tmp_path / "tls", "localhost",
                            directory_url=directory)
    mgr.ensure(responder)
    orders = len(srv_acme.orders)
    ca = tmp_path / "ca.pem"
    ca.write_bytes(srv_acme.ca_cert.public_bytes(
        importlib.import_module("cryptography.hazmat.primitives."
                                "serialization").Encoding.PEM))
    srv = _mini_api("birdnet_go_tpu_torch", tmp_path,
                    _acme_settings(directory))
    try:
        ctx = ssl.create_default_context(cafile=str(ca))
        with urllib.request.urlopen(
                f"https://localhost:{srv.port}{V2}/ping", timeout=10,
                context=ctx) as r:
            assert json.loads(r.read())["pong"] is True
        assert len(srv_acme.orders) == orders
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", ["birdnet_go_tpu", "birdnet_go_tpu_torch"])
def test_acme_failure_falls_back_to_self_signed_as_jax(tmp_path, pkg,
                                                       caplog):
    """A directory that does not answer: ``log.exception`` with JAX's line,
    then the self-signed pair, served over HTTPS (both packages)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    with caplog.at_level(logging.ERROR, logger="birdnet_tpu.api"):
        srv = _mini_api(pkg, tmp_path, _acme_settings(
            f"http://127.0.0.1:{dead}/directory", "birds.example.com"))
    try:
        msgs = [r.getMessage() for r in caplog.records
                if r.name == "birdnet_tpu.api" and r.levelno == logging.ERROR]
        assert msgs == ["ACME setup failed — falling back to self-signed"]
        cert = tmp_path / "tls" / "webserver" / "cert.pem"
        assert _https_get(srv.port, "/ping", cert)[1]["pong"] is True
    finally:
        srv.stop()


# -- ACME against the Pebble analogue ------------------------------------------------------

@pytest.fixture()
def pebble_both():
    """A Pebble analogue and its challenge server for each package's
    client, each reading that package's ``Http01Responder``."""
    out = {}
    for name, mod in (("jax", JA), ("torch", TA)):
        responder = mod.Http01Responder()
        chall = ChallengeHttp(responder)
        chall.start()
        srv = PebbleAnalogue(chall.port)
        srv.start()
        out[name] = (srv, responder, chall)
    yield out
    for srv, _, chall in out.values():
        srv.stop()
        chall.stop()


def _order(mod, srv, responder, d: Path) -> dict:
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    client = mod.AcmeClient(f"{srv.url}/directory", d)
    cert_pem, key_pem = client.obtain("birds.example.com", responder,
                                      poll_interval=0.05, timeout=10)
    cert = x509.load_pem_x509_certificate(cert_pem.encode())
    key = serialization.load_pem_private_key(key_pem.encode(), None)
    sans = cert.extensions.get_extension_for_class(
        x509.SubjectAlternativeName).value
    return {"sans": list(sans.get_values_for_type(x509.DNSName)),
            "chain": cert_pem.count("BEGIN CERTIFICATE"),
            "key_matches": key.public_key().public_numbers()
            == cert.public_key().public_numbers(),
            "account_key": (d / "account.key").is_file(),
            "account_key_mode": oct((d / "account.key").stat().st_mode
                                    & 0o777),
            "key_auth_seen": srv.seen_key_auth == (
                f"{srv.authz['ao1']['token']}.{client.thumbprint()}"),
            "accounts": len(srv.accounts), "orders": len(srv.orders),
            "responder_cleared": responder.get(srv.authz["ao1"]["token"])
            is None}


def test_acme_full_order_as_jax(tmp_path, pebble_both):
    got = {name: _order(mod, *pebble_both[name][:2], tmp_path / name)
           for name, mod in (("jax", JA), ("torch", TA))}
    assert got["torch"] == got["jax"]
    assert got["torch"]["sans"] == ["birds.example.com"]
    assert got["torch"]["key_auth_seen"] and got["torch"]["chain"] == 2


def _manager_steps(mod, srv, responder, d: Path) -> list:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec

    mgr = mod.AutoTlsManager(d, "birds.example.com",
                             directory_url=f"{srv.url}/directory")
    rec = [mgr.days_remaining()]
    cert, key = mgr.ensure(responder)
    rec += [cert.name, key.name, 85 < mgr.days_remaining() <= 90,
            len(srv.orders)]
    mgr.ensure(responder)                       # a cache hit
    rec.append(len(srv.orders))
    # 20 days left: inside RENEW_BEFORE_DAYS, so a renewal order
    k = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(x509.oid.NameOID.COMMON_NAME,
                                         "birds.example.com")])
    now = datetime.datetime.now(datetime.timezone.utc)
    short = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
             .public_key(k.public_key()).serial_number(1)
             .not_valid_before(now)
             .not_valid_after(now + datetime.timedelta(days=20))
             .sign(k, hashes.SHA256()))
    mgr.cert_path.write_bytes(short.public_bytes(
        serialization.Encoding.PEM))
    rec.append(round(mgr.days_remaining()))
    mgr.ensure(responder)
    rec += [len(srv.orders), 85 < mgr.days_remaining() <= 90,
            oct(mgr.key_path.stat().st_mode & 0o777),
            sorted(p.name for p in mgr.dir.iterdir())]
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(mgr.cert_path, mgr.key_path)
    return rec


def test_autotls_manager_cache_and_renewal_as_jax(tmp_path, pebble_both):
    got = {name: _manager_steps(mod, *pebble_both[name][:2],
                                tmp_path / name)
           for name, mod in (("jax", JA), ("torch", TA))}
    assert got["torch"] == got["jax"]
    assert got["torch"][4:6] == [1, 1] and got["torch"][7] == 2


def test_acme_challenge_route_on_the_running_app(tmp_path):
    """Both servers behind a password serve the HTTP-01 answer from their
    ``GLOBAL_RESPONDER`` unauthenticated, and 404 for a token they do not
    hold (JAX's ``test_acme_challenge_route_served_by_api``): the same
    statuses, types and bodies."""
    def secured(s):
        s.webserver.password = "secret"
        s.webserver.allow_local_bypass = False

    got = {}
    for mod in (JA, TA):
        mod.GLOBAL_RESPONDER.set("tok123", "tok123.thumbhere")
    try:
        with mini_pair(tmp_path, secured) as servers:
            for name, srv in servers.items():
                got[name] = [_call(srv.port, "GET", path, prefix=prefix)
                             for prefix, path in (
                                 ("", "/.well-known/acme-challenge/tok123"),
                                 ("", "/.well-known/acme-challenge/absent"),
                                 (V2, "/detections"))]
    finally:
        for mod in (JA, TA):
            mod.GLOBAL_RESPONDER.clear("tok123")
    assert got["torch"] == got["jax"]
    assert [(st, b) for st, _, b in got["torch"][:2]] == \
        [(200, b"tok123.thumbhere"), (404, b"no such challenge")]
    assert got["torch"][2][0] == 401


def test_acme_order_through_the_running_apps_challenge_route(tmp_path):
    """The directory validates through the port's running server: the
    port's client orders with ``GLOBAL_RESPONDER``, and the fetch of
    ``/.well-known/acme-challenge/<token>`` reaches the server's route."""
    srv = _mini_api("birdnet_go_tpu_torch", tmp_path)
    pebble = PebbleAnalogue(srv.port)
    pebble.start()
    try:
        mgr = TA.AutoTlsManager(tmp_path / "tls", "birds.example.com",
                                directory_url=f"{pebble.url}/directory")
        cert, _ = mgr.ensure()
        assert cert.is_file() and len(pebble.orders) == 1
        assert pebble.authz["ao1"]["status"] == "valid"
    finally:
        pebble.stop()
        srv.stop()


# -- UrllibSession(verify=...) against httpx ------------------------------------------------

@pytest.fixture(scope="module")
def https_server(tmp_path_factory):
    """A loopback HTTPS server whose certificate a throwaway CA signed:
    (port, CA file)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("https")
    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                            "throwaway CA")])
    ca = (x509.CertificateBuilder().subject_name(ca_name)
          .issuer_name(ca_name).public_key(ca_key.public_key())
          .serial_number(1).not_valid_before(now)
          .not_valid_after(now + datetime.timedelta(days=2))
          .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                         critical=True)
          .sign(ca_key, hashes.SHA256()))
    key = ec.generate_private_key(ec.SECP256R1())
    leaf = (x509.CertificateBuilder()
            .subject_name(x509.Name([x509.NameAttribute(
                NameOID.COMMON_NAME, "127.0.0.1")]))
            .issuer_name(ca_name).public_key(key.public_key())
            .serial_number(2).not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=2))
            .add_extension(x509.SubjectAlternativeName([x509.IPAddress(
                __import__("ipaddress").ip_address("127.0.0.1"))]),
                critical=False)
            .sign(ca_key, hashes.SHA256()))
    (d / "ca.pem").write_bytes(ca.public_bytes(serialization.Encoding.PEM))
    (d / "leaf.pem").write_bytes(leaf.public_bytes(
        serialization.Encoding.PEM))
    (d / "leaf.key").write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = b'{"served": true}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = HTTPServer(("127.0.0.1", 0), H)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(d / "leaf.pem", d / "leaf.key")
    srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv.server_address[1], d / "ca.pem"
    srv.shutdown()
    srv.server_close()


def _fetch(session, url):
    try:
        r = session.get(url)
        return r.status_code, r.json()
    except Exception as e:
        return type(e).__name__


@pytest.mark.parametrize("verify", ["ca_file", "default_store", "off"])
def test_urllib_session_verify_as_httpx(https_server, verify, monkeypatch):
    """Trusted through the CA file: served; the default store, which does
    not hold the throwaway CA: httpx's ``ConnectError``; ``False``:
    served."""
    import httpx

    from birdnet_go_tpu_torch.utils.httpclient import UrllibSession

    port, ca = https_server
    monkeypatch.delenv("SSL_CERT_FILE", raising=False)
    monkeypatch.delenv("SSL_CERT_DIR", raising=False)
    arg = {"ca_file": str(ca), "default_store": True, "off": False}[verify]
    url = f"https://127.0.0.1:{port}/x"
    hx = httpx.Client(verify=ssl.create_default_context(cafile=arg)
                      if verify == "ca_file" else arg, timeout=10)
    with hx:
        want = _fetch(hx, url)
    got = _fetch(UrllibSession(timeout=10, verify=arg), url)
    assert got == want
    assert got == ((200, {"served": True}) if verify != "default_store"
                   else "ConnectError")


def test_default_store_reads_ssl_cert_file(https_server, monkeypatch):
    """``verify=True`` trusts the file ``SSL_CERT_FILE`` names, as httpx's
    does: how phase 20's leg trusts the fake services' CA."""
    import httpx

    from birdnet_go_tpu_torch.utils.httpclient import UrllibSession

    port, ca = https_server
    monkeypatch.setenv("SSL_CERT_FILE", str(ca))
    url = f"https://127.0.0.1:{port}/x"
    with httpx.Client(timeout=10) as hx:
        want = _fetch(hx, url)
    assert _fetch(UrllibSession(timeout=10), url) == want == \
        (200, {"served": True})
