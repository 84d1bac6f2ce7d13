"""The services a station's integrations talk to, as loopback fakes: an
MQTT broker with a subscriber that records what it receives, the MySQL
server of ``diag/mysql_server.py``, HTTP servers in the place of
BirdWeather, yr.no (met.no's locationforecast) and eBird, each recording
the requests it gets, and those of the API's HTTPS and logins: an
OpenID Connect provider (``oidc_provider``), an ACME directory
(``acme_directory``: RFC 8555's account, order, HTTP-01 and finalize,
``tests/test_acme.py``'s analogue as a service, its certificates signed
by the fakes' CA) and Cloudflare Access's key endpoint over HTTPS
(``cloudflare_certs``, with a certificate from the same CA, ``FakeCA``). Not a feature of the port: ``chip_smoke.py`` phase
20 runs them in a process of their own beside the app, and the port's
tests run them in theirs. Nothing here leaves ``127.0.0.1``.

    python -m birdnet_go_tpu_torch.diag.fake_services --out DIR

writes ``DIR/services.json`` (each service's port, the MySQL password,
the BirdWeather station token, and the CA's file ``DIR/ca.pem``, which
a client that trusts the fakes names in ``SSL_CERT_FILE``) once every
service listens, serves until
SIGTERM or SIGINT, then writes ``DIR/services_record.json`` (what each
service received, with the wall clock of its arrival) and exits 0. The
MySQL database is the file ``DIR/mysql.db``.

In a process of one's own, ``Services(out).start()`` does the same;
``urls()`` gives the bases to point the integrations at.
"""

from __future__ import annotations

import argparse
import base64
import datetime as _dt
import http.server
import json
import re
import secrets
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

    def __init__(self, name: str, routes: list, ssl_context=None):
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
                if self.command != "HEAD":
                    self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _answer

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                    Handler)
        self._srv.daemon_threads = True
        if ssl_context is not None:
            # the handshake in the handler's thread, not in accept()
            self._srv.socket = ssl_context.wrap_socket(
                self._srv.socket, server_side=True,
                do_handshake_on_connect=False)
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


# -- the API's HTTPS and logins ---------------------------------------------------------

OIDC_CLIENT_ID = "birdnet-station"
OIDC_CLIENT_SECRET = "oidc-secret-0"
OIDC_EMAIL = "alice@example.org"
CF_KID = "cf-key-1"


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def rsa_jwk(key, kid: str) -> dict:
    """The public half of an RSA key as a JWK."""
    pub = key.public_key().public_numbers()
    n = pub.n.to_bytes((pub.n.bit_length() + 7) // 8, "big")
    e = pub.e.to_bytes(3, "big").lstrip(b"\0")
    return {"kty": "RSA", "kid": kid, "alg": "RS256", "use": "sig",
            "n": _b64url(n), "e": _b64url(e)}


def sign_rs256(key, claims: dict, kid: str) -> str:
    """A JWT of `claims` signed RS256 by `key`."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    h64 = _b64url(json.dumps({"alg": "RS256", "kid": kid,
                              "typ": "JWT"}).encode())
    p64 = _b64url(json.dumps(claims).encode())
    sig = key.sign(f"{h64}.{p64}".encode(), padding.PKCS1v15(),
                   hashes.SHA256())
    return f"{h64}.{p64}.{_b64url(sig)}"


def _rsa_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


class FakeCA:
    """A throwaway certificate authority (EC P-256) for the fakes: it signs
    the HTTPS fakes' certificates and the ACME directory's; ``pem`` is its
    certificate, the file a client that trusts the fakes names."""

    def __init__(self, name: str = "birdnet fakes CA"):
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        self.key = ec.generate_private_key(ec.SECP256R1())
        self.name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                                  name)])
        now = _dt.datetime.now(_dt.timezone.utc)
        self.cert = (x509.CertificateBuilder()
                     .subject_name(self.name).issuer_name(self.name)
                     .public_key(self.key.public_key())
                     .serial_number(x509.random_serial_number())
                     .not_valid_before(now - _dt.timedelta(minutes=5))
                     .not_valid_after(now + _dt.timedelta(days=3650))
                     .add_extension(x509.BasicConstraints(
                         ca=True, path_length=None), critical=True)
                     .sign(self.key, hashes.SHA256()))
        self.pem = self.cert.public_bytes(serialization.Encoding.PEM)

    def _leaf(self, subject, public_key, san, days: float):
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization

        now = _dt.datetime.now(_dt.timezone.utc)
        cert = (x509.CertificateBuilder()
                .subject_name(subject).issuer_name(self.name)
                .public_key(public_key)
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - _dt.timedelta(minutes=5))
                .not_valid_after(now + _dt.timedelta(days=days))
                .add_extension(san, critical=False)
                .sign(self.key, hashes.SHA256()))
        return cert.public_bytes(serialization.Encoding.PEM)

    def sign_csr(self, csr_der: bytes, days: float = 90) -> str:
        """The chain (leaf, then this CA) for a CSR, as an ACME server
        issues it."""
        from cryptography import x509

        csr = x509.load_der_x509_csr(csr_der)
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid")
        san = csr.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        return (self._leaf(csr.subject, csr.public_key(), san, days)
                + self.pem).decode()

    def server_context(self, names: list[str], d: Path):
        """An ``ssl`` server context on a fresh key and a certificate for
        `names` (DNS names or IP addresses), its files under `d`."""
        import ipaddress
        import ssl

        from cryptography import x509
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        key = ec.generate_private_key(ec.SECP256R1())
        entries = []
        for n in names:
            try:
                entries.append(x509.IPAddress(ipaddress.ip_address(n)))
            except ValueError:
                entries.append(x509.DNSName(n))
        pem = self._leaf(x509.Name([x509.NameAttribute(
            NameOID.COMMON_NAME, names[0])]), key.public_key(),
            x509.SubjectAlternativeName(entries), 30)
        d.mkdir(parents=True, exist_ok=True)
        (d / "server.pem").write_bytes(pem + self.pem)
        kp = d / "server.key"
        kp.write_bytes(key.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(d / "server.pem", kp)
        return ctx


def oidc_provider(client_id: str = OIDC_CLIENT_ID,
                  client_secret: str = OIDC_CLIENT_SECRET,
                  email: str = OIDC_EMAIL) -> FakeHttp:
    """An OpenID Connect provider on loopback HTTP: discovery, its JWKS,
    an ``authorize`` that signs the user in at once (302 to the
    ``redirect_uri`` with a code and the state) and a ``token`` endpoint
    that trades a code, once, for an RS256 id_token holding the nonce.
    ``srv.issued`` lists the codes traded."""
    key = _rsa_key()
    codes: dict[str, dict] = {}
    issued: list[str] = []

    def base() -> str:
        return f"http://127.0.0.1:{srv.port}"

    def discovery(r):
        b = base()
        return 200, {"issuer": b, "authorization_endpoint": b + "/authorize",
                     "token_endpoint": b + "/token", "jwks_uri": b + "/jwks"}

    def authorize(r):
        q = {k: v[0] for k, v in urllib.parse.parse_qs(r["query"]).items()}
        if q.get("client_id") != client_id \
                or q.get("response_type") != "code":
            return 400, {"error": "invalid_request"}
        code = secrets.token_urlsafe(16)
        codes[code] = {"nonce": q.get("nonce"),
                       "redirect_uri": q.get("redirect_uri")}
        sep = "&" if "?" in q["redirect_uri"] else "?"
        loc = (q["redirect_uri"] + sep + urllib.parse.urlencode(
            {"code": code, "state": q.get("state", "")}))
        return 302, b"", {"Location": loc}

    def token(r):
        f = {k: v[0] for k, v in urllib.parse.parse_qs(r["body"]).items()}
        grant = codes.pop(f.get("code", ""), None)
        if grant is None or f.get("client_id") != client_id \
                or f.get("client_secret") != client_secret \
                or f.get("redirect_uri") != grant["redirect_uri"]:
            return 400, {"error": "invalid_grant"}
        issued.append(f["code"])
        now = int(time.time())
        claims = {"iss": base(), "aud": client_id, "sub": "user-1",
                  "email": email, "email_verified": True, "iat": now,
                  "exp": now + 300, "nonce": grant["nonce"]}
        return 200, {"id_token": sign_rs256(key, claims, "oidc-1"),
                     "access_token": secrets.token_urlsafe(16),
                     "token_type": "Bearer", "expires_in": 300}

    srv = FakeHttp("oidc", [
        ("GET", "/.well-known/openid-configuration", discovery),
        ("GET", "/jwks", lambda r: (200, {"keys": [rsa_jwk(key,
                                                           "oidc-1")]})),
        ("GET", "/authorize", authorize),
        ("POST", "/token", token)])
    srv.issued = issued
    return srv


def acme_directory(ca: FakeCA) -> FakeHttp:
    """An ACME directory on loopback HTTP: RFC 8555's nonces, an ES256 JWS
    on every POST (checked against the account's key), account, order,
    authorization, an HTTP-01 challenge validated by a real fetch of
    ``http://<address>/.well-known/acme-challenge/<token>``, finalize
    (the CSR signed by `ca`) and the certificate chain. A domain resolves
    to the address a client registers with ``POST /dns {"domain",
    "address"}`` (standing in for DNS: the address of the server that
    answers the challenge). ``srv.acme`` holds its state (``orders``,
    ``validations``)."""
    st = {"nonces": set(), "accounts": {}, "orders": {}, "authz": {},
          "certs": {}, "dns": {}, "validations": []}
    lock = threading.Lock()

    def base() -> str:
        return f"http://127.0.0.1:{srv.port}"

    def nonce() -> str:
        n = secrets.token_urlsafe(16)
        with lock:
            st["nonces"].add(n)
        return n

    def answer(status, body, headers=None):
        return status, body, {"Replay-Nonce": nonce(), **(headers or {})}

    def verify_jws(r):
        """(payload, jwk) of a signed POST; raises ValueError."""
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec, utils

        jws = json.loads(r["body"])
        protected = json.loads(_b64url_decode(jws["protected"]))
        with lock:
            if protected.get("nonce") not in st["nonces"]:
                raise ValueError("badNonce")
            st["nonces"].discard(protected["nonce"])
        if not protected.get("url", "").endswith(r["path"]):
            raise ValueError("url mismatch")
        jwk = protected.get("jwk") or st["accounts"][protected["kid"]]
        pub = ec.EllipticCurvePublicNumbers(
            int.from_bytes(_b64url_decode(jwk["x"]), "big"),
            int.from_bytes(_b64url_decode(jwk["y"]), "big"),
            ec.SECP256R1()).public_key()
        sig = _b64url_decode(jws["signature"])
        der = utils.encode_dss_signature(int.from_bytes(sig[:32], "big"),
                                         int.from_bytes(sig[32:], "big"))
        pub.verify(der, f"{jws['protected']}.{jws['payload']}".encode(),
                   ec.ECDSA(hashes.SHA256()))
        payload = (json.loads(_b64url_decode(jws["payload"]))
                   if jws["payload"] else None)
        return payload, jwk

    def signed(fn):
        def route(r):
            try:
                payload, jwk = verify_jws(r)
            except ValueError as e:
                kind = "badNonce" if str(e) == "badNonce" else "malformed"
                return answer(400, {"type": f"urn:ietf:params:acme:error:"
                                            f"{kind}", "detail": str(e)})
            except Exception as e:
                return answer(400, {"type": "urn:ietf:params:acme:error:"
                                            "badSignature",
                                    "detail": str(e)})
            return fn(r, payload, jwk)
        return route

    def new_account(r, payload, jwk):
        kid = f"{base()}/acct/{len(st['accounts']) + 1}"
        st["accounts"][kid] = jwk
        return answer(201, {"status": "valid"}, {"Location": kid})

    def new_order(r, payload, jwk):
        domain = payload["identifiers"][0]["value"]
        with lock:
            oid = f"o{len(st['orders']) + 1}"
            aid = f"a{oid}"
            st["authz"][aid] = {"status": "pending", "domain": domain,
                                "token": secrets.token_urlsafe(12),
                                "jwk": jwk}
            st["orders"][oid] = {"status": "pending", "authz": aid,
                                 "domain": domain, "t": time.time()}
        return answer(201, {"status": "pending",
                            "identifiers": payload["identifiers"],
                            "authorizations": [f"{base()}/authz/{aid}"],
                            "finalize": f"{base()}/finalize/{oid}"},
                      {"Location": f"{base()}/order/{oid}"})

    def authz(r, payload, jwk):
        aid = r["path"].rsplit("/", 1)[1]
        a = st["authz"][aid]
        return answer(200, {"status": a["status"], "identifier": {
            "type": "dns", "value": a["domain"]}, "challenges": [{
                "type": "http-01", "token": a["token"], "status":
                a["status"], "url": f"{base()}/chall/{aid}"}]})

    def challenge(r, payload, jwk):
        import hashlib
        import urllib.request

        aid = r["path"].rsplit("/", 1)[1]
        a = st["authz"][aid]
        address = st["dns"].get(a["domain"], a["domain"])
        url = (f"http://{address}/.well-known/acme-challenge/"
               f"{a['token']}")
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                got = resp.read().decode()
        except Exception as e:
            got = f"fetch failed: {e}"
        canon = json.dumps(a["jwk"], separators=(",", ":"),
                           sort_keys=True).encode()
        thumb = _b64url(hashlib.sha256(canon).digest())
        a["status"] = "valid" if got == f"{a['token']}.{thumb}" \
            else "invalid"
        st["validations"].append({"domain": a["domain"], "url": url,
                                  "status": a["status"], "t": time.time()})
        return answer(200, {"type": "http-01", "status": a["status"],
                            "token": a["token"]})

    def finalize(r, payload, jwk):
        oid = r["path"].rsplit("/", 1)[1]
        o = st["orders"][oid]
        if st["authz"][o["authz"]]["status"] != "valid":
            return answer(403, {"type": "urn:ietf:params:acme:error:"
                                        "orderNotReady"})
        st["certs"][oid] = ca.sign_csr(_b64url_decode(payload["csr"]))
        o["status"] = "valid"
        return answer(200, {"status": "valid",
                            "certificate": f"{base()}/cert/{oid}"})

    def order(r, payload, jwk):
        o = st["orders"][r["path"].rsplit("/", 1)[1]]
        body = {"status": o["status"]}
        if o["status"] == "valid":
            body["certificate"] = f"{base()}/cert/{r['path'][7:]}"
        return answer(200, body)

    def cert(r, payload, jwk):
        return answer(200, st["certs"][r["path"].rsplit("/", 1)[1]]
                      .encode(), {"Content-Type":
                                  "application/pem-certificate-chain"})

    def dns(r):
        body = json.loads(r["body"])
        st["dns"][body["domain"]] = body["address"]
        return 200, {"ok": True}

    srv = FakeHttp("acme", [
        ("GET", "/directory", lambda r: (200, {
            "newNonce": f"{base()}/new-nonce",
            "newAccount": f"{base()}/new-account",
            "newOrder": f"{base()}/new-order"})),
        ("HEAD", "/new-nonce", lambda r: answer(200, b"")),
        ("POST", "/dns", dns),
        ("POST", "/new-account", signed(new_account)),
        ("POST", "/new-order", signed(new_order)),
        ("POST", "/authz/[^/]+", signed(authz)),
        ("POST", "/chall/[^/]+", signed(challenge)),
        ("POST", "/finalize/[^/]+", signed(finalize)),
        ("POST", "/order/[^/]+", signed(order)),
        ("POST", "/cert/[^/]+", signed(cert))])
    srv.acme = st
    return srv


def cloudflare_certs(ca: FakeCA, d: Path) -> FakeHttp:
    """Cloudflare Access's key endpoint over HTTPS (a certificate from `ca`
    for 127.0.0.1 and localhost; the verifier hard-wires ``https://``):
    ``/cdn-cgi/access/certs`` lists the team's RSA key as a JWKS. ``POST
    /mint`` (a control route of the fake, not Cloudflare's) answers a JWT
    of the posted claims signed by that key, with the issuer the team
    domain (``127.0.0.1:<port>``) and an hour's expiry unless the claims
    name them."""
    key = _rsa_key()

    def mint(r):
        now = int(time.time())
        claims = {"iss": f"https://127.0.0.1:{srv.port}", "iat": now,
                  "exp": now + 3600, "email": "tunnel@example.org",
                  **json.loads(r["body"] or "{}")}
        return 200, {"token": sign_rs256(key, claims, CF_KID)}

    srv = FakeHttp("cloudflare", [
        ("GET", "/cdn-cgi/access/certs",
         lambda r: (200, {"keys": [rsa_jwk(key, CF_KID)]})),
        ("POST", "/mint", mint)],
        ssl_context=ca.server_context(["127.0.0.1", "localhost"], d))
    return srv


class Services:
    """Every fake, started together: the broker (and its recording
    subscriber on ``<topic>/#``), MySQL on ``out/mysql.db`` (caching_sha2
    with full RSA auth on the first connection), the three HTTP servers of
    the integrations, and the OIDC provider, the ACME directory and
    Cloudflare's key endpoint, whose CA's certificate is ``out/ca.pem``."""

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
        self.ca = FakeCA()
        (self.out / "ca.pem").write_bytes(self.ca.pem)
        self.http = {"birdweather": birdweather_server(),
                     "yrno": yrno_server(), "ebird": ebird_server(),
                     "oidc": oidc_provider(),
                     "acme": acme_directory(self.ca),
                     "cloudflare": cloudflare_certs(self.ca,
                                                    self.out / "tls")}
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
                "station_token": STATION_TOKEN, "ebird_token": EBIRD_TOKEN,
                "ca": str(self.out / "ca.pem"),
                "oidc_client_id": OIDC_CLIENT_ID,
                "oidc_client_secret": OIDC_CLIENT_SECRET,
                "oidc_email": OIDC_EMAIL}

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
            "acme": {"orders": {k: {"domain": o["domain"],
                                    "status": o["status"], "t": o["t"]}
                                for k, o in self.http["acme"].acme[
                                    "orders"].items()},
                     "validations": self.http["acme"].acme["validations"]},
            "oidc": {"codes_traded": len(self.http["oidc"].issued)},
            "http": {k: [{f: x for f, x in r.items() if f != "raw"}
                         for r in v.requests]
                     for k, v in self.http.items()},
        }


def urls(ports: dict) -> dict:
    """The bases to point the integrations at: BirdWeather's client
    ``base_url``, ``YrNoProvider.BASE`` and eBird's ``API_BASE``; the OIDC
    issuer, the ACME directory and the Cloudflare team domain."""
    return {"birdweather": f"http://127.0.0.1:{ports['birdweather']}/api/v1",
            "yrno": f"http://127.0.0.1:{ports['yrno']}{YRNO_PATH}",
            "ebird": f"http://127.0.0.1:{ports['ebird']}/v2",
            "oidc_issuer": f"http://127.0.0.1:{ports['oidc']}",
            "acme_directory": f"http://127.0.0.1:{ports['acme']}/directory",
            "cloudflare_team": f"127.0.0.1:{ports['cloudflare']}"}


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
