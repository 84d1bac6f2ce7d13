"""The port's OIDC (``api/oidc.py``), GitHub (``api/github_auth.py``) and
Cloudflare Access (``api/cloudflare.py``) logins against the JAX
package's, on the CPU, and the port's app built with each setting that
turns one on.

OIDC: ``tests/test_oidc.py``'s ``FakeHttp`` (the provider behind an
injected transport) and key helpers, the same claims through both
``OidcClient``s: the happy path, the code exchange's body, each claim
check, a bad signature, the allowlist, an unsupported alg, discovery
failures and a rotated key; the error strings are JAX's. End to end on
the port's app: ``/auth/oidc/login`` → ``tests/test_oidc.py``'s
``_IdpHandler`` → the callback → a session cookie that authenticates.
GitHub: ``_GhHttp`` through both ``GithubClient``s, and the routes of
both servers (the redirect and a wrong state). Cloudflare: the same
tokens through both verifiers, each rejection, a rotated key and the
cache of unknown kids; then the middleware's tunnel bypass on the port's
app against ``diag/fake_services.py``'s HTTPS key endpoint.
"""

from __future__ import annotations

import base64
import importlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import HTTPServer
from pathlib import Path

import pytest

from tests import test_torch_app as A
from tests.test_oidc import FakeHttp, _GhHttp, _IdpHandler, make_jwks, \
    sign_jwt
from tests.test_torch_app import tiny_v24  # noqa: F401  (fixture)
from tests.test_torch_terminal import mini_pair

JO = importlib.import_module("birdnet_go_tpu.api.oidc")
TO = importlib.import_module("birdnet_go_tpu_torch.api.oidc")
JG = importlib.import_module("birdnet_go_tpu.api.github_auth")
TG = importlib.import_module("birdnet_go_tpu_torch.api.github_auth")
JC = importlib.import_module("birdnet_go_tpu.api.cloudflare")
TC = importlib.import_module("birdnet_go_tpu_torch.api.cloudflare")
SIDES = {"jax": (JO, JG, JC), "torch": (TO, TG, TC)}
V2 = "/api/v2"
ISSUER = "https://idp.test"


@pytest.fixture(scope="module")
def rsa_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


@pytest.fixture(scope="module")
def other_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


# -- OIDC ---------------------------------------------------------------------------------

def _oidc(mod, key, *, claims_extra=None, allowed=None, kid="k1",
          token_key=None, alg="RS256"):
    """``tests/test_oidc.py``'s ``make_client`` for package `mod`."""
    nonce = {}

    def id_token():
        claims = {"iss": ISSUER, "aud": "birdnet", "sub": "u1",
                  "email": "alice@example.org", "exp": time.time() + 300,
                  "nonce": nonce.get("nonce")}
        claims.update(claims_extra or {})
        return sign_jwt(token_key or key, claims, kid=kid, alg=alg)

    client = mod.OidcClient(issuer=ISSUER, client_id="birdnet",
                            client_secret="s3", redirect_uri="http://me/cb",
                            allowed=allowed,
                            http=FakeHttp(ISSUER, make_jwks(key), id_token))
    return client, nonce


def _flow(mod, key, code="authcode", **kw):
    """begin → complete: the claims (nonce and exp dropped) or the error
    string, the authorization URL's query (state and nonce dropped), and
    the token POST."""
    client, nonce = _oidc(mod, key, **kw)
    state, url = client.begin()
    q = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)
    nonce["nonce"] = q["nonce"][0]
    try:
        out = client.complete(state, code)
        out = {k: v for k, v in out.items() if k not in ("nonce", "exp")}
        again = None
        try:
            client.complete(state, code)
        except mod.OidcError as e:
            again = str(e)
    except mod.OidcError as e:
        out, again = f"OidcError: {e}", None
    query = {k: v for k, v in q.items() if k not in ("state", "nonce")}
    return out, again, query, client.http.token_posts


@pytest.mark.parametrize("case", [
    "happy", "aud", "iss", "exp", "nonce", "aud_list", "bad_signature",
    "allow_email", "allow_domain", "deny_domain", "no_email_denied",
    "unknown_kid"])
def test_oidc_flow_as_jax(rsa_key, other_key, case):
    """The same provider and claims through both clients: the claims, the
    authorization URL, the token POST's body and JAX's error strings."""
    kw = {"happy": {},
          "aud": {"claims_extra": {"aud": "someone-else"}},
          "iss": {"claims_extra": {"iss": "https://evil.test"}},
          "exp": {"claims_extra": {"exp": 1}},
          "nonce": {"claims_extra": {"nonce": "forged"}},
          "aud_list": {"claims_extra": {"aud": ["x", "birdnet"]}},
          "bad_signature": {"token_key": other_key},
          "allow_email": {"allowed": ["alice@example.org"]},
          "allow_domain": {"allowed": ["@EXAMPLE.org"]},
          "deny_domain": {"allowed": ["@corp.net"]},
          "no_email_denied": {"allowed": ["@example.org"],
                              "claims_extra": {"email": ""}},
          "unknown_kid": {"kid": "k9"}}[case]
    got = {name: _flow(mods[0], rsa_key, **kw)
           for name, mods in SIDES.items()}
    assert got["torch"] == got["jax"]
    out, _, query, posts = got["torch"]
    assert query["response_type"] == ["code"] and query["scope"] == \
        ["openid email profile"]
    assert posts and posts[-1]["client_secret"] == "s3"
    if case in ("happy", "aud_list", "allow_email", "allow_domain"):
        assert isinstance(out, dict) and got["torch"][1] == \
            "unknown or expired state"
    else:
        assert isinstance(out, str)


@pytest.mark.parametrize("alg", ["none", "HS256"])
def test_oidc_unsupported_alg_as_jax(rsa_key, alg):
    errs = []
    for mods in SIDES.values():
        client, _ = _oidc(mods[0], rsa_key)
        tok = sign_jwt(rsa_key, {"iss": ISSUER}, alg=alg)
        with pytest.raises(mods[0].OidcError) as e:
            client.verify_id_token(tok.rsplit(".", 1)[0] + ".")
        errs.append(str(e.value))
    assert errs[0] == errs[1] == f"unsupported alg {alg!r}"


class _Answers:
    """A transport whose discovery and JWKS answers are scripted, with
    the count of JWKS fetches."""

    class R:
        def __init__(self, code, body):
            self.status_code, self._body = code, body

        def json(self):
            return self._body

    def __init__(self, discovery, jwks_docs):
        self.discovery, self.jwks_docs = discovery, list(jwks_docs)
        self.jwks_fetches = 0

    def get(self, url, **kw):
        if url.endswith("/.well-known/openid-configuration"):
            return self.R(*self.discovery)
        self.jwks_fetches += 1
        return self.R(200, self.jwks_docs[min(self.jwks_fetches,
                                              len(self.jwks_docs)) - 1])


def _discovered(extra=None, status=200):
    doc = {"issuer": ISSUER, "authorization_endpoint": ISSUER + "/auth",
           "token_endpoint": ISSUER + "/token", "jwks_uri": ISSUER + "/j"}
    for k, v in (extra or {}).items():
        if v is None:
            doc.pop(k)
        else:
            doc[k] = v
    return status, doc


@pytest.mark.parametrize("case", ["http_500", "no_token_endpoint",
                                  "no_jwks_uri", "rotated_key"])
def test_oidc_discovery_and_key_rotation_as_jax(rsa_key, other_key, case):
    """Discovery failures (JAX's strings) and a key that rotated after
    the JWKS was cached: one refetch finds it."""
    got = {}
    for name, mods in SIDES.items():
        if case == "rotated_key":
            http = _Answers(_discovered(), [make_jwks(rsa_key, "k1"),
                                            make_jwks(other_key, "k2")])
        else:
            http = _Answers({"http_500": _discovered(status=500),
                             "no_token_endpoint": _discovered(
                                 {"token_endpoint": None}),
                             "no_jwks_uri": _discovered(
                                 {"jwks_uri": None})}[case], [])
        client = mods[0].OidcClient(ISSUER, "birdnet", "s3", "http://me/cb",
                                    http=http)
        try:
            if case == "rotated_key":
                client.jwks()                    # k1 cached
                tok = sign_jwt(other_key, {"iss": ISSUER, "aud": "birdnet",
                                           "exp": time.time() + 60},
                               kid="k2")
                out = sorted(client.verify_id_token(tok))
            else:
                out = client.begin()[1]
        except mods[0].OidcError as e:
            out = f"OidcError: {e}"
        got[name] = (out, http.jwks_fetches)
    assert got["torch"] == got["jax"]
    if case == "rotated_key":
        assert got["torch"] == (["aud", "exp", "iss"], 2)


def _port_app(monkeypatch, tiny_v24, d: Path, configure):  # noqa: F811
    """The port's app (the tiny v2.4) with its API on 127.0.0.1 behind a
    password, `configure(webserver)` applied, set up, its API started."""
    A._patch_models(A.T, monkeypatch, tiny_v24)
    s = A._app_settings(A.T, d)
    ws = s.webserver
    ws.enabled, ws.host, ws.port = True, "127.0.0.1", 0
    ws.password, ws.allow_local_bypass = "hunter2", False
    ws.token_file = str(d / "tokens.json")
    configure(ws)
    app = A.T.app.Application(s, device="cpu")
    app.setup()
    app.api.start()
    return app


def _close_app(app) -> None:
    app.api.stop()
    app.clip_encoder.shutdown()
    app.datastore.close()


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **kw):
        return None


def _open(opener, url, headers=None):
    """(status, headers, body), a redirect not followed."""
    try:
        with opener.open(urllib.request.Request(url, headers=headers or {}),
                         timeout=10) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_oidc_login_end_to_end_on_the_port_app(monkeypatch, tiny_v24,
                                               rsa_key, tmp_path):
    """``/auth/oidc/login`` 302s to the provider with a state and nonce;
    the callback trades the code at the provider's token endpoint,
    verifies the id_token and sets a session cookie that authenticates
    (``auth/status``, an API route); a forged state gets 401."""
    _IdpHandler.key = rsa_key
    _IdpHandler.nonces = []
    idp = HTTPServer(("127.0.0.1", 0), _IdpHandler)
    threading.Thread(target=idp.serve_forever, daemon=True).start()
    issuer = f"http://127.0.0.1:{idp.server_port}"

    def oidc(ws):
        ws.oidc_issuer, ws.oidc_client_id = issuer, "birdnet"
        ws.oidc_client_secret, ws.oidc_allowed = "s3", ["@example.org"]

    app = _port_app(monkeypatch, tiny_v24, tmp_path, oidc)
    base = f"http://127.0.0.1:{app.api.port}"
    opener = urllib.request.build_opener(_NoRedirect)
    try:
        assert _open(opener, base + f"{V2}/detections")[0] == 401
        st, h, _ = _open(opener, base + f"{V2}/auth/oidc/login")
        assert st == 302 and h["Location"].startswith(issuer + "/auth?")
        q = urllib.parse.parse_qs(urllib.parse.urlparse(
            h["Location"]).query)
        assert q["redirect_uri"] == [
            f"http://127.0.0.1:0{V2}/auth/oidc/callback"]
        _IdpHandler.nonces.append(q["nonce"][0])
        st, h, _ = _open(opener, f"{base}{V2}/auth/oidc/callback?state="
                                 f"{q['state'][0]}&code=fakecode")
        assert st == 302 and h["Location"] == "/"
        cookie = h["Set-Cookie"].split(";", 1)[0]
        assert cookie.startswith("birdnet_session=")
        st, _, b = _open(opener, base + f"{V2}/auth/status",
                         {"Cookie": cookie})
        status = json.loads(b)
        assert (st, status["authenticated"], status["method"]) == \
            (200, True, "session") and status["csrf"]
        assert _open(opener, base + f"{V2}/detections",
                     {"Cookie": cookie})[0] == 200
        st, _, b = _open(opener, f"{base}{V2}/auth/oidc/callback?"
                                 f"state=bogus&code=x")
        assert (st, json.loads(b)) == (401, {"error": "unknown or expired "
                                                      "state"})
        st, _, b = _open(opener, f"{base}{V2}/auth/oidc/callback?"
                                 f"error=access_denied")
        assert (st, json.loads(b)) == (401, {"error": "provider: "
                                                      "access_denied"})
    finally:
        _close_app(app)
        idp.shutdown()


# -- GitHub -------------------------------------------------------------------------------

def _github(mod, case: str):
    allowed, public, state = {
        "public_email": (["cat@example.com"], True, None),
        "private_email": (["@example.com"], False, None),
        "login_entry": (["login:octocat"], True, None),
        "not_allowed": (["other@example.com"], True, None),
        "open_allowlist": ([], False, None),
        "unknown_state": (["cat@example.com"], True, "bogus")}[case]
    http = _GhHttp(email_public=public)
    client = mod.GithubClient("cid", "csec", "http://cb", allowed=allowed,
                              http=http)
    real_state, url = client.begin()
    q = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)
    try:
        out = client.complete(state or real_state, "goodcode")
    except mod.GithubAuthError as e:
        out = f"GithubAuthError: {e}"
    return (url.split("?")[0], {k: v for k, v in q.items() if k != "state"},
            q["state"] == [real_state], out, http.posts)


@pytest.mark.parametrize("case", ["public_email", "private_email",
                                  "login_entry", "not_allowed",
                                  "open_allowlist", "unknown_state"])
def test_github_flow_as_jax(case):
    got = {name: _github(mods[1], case) for name, mods in SIDES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "https://github.com/login/oauth/authorize"


def test_github_routes_as_jax(tmp_path):
    """With a client id and secret: ``auth/github/login`` 302s to GitHub's
    authorize URL with a state, a callback with a wrong state gets 401
    (JAX's body), a provider error 401; without them, 404 on both."""
    def github(s):
        s.webserver.password = "pw"
        s.webserver.github_client_id = "cid"
        s.webserver.github_client_secret = "csec"

    got = {}
    with mini_pair(tmp_path, github) as servers:
        for name, srv in servers.items():
            opener = urllib.request.build_opener(_NoRedirect)
            base = f"http://127.0.0.1:{srv.port}{V2}/auth/github"
            st, h, _ = _open(opener, base + "/login")
            loc = urllib.parse.urlsplit(h["Location"])
            q = urllib.parse.parse_qs(loc.query)
            got[name] = [(st, f"{loc.scheme}://{loc.netloc}{loc.path}",
                          sorted(q), q["client_id"], q["scope"],
                          q["redirect_uri"])]
            for tail in ("/callback?state=wrong&code=x",
                         "/callback?error=access_denied"):
                st, h, b = _open(opener, base + tail)
                got[name].append((st, h["Content-Type"], json.loads(b)))
    with mini_pair(tmp_path / "off") as servers:
        for name, srv in servers.items():
            got[name].append(_open(urllib.request.build_opener(_NoRedirect),
                                   f"http://127.0.0.1:{srv.port}{V2}/auth/"
                                   f"github/login")[::2])
    assert got["torch"] == got["jax"]
    assert got["torch"][0][:2] == (302, "https://github.com/login/oauth/"
                                        "authorize")
    assert got["torch"][1][0] == 401 and got["torch"][1][2] == {
        "error": "unknown or expired state"}


# -- Cloudflare Access ----------------------------------------------------------------------

class _CfSession:
    """Cloudflare's key endpoint as a session: the JWKS of each fetch in
    turn (the last one repeated), the fetches counted."""

    class R:
        def __init__(self, doc):
            self._doc = doc

        def raise_for_status(self):
            return self

        def json(self):
            return self._doc

    def __init__(self, docs):
        self.docs, self.fetches, self.urls = list(docs), 0, []

    def get(self, url, **kw):
        self.urls.append(url)
        self.fetches += 1
        return self.R(self.docs[min(self.fetches, len(self.docs)) - 1])


TEAM = "birds.cloudflareaccess.com"


def _cf_token(key, kid="k1", **claims):
    base = {"iss": f"https://{TEAM}", "aud": ["aud-tag"],
            "exp": time.time() + 600, "email": "a@example.org"}
    base.update(claims)
    return sign_jwt(key, base, kid=kid)


def _tamper(token: str) -> str:
    h, p, s = token.split(".")
    claims = json.loads(base64.urlsafe_b64decode(p + "=" * (-len(p) % 4)))
    claims["email"] = "mallory@example.org"
    p2 = base64.urlsafe_b64encode(json.dumps(claims).encode()) \
        .rstrip(b"=").decode()
    return f"{h}.{p2}.{s}"


@pytest.mark.parametrize("case", [
    "valid", "expired", "wrong_issuer", "wrong_audience", "no_audience_set",
    "audience_string", "alg_none", "tampered", "other_key", "malformed",
    "unknown_kid_cached", "rotated_key"])
def test_cloudflare_verifier_as_jax(rsa_key, other_key, case):
    """The same tokens through both verifiers: the claims or None, and the
    JWKS fetches (a rotation refetches once; an unknown kid is fetched
    for once, then negative-cached until the next scheduled refresh)."""
    got = {}
    for name, mods in SIDES.items():
        docs = [make_jwks(rsa_key, "k1")]
        if case == "rotated_key":
            docs.append(make_jwks(other_key, "k2"))
        sess = _CfSession(docs)
        v = mods[2].CloudflareAccessVerifier(
            f"https://{TEAM}/", audience="" if case == "no_audience_set"
            else "aud-tag", session=sess)
        tokens = {
            "valid": [_cf_token(rsa_key)],
            "expired": [_cf_token(rsa_key, exp=1)],
            "wrong_issuer": [_cf_token(rsa_key, iss="https://evil.test")],
            "wrong_audience": [_cf_token(rsa_key, aud=["other"])],
            "no_audience_set": [_cf_token(rsa_key, aud=["other"])],
            "audience_string": [_cf_token(rsa_key, aud="aud-tag")],
            "alg_none": [sign_jwt(rsa_key, {"iss": f"https://{TEAM}"},
                                  kid="k1", alg="none")],
            "tampered": [_tamper(_cf_token(rsa_key))],
            "other_key": [_cf_token(other_key)],
            "malformed": ["not-a-jwt", "a.b", ""],
            "unknown_kid_cached": [_cf_token(rsa_key, kid="nope")] * 3,
            "rotated_key": [_cf_token(rsa_key), _cf_token(other_key,
                                                          kid="k2")],
        }[case]
        outs = []
        for tok in tokens:
            claims = v.verify(tok)
            outs.append(None if claims is None
                        else sorted(k for k in claims if k != "exp"))
        got[name] = (outs, sess.fetches, sess.urls[:1], v.issuer)
    assert got["torch"] == got["jax"]
    outs, fetches, urls, issuer = got["torch"]
    assert issuer == f"https://{TEAM}" and (not urls or urls[0] ==
                                            f"https://{TEAM}/cdn-cgi/"
                                            f"access/certs")
    if case in ("valid", "no_audience_set", "audience_string"):
        assert outs[0] is not None
    if case == "unknown_kid_cached":
        assert outs == [None] * 3 and fetches == 2
    if case == "rotated_key":
        assert all(o is not None for o in outs) and fetches == 2


def test_tunnel_bypass_on_the_port_app(monkeypatch, tiny_v24, tmp_path):
    """``cloudflare_bypass_enabled`` on the port's app behind a password,
    the team's keys from ``diag/fake_services.py``'s HTTPS endpoint
    (trusted through a client of its CA): a request with a token the team
    key signed is served without a session, a tampered one, an expired one
    and none at all get 401."""
    from birdnet_go_tpu_torch.diag import fake_services as F
    from birdnet_go_tpu_torch.utils import httpclient

    ca = F.FakeCA()
    (tmp_path / "ca.pem").write_bytes(ca.pem)
    cf = F.cloudflare_certs(ca, tmp_path / "cf").start()
    monkeypatch.setattr(httpclient, "_shared", httpclient.HttpClient(
        session=httpclient.UrllibSession(timeout=10,
                                         verify=str(tmp_path / "ca.pem"))))

    def bypass(ws):
        ws.cloudflare_bypass_enabled = True
        ws.cloudflare_team_domain = f"127.0.0.1:{cf.port}"

    app = _port_app(monkeypatch, tiny_v24, tmp_path, bypass)
    base = f"http://127.0.0.1:{app.api.port}{V2}/detections"
    opener = urllib.request.build_opener(_NoRedirect)

    def mint(**claims):
        req = urllib.request.Request(
            f"https://127.0.0.1:{cf.port}/mint",
            data=json.dumps(claims).encode(), method="POST")
        import ssl

        ctx = ssl.create_default_context(cafile=str(tmp_path / "ca.pem"))
        with urllib.request.urlopen(req, context=ctx, timeout=10) as r:
            return json.loads(r.read())["token"]

    try:
        good = mint()
        got = [_open(opener, base, {JC.JWT_HEADER: tok} if tok else {})[0]
               for tok in (good, _tamper(good), mint(exp=1), None)]
        assert got == [200, 401, 401, 401]
        fetches = [r for r in cf.requests if r["method"] == "GET"]
        assert len(fetches) == 1               # cached within its TTL
    finally:
        _close_app(app)
        cf.stop()


# -- the app sets up with each setting ---------------------------------------------------------

@pytest.mark.parametrize("setting", ["tls_enabled", "oidc_issuer",
                                     "github_client_id",
                                     "cloudflare_bypass_enabled"])
def test_app_sets_up_with_each_login_setting(monkeypatch, tiny_v24,
                                             tmp_path, setting):
    """Each setting ``setup`` refused before builds and serves: the API's
    HTTPS (self-signed under ``tls_dir``), the OIDC and GitHub login
    routes (a redirect), the Cloudflare bypass in the middleware."""
    def enable(ws):
        ws.tls_dir = str(tmp_path / "tls")
        if setting == "tls_enabled":
            ws.tls_enabled = True
        elif setting == "oidc_issuer":
            ws.oidc_issuer = "http://127.0.0.1:9"
        elif setting == "github_client_id":
            ws.github_client_id, ws.github_client_secret = "cid", "sec"
        else:
            ws.cloudflare_bypass_enabled = True
            ws.cloudflare_team_domain = "127.0.0.1:9"

    app = _port_app(monkeypatch, tiny_v24, tmp_path, enable)
    try:
        port = app.api.port
        opener = urllib.request.build_opener(_NoRedirect)
        if setting == "tls_enabled":
            import ssl

            ctx = ssl.create_default_context(
                cafile=str(tmp_path / "tls" / "webserver" / "cert.pem"))
            ctx.check_hostname = False
            with urllib.request.urlopen(f"https://127.0.0.1:{port}{V2}/ping",
                                        context=ctx, timeout=10) as r:
                assert r.status == 200
        elif setting == "oidc_issuer":
            # the provider does not answer: JAX's 502 with the error
            st, _, b = _open(opener, f"http://127.0.0.1:{port}{V2}/auth/"
                                     f"oidc/login")
            assert st == 502 and json.loads(b)["error"]
        elif setting == "github_client_id":
            st, h, _ = _open(opener, f"http://127.0.0.1:{port}{V2}/auth/"
                                     f"github/login")
            assert st == 302 and h["Location"].startswith(
                "https://github.com/login/oauth/authorize?")
        else:
            st, _, _ = _open(opener, f"http://127.0.0.1:{port}{V2}/"
                                     f"detections",
                             {JC.JWT_HEADER: "a.b.c"})
            assert st == 401
    finally:
        _close_app(app)
