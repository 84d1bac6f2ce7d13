"""Authentication + security middleware (reference: internal/security,
internal/api/auth — OAuth2 server with auth codes and persisted bearer
tokens, basic-auth login flow, binary authz; flows described in the
reference's ARCHITECTURE.md:1896-2180).

Surface implemented the same way the reference's is used in practice:

- **Login** (basic auth): POST /api/v2/auth/login {password} → HttpOnly
  session cookie + CSRF token. The browser SPA authenticates this way.
- **OAuth2**: GET /api/v2/oauth2/authorize (needs an authenticated
  session) issues a short-lived auth code; POST /api/v2/oauth2/token
  exchanges it (grant_type=authorization_code) — or client credentials
  (grant_type=client_credentials) — for a persisted bearer access token.
- **Middleware** accepts: static configured token, issued access tokens,
  session cookies, HTTP Basic, or the direct local-subnet bypass.
- **CSRF**: cookie-authenticated mutating requests must echo the session's
  CSRF token in X-CSRF-Token (bearer-token requests are exempt, standard
  practice — the token itself is the proof).

Tokens persist across restarts as salted SHA-256 digests (never
plaintext) in webserver.token_file, mirroring the reference's atomic
token persistence.

A copy of ``birdnet_go_tpu/api/security.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_api.py`` holds it to the
original, and ``tests/test_torch_logins.py`` its OIDC, GitHub and
Cloudflare logins (``api/oidc.py``, ``api/github_auth.py``,
``api/cloudflare.py``, the port's copies, over its ``HttpClient``).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import secrets
import time
from pathlib import Path

from birdnet_go_tpu_torch.api import web
from birdnet_go_tpu_torch.api.auth import is_local_address

log = logging.getLogger("birdnet_tpu.security")

PUBLIC_PATHS = {"/api/v2/health", "/api/v2/ping", "/metrics",
                "/api/v2/auth/login", "/api/v2/auth/status",
                "/api/v2/auth/oidc/login", "/api/v2/auth/oidc/callback",
                "/api/v2/auth/github/login", "/api/v2/auth/github/callback",
                "/api/v2/oauth2/token", "/manifest.json", "/sw.js"}
# /.well-known/acme-challenge: HTTP-01 validation fetches MUST succeed
# unauthenticated (RFC 8555; reference AutoTLS listener)
PUBLIC_PREFIXES = ("/ui", "/login", "/static/",
                   "/.well-known/acme-challenge/")

SESSION_COOKIE = "birdnet_session"
AUTH_CODE_TTL = 120.0


def _digest(value: str, salt: str) -> str:
    return hashlib.sha256((salt + value).encode()).hexdigest()


class SecurityManager:
    """Session + token + auth-code state for one server instance."""

    def __init__(self, settings, clock=time.time):
        ws = settings.webserver
        self.settings = settings
        self.clock = clock
        self.enabled = bool(
            ws.password or ws.auth_token or ws.oauth_client_secret
            or getattr(ws, "oidc_client_secret", None)
            or getattr(ws, "github_client_secret", None))
        self._salt = "birdnet-go-tpu.v1"
        # sessions: sid -> {expires, csrf}
        self._sessions: dict[str, dict] = {}
        # auth codes: code -> {expires, client_id}
        self._codes: dict[str, dict] = {}
        # access tokens: digest -> {expires, subject}
        self._tokens: dict[str, dict] = {}
        self._token_file = Path(ws.token_file)
        self._load_tokens()

    # -- persistence --------------------------------------------------------------

    def _load_tokens(self) -> None:
        try:
            raw = json.loads(self._token_file.read_text())
            now = self.clock()
            self._tokens = {k: v for k, v in raw.items()
                            if v.get("expires", 0) > now}
        except (OSError, ValueError):
            self._tokens = {}

    def _save_tokens(self) -> None:
        try:
            self._token_file.parent.mkdir(parents=True, exist_ok=True)
            tmp = self._token_file.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._tokens))
            tmp.rename(self._token_file)        # atomic (reference pattern)
        except OSError:
            log.exception("token persistence failed")

    # -- sessions (basic-auth login) -----------------------------------------------

    def check_password(self, password: str) -> bool:
        configured = self.settings.webserver.password
        return bool(configured) and hmac.compare_digest(
            password.encode(), configured.encode())

    def create_session(self) -> tuple[str, str]:
        sid = secrets.token_urlsafe(32)
        csrf = secrets.token_urlsafe(24)
        self._sessions[sid] = {
            "expires": self.clock()
            + self.settings.webserver.session_hours * 3600.0,
            "csrf": csrf,
        }
        return sid, csrf

    def session(self, sid: str | None) -> dict | None:
        if not sid:
            return None
        s = self._sessions.get(sid)
        if s is None or s["expires"] < self.clock():
            self._sessions.pop(sid, None)
            return None
        return s

    def drop_session(self, sid: str | None) -> None:
        if sid:
            self._sessions.pop(sid, None)

    # -- OAuth2 --------------------------------------------------------------------

    def issue_auth_code(self, client_id: str) -> str:
        code = secrets.token_urlsafe(24)
        self._codes[code] = {"expires": self.clock() + AUTH_CODE_TTL,
                             "client_id": client_id}
        return code

    def exchange_code(self, code: str, client_id: str) -> str | None:
        entry = self._codes.pop(code, None)
        if entry is None or entry["expires"] < self.clock() \
                or entry["client_id"] != client_id:
            return None
        return self.issue_token(subject=f"oauth:{client_id}")

    def client_credentials(self, client_id: str, client_secret: str
                           ) -> str | None:
        ws = self.settings.webserver
        if not ws.oauth_client_secret:
            return None
        if client_id != ws.oauth_client_id or not hmac.compare_digest(
                client_secret.encode(), ws.oauth_client_secret.encode()):
            return None
        return self.issue_token(subject=f"client:{client_id}")

    def issue_token(self, subject: str, ttl_hours: float | None = None
                    ) -> str:
        token = secrets.token_urlsafe(32)
        ttl = (ttl_hours or self.settings.webserver.session_hours) * 3600.0
        self._tokens[_digest(token, self._salt)] = {
            "expires": self.clock() + ttl, "subject": subject}
        self._save_tokens()
        return token

    def check_token(self, token: str) -> bool:
        static = self.settings.webserver.auth_token
        if static and hmac.compare_digest(token.encode(), static.encode()):
            return True
        entry = self._tokens.get(_digest(token, self._salt))
        if entry is None:
            return False
        if entry["expires"] < self.clock():
            self._tokens.pop(_digest(token, self._salt), None)
            self._save_tokens()
            return False
        return True

    def revoke_token(self, token: str) -> bool:
        removed = self._tokens.pop(_digest(token, self._salt), None)
        if removed is not None:
            self._save_tokens()
        return removed is not None


def _is_public(path: str) -> bool:
    return path in PUBLIC_PATHS or path == "/" \
        or any(path.startswith(p) for p in PUBLIC_PREFIXES)


def security_middleware(manager: SecurityManager,
                        allow_local_bypass: bool = True):
    """Authn + CSRF middleware. When no credential is configured at all the
    server stays open (reference: security disabled ⇒ binary authz allows)."""
    ws = manager.settings.webserver
    cf_verifier = None
    if getattr(ws, "cloudflare_bypass_enabled", False) \
            and getattr(ws, "cloudflare_team_domain", ""):
        from birdnet_go_tpu_torch.api.cloudflare import (
            CloudflareAccessVerifier,
        )

        cf_verifier = CloudflareAccessVerifier(
            ws.cloudflare_team_domain,
            audience=getattr(ws, "cloudflare_audience", ""))

    @web.middleware
    async def middleware(request, handler):
        if not manager.enabled or _is_public(request.path):
            return await handler(request)

        # Cloudflare Access bypass: a tunnel-delivered request whose JWT
        # validates (team JWKS, issuer, expiry, optional audience) is
        # trusted (doc/wiki/security.md)
        if cf_verifier is not None:
            from birdnet_go_tpu_torch.api.cloudflare import JWT_HEADER

            cf_token = request.headers.get(JWT_HEADER)
            if cf_token:
                import asyncio as _aio

                # verification may fetch the JWKS (blocking httpx) — keep
                # it off the event loop like the OIDC/GitHub callbacks
                claims = await _aio.get_event_loop().run_in_executor(
                    None, cf_verifier.verify, cf_token)
                if claims is not None:
                    return await handler(request)

        # direct local connections may bypass (never when proxied)
        proxied = ("X-Forwarded-For" in request.headers
                   or "X-Real-IP" in request.headers
                   or "Forwarded" in request.headers)
        if allow_local_bypass and not proxied and request.remote \
                and is_local_address(
                    request.remote,
                    getattr(manager.settings.webserver,
                            "bypass_subnets", None)):
            return await handler(request)

        # bearer token (static or issued) — CSRF-exempt
        header = request.headers.get("Authorization", "")
        if header.startswith("Bearer "):
            if manager.check_token(header[7:].strip()):
                return await handler(request)
            return web.json_response({"error": "invalid token"}, status=401)
        # ?token= for EventSource clients that can't set headers
        qtok = request.query.get("token")
        if qtok and manager.check_token(qtok):
            return await handler(request)

        # HTTP Basic (any username; the reference's basic auth is
        # password-only as well)
        if header.startswith("Basic "):
            import base64

            try:
                decoded = base64.b64decode(header[6:]).decode()
                _, _, password = decoded.partition(":")
            except Exception:
                password = ""
            if manager.check_password(password):
                return await handler(request)
            return web.json_response({"error": "invalid credentials"},
                                     status=401)

        # session cookie (+ CSRF for mutations)
        session = manager.session(request.cookies.get(SESSION_COOKIE))
        if session is not None:
            if request.method in ("POST", "PUT", "PATCH", "DELETE"):
                supplied = request.headers.get("X-CSRF-Token", "")
                if not hmac.compare_digest(supplied.encode(),
                                           session["csrf"].encode()):
                    return web.json_response({"error": "CSRF token missing"},
                                             status=403)
            return await handler(request)

        return web.json_response({"error": "unauthorized"}, status=401)

    return middleware


@web.middleware
async def http_metrics_middleware(request, handler):
    """Per-request Prometheus metrics (reference: observability http
    domain): count + latency by method/status, with the path template
    (not the raw path — label cardinality stays bounded)."""
    import time as _t

    from birdnet_go_tpu_torch.utils.metrics import REGISTRY

    t0 = _t.monotonic()
    status = 500          # BaseException (e.g. CancelledError) reaches
    try:                  # finally without hitting an except clause
        resp = await handler(request)
        status = resp.status
        return resp
    except web.HTTPException as e:
        status = e.status
        raise
    except Exception:
        status = 500
        raise
    finally:
        route = request.match_info.route
        tmpl = getattr(getattr(route, "resource", None),
                       "canonical", None) or "unmatched"
        labels = {"method": request.method, "route": tmpl,
                  "status": str(status)}
        REGISTRY.counter("http_requests_total",
                         "HTTP requests").inc(labels=labels)
        REGISTRY.histogram(
            "http_request_duration_seconds",
            "HTTP request latency").observe(
                _t.monotonic() - t0,
                labels={"method": request.method, "route": tmpl})


@web.middleware
async def secure_headers_middleware(request, handler):
    """Baseline secure headers (reference: Echo secure middleware)."""
    resp = await handler(request)
    h = resp.headers
    h.setdefault("X-Content-Type-Options", "nosniff")
    h.setdefault("X-Frame-Options", "SAMEORIGIN")
    h.setdefault("Referrer-Policy", "no-referrer")
    h.setdefault("Permissions-Policy", "geolocation=(), microphone=()")
    return resp


@web.middleware
async def gzip_middleware(request, handler):
    """Compress large compressible bodies when the client accepts gzip."""
    resp = await handler(request)
    if not isinstance(resp, web.Response) or resp.body is None:
        return resp
    if "gzip" not in request.headers.get("Accept-Encoding", ""):
        return resp
    ctype = resp.content_type or ""
    if resp.headers.get("Content-Encoding"):
        return resp
    if len(resp.body) < 1024 or not (
            ctype.startswith("text/") or "json" in ctype
            or "javascript" in ctype or "svg" in ctype):
        return resp
    import gzip as _gz

    resp.body = _gz.compress(bytes(resp.body), 6)
    resp.headers["Content-Encoding"] = "gzip"
    resp.headers["Vary"] = "Accept-Encoding"
    return resp


class AuthHandlers:
    """Mixin: login/logout/status + OAuth2 endpoints (routes registered by
    ApiServer.build_app when a SecurityManager exists)."""

    security: SecurityManager | None

    def register_auth_routes(self, r, v2: str) -> None:
        r.add_post(f"{v2}/auth/login", self.h_auth_login)
        r.add_post(f"{v2}/auth/logout", self.h_auth_logout)
        r.add_get(f"{v2}/auth/status", self.h_auth_status)
        r.add_get(f"{v2}/oauth2/authorize", self.h_oauth_authorize)
        r.add_post(f"{v2}/oauth2/token", self.h_oauth_token)
        r.add_post(f"{v2}/auth/tokens", self.h_token_create)
        r.add_delete(f"{v2}/auth/tokens", self.h_token_revoke)
        r.add_get(f"{v2}/auth/oidc/login", self.h_oidc_login)
        r.add_get(f"{v2}/auth/oidc/callback", self.h_oidc_callback)
        r.add_get(f"{v2}/auth/github/login", self.h_github_login)
        r.add_get(f"{v2}/auth/github/callback", self.h_github_callback)
        r.add_get("/login", self.h_login_page)

    # -- GitHub social auth (reference: goth GitHub provider) ---------------------

    _github = None

    def _github_client(self):
        if self._github is not None:
            return self._github
        ws = self.ctx.settings.webserver
        if not getattr(ws, "github_client_id", "") \
                or not getattr(ws, "github_client_secret", None):
            return None
        from birdnet_go_tpu_torch.api.github_auth import GithubClient

        base = getattr(ws, "base_url", "") or ""
        redirect = (base.rstrip("/")
                    + "/api/v2/auth/github/callback") if base \
            else f"http://{ws.host}:{ws.port}/api/v2/auth/github/callback"
        self._github = GithubClient(
            ws.github_client_id, ws.github_client_secret, redirect,
            allowed=getattr(ws, "github_allowed", []))
        return self._github

    async def h_github_login(self, request):
        client = self._github_client()
        if client is None:
            return web.json_response({"error": "GitHub auth not configured"},
                                     status=404)
        _, url = client.begin()
        raise web.HTTPFound(url)

    async def h_github_callback(self, request):
        client = self._github_client()
        sec = self.security
        if client is None or sec is None:
            return web.json_response({"error": "GitHub auth not configured"},
                                     status=404)
        if err := request.query.get("error"):
            return web.json_response({"error": f"provider: {err}"},
                                     status=401)
        import asyncio as _aio

        from birdnet_go_tpu_torch.api.github_auth import GithubAuthError

        try:
            who = await _aio.get_event_loop().run_in_executor(
                None, client.complete, request.query.get("state", ""),
                request.query.get("code", ""))
        except GithubAuthError as e:
            return web.json_response({"error": str(e)}, status=401)
        sid, _csrf = sec.create_session()
        log.info("GitHub login: %s", who.get("email") or who.get("login"))
        resp = web.HTTPFound("/")
        resp.set_cookie(SESSION_COOKIE, sid, httponly=True,
                        samesite="Lax",
                        max_age=int(sec.settings.webserver.session_hours
                                    * 3600))
        raise resp

    # -- OIDC / SSO (reference: social + OIDC login) ------------------------------

    _oidc = None

    def _oidc_client(self):
        """Lazy relying-party client from webserver.oidc_* settings."""
        if self._oidc is not None:
            return self._oidc
        ws = self.ctx.settings.webserver
        issuer = getattr(ws, "oidc_issuer", "")
        if not issuer:
            return None
        from birdnet_go_tpu_torch.api.oidc import OidcClient

        base = (ws.base_url.rstrip("/")
                or f"http://{ws.host}:{ws.port}")
        self._oidc = OidcClient(
            issuer=issuer,
            client_id=getattr(ws, "oidc_client_id", ""),
            client_secret=getattr(ws, "oidc_client_secret", "") or "",
            redirect_uri=f"{base}/api/v2/auth/oidc/callback",
            allowed=getattr(ws, "oidc_allowed", []) or [])
        return self._oidc

    async def h_oidc_login(self, request):
        """Kick off the authorization-code flow: 302 to the provider."""
        client = self._oidc_client()
        if client is None:
            return web.json_response({"error": "OIDC not configured"},
                                     status=404)
        import asyncio as _aio

        try:
            _, url = await _aio.get_event_loop().run_in_executor(
                None, client.begin)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=502)
        raise web.HTTPFound(url)

    async def h_oidc_callback(self, request):
        """Provider redirect target: verify + allowlist → session cookie."""
        client = self._oidc_client()
        sec = self.security
        if client is None or sec is None:
            return web.json_response({"error": "OIDC not configured"},
                                     status=404)
        state = request.query.get("state", "")
        code = request.query.get("code", "")
        if err := request.query.get("error"):
            return web.json_response({"error": f"provider: {err}"},
                                     status=401)
        import asyncio as _aio

        from birdnet_go_tpu_torch.api.oidc import OidcError

        try:
            claims = await _aio.get_event_loop().run_in_executor(
                None, client.complete, state, code)
        except OidcError as e:
            return web.json_response({"error": str(e)}, status=401)
        sid, _csrf = sec.create_session()
        log.info("OIDC login: %s", claims.get("email") or claims.get("sub"))
        resp = web.HTTPFound("/")
        resp.set_cookie(SESSION_COOKIE, sid, httponly=True,
                        samesite="Lax",
                        max_age=int(sec.settings.webserver.session_hours
                                    * 3600))
        raise resp

    async def h_auth_login(self, request):
        sec = self.security
        body = await request.json()
        if sec is None or not sec.check_password(body.get("password", "")):
            return web.json_response({"error": "invalid credentials"},
                                     status=401)
        sid, csrf = sec.create_session()
        resp = web.json_response({"authenticated": True, "csrf": csrf})
        resp.set_cookie(SESSION_COOKIE, sid, httponly=True,
                        samesite="Lax",
                        max_age=int(sec.settings.webserver.session_hours
                                    * 3600))
        return resp

    async def h_auth_logout(self, request):
        if self.security is not None:
            self.security.drop_session(request.cookies.get(SESSION_COOKIE))
        resp = web.json_response({"authenticated": False})
        resp.del_cookie(SESSION_COOKIE)
        return resp

    async def h_auth_status(self, request):
        sec = self.security
        if sec is None or not sec.enabled:
            return web.json_response({"security_enabled": False,
                                      "authenticated": True})
        session = sec.session(request.cookies.get(SESSION_COOKIE))
        header = request.headers.get("Authorization", "")
        by_token = header.startswith("Bearer ") \
            and sec.check_token(header[7:].strip())
        out = {
            "security_enabled": True,
            "authenticated": bool(session) or by_token,
            "method": "session" if session else
                      ("token" if by_token else None),
        }
        if session:
            # deliver the session's CSRF token to same-origin JS — OIDC/SSO
            # logins arrive via redirect and never pass through the password
            # login page that seeds sessionStorage (the cookie is httponly,
            # so this endpoint is the only way the SPA can learn it)
            out["csrf"] = session.get("csrf", "")
        return web.json_response(out)

    async def h_oauth_authorize(self, request):
        """Authorization-code grant step 1 (requires authenticated caller —
        the security middleware has already enforced that)."""
        sec = self.security
        client_id = request.query.get("client_id", "")
        if sec is None or client_id != \
                sec.settings.webserver.oauth_client_id:
            return web.json_response({"error": "unknown client"},
                                     status=400)
        redirect = request.query.get("redirect_uri")
        if redirect and redirect not in \
                sec.settings.webserver.oauth_redirect_uris:
            # never bounce an auth code to an unregistered target — codes
            # exchange into bearer tokens (open-redirect exfiltration)
            return web.json_response(
                {"error": "redirect_uri not registered"}, status=400)
        code = sec.issue_auth_code(client_id)
        if redirect:
            sep = "&" if "?" in redirect else "?"
            raise web.HTTPFound(f"{redirect}{sep}code={code}")
        return web.json_response({"code": code,
                                  "expires_in": int(AUTH_CODE_TTL)})

    async def h_oauth_token(self, request):
        sec = self.security
        if sec is None:
            return web.json_response({"error": "security disabled"},
                                     status=400)
        if request.content_type == "application/json":
            body = await request.json()
        else:
            body = dict(await request.post())
        grant = body.get("grant_type", "")
        if grant == "authorization_code":
            token = sec.exchange_code(body.get("code", ""),
                                      body.get("client_id", ""))
        elif grant == "client_credentials":
            token = sec.client_credentials(body.get("client_id", ""),
                                           body.get("client_secret", ""))
        else:
            return web.json_response(
                {"error": "unsupported_grant_type"}, status=400)
        if token is None:
            return web.json_response({"error": "invalid_grant"}, status=401)
        return web.json_response({
            "access_token": token, "token_type": "Bearer",
            "expires_in": int(sec.settings.webserver.session_hours * 3600),
        })

    async def h_token_create(self, request):
        """Issue a personal bearer token from an authenticated session."""
        sec = self.security
        if sec is None:
            return web.json_response({"error": "security disabled"},
                                     status=400)
        body = await request.json() if request.can_read_body else {}
        token = sec.issue_token(
            subject=body.get("name", "api"),
            ttl_hours=float(body.get("ttl_hours",
                                     sec.settings.webserver.session_hours)))
        return web.json_response({"token": token})

    async def h_token_revoke(self, request):
        sec = self.security
        body = await request.json()
        if sec is None or not sec.revoke_token(body.get("token", "")):
            return web.json_response({"error": "unknown token"}, status=404)
        return web.json_response({"revoked": True})

    async def h_login_page(self, request):
        page = _LOGIN_PAGE
        if getattr(self.ctx.settings.webserver, "oidc_issuer", ""):
            page = page.replace(
                "<p class=\"err\" id=\"err\"></p>",
                "<p class=\"err\" id=\"err\"></p>"
                "<a href=\"/api/v2/auth/oidc/login\" "
                "style=\"display:block;text-align:center;margin-top:.6rem;"
                "color:#7dd3fc\">Sign in with SSO</a>")
        return web.Response(text=page, content_type="text/html")


_LOGIN_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>BirdNET-TPU — Sign in</title>
<style>
body{font-family:system-ui,sans-serif;display:flex;align-items:center;
justify-content:center;height:100vh;margin:0;background:#0f172a;color:#e2e8f0}
form{background:#1e293b;padding:2rem;border-radius:12px;width:300px}
h1{font-size:1.1rem;margin:0 0 1rem}
input,button{width:100%;padding:.6rem;margin:.3rem 0;border-radius:8px;
border:1px solid #334155;background:#0f172a;color:#e2e8f0;box-sizing:border-box}
button{background:#0ea5e9;border:none;color:#fff;cursor:pointer}
p.err{color:#f87171;min-height:1em;font-size:.85rem}
</style></head><body>
<form id="f"><h1>BirdNET&#8209;TPU</h1>
<input type="password" id="pw" placeholder="Password" autofocus>
<button>Sign in</button><p class="err" id="err"></p></form>
<script>
document.getElementById('f').addEventListener('submit', async (e) => {
  e.preventDefault();
  const r = await fetch('/api/v2/auth/login', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({password: document.getElementById('pw').value})});
  if (r.ok) { const j = await r.json();
    sessionStorage.setItem('csrf', j.csrf); location.href = '/ui'; }
  else document.getElementById('err').textContent = 'Invalid password';
});
</script></body></html>
"""
