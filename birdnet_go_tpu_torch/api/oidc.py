"""OIDC / SSO login (reference: internal/security social + OIDC flows,
ARCHITECTURE.md:1896-2180 — Google/GitHub via goth plus generic OIDC).

One generic OpenID Connect relying party covers all of them: discovery
document → authorization-code redirect → token exchange → RS256 id_token
verification against the provider's JWKS → email/domain allowlist →
normal session cookie (the same session machinery as password login).

No external OIDC library: JWS verification uses `cryptography` directly,
and the two HTTP calls (discovery/JWKS fetch, code exchange) go through
the shared pooled HTTP client so tests can inject a fake IdP.

A copy of ``birdnet_go_tpu/api/oidc.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_logins.py`` holds it to
the original. Its default transport is the port's ``HttpClient``
(``utils/httpclient.py``, over urllib), where JAX's is over httpx.
"""

from __future__ import annotations

import base64
import json
import logging
import secrets
import time
from typing import Any

log = logging.getLogger("birdnet_tpu.oidc")

STATE_TTL = 600.0          # seconds a login attempt may take


def jwk_to_rsa_key(jwk: dict):
    """RSA public key from a JWK dict (shared by the OIDC and Cloudflare
    Access validators — one JWT key-construction path)."""
    from cryptography.hazmat.primitives.asymmetric.rsa import (
        RSAPublicNumbers,
    )

    n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
    e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
    return RSAPublicNumbers(e, n).public_key()


def _b64url_decode(s: str | bytes) -> bytes:
    if isinstance(s, str):
        s = s.encode()
    return base64.urlsafe_b64decode(s + b"=" * (-len(s) % 4))


class OidcError(Exception):
    pass


class OidcClient:
    """Relying-party side of the authorization-code flow."""

    def __init__(self, issuer: str, client_id: str, client_secret: str,
                 redirect_uri: str, allowed: list[str] | None = None,
                 http=None, clock=time.time):
        from birdnet_go_tpu_torch.utils.httpclient import HttpClient

        self.issuer = issuer.rstrip("/")
        self.client_id = client_id
        self.client_secret = client_secret
        self.redirect_uri = redirect_uri
        # allowlist entries: full emails or "@domain.tld"; empty = any
        # authenticated subject
        self.allowed = [a.lower() for a in (allowed or [])]
        self.http = http or HttpClient(timeout=15.0)
        self.clock = clock
        self._discovery: dict | None = None
        self._jwks: dict | None = None
        # state → {nonce, expires}; pruned on use
        self._pending: dict[str, dict] = {}

    # -- provider metadata -------------------------------------------------------

    def discovery(self) -> dict:
        if self._discovery is None:
            url = self.issuer + "/.well-known/openid-configuration"
            resp = self.http.get(url)
            if resp.status_code != 200:
                raise OidcError(f"discovery failed: HTTP {resp.status_code}")
            doc = resp.json()
            for key in ("authorization_endpoint", "token_endpoint",
                        "jwks_uri", "issuer"):
                if key not in doc:
                    raise OidcError(f"discovery missing {key}")
            self._discovery = doc
        return self._discovery

    def jwks(self, refresh: bool = False) -> dict:
        if self._jwks is None or refresh:
            resp = self.http.get(self.discovery()["jwks_uri"])
            if resp.status_code != 200:
                raise OidcError(f"jwks fetch failed: {resp.status_code}")
            self._jwks = resp.json()
        return self._jwks

    # -- flow --------------------------------------------------------------------

    def begin(self) -> tuple[str, str]:
        """Start a login: returns (state, authorization URL)."""
        from urllib.parse import urlencode

        state = secrets.token_urlsafe(24)
        nonce = secrets.token_urlsafe(24)
        now = self.clock()
        self._pending = {k: v for k, v in self._pending.items()
                         if v["expires"] > now}        # prune stale
        self._pending[state] = {"nonce": nonce, "expires": now + STATE_TTL}
        q = urlencode({
            "response_type": "code",
            "client_id": self.client_id,
            "redirect_uri": self.redirect_uri,
            "scope": "openid email profile",
            "state": state,
            "nonce": nonce,
        })
        return state, f"{self.discovery()['authorization_endpoint']}?{q}"

    def complete(self, state: str, code: str) -> dict[str, Any]:
        """Callback half: state check → code exchange → id_token verify →
        allowlist. Returns the verified claims."""
        pend = self._pending.pop(state, None)
        if pend is None or pend["expires"] < self.clock():
            raise OidcError("unknown or expired state")
        resp = self.http.post(
            self.discovery()["token_endpoint"],
            data={"grant_type": "authorization_code", "code": code,
                  "redirect_uri": self.redirect_uri,
                  "client_id": self.client_id,
                  "client_secret": self.client_secret})
        if resp.status_code != 200:
            raise OidcError(f"token exchange failed: {resp.status_code}")
        body = resp.json()
        raw = body.get("id_token")
        if not raw:
            raise OidcError("no id_token in token response")
        claims = self.verify_id_token(raw, nonce=pend["nonce"])
        if not self.authorize(claims):
            raise OidcError(
                f"subject {claims.get('email') or claims.get('sub')!r}"
                " not in the allowlist")
        return claims

    # -- id_token (JWS RS256) ------------------------------------------------------

    def verify_id_token(self, raw: str, nonce: str | None = None) -> dict:
        try:
            h64, p64, s64 = raw.split(".")
        except ValueError as e:
            raise OidcError("malformed id_token") from e
        header = json.loads(_b64url_decode(h64))
        if header.get("alg") != "RS256":
            raise OidcError(f"unsupported alg {header.get('alg')!r}")
        sig = _b64url_decode(s64)
        signing_input = f"{h64}.{p64}".encode()
        key = self._rsa_key(header.get("kid"))
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding

        try:
            key.verify(sig, signing_input, padding.PKCS1v15(),
                       hashes.SHA256())
        except InvalidSignature as e:
            raise OidcError("id_token signature invalid") from e
        claims = json.loads(_b64url_decode(p64))
        if claims.get("iss", "").rstrip("/") != self.issuer:
            raise OidcError(f"issuer mismatch: {claims.get('iss')!r}")
        aud = claims.get("aud")
        if (aud != self.client_id
                and not (isinstance(aud, list) and self.client_id in aud)):
            raise OidcError("audience mismatch")
        if claims.get("exp", 0) < self.clock():
            raise OidcError("id_token expired")
        if nonce is not None and claims.get("nonce") != nonce:
            raise OidcError("nonce mismatch")
        return claims

    def _rsa_key(self, kid: str | None):
        for refresh in (False, True):     # key rotation: one refetch
            for jwk in self.jwks(refresh=refresh).get("keys", []):
                if jwk.get("kty") != "RSA":
                    continue
                if kid is not None and jwk.get("kid") != kid:
                    continue
                return jwk_to_rsa_key(jwk)
        raise OidcError(f"no RSA key {kid!r} in provider JWKS")

    # -- authorization ----------------------------------------------------------

    def authorize(self, claims: dict) -> bool:
        """Binary authz like the reference (no RBAC): the allowlist holds
        emails or @domains; empty list = any verified subject."""
        if not self.allowed:
            return True
        email = str(claims.get("email", "")).lower()
        if not email:
            return False
        if email in self.allowed:
            return True
        domain = "@" + email.split("@", 1)[-1]
        return domain in self.allowed
