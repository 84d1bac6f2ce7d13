"""Cloudflare Access authentication bypass.

Reference: internal/security Cloudflare bypass (doc/wiki/security.md
"Cloudflare Access Authentication Bypass"): requests arriving through a
Cloudflare tunnel carry a `Cf-Access-Jwt-Assertion` JWT; when the bypass
is enabled the request is trusted iff the token verifies against the
team's JWKS (RS256), is unexpired, was issued by the team domain, and —
when configured — carries the expected policy audience.

A copy of ``birdnet_go_tpu/api/cloudflare.py`` for the port, which
imports nothing of the JAX package (``jwk_to_rsa_key`` and
``_b64url_decode`` come from the port's ``api/oidc.py``);
``tests/test_torch_logins.py`` holds it to the original. Its JWKS comes
over the port's ``shared_client()`` (``utils/httpclient.py``, over
urllib), where JAX's comes over httpx.
"""

from __future__ import annotations

import json
import logging
import time

from birdnet_go_tpu_torch.api.oidc import _b64url_decode as _b64url
from birdnet_go_tpu_torch.api.oidc import jwk_to_rsa_key

log = logging.getLogger("birdnet_tpu.cloudflare")

JWT_HEADER = "Cf-Access-Jwt-Assertion"
_CERTS_TTL = 3600.0


class CloudflareAccessVerifier:
    """Validates Cloudflare Access JWTs against the team's JWKS."""

    def __init__(self, team_domain: str, audience: str = "",
                 session=None, clock=time.time):
        self.team_domain = (team_domain.strip()
                            .removeprefix("https://").rstrip("/"))
        self.audience = audience
        self.clock = clock
        self._session = session
        self._keys: dict[str, object] = {}
        self._fetched_at = 0.0
        # kids that failed to resolve after a refresh: do NOT refetch the
        # JWKS again for them inside the TTL (self-minted random-kid
        # tokens would otherwise drive one outbound fetch per request)
        self._bad_kids: set[str] = set()

    @property
    def issuer(self) -> str:
        return f"https://{self.team_domain}"

    def _jwks_url(self) -> str:
        return f"https://{self.team_domain}/cdn-cgi/access/certs"

    def _refresh_keys(self) -> None:
        # TTL on the FETCH TIME (an empty key set must not refetch per
        # call — a misconfigured team domain would hammer the endpoint)
        if self._fetched_at and self.clock() - self._fetched_at < _CERTS_TTL:
            return
        if self._session is None:
            from birdnet_go_tpu_torch.utils.httpclient import shared_client

            self._session = shared_client()
        resp = self._session.get(self._jwks_url())
        resp.raise_for_status()
        keys = {}
        for jwk in resp.json().get("keys", []):
            if jwk.get("kty") != "RSA":
                continue
            keys[jwk.get("kid", "")] = jwk_to_rsa_key(jwk)
        self._keys = keys
        self._bad_kids.clear()
        self._fetched_at = self.clock()

    def verify(self, token: str) -> dict | None:
        """Claims dict when the token is valid; None otherwise."""
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url(header_b64))
            claims = json.loads(_b64url(payload_b64))
            if header.get("alg") != "RS256":
                return None
            self._refresh_keys()
            kid = header.get("kid", "")
            key = self._keys.get(kid)
            if key is None and kid not in self._bad_kids:
                # key rotation: one forced refresh per unknown kid, then
                # negative-cache it until the next scheduled refresh
                self._fetched_at = 0.0
                self._refresh_keys()
                key = self._keys.get(kid)
                if key is None:
                    self._bad_kids.add(kid)
            if key is None:
                return None
            from cryptography.hazmat.primitives import hashes
            from cryptography.hazmat.primitives.asymmetric import padding

            key.verify(_b64url(sig_b64),
                       f"{header_b64}.{payload_b64}".encode(),
                       padding.PKCS1v15(), hashes.SHA256())
            now = self.clock()
            if claims.get("exp", 0) < now:
                return None
            if claims.get("iss") != self.issuer:
                return None
            if self.audience:
                aud = claims.get("aud", [])
                if isinstance(aud, str):
                    aud = [aud]
                if self.audience not in aud:
                    return None
            return claims
        except Exception:
            log.debug("cloudflare access token rejected", exc_info=True)
            return None
