"""Auto-TLS: a from-scratch RFC 8555 (ACME) client with HTTP-01.

Reference: the Go server's AutoTLS mode (internal/api/server.go:601-633,
golang.org/x/crypto/acme/autocert + Echo's AutoTLSManager, cert cache in
`tls-acme/`, validated against a Pebble container in
autotls_pebble_test.go). Same stance as the wire-level MySQL/MQTT
clients: no external ACME dependency — JWS (ES256), account/order/
challenge/finalize/download implemented directly on the pooled HTTP
client, certificates cached on disk so they survive restarts, and an
in-process Pebble-analogue server drives the test suite.

Production setup: `webserver.tls_enabled: true`, `tls_mode: "acme"`,
`acme_domain: "birds.example.com"` — the HTTP-01 token is served by the
API server at /.well-known/acme-challenge/<token> (port 80 must reach
this host, per ACME).

A copy of ``birdnet_go_tpu/utils/acme.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_tls.py`` runs both
clients against the same RFC 8555 server. Where it differs: the default
transport is ``utils/httpclient.py``'s ``UrllibSession(timeout=30.0,
verify=verify_tls)``, where JAX builds ``httpx.Client(timeout=30.0,
verify=verify_tls)`` (the card's machine has no httpx).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import logging
import threading
import time
from pathlib import Path

log = logging.getLogger("birdnet_tpu.acme")

LETS_ENCRYPT = "https://acme-v02.api.letsencrypt.org/directory"
RENEW_BEFORE_DAYS = 30


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).decode().rstrip("=")


def _b64json(obj) -> str:
    return _b64(json.dumps(obj, separators=(",", ":")).encode())


class Http01Responder:
    """token → key-authorization store the API server reads when ACME
    validation fetches /.well-known/acme-challenge/<token>."""

    def __init__(self):
        self._tokens: dict[str, str] = {}
        self._lock = threading.Lock()

    def set(self, token: str, key_auth: str) -> None:
        with self._lock:
            self._tokens[token] = key_auth

    def get(self, token: str) -> str | None:
        with self._lock:
            return self._tokens.get(token)

    def clear(self, token: str) -> None:
        with self._lock:
            self._tokens.pop(token, None)


# one process-wide responder: the server route and any client share it
GLOBAL_RESPONDER = Http01Responder()


class AcmeError(Exception):
    pass


class AcmeClient:
    """Minimal ACME v2 account + order flow (ES256 JWS, HTTP-01)."""

    def __init__(self, directory_url: str, cache_dir: str | Path,
                 contact: str | None = None, http=None,
                 verify_tls: bool | str = True):
        from birdnet_go_tpu_torch.utils.httpclient import UrllibSession

        self.directory_url = directory_url
        self.cache = Path(cache_dir)
        self.cache.mkdir(parents=True, exist_ok=True)
        self.contact = contact
        self.http = http or UrllibSession(timeout=30.0, verify=verify_tls)
        self._nonce: str | None = None
        self._kid: str | None = None
        self._dir: dict | None = None
        self._key = self._load_or_create_account_key()

    # -- keys / JWS ---------------------------------------------------------------

    def _load_or_create_account_key(self):
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import ec

        path = self.cache / "account.key"
        if path.is_file():
            return serialization.load_pem_private_key(path.read_bytes(),
                                                      password=None)
        key = ec.generate_private_key(ec.SECP256R1())
        path.write_bytes(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
        path.chmod(0o600)
        return key

    def _jwk(self) -> dict:
        nums = self._key.public_key().public_numbers()
        return {"crv": "P-256", "kty": "EC",
                "x": _b64(nums.x.to_bytes(32, "big")),
                "y": _b64(nums.y.to_bytes(32, "big"))}

    def thumbprint(self) -> str:
        """RFC 7638 JWK thumbprint (key-authorization suffix)."""
        canon = json.dumps(self._jwk(), separators=(",", ":"),
                           sort_keys=True).encode()
        return _b64(hashlib.sha256(canon).digest())

    def _sign(self, protected: str, payload: str) -> str:
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec, utils

        der = self._key.sign(f"{protected}.{payload}".encode(),
                             ec.ECDSA(hashes.SHA256()))
        r, s = utils.decode_dss_signature(der)
        return _b64(r.to_bytes(32, "big") + s.to_bytes(32, "big"))

    # -- transport ---------------------------------------------------------------

    def _directory(self) -> dict:
        if self._dir is None:
            r = self.http.get(self.directory_url)
            r.raise_for_status()
            self._dir = r.json()
        return self._dir

    def _fresh_nonce(self) -> str:
        if self._nonce:
            n, self._nonce = self._nonce, None
            return n
        r = self.http.head(self._directory()["newNonce"])
        return r.headers["Replay-Nonce"]

    def _post(self, url: str, payload, use_kid: bool = True):
        """Signed POST (POST-as-GET when payload is None); one badNonce
        retry per RFC 8555 §6.5."""
        for attempt in (0, 1):
            protected = {"alg": "ES256", "nonce": self._fresh_nonce(),
                         "url": url}
            if use_kid and self._kid:
                protected["kid"] = self._kid
            else:
                protected["jwk"] = self._jwk()
            p64 = _b64json(protected)
            body64 = "" if payload is None else _b64json(payload)
            jws = {"protected": p64, "payload": body64,
                   "signature": self._sign(p64, body64)}
            r = self.http.post(url, json=jws,
                               headers={"Content-Type":
                                        "application/jose+json"})
            self._nonce = r.headers.get("Replay-Nonce")
            if r.status_code == 400 and attempt == 0 \
                    and b"badNonce" in r.content:
                continue
            if r.status_code >= 400:
                raise AcmeError(f"{url}: {r.status_code} {r.text[:200]}")
            return r
        raise AcmeError("nonce retry exhausted")

    # -- flow --------------------------------------------------------------------

    def register(self) -> str:
        payload = {"termsOfServiceAgreed": True}
        if self.contact:
            payload["contact"] = [f"mailto:{self.contact}"]
        r = self._post(self._directory()["newAccount"], payload,
                       use_kid=False)
        self._kid = r.headers["Location"]
        return self._kid

    def obtain(self, domain: str,
               responder: Http01Responder | None = None,
               poll_interval: float = 0.5, timeout: float = 60.0
               ) -> tuple[str, str]:
        """Run a full order → (certificate chain PEM, private key PEM)."""
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        responder = responder or GLOBAL_RESPONDER
        if self._kid is None:
            self.register()
        r = self._post(self._directory()["newOrder"],
                       {"identifiers": [{"type": "dns", "value": domain}]})
        order = r.json()
        order_url = r.headers["Location"]

        token = None
        for authz_url in order["authorizations"]:
            authz = self._post(authz_url, None).json()
            chall = next(c for c in authz["challenges"]
                         if c["type"] == "http-01")
            token = chall["token"]
            key_auth = f"{token}.{self.thumbprint()}"
            responder.set(token, key_auth)
            self._post(chall["url"], {})          # "ready for validation"
            deadline = time.monotonic() + timeout
            while True:
                status = self._post(authz_url, None).json()["status"]
                if status == "valid":
                    break
                if status in ("invalid", "revoked", "deactivated"):
                    raise AcmeError(f"authorization {status} for {domain}")
                if time.monotonic() > deadline:
                    raise AcmeError("authorization poll timeout")
                time.sleep(poll_interval)

        cert_key = ec.generate_private_key(ec.SECP256R1())
        csr = x509.CertificateSigningRequestBuilder().subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, domain)])
        ).add_extension(
            x509.SubjectAlternativeName([x509.DNSName(domain)]),
            critical=False,
        ).sign(cert_key, hashes.SHA256())
        self._post(order["finalize"],
                   {"csr": _b64(csr.public_bytes(
                       serialization.Encoding.DER))})
        deadline = time.monotonic() + timeout
        while True:
            o = self._post(order_url, None).json()
            if o["status"] == "valid":
                break
            if o["status"] == "invalid":
                raise AcmeError("order invalid")
            if time.monotonic() > deadline:
                raise AcmeError("order poll timeout")
            time.sleep(poll_interval)
        cert_pem = self._post(o["certificate"], None).text
        if token:
            responder.clear(token)
        key_pem = cert_key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()).decode()
        return cert_pem, key_pem


class AutoTlsManager:
    """autocert analogue: cached cert under `<tls_dir>/acme/`, obtained
    on demand and renewed RENEW_BEFORE_DAYS before expiry (the cache
    dir mirrors the reference's `tls-acme` DirCache)."""

    def __init__(self, tls_dir: str | Path, domain: str,
                 directory_url: str = LETS_ENCRYPT,
                 contact: str | None = None, http=None,
                 verify_tls: bool = True):
        self.dir = Path(tls_dir) / "acme"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.domain = domain
        self.directory_url = directory_url
        self.contact = contact
        self._http = http
        self._verify = verify_tls

    @property
    def cert_path(self) -> Path:
        return self.dir / f"{self.domain}.crt"

    @property
    def key_path(self) -> Path:
        return self.dir / f"{self.domain}.key"

    def days_remaining(self) -> float | None:
        from cryptography import x509

        if not self.cert_path.is_file():
            return None
        cert = x509.load_pem_x509_certificate(self.cert_path.read_bytes())
        now = datetime.datetime.now(datetime.timezone.utc)
        return (cert.not_valid_after_utc - now).total_seconds() / 86400.0

    def ensure(self, responder: Http01Responder | None = None
               ) -> tuple[Path, Path]:
        """Return (cert, key) paths, obtaining/renewing if needed."""
        days = self.days_remaining()
        if days is not None and days > RENEW_BEFORE_DAYS:
            return self.cert_path, self.key_path
        log.info("ACME: obtaining certificate for %s (%s)", self.domain,
                 "renewal" if days is not None else "first issue")
        client = AcmeClient(self.directory_url, self.dir,
                            contact=self.contact, http=self._http,
                            verify_tls=self._verify)
        cert_pem, key_pem = client.obtain(self.domain, responder)
        tmp_c = self.cert_path.with_suffix(".crt.tmp")
        tmp_k = self.key_path.with_suffix(".key.tmp")
        tmp_c.write_text(cert_pem)
        tmp_k.write_text(key_pem)
        tmp_k.chmod(0o600)
        tmp_c.rename(self.cert_path)
        tmp_k.rename(self.key_path)
        return self.cert_path, self.key_path
