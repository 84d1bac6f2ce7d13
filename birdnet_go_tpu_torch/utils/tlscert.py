"""Self-signed TLS certificate management for the HTTPS server.

Reference: internal/tls (generate.go — EC P-256 self-signed with 128-bit
random serial; sans.go — SAN collection from host/baseURL/interfaces with
hostname validation) and internal/api/v2/tls/tls.go (certificate store:
get/upload/delete/generate/download with key-pair validation and backup
before overwrite). Certificates live as PEM files under a service
directory; the web server loads them into an ssl.SSLContext at startup.

A copy of ``birdnet_go_tpu/utils/tlscert.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_tls.py`` holds it to the
original (each side reads and accepts the other's pairs). ``cryptography``
is imported inside the functions that use it, as in JAX.
"""

from __future__ import annotations

import datetime
import ipaddress
import logging
import re
import secrets
import shutil
import socket
from pathlib import Path
from urllib.parse import urlparse

log = logging.getLogger("birdnet_tpu.tls")

DEFAULT_VALIDITY_DAYS = 1825            # 5 years (tls.go defaultValidityDays)
MIN_VALIDITY_HOURS = 24                 # tls.go minValidityHours
MAX_VALIDITY_HOURS = 24 * 365 * 10      # tls.go maxValidityHours

_MAX_HOSTNAME_LEN = 253                 # sans.go maxHostnameLen (RFC 1035)
_LABEL_RE = re.compile(r"^[a-zA-Z0-9]([a-zA-Z0-9-]{0,61}[a-zA-Z0-9])?$")


def is_valid_hostname(name: str) -> bool:
    """RFC 1035-ish hostname check (sans.go isValidHostname); IP literals
    are accepted too (they become IP SANs)."""
    if not name or len(name) > _MAX_HOSTNAME_LEN:
        return False
    try:
        ipaddress.ip_address(name)
        return True
    except ValueError:
        pass
    return all(_LABEL_RE.match(label) for label in name.rstrip(".").split("."))


def collect_sans(host: str = "", base_url: str = "") -> list[str]:
    """Gather SANs from the configured host, the base URL's hostname, the
    machine's non-loopback IPv4 addresses, plus localhost + 127.0.0.1
    (sans.go CollectSANs — deduplicated, order-preserving)."""
    seen: set[str] = set()
    sans: list[str] = []

    def add(s: str) -> None:
        s = s.strip()
        if not s:
            return
        if not is_valid_hostname(s):
            log.warning("skipping invalid SAN entry %r", s)
            return
        if s not in seen:
            seen.add(s)
            sans.append(s)

    if host and host not in ("0.0.0.0", "::"):
        add(host)
    if base_url:
        parsed = urlparse(base_url)
        if parsed.hostname:
            add(parsed.hostname)
    for addr in _interface_ipv4_addresses():
        add(addr)
    add("localhost")
    add("127.0.0.1")
    return sans


def _interface_ipv4_addresses() -> list[str]:
    """Non-loopback IPv4 addresses (sans.go addInterfaceAddresses)."""
    out = []
    try:
        host = socket.gethostname()
        for info in socket.getaddrinfo(host, None, socket.AF_INET):
            ip = info[4][0]
            if not ip.startswith("127.") and ip not in out:
                out.append(ip)
    except OSError:
        pass
    return out


def parse_validity(value: str | None) -> datetime.timedelta:
    """Parse a validity request like '8760h', '365d', or '' (default).
    Bounds per tls.go: [24h, 10y]; out-of-range raises ValueError."""
    if not value:
        return datetime.timedelta(days=DEFAULT_VALIDITY_DAYS)
    m = re.fullmatch(r"(\d+)\s*([hd]?)", value.strip().lower())
    if not m:
        raise ValueError(f"invalid validity {value!r} (use e.g. '8760h'"
                         " or '365d')")
    n, unit = int(m.group(1)), m.group(2) or "h"
    hours = n * 24 if unit == "d" else n
    if hours < MIN_VALIDITY_HOURS or hours > MAX_VALIDITY_HOURS:
        raise ValueError(f"validity must be between {MIN_VALIDITY_HOURS}h"
                         f" and {MAX_VALIDITY_HOURS}h")
    return datetime.timedelta(hours=hours)


def generate_self_signed(validity: datetime.timedelta | None = None,
                         sans: list[str] | None = None,
                         common_name: str = "birdnet-go-tpu"
                         ) -> tuple[str, str]:
    """EC P-256 self-signed certificate with a random 128-bit serial
    (generate.go GenerateSelfSigned). Returns (cert_pem, key_pem)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    if validity is None:
        validity = datetime.timedelta(days=DEFAULT_VALIDITY_DAYS)
    if validity.total_seconds() <= 0:
        raise ValueError("certificate validity must be positive")

    key = ec.generate_private_key(ec.SECP256R1())
    # SANs split into DNS names vs IP addresses (generate.go)
    san_entries: list[x509.GeneralName] = []
    for s in (sans or ["localhost", "127.0.0.1"]):
        try:
            san_entries.append(x509.IPAddress(ipaddress.ip_address(s)))
        except ValueError:
            san_entries.append(x509.DNSName(s))

    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name),
                      x509.NameAttribute(NameOID.ORGANIZATION_NAME,
                                         "BirdNET-Go-TPU")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(secrets.randbits(128))
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + validity)
            .add_extension(x509.SubjectAlternativeName(san_entries),
                           critical=False)
            .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                           critical=True)
            .add_extension(x509.ExtendedKeyUsage(
                [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
            .sign(key, hashes.SHA256()))
    cert_pem = cert.public_bytes(serialization.Encoding.PEM).decode()
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()).decode()
    return cert_pem, key_pem


def parse_certificate_info(cert_pem: str | bytes) -> dict:
    """Certificate details for the API (tls.go TLSCertificateInfo)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes

    if isinstance(cert_pem, str):
        cert_pem = cert_pem.encode()
    cert = x509.load_pem_x509_certificate(cert_pem)
    try:
        san_ext = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName)
        sans = [str(g.value) for g in san_ext.value]
    except x509.ExtensionNotFound:
        sans = []
    now = datetime.datetime.now(datetime.timezone.utc)
    days_left = max(0, (cert.not_valid_after_utc - now).days)
    return {
        "installed": True,
        "subject": cert.subject.rfc4514_string(),
        "issuer": cert.issuer.rfc4514_string(),
        "notBefore": cert.not_valid_before_utc.isoformat(),
        "notAfter": cert.not_valid_after_utc.isoformat(),
        "daysUntilExpiry": days_left,
        "sans": sans,
        "serialNumber": format(cert.serial_number, "x"),
        "fingerprint": cert.fingerprint(hashes.SHA256()).hex(),
    }


def validate_key_pair(cert_pem: str | bytes, key_pem: str | bytes) -> None:
    """Raise ValueError unless the certificate's public key matches the
    private key (tls.go validateKeyPair — crypto/tls.X509KeyPair check)."""
    import ssl
    import tempfile

    if isinstance(cert_pem, str):
        cert_pem = cert_pem.encode()
    if isinstance(key_pem, str):
        key_pem = key_pem.encode()
    # ssl's loader performs the real pairing check the server would hit
    with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
            tempfile.NamedTemporaryFile(suffix=".pem") as kf:
        cf.write(cert_pem)
        cf.flush()
        kf.write(key_pem)
        kf.flush()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        try:
            ctx.load_cert_chain(cf.name, kf.name)
        except ssl.SSLError as e:
            raise ValueError(f"certificate/key pair invalid: {e}") from e


class TLSManager:
    """PEM store for one service's certificate + key (conf.TLSManager role:
    CertificateExists / GetCertificatePath / Save / Delete / Backup)."""

    def __init__(self, base_dir: str | Path):
        self.base = Path(base_dir)

    def _dir(self, service: str) -> Path:
        return self.base / service

    def cert_path(self, service: str = "webserver") -> Path:
        return self._dir(service) / "cert.pem"

    def key_path(self, service: str = "webserver") -> Path:
        return self._dir(service) / "key.pem"

    def exists(self, service: str = "webserver") -> bool:
        return self.cert_path(service).is_file() \
            and self.key_path(service).is_file()

    def save(self, cert_pem: str, key_pem: str,
             service: str = "webserver") -> None:
        validate_key_pair(cert_pem, key_pem)
        d = self._dir(service)
        d.mkdir(parents=True, exist_ok=True)
        self.backup(service)
        self.cert_path(service).write_text(cert_pem)
        kp = self.key_path(service)
        kp.write_text(key_pem)
        kp.chmod(0o600)

    def backup(self, service: str = "webserver") -> None:
        """Keep one .bak generation before overwrite (BackupAllCertificates)."""
        for p in (self.cert_path(service), self.key_path(service)):
            if p.is_file():
                shutil.copy2(p, p.with_suffix(p.suffix + ".bak"))

    def delete(self, service: str = "webserver") -> bool:
        found = False
        for p in (self.cert_path(service), self.key_path(service)):
            if p.is_file():
                self.backup(service)
                p.unlink()
                found = True
        return found

    def info(self, service: str = "webserver") -> dict:
        if not self.exists(service):
            return {"installed": False}
        return parse_certificate_info(self.cert_path(service).read_text())

    def ensure_self_signed(self, host: str = "", base_url: str = "",
                           service: str = "webserver") -> None:
        """Generate + persist a self-signed pair when none is installed or
        the installed one expired (server startup path when TLS is enabled
        without user-supplied certificates)."""
        if self.exists(service):
            try:
                if self.info(service).get("daysUntilExpiry", 0) > 0:
                    return
                log.warning("TLS certificate for %s expired — regenerating",
                            service)
            except Exception:
                log.exception("unreadable TLS certificate — regenerating")
        cert, key = generate_self_signed(sans=collect_sans(host, base_url))
        self.save(cert, key, service)
        log.info("self-signed TLS certificate generated for %s (%s)",
                 service, self.cert_path(service))

    def ssl_context(self, service: str = "webserver"):
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.cert_path(service), self.key_path(service))
        return ctx
