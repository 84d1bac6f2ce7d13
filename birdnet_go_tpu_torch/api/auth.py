"""API authentication middleware.

Reference: internal/security + internal/api/auth — OAuth2/social/OIDC at
full surface; here the core protections: bearer-token auth with
constant-time comparison, local-subnet bypass (reference's
binary authz model), and public-path allowlist (health/ping/SSE keepalive
stay reachable for probes).

A copy of ``birdnet_go_tpu/api/auth.py`` for the port, which imports nothing
of the JAX package; ``tests/test_torch_api.py`` holds it to the original.
"""

from __future__ import annotations

import hmac
import ipaddress
import secrets

from birdnet_go_tpu_torch.api import web

PUBLIC_PATHS = {"/api/v2/health", "/api/v2/ping", "/metrics"}

_LOCAL_NETS = [
    ipaddress.ip_network("127.0.0.0/8"),
    ipaddress.ip_network("10.0.0.0/8"),
    ipaddress.ip_network("172.16.0.0/12"),
    ipaddress.ip_network("192.168.0.0/16"),
    ipaddress.ip_network("::1/128"),
]


def generate_token() -> str:
    return secrets.token_urlsafe(32)


def is_local_address(addr: str, subnets: list | None = None) -> bool:
    """True when addr is inside the bypass subnets. `subnets` (CIDR
    strings from webserver.bypass_subnets) narrows the default RFC1918
    set — the reference's subnet-bypass guidance is "keep the subnet
    narrow" (doc/wiki/security.md)."""
    try:
        ip = ipaddress.ip_address(addr)
    except ValueError:
        return False
    nets = _LOCAL_NETS
    if subnets:
        nets = []
        for cidr in subnets:
            try:
                net = ipaddress.ip_network(cidr, strict=False)
            except ValueError:
                continue
            # NARROWING only: a configured public CIDR must never widen
            # the no-auth bypass to the internet
            if not net.is_private:
                continue
            nets.append(net)
        if not nets:
            nets = _LOCAL_NETS
    return any(ip in net for net in nets)


def auth_middleware(token: str, allow_local_bypass: bool = True):
    """aiohttp middleware enforcing `Authorization: Bearer <token>`."""

    @web.middleware
    async def middleware(request, handler):
        if request.path in PUBLIC_PATHS or request.path in ("/", "/ui"):
            return await handler(request)
        # Local-subnet bypass honors only DIRECT connections: a request
        # carrying proxy headers was forwarded (a reverse proxy on
        # localhost/RFC1918 must not expose restart/settings/media
        # unauthenticated through the bypass).
        proxied = ("X-Forwarded-For" in request.headers
                   or "X-Real-IP" in request.headers
                   or "Forwarded" in request.headers)
        if allow_local_bypass and not proxied and request.remote \
                and is_local_address(request.remote):
            return await handler(request)
        header = request.headers.get("Authorization", "")
        supplied = header.removeprefix("Bearer ").strip()
        # also accept ?token= for SSE/EventSource clients (no headers)
        if not supplied:
            supplied = request.query.get("token", "")
        if supplied and hmac.compare_digest(supplied.encode(), token.encode()):
            return await handler(request)
        return web.json_response({"error": "unauthorized"}, status=401)

    return middleware
