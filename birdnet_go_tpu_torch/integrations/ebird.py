"""eBird API v2 client (taxonomy + nearby observations).

Reference: internal/ebird — authenticated client (X-eBirdApiToken) with a
TTL cache in front of the taxonomy and recent-observations endpoints,
feeding the name-resolution chain and locality context.

A copy of ``birdnet_go_tpu/integrations/ebird.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_integrations.py``
holds it to the original. Its default session is the shared client on
the port's transport (``utils/httpclient.py``).
"""

from __future__ import annotations

import logging
import threading
import time

from birdnet_go_tpu_torch.utils.circuit import CircuitBreaker, CircuitOpenError

log = logging.getLogger("birdnet_tpu.ebird")

API_BASE = "https://api.ebird.org/v2"
CACHE_TTL_SECONDS = 6 * 3600.0


class EBirdClient:
    def __init__(self, api_token: str = "", session=None,
                 clock=time.time):
        from birdnet_go_tpu_torch.utils.httpclient import shared_client

        self.session = session or shared_client()
        self.api_token = api_token
        self.clock = clock
        self.breaker = CircuitBreaker()
        self._cache: dict[str, tuple[float, object]] = {}
        self._lock = threading.Lock()

    def _get(self, path: str, params: dict | None = None):
        key = f"{path}?{sorted((params or {}).items())}"
        now = self.clock()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and now - hit[0] < CACHE_TTL_SECONDS:
                return hit[1]
        headers = {}
        if self.api_token:
            headers["X-eBirdApiToken"] = self.api_token
        try:
            r = self.breaker.call(self.session.get, API_BASE + path,
                                  params=params or {}, headers=headers)
            r.raise_for_status()
            data = r.json()
        except (CircuitOpenError, Exception) as e:  # noqa: BLE001
            log.warning("ebird request %s failed: %s", path, e)
            return None
        with self._lock:
            self._cache[key] = (now, data)
        return data

    def taxonomy(self, species_code: str | None = None,
                 scientific: str | None = None) -> list[dict]:
        """eBird/Clements taxonomy rows (ref/taxonomy/ebird)."""
        params = {"fmt": "json"}
        if species_code:
            params["species"] = species_code
        data = self._get("/ref/taxonomy/ebird", params)
        rows = data if isinstance(data, list) else []
        if scientific:
            s = scientific.lower()
            rows = [r for r in rows
                    if r.get("sciName", "").lower() == s]
        return rows

    def recent_observations(self, lat: float, lon: float,
                            dist_km: int = 25, back_days: int = 7
                            ) -> list[dict]:
        """Recent nearby observations (data/obs/geo/recent) — locality
        context for the dashboard/range comparison."""
        data = self._get("/data/obs/geo/recent", {
            "lat": round(lat, 2), "lng": round(lon, 2),
            "dist": dist_km, "back": back_days})
        return data if isinstance(data, list) else []

    def species_code(self, scientific: str) -> str | None:
        rows = self.taxonomy(scientific=scientific)
        return rows[0].get("speciesCode") if rows else None
