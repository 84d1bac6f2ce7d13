"""Species image providers: Wikipedia + Avicommons with DB-backed cache and
negative caching.

Reference: internal/imageprovider/ — wikipedia.go (pageimages API, strict
User-Agent, rate limiting, circuit breaker), avicommons.go (static CDN keyed
by eBird code from a pre-loaded dataset), imageprovider.go (provider chain +
datastore ImageCache + negative cache so absent species aren't re-queried
every dashboard render).

A copy of ``birdnet_go_tpu/integrations/imageprovider.py`` for the port,
which imports nothing of the JAX package; ``tests/test_torch_api.py`` holds
it to the original.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any

from birdnet_go_tpu_torch.utils.circuit import CircuitBreaker, CircuitOpenError

log = logging.getLogger("birdnet_tpu.imageprovider")

USER_AGENT = ("BirdNET-TPU/0.1 (bioacoustics monitoring; "
              "https://example.invalid) python-httpx")
NEGATIVE_TTL_SECONDS = 24 * 3600.0      # re-try absent species daily
WIKIPEDIA_API = "https://en.wikipedia.org/w/api.php"
AVICOMMONS_BASE = "https://static.avicommons.org"


@dataclasses.dataclass
class ImageInfo:
    scientific_name: str
    url: str
    thumbnail_url: str = ""
    author: str = ""
    license: str = ""
    provider: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class WikipediaProvider:
    """pageimages lookup by scientific name (wikipedia.go)."""

    name = "wikimedia"

    def __init__(self, session=None, rate_per_second: float = 1.0):
        self._session = session
        self.breaker = CircuitBreaker()
        self._min_interval = 1.0 / rate_per_second
        self._last_call = 0.0
        self._lock = threading.Lock()

    @property
    def session(self):
        """The HTTP client (the port's transport, ``utils/httpclient.py``),
        built at the first lookup where JAX builds it in ``__init__``."""
        if self._session is None:
            from birdnet_go_tpu_torch.utils.httpclient import HttpClient

            # dedicated pool: Wikimedia requires the provider's own UA policy
            self._session = HttpClient(timeout=15.0, user_agent=USER_AGENT)
        return self._session

    def fetch(self, scientific: str) -> ImageInfo | None:
        with self._lock:                      # global 1 rps rate limit
            wait = self._last_call + self._min_interval - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self._last_call = time.monotonic()
        params = {
            "action": "query", "prop": "pageimages|imageinfo",
            "piprop": "thumbnail|original", "pithumbsize": "320",
            "titles": scientific, "redirects": "1", "format": "json",
        }
        try:
            r = self.breaker.call(self.session.get, WIKIPEDIA_API,
                                  params=params)
            r.raise_for_status()
            pages = r.json().get("query", {}).get("pages", {})
        except (CircuitOpenError, Exception) as e:  # noqa: BLE001
            log.debug("wikipedia lookup failed for %s: %s", scientific, e)
            return None
        for page in pages.values():
            thumb = page.get("thumbnail", {}).get("source", "")
            orig = page.get("original", {}).get("source", "") or thumb
            if orig:
                return ImageInfo(scientific_name=scientific, url=orig,
                                 thumbnail_url=thumb, provider=self.name,
                                 license="wikimedia")
        return None


class AvicommonsProvider:
    """Static-CDN lookup from the pre-loaded Avicommons dataset
    (avicommons.go). The dataset (latest.json) maps scientific names to
    eBird code + photo key; images live at a deterministic URL."""

    name = "avicommons"

    def __init__(self, dataset_path: str | Path | None = None,
                 size: str = "320"):
        self.size = size
        self._by_sci: dict[str, dict] = {}
        if dataset_path and Path(dataset_path).is_file():
            self.load_dataset(Path(dataset_path).read_text())

    def load_dataset(self, raw_json: str) -> int:
        data = json.loads(raw_json)
        entries = data if isinstance(data, list) else data.get("entries", [])
        self._by_sci = {e["sciName"].lower(): e for e in entries
                        if e.get("sciName") and e.get("key")
                        and e.get("code")}    # fetch() builds the URL
                                              # from code: no code, no entry
        return len(self._by_sci)

    def fetch(self, scientific: str) -> ImageInfo | None:
        e = self._by_sci.get(scientific.lower())
        if e is None:
            return None
        url = f"{AVICOMMONS_BASE}/{e['code']}-{e['key']}-{self.size}.jpg"
        return ImageInfo(scientific_name=scientific, url=url,
                         thumbnail_url=url, author=e.get("by", ""),
                         license=e.get("license", ""), provider=self.name)


class ImageProviderService:
    """Provider chain + DB cache + negative caching (imageprovider.go)."""

    def __init__(self, providers: list[Any], datastore=None,
                 clock=time.time):
        self.providers = providers
        self.datastore = datastore
        self.clock = clock
        self._mem: dict[str, tuple[ImageInfo | None, float]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.negative_hits = 0

    def get_image(self, scientific: str) -> ImageInfo | None:
        from birdnet_go_tpu_torch.taxonomy import nonbird

        if nonbird.is_nonbird_name(scientific):
            # FSD50K sound classes ("Engine", "power_tool") are not taxa —
            # querying Wikipedia for them wastes the rate limit and caches
            # junk (reference: imageprovider.go nonbird.IsNonBirdName gate)
            self.negative_hits += 1
            return None
        key = scientific.lower()
        now = self.clock()
        with self._lock:
            cached = self._mem.get(key)
        if cached is not None:
            info, at = cached
            if info is not None or now - at < NEGATIVE_TTL_SECONDS:
                if info is None:
                    self.negative_hits += 1
                else:
                    self.hits += 1
                return info
        # DB cache (persists across restarts)
        if self.datastore is not None:
            row = self.datastore.get_image_cache(key)
            if row is not None:
                if row["url"]:
                    info = ImageInfo(scientific_name=scientific,
                                     url=row["url"],
                                     thumbnail_url=row["thumbnail_url"],
                                     author=row["author"],
                                     license=row["license"],
                                     provider=row["provider"])
                    with self._lock:
                        self._mem[key] = (info, now)
                    self.hits += 1
                    return info
                if now - row["cached_at"] < NEGATIVE_TTL_SECONDS:
                    with self._lock:
                        self._mem[key] = (None, row["cached_at"])
                    self.negative_hits += 1
                    return None
        # providers, in order
        self.misses += 1
        for p in self.providers:
            try:
                info = p.fetch(scientific)
            except Exception:  # noqa: BLE001
                info = None
            if info is not None:
                self._store(key, info, now)
                return info
        self._store(key, None, now)      # negative cache
        return None

    def _store(self, key: str, info: ImageInfo | None, now: float) -> None:
        with self._lock:
            self._mem[key] = (info, now)
        if self.datastore is not None:
            try:
                self.datastore.save_image_cache(
                    key,
                    url=info.url if info else "",
                    thumbnail_url=info.thumbnail_url if info else "",
                    author=info.author if info else "",
                    license=info.license if info else "",
                    provider=info.provider if info else "",
                    cached_at=now)
            except Exception:
                log.exception("image cache save failed")

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "negative_hits": self.negative_hits,
                "providers": [p.name for p in self.providers]}
