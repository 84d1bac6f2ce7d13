"""Release update check (reference: internal/update — fetch the release
manifest, compare semver against the running version, surface the result
in the UI; never auto-updates).

A copy of ``birdnet_go_tpu/utils/update.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_api.py`` holds it to the
original. The check goes over the port's transport (``utils/httpclient.py``
``UrllibSession``), where JAX's builds an ``httpx.Client``.
"""

from __future__ import annotations

import logging
import re
import time

from birdnet_go_tpu_torch.utils.httpclient import UrllibSession
from birdnet_go_tpu_torch.version import __version__

log = logging.getLogger("birdnet_tpu.update")

DEFAULT_MANIFEST_URL = \
    "https://api.github.com/repos/birdnet-tpu/birdnet-tpu/releases/latest"
CACHE_TTL_SECONDS = 6 * 3600.0

_cache: tuple[float, dict] | None = None


def parse_version(v: str) -> tuple[int, ...]:
    nums = re.findall(r"\d+", v or "")
    return tuple(int(n) for n in nums[:3]) or (0,)


def is_newer(candidate: str, current: str = __version__) -> bool:
    return parse_version(candidate) > parse_version(current)


def check_for_update(manifest_url: str = DEFAULT_MANIFEST_URL,
                     session=None, clock=time.time) -> dict:
    """{current, latest, update_available, url} — cached for 6 h."""
    global _cache
    now = clock()
    if _cache is not None and now - _cache[0] < CACHE_TTL_SECONDS:
        return _cache[1]
    out = {"current": __version__, "latest": None,
           "update_available": False, "url": None, "checked_at": now}
    try:
        sess = session or UrllibSession(timeout=10.0)
        r = sess.get(manifest_url,
                     headers={"Accept": "application/vnd.github+json"})
        r.raise_for_status()
        data = r.json()
        latest = (data.get("tag_name") or data.get("version") or "").lstrip("v")
        out["latest"] = latest
        out["url"] = data.get("html_url")
        out["update_available"] = is_newer(latest)
    except Exception as e:  # noqa: BLE001 — update check is best-effort
        out["error"] = str(e)[:200]
        log.debug("update check failed: %s", e)
    _cache = (now, out)
    return out
