"""Precompressed per-locale species-name dictionaries.

Reference: internal/speciesdict — the browser receives the full
scientific→common-name dictionary for its locale as a PRECOMPRESSED gzip
blob (served with Content-Encoding: gzip, never recompressed per request).
Dataset: {locale}.json.gz files resolved like the other taxonomy data.

A copy of ``birdnet_go_tpu/taxonomy/speciesdict.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_api.py`` holds it to
the original.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
from pathlib import Path

log = logging.getLogger("birdnet_tpu.speciesdict")

_DATA_ENV = "BIRDNET_TPU_DATA"
_DEFAULT_DIRS = (
    "./data/speciesdict",
    # vendored per-locale dictionaries (reference embeds the same
    # .json.gz blobs — internal/speciesdict/data)
    str(Path(__file__).resolve().parents[2] / "data" / "speciesdict"),
)


def data_dir(explicit: str | None = None) -> Path | None:
    candidates = []
    if explicit:
        candidates.append(explicit)
    env = os.environ.get(_DATA_ENV)
    if env:
        candidates.append(str(Path(env) / "speciesdict"))
    candidates.extend(_DEFAULT_DIRS)
    for c in candidates:
        p = Path(c)
        if p.is_dir() and any(p.glob("*.json.gz")):
            return p
    return None


def available_locales(explicit: str | None = None) -> list[str]:
    base = data_dir(explicit)
    if base is None:
        return []
    return sorted(p.name.split(".")[0] for p in base.glob("*.json.gz"))


def compressed_dictionary(locale: str, explicit: str | None = None
                          ) -> bytes | None:
    """Raw gzip bytes for a locale (serve with Content-Encoding: gzip)."""
    base = data_dir(explicit)
    if base is None:
        return None
    lang = locale.split("_")[0].split("-")[0].lower()
    for candidate in (locale.lower(), lang):
        path = base / f"{candidate}.json.gz"
        if path.is_file():
            return path.read_bytes()
    return None


def dictionary(locale: str, explicit: str | None = None) -> dict | None:
    blob = compressed_dictionary(locale, explicit)
    if blob is None:
        return None
    try:
        return json.loads(gzip.decompress(blob))
    except (OSError, ValueError):
        return None
