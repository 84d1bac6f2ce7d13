"""OpenFauna taxonomic aliasing + species metadata.

Reference: internal/openfauna — acoustic models are trained on time-frozen
taxonomies, so different models emit different scientific names for the
same species (BirdNET v2.4's "Streptopelia senegalensis" vs the current
"Spilopelia senegalensis" used by the v3 geomodel/Perch). The OpenFauna
dataset ships an alias map (legacy → canonical) consumed here so
cross-model consensus, range-filter matching, and de-duplication all key
on ONE canonical name; plus a metadata table (class/order/family +
Wikipedia/iNaturalist links) powering taxonomy endpoints.

Dataset files (aliases.json, metadata.csv.gz) resolve like label files:
$BIRDNET_TPU_DATA/openfauna or the dev-convenience reference mount.

A copy of ``birdnet_go_tpu/taxonomy/openfauna.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_detection.py``
holds it to the original.
"""

from __future__ import annotations

import csv
import gzip
import io
import json
import logging
import os
import threading
from pathlib import Path

log = logging.getLogger("birdnet_tpu.openfauna")

_DATA_ENV = "BIRDNET_TPU_DATA"
_DEFAULT_DIRS = (
    "./data/openfauna",
    # vendored dataset (aliases + metadata tables; reference ships the
    # same files embedded — internal/openfauna/data)
    str(Path(__file__).resolve().parents[2] / "data" / "openfauna"),
)

_lock = threading.Lock()
_aliases: dict[str, str] | None = None
_metadata: dict[str, dict] | None = None


def data_dir(explicit: str | None = None) -> Path | None:
    candidates = []
    if explicit:
        candidates.append(explicit)
    env = os.environ.get(_DATA_ENV)
    if env:
        candidates.append(str(Path(env) / "openfauna"))
        candidates.append(env)
    candidates.extend(_DEFAULT_DIRS)
    for c in candidates:
        p = Path(c)
        if (p / "aliases.json").is_file():
            return p
    return None


def load_aliases(explicit: str | None = None) -> dict[str, str]:
    """Normalized legacy scientific name → canonical name (dataset case)."""
    global _aliases
    with _lock:
        if _aliases is not None:
            return _aliases
        base = data_dir(explicit)
        if base is None:
            _aliases = {}
            return _aliases
        global _reverse
        try:
            raw = json.loads((base / "aliases.json").read_text())
            _aliases = {k.strip().lower(): v for k, v in raw.items()
                        if isinstance(v, str)}
            # reverse map keeps the dataset-case legacy names — consumers
            # compare against label sets / user config verbatim
            _reverse = {}
            for k, v in raw.items():
                if isinstance(v, str):
                    _reverse.setdefault(v.strip().lower(), []).append(
                        k.strip())
            log.info("openfauna: %d taxonomic aliases loaded", len(_aliases))
        except (OSError, ValueError):
            log.exception("openfauna alias load failed")
            _aliases = {}
            _reverse = {}
        return _aliases


def canonical_name(scientific: str) -> str:
    """Collapse a legacy scientific name to its canonical form; identity
    when no alias exists (resolver.go role)."""
    if not scientific:
        return scientific
    return load_aliases().get(scientific.strip().lower(), scientific)


_reverse: dict[str, list[str]] | None = None


def legacy_names_for(canonical: str) -> list[str]:
    """Legacy scientific names (dataset case) that map to a canonical
    name — needed wherever user config or model label sets may still use
    the OLD taxonomy (per-species thresholds, include/exclude, ranges)."""
    load_aliases()
    return (_reverse or {}).get(canonical.strip().lower(), [])


def species_metadata(scientific: str) -> dict | None:
    """class/order/family + reference links from metadata.csv.gz."""
    global _metadata
    with _lock:
        if _metadata is None:
            _metadata = {}
            base = data_dir()
            path = base / "metadata.csv.gz" if base else None
            if path and path.is_file():
                try:
                    with gzip.open(path, "rt", encoding="utf-8",
                                   newline="") as f:
                        for row in csv.DictReader(f):
                            sci = row.get("scientific_name", "").lower()
                            if sci:
                                _metadata[sci] = row
                    log.info("openfauna: metadata for %d taxa loaded",
                             len(_metadata))
                except OSError:
                    log.exception("openfauna metadata load failed")
    key = canonical_name(scientific).lower()
    return _metadata.get(key) or _metadata.get(scientific.lower())


def reset_cache() -> None:
    """Testing hook."""
    global _aliases, _metadata, _reverse
    with _lock:
        _aliases = None
        _metadata = None
        _reverse = None
