"""Species labels and eBird taxonomy codes (a copy of
``birdnet_go_tpu/taxonomy/labels.py``; installed labels resolve through the
port's own ``inference.loader.model_home``).

Label-file format (one species per line, index = class index):
    "Scientific name_Common Name"
parsed exactly like the reference's detection.Species (detection/species.go:29).
eBird code map: a bidirectional JSON {"code": "Sci_Common", "Sci_Common":
"code", ...} (internal/classifier/data/eBird_taxonomy_codes_2021E.json).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from pathlib import Path

from birdnet_go_tpu_torch.inference.loader import model_home

_DATA_ENV = "BIRDNET_TPU_DATA"
# Shipped data: the 42-locale v2.4 label files, eBird code map, and genus
# taxonomy are vendored under <repo>/data/taxonomy (the reference embeds
# the same tables into its binary — internal/classifier/data/,
# models_embedded.go:14-22), so a fresh clone serves real species names
# with no external mounts. cwd-relative ./data/taxonomy still wins for
# deployments that stage their own tables beside the working directory.
_DEFAULT_DATA_DIRS = (
    "./data/taxonomy",
    str(Path(__file__).resolve().parents[2] / "data" / "taxonomy"),
)
_V24_LABEL_TEMPLATE = "labels/V2.4/BirdNET_GLOBAL_6K_V2.4_Labels_{locale}.txt"
_EBIRD_JSON = "eBird_taxonomy_codes_2021E.json"


@dataclasses.dataclass(frozen=True)
class Species:
    """A species label: 'Scientific name_Common Name'."""

    scientific: str
    common: str

    @classmethod
    def parse(cls, label: str) -> "Species":
        sci, _, common = label.partition("_")
        return cls(sci.strip(), common.strip())

    @property
    def label(self) -> str:
        return f"{self.scientific}_{self.common}"

    def __str__(self) -> str:
        return self.label


@dataclasses.dataclass
class LabelSet:
    """Ordered species labels for one model + optional eBird code map."""

    species: list[Species]
    locale: str = "en_us"
    codes: dict[str, str] | None = None        # label → eBird code

    def __len__(self) -> int:
        return len(self.species)

    def __getitem__(self, idx: int) -> Species:
        return self.species[idx]

    @functools.cached_property
    def index_by_scientific(self) -> dict[str, int]:
        return {s.scientific: i for i, s in enumerate(self.species)}

    def code_for(self, sp: Species) -> str:
        """eBird species code, or a slug fallback when no map is loaded."""
        if self.codes:
            code = self.codes.get(sp.label)
            if code:
                return code
        # fallback slug mirrors the reference's behavior for non-taxa labels
        # (e.g. "Engine", "Human vocal"): lowercase common name token
        return sp.common.lower().replace(" ", "")[:12] or "unknown"


def resolve_data_dir(explicit: str | None = None) -> Path | None:
    """Resolution order: explicit arg → $BIRDNET_TPU_DATA → known defaults."""
    candidates = []
    if explicit:
        candidates.append(explicit)
    if os.environ.get(_DATA_ENV):
        candidates.append(os.environ[_DATA_ENV])
    candidates.extend(_DEFAULT_DATA_DIRS)
    for c in candidates:
        p = Path(c)
        if p.is_dir():
            return p
    return None


def load_labels(data_dir: str | Path | None = None, locale: str = "en_us",
                model_id: str = "BirdNET_V2.4",
                expected_count: int | None = None) -> LabelSet:
    """Load the label file for (model, locale); falls back to synthetic.

    Synthetic fallback keeps the full pipeline runnable without the data
    files (tests, fresh installs before `model install`).
    """
    base = resolve_data_dir(str(data_dir) if data_dir else None)
    candidates: list[Path] = []
    if base is not None:
        if model_id == "BirdNET_V2.4":
            candidates.append(base / _V24_LABEL_TEMPLATE.format(locale=locale))
            candidates.append(base / _V24_LABEL_TEMPLATE.format(locale="en_us"))
        else:
            candidates.append(base / "labels" / model_id / f"{locale}.txt")
    # `model install` stages labels beside the weights (catalog.py
    # _stage_labels), so an installed model resolves its species names
    # even when no shared data dir exists on this host
    staged = model_home() / model_id / "labels"
    if model_id == "BirdNET_V2.4":
        for loc in (locale, "en_us"):
            candidates.append(
                staged / Path(_V24_LABEL_TEMPLATE.format(locale=loc)).name)
    else:
        candidates.append(staged / f"{locale}.txt")
    for path in candidates:
        if not path.is_file():
            continue
        lines = path.read_text(encoding="utf-8").splitlines()
        species = [Species.parse(ln) for ln in lines if ln.strip()]
        # A label set that doesn't match the model head is unusable —
        # fall back to synthetic of the right width (mirrors the
        # reference's label-count validation at model load).
        if expected_count is None or len(species) == expected_count:
            codes = load_ebird_codes(base) if base is not None else None
            return LabelSet(species=species, locale=locale, codes=codes)
    n = expected_count or 6522
    return synthetic_labels(n, locale=locale)


def load_ebird_codes(data_dir: str | Path | None = None) -> dict[str, str] | None:
    """label 'Sci_Common' → eBird code map (None if file absent)."""
    base = resolve_data_dir(str(data_dir) if data_dir else None)
    if base is None:
        return None
    path = base / _EBIRD_JSON
    if not path.is_file():
        return None
    raw = json.loads(path.read_text(encoding="utf-8"))
    # file is bidirectional; keep only label→code entries
    return {k: v for k, v in raw.items() if "_" in k and "_" not in v}


def genus_of(scientific: str) -> str:
    """Genus = first token of the scientific name (fallback taxonomy —
    reference: internal/classifier/genus.go provides richer family data;
    the genus itself is derivable)."""
    return scientific.split(" ")[0] if scientific else ""


def load_genus_taxonomy(data_dir: str | Path | None = None
                        ) -> dict[str, dict] | None:
    """Genus → {family, order, ...} from genus_taxonomy.json when the data
    dir is available (None otherwise; callers fall back to genus_of)."""
    base = resolve_data_dir(str(data_dir) if data_dir else None)
    if base is None:
        return None
    path = base / "genus_taxonomy.json"
    if not path.is_file():
        return None
    raw = json.loads(path.read_text(encoding="utf-8"))
    # file layout: {"genera": {"Turdus": {...}}, ...} or flat — accept both
    genera = raw.get("genera", raw)
    return genera if isinstance(genera, dict) else None


def synthetic_labels(n: int, locale: str = "en_us") -> LabelSet:
    """Deterministic placeholder labels for tests / modelless runs."""
    species = [Species(f"Synthetica speciei{i:04d}", f"Synthetic Species {i:04d}")
               for i in range(n)]
    return LabelSet(species=species, locale=locale, codes=None)
