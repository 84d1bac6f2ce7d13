"""Taxonomy & labels: species label files, eBird code map, locale handling
(a copy of ``birdnet_go_tpu/taxonomy/__init__.py``).

Reference: internal/classifier/taxonomy.go, label_files.go, names.go and
the data files under internal/classifier/data/ (42 locale label files of
6,522 "Scientific_Common" lines + eBird taxonomy code JSON).

The data is read at run time from a data directory ($BIRDNET_TPU_DATA,
./data/taxonomy, then the repository's data/taxonomy), with a
deterministic synthetic fallback so every layer stays testable without the
data files.
"""

from birdnet_go_tpu_torch.taxonomy.labels import (
    Species,
    LabelSet,
    load_labels,
    load_ebird_codes,
    resolve_data_dir,
    synthetic_labels,
)

__all__ = [
    "Species",
    "LabelSet",
    "load_labels",
    "load_ebird_codes",
    "resolve_data_dir",
    "synthetic_labels",
]
