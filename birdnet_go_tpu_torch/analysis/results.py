"""Detection result types (a copy of ``birdnet_go_tpu/analysis/results.py``;
reference: internal/detection/result.go:12, internal/datastore/model.go
Note).

Produced by offline analysis, consumed by the Raven writer.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt

from birdnet_go_tpu_torch.taxonomy.labels import Species


@dataclasses.dataclass
class WindowResult:
    """All per-window model output kept after device post-processing:
    top-K (species index, confidence) pairs for one analysis window."""

    window_index: int
    begin_seconds: float
    end_seconds: float
    model_id: str
    indices: list[int]
    confidences: list[float]


@dataclasses.dataclass
class Detection:
    """One accepted species detection."""

    species: Species
    confidence: float
    begin_seconds: float
    end_seconds: float
    model_id: str
    source_id: str = ""
    window_index: int = 0
    timestamp: _dt.datetime | None = None       # wall-clock (realtime mode)
    species_code: str = ""

    @property
    def label(self) -> str:
        return self.species.label
