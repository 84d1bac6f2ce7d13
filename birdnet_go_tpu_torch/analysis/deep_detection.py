"""Deep Detection (false-positive repeat-confirmation filter).

Reference semantics (internal/analysis/processor/false_positive_filter.go
+ processor.go:1669-1729 calculateMinDetectionsFromSettings):

- level 0 disables filtering (min 1 detection);
- levels 1-5 map to minimum recommended overlap {2.0, 2.2, 2.4, 2.7, 2.8}
  and to a required fraction {20, 30, 50, 60, 70}% of the detections
  possible inside a 6 s vocalization reference window;
- segment length = max(0.1, 3.0 − overlap); possible = 6.0 / segment;
- required = max(1, ceil(possible · fraction − 1e-9)) — epsilon guards
  float rounding (5.0000000003 must not ceil to 6).

A copy of ``birdnet_go_tpu/analysis/deep_detection.py`` for the port,
which imports nothing of the JAX package;
``tests/test_torch_detection.py`` holds it to the original.
"""

from __future__ import annotations

import math

_CHUNK_SECONDS = 3.0
_REFERENCE_WINDOW_SECONDS = 6.0
_MIN_SEGMENT = 0.1
_EPSILON = 1e-9

_MIN_OVERLAP = {0: 0.0, 1: 2.0, 2: 2.2, 3: 2.4, 4: 2.7, 5: 2.8}
_THRESHOLD_PCT = {0: 0.0, 1: 0.20, 2: 0.30, 3: 0.50, 4: 0.60, 5: 0.70}
_LEVEL_NAMES = {0: "Off", 1: "Lenient", 2: "Moderate", 3: "Balanced",
                4: "Strict", 5: "Maximum"}


def minimum_overlap_for_level(level: int) -> float:
    return _MIN_OVERLAP.get(level, 2.2)


def threshold_for_level(level: int) -> float:
    return _THRESHOLD_PCT.get(level, 0.30)


def level_name(level: int) -> str:
    return _LEVEL_NAMES.get(level, "Unknown")


def min_detections(level: int, overlap: float,
                   chunk_seconds: float = _CHUNK_SECONDS) -> int:
    """Minimum repeated detections required before a species is approved."""
    if level == 0:
        return 1
    segment = max(_MIN_SEGMENT, chunk_seconds - overlap)
    possible = _REFERENCE_WINDOW_SECONDS / segment
    required = possible * threshold_for_level(level) - _EPSILON
    return max(1, math.ceil(required))
