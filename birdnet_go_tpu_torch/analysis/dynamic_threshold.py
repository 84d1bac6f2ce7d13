"""Dynamic per-(model, species) confidence thresholds.

Reference: internal/analysis/processor/dynamic_threshold.go:49-518 —
approved detections above the trigger confidence (default 0.90)
progressively lower that species' threshold through levels 1-3
(multipliers 0.75/0.50/0.25 of the model-global base), clamped to `min`
(default 0.20). Semantics mirrored exactly:

- The level follows the high-confidence count: 1st → level 1, 2nd →
  level 2, 3rd+ → level 3 (maximum).
- A learning COOLDOWN of (export length − pre-capture, min 5 s) prevents
  multiple learnings within one detection window; the expiry timer is
  still extended by every approved high-confidence detection.
- On expiry the state resets fully to level 0 (not a gradual decay).
- Species with a USER-CONFIGURED threshold are exempt: adjust() returns
  the custom value unchanged and learn() refuses to learn for them.
- Level changes emit threshold events (reason "high_confidence" or
  "expiry") for persistence/UI (recordThresholdEvent, BG-59).

A copy of ``birdnet_go_tpu/analysis/dynamic_threshold.py`` for the port,
which imports nothing of the JAX package;
``tests/test_torch_detection.py`` holds it to the original.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

_LEVEL_MULTIPLIER = {0: 1.0, 1: 0.75, 2: 0.5, 3: 0.25}
_MAX_LEVEL = 3
_MIN_COOLDOWN_SECONDS = 5.0


@dataclasses.dataclass
class ThresholdState:
    level: int = 0
    high_conf_count: int = 0
    expires_at: float = 0.0         # unix time; 0 = never armed
    last_learned_at: float = 0.0    # learning-cooldown anchor

    def current_multiplier(self) -> float:
        return _LEVEL_MULTIPLIER[self.level]


@dataclasses.dataclass(frozen=True)
class ThresholdEvent:
    """One level transition (datastore.ThresholdEvent analogue)."""

    model_id: str
    scientific: str
    previous_level: int
    new_level: int
    previous_value: float
    new_value: float
    reason: str                     # "high_confidence" | "expiry"
    confidence: float
    timestamp: float


class DynamicThresholds:
    """Thread-safe learned-threshold store keyed (model_id, scientific)."""

    def __init__(self, trigger: float = 0.90, floor: float = 0.20,
                 valid_hours: float = 24.0,
                 learning_cooldown_seconds: float = 12.0,
                 on_event: Callable[[ThresholdEvent], None] | None = None):
        self.trigger = trigger
        self.floor = floor
        self.valid_seconds = valid_hours * 3600.0
        self.learning_cooldown = max(learning_cooldown_seconds,
                                     _MIN_COOLDOWN_SECONDS)
        self.on_event = on_event
        self._state: dict[tuple[str, str], ThresholdState] = {}
        self._lock = threading.Lock()

    def _emit(self, model_id: str, scientific: str, prev_level: int,
              new_level: int, prev_value: float, new_value: float,
              reason: str, confidence: float, now: float) -> None:
        if self.on_event is None or prev_level == new_level:
            return
        try:
            self.on_event(ThresholdEvent(
                model_id=model_id, scientific=scientific,
                previous_level=prev_level, new_level=new_level,
                previous_value=prev_value, new_value=new_value,
                reason=reason, confidence=confidence, timestamp=now))
        except Exception:   # event sink must never break the hot path
            pass

    def adjust(self, base_threshold: float, model_id: str, scientific: str,
               now: float | None = None, is_custom: bool = False) -> float:
        """Effective threshold for a species. A user-configured (custom)
        threshold is returned unchanged (getAdjustedConfidenceThreshold)."""
        if is_custom:
            return base_threshold
        now = time.time() if now is None else now
        with self._lock:
            st = self._state.get((model_id, scientific))
            if st is None:
                return base_threshold
            if now > st.expires_at and (st.level > 0
                                        or st.high_conf_count > 0):
                prev_level = st.level
                prev_value = max(self.floor,
                                 base_threshold * st.current_multiplier())
                st.level = 0
                st.high_conf_count = 0
                st.last_learned_at = 0.0
                self._emit(model_id, scientific, prev_level, 0, prev_value,
                           base_threshold, "expiry", 0.0, now)
            if st.level == 0:
                if st.high_conf_count == 0:
                    # fully-reset entries are dropped — the map must not
                    # grow without bound over months of expiries
                    self._state.pop((model_id, scientific), None)
                return base_threshold
            return max(self.floor, base_threshold * st.current_multiplier())

    def learn(self, confidence: float, model_id: str, scientific: str,
              now: float | None = None, is_custom: bool = False,
              base_threshold: float = 1.0) -> None:
        """LearnFromApprovedDetection: approved detections STRICTLY above
        the trigger raise the level (1st→1, 2nd→2, 3rd+→3); the expiry
        timer always extends, but the level only moves once per learning
        cooldown (one detection window)."""
        if confidence <= self.trigger or is_custom:
            return
        now = time.time() if now is None else now
        with self._lock:
            st = self._state.setdefault((model_id, scientific),
                                        ThresholdState())
            prev_level = st.level
            st.expires_at = now + self.valid_seconds
            if st.high_conf_count > 0 and \
                    now - st.last_learned_at < self.learning_cooldown:
                return
            st.high_conf_count += 1
            st.last_learned_at = now
            st.level = min(_MAX_LEVEL, st.high_conf_count)
            self._emit(model_id, scientific, prev_level, st.level,
                       max(self.floor,
                           base_threshold * _LEVEL_MULTIPLIER[prev_level]),
                       max(self.floor,
                           base_threshold * _LEVEL_MULTIPLIER[st.level]),
                       "high_confidence", confidence, now)

    def snapshot(self) -> dict[tuple[str, str], ThresholdState]:
        with self._lock:
            return {k: dataclasses.replace(v) for k, v in self._state.items()}

    def restore(self, state: dict[tuple[str, str], ThresholdState]) -> None:
        with self._lock:
            self._state = {k: dataclasses.replace(v)
                           for k, v in state.items()}

    def stats(self) -> dict:
        """Aggregate view for GET /dynamic-thresholds/stats."""
        with self._lock:
            by_level: dict[int, int] = {}
            for st in self._state.values():
                by_level[st.level] = by_level.get(st.level, 0) + 1
            return {
                "species_tracked": len(self._state),
                "by_level": {str(k): v for k, v in sorted(by_level.items())},
                "trigger": self.trigger,
                "floor": self.floor,
                "valid_hours": self.valid_seconds / 3600.0,
            }

    def entries(self) -> list[dict]:
        """Per-species view for GET /dynamic-thresholds."""
        with self._lock:
            return [{
                "model_id": k[0], "scientific_name": k[1],
                "level": v.level, "high_conf_count": v.high_conf_count,
                "multiplier": v.current_multiplier(),
                "expires_at": v.expires_at,
            } for k, v in sorted(self._state.items())]

    def clear(self, model_id: str | None = None,
              scientific: str | None = None) -> int:
        """Remove learned state (API: DELETE /dynamic-thresholds[/:species])."""
        with self._lock:
            keys = [k for k in self._state
                    if (model_id is None or k[0] == model_id)
                    and (scientific is None or k[1] == scientific)]
            for k in keys:
                del self._state[k]
            return len(keys)
