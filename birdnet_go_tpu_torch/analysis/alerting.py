"""Alerting rules engine.

Reference: internal/alerting (2.8k LoC) — user-defined rules with
conditions (species match, confidence floor, time windows, sources,
novelty) and schedules, fed by detection events off the event bus, firing
through the notification dispatcher with per-rule rate limits; rule test
endpoint + firing history.

A copy of ``birdnet_go_tpu/analysis/alerting.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import fnmatch
import logging
import threading
import time
from typing import Any

log = logging.getLogger("birdnet_tpu.alerting")


@dataclasses.dataclass
class AlertRule:
    rule_id: str
    name: str
    enabled: bool = True
    # conditions (all must hold)
    species: list[str] = dataclasses.field(default_factory=list)
    # glob patterns against scientific or common name; empty = any species
    min_confidence: float = 0.0
    sources: list[str] = dataclasses.field(default_factory=list)
    only_new_species: bool = False
    # active window "HH:MM-HH:MM" local, empty = always
    active_window: str = ""
    # throttle
    min_interval_seconds: float = 300.0
    # action
    priority: str = "normal"
    message_template: str = "{common_name} detected ({confidence:.0%})"
    # -- system-metric rules (internal/monitor README: the monitor
    # publishes cpu/memory/disk samples; RULES evaluate thresholds) --
    # metric != "" makes this a metric rule; detection conditions above
    # are ignored for it. threshold is a percentage; sustained_seconds
    # requires the metric to stay above threshold for the whole window
    # (MetricTracker ring buffers); path qualifies disk rules to one
    # mount ("" = any). A recovery notice fires when the metric drops
    # back below after an alert.
    metric: str = ""                   # "cpu" | "memory" | "disk"
    threshold: float = 0.0             # percent
    sustained_seconds: float = 0.0
    path: str = ""


@dataclasses.dataclass
class AlertEvent:
    rule_id: str
    fired_at: float
    message: str
    detection: dict[str, Any]


class AlertingEngine:
    def __init__(self, notification_service=None,
                 clock=time.time):
        self.rules: dict[str, AlertRule] = {}
        self.notifications = notification_service
        self.clock = clock
        self.history: list[AlertEvent] = []
        self._last_fired: dict[str, float] = {}
        # per-(metric,path) sample rings for sustained-window evaluation
        # (alerting MetricTracker: path-qualified keys isolate per-disk
        # buffers) and per-(rule,path) alert state for recovery notices
        self._metric_samples: dict[tuple, list] = {}
        self._metric_alerting: dict[tuple, bool] = {}
        self._lock = threading.Lock()

    # -- rule management ---------------------------------------------------------

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self.rules[rule.rule_id] = rule

    def remove_rule(self, rule_id: str) -> bool:
        with self._lock:
            return self.rules.pop(rule_id, None) is not None

    def replace_rules(self, rules: list[AlertRule]) -> None:
        """Atomic swap used by the settings hot-reload path; throttle
        state (_last_fired) survives so edits don't re-fire alerts."""
        with self._lock:
            self.rules = {r.rule_id: r for r in rules}

    def list_rules(self) -> list[AlertRule]:
        with self._lock:
            return list(self.rules.values())

    # -- evaluation -----------------------------------------------------------------

    def matches(self, rule: AlertRule, detection: dict[str, Any],
                is_new_species: bool = False,
                now: float | None = None) -> bool:
        if not rule.enabled or rule.metric:
            return False
        if detection.get("confidence", 0.0) < rule.min_confidence:
            return False
        if rule.species:
            sci = detection.get("scientific_name", "")
            com = detection.get("common_name", "")
            if not any(fnmatch.fnmatch(sci, pat) or fnmatch.fnmatch(com, pat)
                       for pat in rule.species):
                return False
        if rule.sources and detection.get("source_id") not in rule.sources:
            return False
        if rule.only_new_species and not is_new_species:
            return False
        if rule.active_window:
            start_s, _, end_s = rule.active_window.partition("-")
            try:
                t = _dt.datetime.fromtimestamp(
                    now or self.clock()).time()
                sh, sm = map(int, start_s.strip().split(":"))
                eh, em = map(int, end_s.strip().split(":"))
                start, end = _dt.time(sh, sm), _dt.time(eh, em)
            except ValueError:
                return False
            inside = (start <= t < end) if start <= end \
                else (t >= start or t < end)
            if not inside:
                return False
        return True

    def on_detection(self, detection: dict[str, Any],
                     is_new_species: bool = False) -> list[AlertEvent]:
        """Evaluate every rule against a detection; fire matching ones."""
        now = self.clock()
        fired = []
        with self._lock:
            rules = list(self.rules.values())
        for rule in rules:
            if not self.matches(rule, detection, is_new_species, now):
                continue
            with self._lock:
                last = self._last_fired.get(rule.rule_id)
                if last is not None \
                        and now - last < rule.min_interval_seconds:
                    continue
                self._last_fired[rule.rule_id] = now
            try:
                msg = rule.message_template.format(**detection)
            except (KeyError, ValueError):
                msg = rule.message_template
            fired.append(self._fire(rule, msg, detection, now))
        return fired

    # -- system metrics (monitor → rules, internal/monitor README) --------------

    def publish_metric(self, metric: str, value: float,
                       path: str = "") -> list[AlertEvent]:
        """One resource sample (cpu/memory % or disk % for one mount).
        Metric rules matching it fire on threshold crossings; sustained
        rules require the whole window above threshold; a recovery
        notice is emitted when an alerting metric drops back below."""
        now = self.clock()
        key = (metric, path)
        with self._lock:
            ring = self._metric_samples.setdefault(key, [])
            ring.append((now, value))
            # keep 30 min of samples — longer than any sane sustained
            # window at the default 60 s poll interval
            cutoff = now - 1800.0
            while ring and ring[0][0] < cutoff:
                ring.pop(0)
            rules = [r for r in self.rules.values()
                     if r.enabled and r.metric == metric
                     and (not r.path or r.path == path)]
            samples = list(ring)
        fired = []
        for rule in rules:
            skey = (rule.rule_id, path)
            above = value >= rule.threshold
            if above and rule.sustained_seconds > 0:
                window = [v for t, v in samples
                          if t >= now - rule.sustained_seconds]
                oldest = samples[0][0] if samples else now
                # the window must be fully covered by samples AND every
                # sample in it above threshold
                above = (oldest <= now - rule.sustained_seconds
                         and all(v >= rule.threshold for v in window))
            with self._lock:
                was_alerting = self._metric_alerting.get(skey, False)
            if above:
                with self._lock:
                    last = self._last_fired.get(rule.rule_id)
                    if last is not None \
                            and now - last < rule.min_interval_seconds:
                        continue
                    self._last_fired[rule.rule_id] = now
                    self._metric_alerting[skey] = True
                label = f"{metric}{' ' + path if path else ''}"
                tpl = rule.message_template \
                    if "{metric" in rule.message_template \
                    or "{value" in rule.message_template \
                    else "{metric} at {value:.0f}% (threshold {threshold:.0f}%)"
                try:
                    msg = tpl.format(metric=label, value=value,
                                     threshold=rule.threshold, path=path)
                except (KeyError, ValueError):
                    msg = f"{label} at {value:.0f}%"
                fired.append(self._fire(rule, msg, {
                    "metric": metric, "value": value, "path": path}, now))
            elif was_alerting and value < rule.threshold:
                with self._lock:
                    self._metric_alerting[skey] = False
                label = f"{metric}{' ' + path if path else ''}"
                msg = (f"{label} recovered: {value:.0f}% "
                       f"(threshold {rule.threshold:.0f}%)")
                fired.append(self._fire(
                    rule, msg, {"metric": metric, "value": value,
                                "path": path, "recovered": True}, now,
                    priority="normal"))
        return fired

    def _fire(self, rule: AlertRule, msg: str, payload: dict[str, Any],
              now: float, priority: str | None = None) -> AlertEvent:
        ev = AlertEvent(rule_id=rule.rule_id, fired_at=now,
                        message=msg, detection=dict(payload))
        with self._lock:
            self.history.append(ev)
            if len(self.history) > 500:
                self.history = self.history[-500:]
        if self.notifications is not None:
            from birdnet_go_tpu_torch.integrations.notification import Notification

            self.notifications.notify(Notification(
                title=f"Alert: {rule.name}", message=msg,
                priority=priority or rule.priority, payload=payload))
        return ev

    def test_rule(self, rule_id: str,
                  sample: dict[str, Any] | None = None) -> bool:
        """Rule test endpoint: evaluate against a sample without firing."""
        with self._lock:
            rule = self.rules.get(rule_id)
        if rule is None:
            raise KeyError(rule_id)
        sample = sample or {
            "scientific_name": "Turdus merula",
            "common_name": "Eurasian Blackbird",
            "confidence": 0.95, "source_id": "test",
        }
        return self.matches(rule, sample, is_new_species=True)
