"""Realtime detection processor: filter stack, cross-model consensus,
Deep Detection, and the flush loop.

Reference: internal/analysis/processor/processor.go — the single consumer
of the results queue. Per result: canonicalize species, record human/dog
detections, exclusion list, per-species > per-model > global thresholds
with dynamic-threshold adjustment, range-filter inclusion; then merge into
a pending map keyed "sourceID:scientificName" carrying per-model
contributions (cross-model consensus). A 1 s flusher approves items whose
total count reaches minDetections by FlushDeadline and runs their actions.

Timing model (Appendix C of SURVEY.md): FlushDeadline = firstSeen +
(Export.Length − PreCapture); privacy filter discards when a human
vocalization was heard at-or-after the detection start (>= semantics,
processor.go:1504-1510).

A copy of ``birdnet_go_tpu/analysis/processor.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_detection.py``
holds it to the original.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import logging
import threading
import time
from typing import Callable

import numpy as np

from birdnet_go_tpu_torch.analysis import deep_detection
from birdnet_go_tpu_torch.analysis.dynamic_threshold import DynamicThresholds
from birdnet_go_tpu_torch.analysis.results import Detection
from birdnet_go_tpu_torch.config.settings import Settings
from birdnet_go_tpu_torch.taxonomy.labels import LabelSet, Species
from birdnet_go_tpu_torch.utils import tracing

log = logging.getLogger("birdnet_tpu.processor")


@dataclasses.dataclass
class WindowPrediction:
    """One model's post-processed output for one stream window (the queue
    element between scheduler and processor — classifier.Results analogue)."""

    source_id: str
    model_id: str
    start_time: float                 # unix seconds of window start
    end_time: float
    indices: list[int]
    confidences: list[float]
    # Window PCM (fresh array per window — the reference's deep copy at
    # process.go:388-396); feeds clip-export fallback when the
    # CaptureBuffer has lost the span.
    pcm: "object" = None              # np.ndarray | None
    pcm_rate: int = 0
    # Ultrasonic-band CV computed on device for raw-rate (bat) models;
    # None for ordinary models (processor.go:881-893).
    ultrasonic_cv: float | None = None


@dataclasses.dataclass
class ModelContribution:
    model_id: str
    count: int = 0
    max_confidence: float = 0.0


@dataclasses.dataclass
class PendingDetection:
    detection: Detection              # best-so-far
    source_id: str
    first_detected: float
    flush_deadline: float
    count: int = 0
    last_updated: float = 0.0         # most recent contributing window
    # extended capture (extended_capture.go): one long clip per calling
    # session, scaled flush deadline capped by max_deadline
    extended: bool = False
    max_deadline: float = 0.0
    contributions: dict[str, ModelContribution] = dataclasses.field(
        default_factory=dict)
    # PCM of the first contributing window (clip-export fallback when the
    # CaptureBuffer ring has already overwritten the detection span).
    pcm: "object" = None              # np.ndarray | None
    pcm_rate: int = 0
    # full top-K of the window holding the best confidence, decoded to
    # (scientific, common, confidence) — persisted as the detection's
    # secondary results (reference: Note.Results, datastore/model.go)
    topk: list = dataclasses.field(default_factory=list)

    @property
    def best_model_id(self) -> str:
        if not self.contributions:
            return self.detection.model_id
        return max(self.contributions.values(),
                   key=lambda c: c.max_confidence).model_id


@dataclasses.dataclass
class ProcessorStats:
    results_processed: int = 0
    detections_filtered: int = 0
    detections_pending: int = 0
    detections_approved: int = 0
    detections_discarded: int = 0
    discard_reasons: dict[str, int] = dataclasses.field(default_factory=dict)


def _raw_label(sp: Species) -> str:
    """Reconstruct the raw model label. Species.parse splits on the first
    underscore, so single-word FSD50K classes ("Growling") have an empty
    common part — sp.label would add a spurious trailing underscore."""
    return sp.label if sp.common else sp.scientific


# Perch v2 dog sound classes + the domestic dog taxon. Wild canids (wolf,
# coyote) stay detectable as wildlife (reference: perchDogLabels,
# vocalization_labels.go:72-77 — "Growling" is the AudioSet child of Dog).
_DOG_LABELS = frozenset({"dog", "bark", "growling", "canis familiaris"})


def _is_human(sp: Species) -> bool:
    """Human-vocalization classes drive the privacy filter. Matches the
    RAW label like the reference (vocalization_labels.go): BirdNET's
    locale-stable "Human ..." English prefix (trailing space is
    load-bearing — the cicada "Pacarina schumanni" contains "human"),
    Perch's FSD50K speech classes via the nonbird taxonomy, and the
    iNaturalist taxon "homo sapiens"."""
    from birdnet_go_tpu_torch.taxonomy import nonbird

    raw = _raw_label(sp)
    if nonbird.category_of(raw) == nonbird.HUMAN:
        return True
    lowered = raw.lower()
    if lowered == "homo sapiens" or sp.scientific.lower() == "homo sapiens":
        return True
    return lowered.startswith("human ")


def _is_dog(sp: Species) -> bool:
    """Dog-bark-filter classes, matched on the RAW label: Perch classes
    exactly (incl. "Growling"), BirdNET's "Dog_<common>" by the "dog_"
    prefix (the underscore excludes the katydid "Poecilimon doga")."""
    lowered = _raw_label(sp).lower()
    if lowered in _DOG_LABELS or sp.scientific.lower() in _DOG_LABELS:
        return True
    return lowered.startswith("dog_")


class Processor:
    """Single-consumer detection engine (thread-safe submit/flush)."""

    def __init__(self, settings: Settings,
                 labels_by_model: dict[str, LabelSet],
                 on_approved: Callable[[Detection, PendingDetection], None]
                 | None = None,
                 included_species: set[str] | None = None,
                 clock: Callable[[], float] = time.time):
        self.settings = settings
        self.labels_by_model = labels_by_model
        self.on_approved = on_approved
        self.clock = clock
        # range filter included set: scientific names; None = filter inactive
        self.included_species = included_species
        # Learning cooldown = one detection window (export length −
        # pre-capture, min 5 s) so a single event can't raise the level
        # multiple times (dynamic_threshold.go LearnFromApprovedDetection).
        self.dynamic = DynamicThresholds(
            trigger=settings.dynamic_threshold.trigger,
            floor=settings.dynamic_threshold.min,
            valid_hours=settings.dynamic_threshold.valid_hours,
            learning_cooldown_seconds=(settings.export.clip_length_seconds
                                       - settings.export.pre_capture_seconds))
        self._pending: dict[str, PendingDetection] = {}
        # (config object, lowercased copy) — see _base_threshold
        self._species_cfg_cache: tuple[dict, dict] | None = None
        # model_id -> (fingerprint, thr[S], nonspecial[S]) — see _fast_gate
        self._gate_cache: dict[str, tuple] = {}
        # pending-broadcast hook (pending_broadcast.go): called with the
        # serializable snapshot whenever it CHANGES (deduplicated)
        self.on_pending: Callable[[list[dict]], None] | None = None
        self._last_pending_sig: tuple = ()
        self._last_human: dict[str, float] = {}
        self._last_dog: dict[str, float] = {}
        self._lock = threading.Lock()
        self.stats = ProcessorStats()
        self._model_settings = {m.model_id: m for m in settings.models}
        self._extended_all = False
        self._extended_species: frozenset[str] = frozenset()
        self._daylight_species: frozenset[str] = frozenset()
        self.rebuild_extended_capture()
        self.rebuild_daylight_filter()

    # -- configuration lookups -------------------------------------------------

    @staticmethod
    def _name_variants(sp: Species) -> list[str]:
        """Every name a user/config may know this species by: canonical
        scientific, label, common, and LEGACY taxonomy aliases (detections
        are canonicalized at submit, but configs/range sets may still use
        the old names — openfauna reverse map)."""
        from birdnet_go_tpu_torch.taxonomy.openfauna import legacy_names_for

        names = [sp.scientific, sp.label, sp.common]
        names += legacy_names_for(sp.scientific)
        return names

    def _base_threshold(self, model_id: str, sp: Species
                        ) -> tuple[float, bool]:
        """(threshold, is_custom). A user-configured per-species threshold
        is custom — dynamic adjustment never applies to it."""
        cfg = self.settings.species.config
        # per-detection hot path: lowercase the user config once per
        # config object, not per call. Keyed by identity WITH a strong
        # reference retained (a bare id() could collide when a freed
        # dict's address is reused by the reload's replacement).
        cached = self._species_cfg_cache
        if cached is not None and cached[0] is cfg:
            cfg_l = cached[1]
        else:
            cfg_l = {k.lower(): v for k, v in cfg.items()} if cfg else {}
            self._species_cfg_cache = (cfg, cfg_l)
        for name in self._name_variants(sp):
            sc = cfg.get(name) or cfg_l.get(name.lower())
            if sc and "threshold" in sc:
                return float(sc["threshold"]), True
        ms = self._model_settings.get(model_id)
        if ms is not None:
            return ms.threshold, False
        return 0.8, False

    def effective_threshold(self, model_id: str, sp: Species,
                            now: float | None = None) -> float:
        base, is_custom = self._base_threshold(model_id, sp)
        if self.settings.dynamic_threshold.enabled:
            return self.dynamic.adjust(base, model_id, sp.scientific,
                                       now=now or self.clock(),
                                       is_custom=is_custom)
        return base

    def _deep_detection_params(self, model_id: str) -> tuple[int, float]:
        """(level, overlap) for minDetections — bat models use bat_level
        (false_positive_filter.go separate bat config)."""
        level = self.settings.deep_detection.level
        if "bat" in model_id.lower():
            level = self.settings.deep_detection.bat_level
        ms = self._model_settings.get(model_id)
        overlap = ms.overlap if ms else 0.0
        return level, overlap

    # -- ingest ------------------------------------------------------------------

    def _fast_gate(self, model_id: str, labels: "LabelSet"):
        """Per-species minimum-actionable-confidence array for the
        vectorized submit_batch gate.

        thr[i] = the lowest confidence at which a result for species i can
        have ANY observable effect: privacy floor for human classes, dog
        floor for dog classes, the custom threshold for user-configured
        species (dynamic adjustment never applies to those), and
        min(model base threshold, dynamic floor) otherwise. nonspecial[i]
        marks classes whose sub-threshold results increment
        detections_filtered in the scalar path (human/dog return early
        without counting). Cached per model; rebuilt when the relevant
        settings change (same identity-keyed convention as
        _species_cfg_cache)."""
        from birdnet_go_tpu_torch.taxonomy.openfauna import canonical_name

        ms = self._model_settings.get(model_id)
        base = ms.threshold if ms is not None else 0.8
        dyn = self.settings.dynamic_threshold.enabled
        cfg = self.settings.species.config
        # identity-keyed fingerprint — the cache entry RETAINS the cfg and
        # labels objects (last tuple element) so a freed dict's reused
        # address can never alias a stale entry (same hazard the
        # _species_cfg_cache comment documents)
        fp = (id(labels), len(labels), base, dyn, self.dynamic.floor,
              self.settings.privacy_filter.confidence,
              self.settings.dog_bark_filter.confidence,
              id(cfg), len(cfg or ()))
        cached = self._gate_cache.get(model_id)
        if cached is not None and cached[0] == fp:
            return cached[1], cached[2]
        default_thr = min(base, self.dynamic.floor) if dyn else base
        thr = np.full(len(labels), default_thr, np.float32)
        nonspecial = np.ones(len(labels), bool)
        for i, sp in enumerate(labels):
            # mirror submit(): species are canonicalized BEFORE any
            # threshold/human/dog decision, so legacy-label models hit
            # the same per-species config entries as the scalar path
            canon = canonical_name(sp.scientific)
            if canon != sp.scientific:
                sp = Species(canon, sp.common)
            if _is_human(sp):
                thr[i] = self.settings.privacy_filter.confidence
                nonspecial[i] = False
            elif _is_dog(sp):
                thr[i] = self.settings.dog_bark_filter.confidence
                nonspecial[i] = False
            else:
                b, is_custom = self._base_threshold(model_id, sp)
                if is_custom:
                    thr[i] = b
        self._gate_cache[model_id] = (fp, thr, nonspecial, (labels, cfg))
        return thr, nonspecial

    def prewarm(self, model_id: str | None = None) -> None:
        """Build the per-model fast gates and force the lazy taxonomy
        tables (openfauna aliases, nonbird categories) BEFORE live
        traffic: the first _fast_gate over a 6,522-label set costs
        seconds on small hosts, and paying it inside the first harvested
        batch stalls the device loop long enough to clobber ingest rings
        (observed: ~10 s freeze at 5,000 streams). Application.start and
        the soak call this ahead of stream start."""
        from birdnet_go_tpu_torch.taxonomy.openfauna import canonical_name

        canonical_name("Turdus merula")
        for mid, labels in self.labels_by_model.items():
            if model_id is None or mid == model_id:
                self._fast_gate(mid, labels)

    def submit_batch(self, model_id: str, source_ids, start_times,
                     end_times, confidences, indices,
                     ultrasonic_cv=None) -> int:
        """Vectorized processResults over one harvested device batch.

        Behaviorally identical to calling submit() per window — windows
        with at least one actionable result (per-species gate above) go
        through the exact scalar path; the rest are accounted in bulk
        (results_processed per window, detections_filtered per valid
        non-human/non-dog result, ultrasonic-filter discards per window)
        without building any per-result Python objects. This is what
        keeps the host plane off the floor at thousands of streams
        (reference processes per-result in Go, process.go:423-470; the
        Python-native equivalent of 'fast' is numpy over the batch).
        Returns how many windows took the scalar path."""
        with tracing.span("submit.batch"):
            n_scalar = self._submit_batch(model_id, source_ids, start_times,
                                          end_times, confidences, indices,
                                          ultrasonic_cv)
        tracing.count("submit.scalar_rows", n_scalar)
        return n_scalar

    def _submit_batch(self, model_id, source_ids, start_times, end_times,
                      confidences, indices, ultrasonic_cv) -> int:
        labels = self.labels_by_model.get(model_id)
        if labels is None:
            log.warning("no labels for model %s", model_id)
            return 0
        vals = np.asarray(confidences, np.float32)
        idx = np.asarray(indices)
        n = len(vals)
        if n == 0:
            return 0
        thr, nonspecial = self._fast_gate(model_id, labels)
        us = self.settings.ultrasonic_filter
        if us.enabled and ultrasonic_cv is not None:
            us_fail = np.asarray(ultrasonic_cv, np.float32) \
                < us.cv_threshold
        else:
            us_fail = np.zeros(n, bool)
        valid = (idx >= 0) & (idx < len(labels))
        safe = np.clip(idx, 0, len(labels) - 1)
        act = valid & (vals >= thr[safe])
        row_scalar = act.any(axis=1) & ~us_fail
        skip_rows = ~row_scalar & ~us_fail
        filtered_bulk = int((valid & nonspecial[safe]
                             & skip_rows[:, None]).sum())
        n_us = int(us_fail.sum())
        n_scalar = int(row_scalar.sum())
        with self._lock:
            self.stats.results_processed += n - n_scalar
            self.stats.detections_filtered += filtered_bulk + n_us
            if n_us:
                self.stats.discard_reasons["ultrasonic filter"] = \
                    self.stats.discard_reasons.get("ultrasonic filter",
                                                   0) + n_us
        for r in np.flatnonzero(row_scalar):
            self.submit(WindowPrediction(
                source_id=source_ids[r], model_id=model_id,
                start_time=float(start_times[r]),
                end_time=float(end_times[r]),
                indices=idx[r].tolist(),
                confidences=vals[r].tolist(),
                ultrasonic_cv=(float(ultrasonic_cv[r])
                               if ultrasonic_cv is not None else None)))
        return n_scalar

    def submit(self, pred: WindowPrediction) -> None:
        """Process one window's top-K results (processResults analogue)."""
        labels = self.labels_by_model.get(pred.model_id)
        if labels is None:
            log.warning("no labels for model %s", pred.model_id)
            return
        with self._lock:
            self.stats.results_processed += 1
        # Ultrasonic CV validation (applyUltrasonicFilter,
        # processor.go:881-893): a raw-rate window whose ultrasonic-band
        # energy is too steady is broadband noise, not bat calls — every
        # detection in the window is unlikely and discarded.
        us = self.settings.ultrasonic_filter
        if us.enabled and pred.ultrasonic_cv is not None \
                and pred.ultrasonic_cv < us.cv_threshold:
            with self._lock:
                self.stats.detections_filtered += 1
                self.stats.discard_reasons["ultrasonic filter"] = \
                    self.stats.discard_reasons.get("ultrasonic filter", 0) + 1
            return
        from birdnet_go_tpu_torch.taxonomy.openfauna import canonical_name

        for conf, idx in zip(pred.confidences, pred.indices):
            if idx < 0 or idx >= len(labels):
                continue
            sp = labels[idx]
            # Canonicalize legacy taxonomy (openfauna aliases) so models
            # trained on different label vintages merge into ONE pending
            # entry (cross-model consensus keys on scientific name).
            canon = canonical_name(sp.scientific)
            if canon != sp.scientific:
                sp = Species(canon, sp.common)
            self._process_one(pred, sp, float(conf), labels)

    def _process_one(self, pred: WindowPrediction, sp: Species,
                     conf: float, labels: LabelSet) -> None:
        now_detect = pred.start_time
        # Human/dog bookkeeping happens before any filtering so privacy
        # state updates even for sub-threshold hits above their own floors.
        if _is_human(sp):
            if conf >= self.settings.privacy_filter.confidence:
                with self._lock:
                    prev = self._last_human.get(pred.source_id, 0.0)
                    self._last_human[pred.source_id] = max(prev, now_detect)
            return                      # never stored as a bird detection
        if _is_dog(sp):
            if conf >= self.settings.dog_bark_filter.confidence:
                with self._lock:
                    prev = self._last_dog.get(pred.source_id, 0.0)
                    self._last_dog[pred.source_id] = max(prev, now_detect)
            return

        if self._should_filter(pred.model_id, sp, conf):
            with self._lock:
                self.stats.detections_filtered += 1
            return
        self._merge_pending(pred, sp, conf, labels)

    def _should_filter(self, model_id: str, sp: Species, conf: float) -> bool:
        names = self._name_variants(sp)
        # exclusion list (config species.exclude; any known name matches)
        excl = self.settings.species.exclude
        if excl and any(n in excl for n in names):
            return True
        if conf < self.effective_threshold(model_id, sp):
            return True
        # range filter inclusion (config include list always passes)
        if any(n in self.settings.species.include for n in names):
            return False
        if self.included_species is not None \
                and not any(n in self.included_species for n in names):
            return True
        return False

    def _merge_pending(self, pred: WindowPrediction, sp: Species,
                       conf: float, labels: LabelSet = None) -> None:
        key = f"{pred.source_id}:{sp.scientific}"
        exp = self.settings.export
        with self._lock:
            item = self._pending.get(key)
            if item is None:
                det = Detection(
                    species=sp, confidence=conf,
                    begin_seconds=0.0, end_seconds=0.0,
                    model_id=pred.model_id, source_id=pred.source_id,
                    species_code="")
                # non-negative window (processor.go:690-691): pre_capture
                # larger than clip length must not create already-past
                # deadlines that flush-and-discard every detection
                deadline = pred.start_time + max(
                    0.0, exp.clip_length_seconds - exp.pre_capture_seconds)
                item = PendingDetection(
                    detection=det, source_id=pred.source_id,
                    first_detected=pred.start_time, flush_deadline=deadline,
                    pcm=pred.pcm, pcm_rate=pred.pcm_rate)
                self._pending[key] = item
                self.stats.detections_pending += 1
            item.count += 1
            item.last_updated = max(item.last_updated, pred.start_time)
            if self._is_extended_species(sp.scientific):
                ec = self.settings.extended_capture
                if not item.extended:
                    item.extended = True
                    item.max_deadline = item.first_detected \
                        + ec.max_duration_seconds
                normal_window = max(0.0, exp.clip_length_seconds
                                    - exp.pre_capture_seconds)
                # monotonic: an out-of-order window (slower model's later
                # submit with an earlier start) must not move the
                # deadline backwards and truncate the session
                item.flush_deadline = max(
                    item.flush_deadline,
                    self._extended_deadline(pred.start_time, item,
                                            normal_window))
            c = item.contributions.setdefault(
                pred.model_id, ModelContribution(model_id=pred.model_id))
            c.count += 1
            if conf > c.max_confidence:
                c.max_confidence = conf
            improved = conf > item.detection.confidence
            if improved:
                item.detection.confidence = conf
                item.detection.model_id = pred.model_id
            if labels is not None and (improved or not item.topk):
                # decode the best window's top-K (Note.Results parity)
                item.topk = [
                    (labels[i].scientific, labels[i].common, float(c))
                    for c, i in zip(pred.confidences, pred.indices)
                    if 0 <= i < len(labels)]

    # -- extended capture (extended_capture.go) -----------------------------------

    # scaled-timeout thresholds (extended_capture.go:14-20)
    _EXT_MIN_INITIAL = 15.0
    _EXT_MEDIUM_THRESHOLD = 30.0
    _EXT_MEDIUM_WAIT = 30.0
    _EXT_LONG_THRESHOLD = 120.0
    _EXT_LONG_WAIT = 60.0

    def rebuild_extended_capture(self) -> None:
        """Resolve the extended-capture species filter against the loaded
        label union (RebuildExtendedCaptureFilter; config entries may be
        scientific names, common names, or openfauna aliases)."""
        ec = getattr(self.settings, "extended_capture", None)
        if ec is None or not ec.enabled:
            self._extended_all = False
            self._extended_species = frozenset()
            return
        if not ec.species:
            self._extended_all = True
            self._extended_species = frozenset()
            return
        sci_names = set()
        common_to_sci = {}
        for labels in self.labels_by_model.values():
            for sp in labels.species:
                sci_names.add(sp.scientific.lower())
                if sp.common:
                    common_to_sci[sp.common.lower()] = sp.scientific.lower()
        from birdnet_go_tpu_torch.taxonomy.openfauna import canonical_name

        resolved = set()
        # detections are canonicalized at submit(), so the filter must
        # hold CANONICAL names even when resolved from legacy labels
        for entry in ec.species:
            e = entry.strip().lower()
            if e in sci_names:
                resolved.add(canonical_name(entry.strip()).lower())
            elif e in common_to_sci:
                resolved.add(canonical_name(common_to_sci[e]).lower())
            else:
                canon = canonical_name(entry).lower()
                if canon in sci_names:
                    resolved.add(canon)
                else:
                    log.warning("extended-capture species %r not resolved",
                                entry)
        self._extended_all = False
        self._extended_species = frozenset(resolved)

    def rebuild_daylight_filter(self) -> None:
        """Resolve the daylight-filter species list against the loaded
        label union (daylight_filter.go initDaylightFilter). An EMPTY
        list filters nothing — the exclusionary-filter contract: the
        reference overrides resolveSpeciesFilter's match-all default
        here, with a warning."""
        df = getattr(self.settings, "daylight_filter", None)
        self._daylight_species = frozenset()
        if df is None or not df.enabled:
            return
        if self.settings.location.latitude is None:
            log.warning("daylight filter enabled but location not "
                        "configured; filter inactive")
            return
        if not df.species:
            log.warning("daylight filter has empty species list; "
                        "no species will be filtered")
            return
        sci_names = set()
        common_to_sci = {}
        for labels in self.labels_by_model.values():
            for sp in labels.species:
                sci_names.add(sp.scientific.lower())
                if sp.common:
                    common_to_sci[sp.common.lower()] = sp.scientific.lower()
        from birdnet_go_tpu_torch.taxonomy.openfauna import canonical_name

        resolved = set()
        for entry in df.species:
            e = entry.strip().lower()
            if e in sci_names:
                resolved.add(canonical_name(entry.strip()).lower())
            elif e in common_to_sci:
                resolved.add(canonical_name(common_to_sci[e]).lower())
            else:
                canon = canonical_name(entry).lower()
                if canon in sci_names:
                    resolved.add(canon)
                else:
                    log.warning("daylight-filter species %r not resolved",
                                entry)
        self._daylight_species = frozenset(resolved)

    def _is_extended_species(self, scientific: str) -> bool:
        ec = getattr(self.settings, "extended_capture", None)
        if ec is None or not ec.enabled:
            return False
        return self._extended_all             or scientific.lower() in self._extended_species

    def _extended_deadline(self, now: float, item: PendingDetection,
                           normal_window: float) -> float:
        """calculateExtendedFlushDeadline: short sessions wait
        max(normal window, 15 s); medium (30 s-2 m) wait 30 s; long
        wait 60 s — always capped at max_deadline."""
        session = now - item.first_detected
        if session < self._EXT_MEDIUM_THRESHOLD:
            deadline = now + max(normal_window, self._EXT_MIN_INITIAL)
        elif session < self._EXT_LONG_THRESHOLD:
            deadline = now + self._EXT_MEDIUM_WAIT
        else:
            deadline = now + self._EXT_LONG_WAIT
        return min(deadline, item.max_deadline)

    # -- flush --------------------------------------------------------------------

    def flush(self, now: float | None = None) -> list[Detection]:
        """One flush cycle: approve/discard items past their deadline.
        Returns approved detections (actions already dispatched)."""
        with tracing.span("flush"):
            return self._flush(now)

    def _flush(self, now: float | None) -> list[Detection]:
        now = self.clock() if now is None else now
        approved: list[tuple[Detection, PendingDetection]] = []
        with self._lock:
            due = [(k, v) for k, v in self._pending.items()
                   if now > v.flush_deadline]
            for key, item in due:
                del self._pending[key]
                discard, reason = self._should_discard(item)
                if discard:
                    self.stats.detections_discarded += 1
                    self.stats.discard_reasons[reason] = \
                        self.stats.discard_reasons.get(reason, 0) + 1
                    continue
                self.stats.detections_approved += 1
                d = item.detection
                # realtime mode: begin/end carry unix wall-clock of the
                # detection span (clip extraction reads the CaptureBuffer
                # by wall-clock — buffer/capture.go:198 ReadSegment)
                d.timestamp = _dt.datetime.fromtimestamp(item.first_detected)
                d.begin_seconds = item.first_detected
                if item.extended:
                    # normalizeDetectionTimes: the clip spans the whole
                    # calling session (last hit + normal window)
                    exp = self.settings.export
                    d.end_seconds = item.last_updated + max(
                        0.0, exp.clip_length_seconds
                        - exp.pre_capture_seconds)
                else:
                    d.end_seconds = item.flush_deadline
                approved.append((d, item))
        for d, item in approved:
            if self.settings.dynamic_threshold.enabled:
                base, is_custom = self._base_threshold(d.model_id, d.species)
                self.dynamic.learn(d.confidence, d.model_id,
                                   d.species.scientific, now=now,
                                   is_custom=is_custom, base_threshold=base)
            if self.on_approved is not None:
                try:
                    self.on_approved(d, item)
                except Exception:
                    log.exception("on_approved failed for %s", d.label)
        return [d for d, _ in approved]

    def _should_discard(self, item: PendingDetection) -> tuple[bool, str]:
        """shouldDiscardDetection: minDetections, privacy, dog bark.

        (Daylight filter hooks in via analysis.suncalc once present.)
        Caller holds self._lock.
        """
        level, overlap = self._deep_detection_params(item.best_model_id)
        required = deep_detection.min_detections(level, overlap)
        if item.count < required:
            return True, f"false positive, matched {item.count}/{required} times"
        if self.settings.privacy_filter.enabled:
            last_human = self._last_human.get(item.source_id)
            # >= semantics: equal timestamps still trip the filter
            # (processor.go:1504-1510)
            if last_human is not None and last_human >= item.first_detected:
                return True, "privacy filter"
        if self.settings.dog_bark_filter.enabled:
            last_dog = self._last_dog.get(item.source_id)
            if last_dog is not None:
                window = self.settings.dog_bark_filter.remember_minutes * 60.0
                if item.first_detected - last_dog < window:
                    return True, "recent dog bark"
        df = self.settings.daylight_filter
        if df.enabled and self._daylight_species \
                and self.settings.location.latitude is not None:
            # reference semantics (daylight_filter.go checkDaylightFilter):
            # only LISTED (nocturnal) species are filtered, and they are
            # discarded when detected DURING the daylight window — a noon
            # owl is a likely misidentification. Fails open on sun-math
            # errors.
            sp = item.detection.species
            if sp.scientific.lower() in self._daylight_species:
                import datetime as _dtm

                from birdnet_go_tpu_torch.utils.suncalc import in_daylight_window

                when = _dtm.datetime.fromtimestamp(
                    item.first_detected, tz=_dtm.timezone.utc)
                try:
                    daylight = in_daylight_window(
                        when, self.settings.location.latitude,
                        self.settings.location.longitude, df.offset_hours)
                except Exception as e:
                    log.warning("daylight check failed (%s); allowing %s",
                                e, sp.scientific)
                    daylight = False
                if daylight:
                    return True, "daylight filter"
        return False, ""

    # -- introspection ---------------------------------------------------------------

    def pending_snapshot(self) -> list[PendingDetection]:
        with self._lock:
            return list(self._pending.values())

    def pending_as_dicts(self) -> list[dict]:
        """Serializable pending view (the SSE broadcast payload)."""
        with self._lock:
            return [{
                "scientific_name": it.detection.species.scientific,
                "common_name": it.detection.species.common,
                "source_id": it.source_id,
                "count": it.count,
                "confidence": round(it.detection.confidence, 4),
                "first_detected": it.first_detected,
                "flush_deadline": it.flush_deadline,
                "models": sorted(it.contributions),
            } for it in self._pending.values()]

    def broadcast_pending(self) -> bool:
        """Invoke on_pending when the snapshot changed since the last call
        (the reference broadcasts deduplicated snapshots on the flusher
        tick — pending_broadcast.go:173-251)."""
        if self.on_pending is None:
            return False
        snap = self.pending_as_dicts()
        sig = tuple(sorted((d["scientific_name"], d["source_id"],
                            d["count"]) for d in snap))
        if sig == self._last_pending_sig:
            return False
        self._last_pending_sig = sig
        try:
            self.on_pending(snap)
        except Exception:
            log.exception("pending broadcast failed")
        return True

    def set_included_species(self, included: set[str] | None) -> None:
        """Swap the range-filter inclusion set (rebuild_range_filter)."""
        with self._lock:
            self.included_species = included


class FlushLoop:
    """1 s flusher thread (pendingDetectionsFlusher, processor.go:1846)."""

    def __init__(self, processor: Processor, interval: float = 1.0):
        self.processor = processor
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="flusher",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.processor.flush()
                self.processor.broadcast_pending()
            except Exception:
                log.exception("flush cycle failed")
