"""The port's detection stack against the JAX package's, on the CPU.

Each case runs once through the JAX package's modules and once through the
port's copies (``config/settings.py``, ``analysis/deep_detection.py``,
``dynamic_threshold.py``, ``processor.py``, ``jobqueue.py``,
``actions.py``, ``datastore/sqlite.py``, ``taxonomy/``, ``utils/suncalc.py``)
from the same inputs, with an injected clock, and records what it observes:
``flush(now)`` Detection lists field for field, discard reasons, the
processor's counters and pending map, dynamic-threshold snapshots and
events, job-queue counters, and every table of a datastore dumped in key
order. The two records must be equal. The cases are those of
``tests/test_processor.py`` (its event-tracker cases excepted: that module
is not ported), ``submit_batch`` on seeded top-10s of two models with
shared sources, and ``DatabaseAction`` into both datastores. The one
divergence is stated by its own test: the port's ``delete_detection``
recomputes the day's ``daily_events`` row, which JAX's leaves stale.
"""

import dataclasses
import datetime
import importlib
import sqlite3
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

PACKAGES = ("birdnet_go_tpu", "birdnet_go_tpu_torch")
M = "BirdNET_V2.4"


def _pkg(name: str) -> SimpleNamespace:
    mod = {k: importlib.import_module(f"{name}.{path}") for k, path in (
        ("processor", "analysis.processor"),
        ("deep", "analysis.deep_detection"),
        ("dynamic", "analysis.dynamic_threshold"),
        ("jobqueue", "analysis.jobqueue"),
        ("actions", "analysis.actions"),
        ("results", "analysis.results"),
        ("settings", "config.settings"),
        ("labels", "taxonomy.labels"),
        ("sqlite", "datastore.sqlite"),
        ("suncalc", "utils.suncalc"),
        ("nonbird", "taxonomy.nonbird"),
        ("openfauna", "taxonomy.openfauna"))}
    return SimpleNamespace(**mod)


J, T = _pkg(PACKAGES[0]), _pkg(PACKAGES[1])


def _plain(x):
    """A comparable value: dataclasses by class name and fields, dicts
    with sorted items, arrays as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return sorted((repr(_plain(k)), _plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _both(case, *args):
    """`case` through both packages: the two records, asserted equal."""
    want, got = case(J, *args), case(T, *args)
    assert _plain(got) == _plain(want)
    return got


# -- settings ----------------------------------------------------------------------

YAML = """
main:
  name: soak-node
birdnet:
  latitude: 60.17
  longitude: 24.94
models:
  - model_id: BirdNET_V2.4
    threshold: 0.7
    overlap: 1.5
  - model_id: Perch_V2
    threshold: 0.55
species:
  include: [Strix aluco]
  exclude: [Corvus corax]
  config:
    Pica pica: {threshold: 0.2}
privacy_filter:
  enabled: true
  confidence: 0.07
dynamic_threshold:
  enabled: true
  trigger: 0.92
deep_detection:
  level: 3
realtime:
  max_batch: 128
"""


def test_settings_defaults_equal_jax():
    assert dataclasses.asdict(T.settings.Settings()) == \
        dataclasses.asdict(J.settings.Settings())
    assert dataclasses.asdict(T.settings.default_settings()) == \
        dataclasses.asdict(J.settings.default_settings())


@pytest.mark.parametrize("with_file", [False, True])
def test_load_settings_file_and_env_equal_jax(with_file, tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(YAML)
    env = {"BIRDNET_TPU_DYNAMIC_THRESHOLD__MIN": "0.25",
           "BIRDNET_TPU_PRIVACY_FILTER__ENABLED": "false",
           "BIRDNET_TPU_BIRDNET__LATITUDE": "-33.9",
           "BIRDNET_TPU_REALTIME__MAX_BATCH": "64",
           "BIRDNET_TPU_DATA": "/nowhere",
           "BIRDNET_TPU_NO__SUCH": "x", "OTHER": "y"}
    src = str(path) if with_file else None
    got = T.settings.load_settings(src, env)
    want = J.settings.load_settings(src, env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got != T.settings.Settings()


def test_settings_reads_yaml_only_in_load_settings(tmp_path, monkeypatch):
    """Without yaml the module works; only reading a file raises."""
    path = tmp_path / "config.yaml"
    path.write_text(YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert T.settings.load_settings(None, {}) == T.settings.Settings()
    with pytest.raises(ImportError):
        T.settings.load_settings(path, {})


def test_settings_validation_equal_jax():
    """``validate`` returns the same warnings and clamps the same fields."""
    def case(pkg):
        s = pkg.settings.Settings()
        s.models[0].threshold = 1.5
        s.models[0].sensitivity = -1.0
        s.models[0].overlap = 3.5
        s.location.latitude, s.location.longitude = 95.0, 10.0
        s.deep_detection.level = 9
        s.extended_capture.enabled = True
        s.extended_capture.max_duration_seconds = 1e6
        s.extended_capture.capture_buffer_seconds = 10.0
        return {"warnings": s.validate(), "settings": dataclasses.asdict(s)}

    assert len(_both(case)["warnings"]) == 7


# -- deep detection ----------------------------------------------------------------

@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("overlap", [0.0, 1.5, 2.0, 2.2, 2.4, 2.7, 2.8, 2.95])
def test_min_detections_equal_jax(level, overlap):
    assert T.deep.min_detections(level, overlap) == \
        J.deep.min_detections(level, overlap)


# -- processor cases (tests/test_processor.py) ---------------------------------------

def _labels(pkg, extra=()):
    sp = pkg.labels.Species
    return pkg.labels.LabelSet(species=[
        sp("Turdus merula", "Eurasian Blackbird"),        # 0
        sp("Strix aluco", "Tawny Owl"),                   # 1
        sp("Human vocal", "Human vocal"),                 # 2
        sp("Canis familiaris", "Dog"),                    # 3
        sp("Parus major", "Great Tit"),                   # 4
        *[sp(*e) for e in extra]])


def _processor(pkg, sink=None, **overrides):
    s = pkg.settings.Settings()
    s.models = [pkg.settings.ModelSettings(model_id=M, threshold=0.5)]
    s.export.clip_length_seconds = 15.0
    s.export.pre_capture_seconds = 3.0
    for k, v in overrides.items():
        obj = s
        parts = k.split(".")
        for part in parts[:-1]:
            obj = getattr(obj, part)
        setattr(obj, parts[-1], v)
    now = [1000.0]
    p = pkg.processor.Processor(s, {M: _labels(pkg)}, on_approved=sink,
                                clock=lambda: now[0])
    return p, s, now


def _pred(pkg, idx, conf, t=1000.0, source="src1", model=M):
    return pkg.processor.WindowPrediction(
        source_id=source, model_id=model, start_time=t, end_time=t + 3.0,
        indices=[idx], confidences=[conf])


def _state(p) -> dict:
    """What a case observes of a processor after it ran."""
    return {"stats": p.stats, "pending": p.pending_as_dicts(),
            "dynamic": p.dynamic.snapshot()}


PROCESSOR_CASES = {}


def _case(fn):
    PROCESSOR_CASES[fn.__name__] = fn
    return fn


@_case
def below_threshold_filtered(pkg):
    p, _, _ = _processor(pkg)
    p.submit(_pred(pkg, 0, 0.4))
    assert p.stats.detections_filtered == 1
    return _state(p)


@_case
def pends_then_approves(pkg):
    approved = []
    p, _, _ = _processor(pkg, lambda d, item: approved.append((d, item)))
    p.submit(_pred(pkg, 0, 0.9, t=1000.0))
    early = p.flush(now=1011.9)
    out = p.flush(now=1012.1)
    assert early == [] and len(out) == 1 and approved
    return {"early": early, "out": out,
            "approved": [(d, i.count, sorted(i.contributions))
                         for d, i in approved], **_state(p)}


@_case
def per_species_threshold_override(pkg):
    p, s, _ = _processor(pkg)
    s.species.config["Turdus merula"] = {"threshold": 0.95}
    p.submit(_pred(pkg, 0, 0.9))
    p.submit(_pred(pkg, 1, 0.9))
    return _state(p)


@_case
def exclusion_list(pkg):
    p, s, _ = _processor(pkg)
    s.species.exclude = ["Turdus merula"]
    p.submit(_pred(pkg, 0, 0.99))
    return _state(p)


@_case
def range_filter_and_include_override(pkg):
    p, s, _ = _processor(pkg)
    p.set_included_species({"Strix aluco"})
    p.submit(_pred(pkg, 0, 0.9))
    p.submit(_pred(pkg, 1, 0.9))
    s.species.include = ["Turdus merula"]
    p.submit(_pred(pkg, 0, 0.9))
    assert len(p.pending_snapshot()) == 2
    return _state(p)


@_case
def cross_model_consensus(pkg):
    p, s, _ = _processor(pkg)
    s.models.append(pkg.settings.ModelSettings(model_id="Perch_V2",
                                               threshold=0.5))
    p._model_settings = {m.model_id: m for m in s.models}
    p.labels_by_model["Perch_V2"] = _labels(pkg)
    p.submit(_pred(pkg, 0, 0.6, t=1000.0))
    p.submit(_pred(pkg, 0, 0.8, t=1001.5, model="Perch_V2"))
    (item,) = p.pending_snapshot()
    assert item.best_model_id == "Perch_V2" and item.count == 2
    return {"item": item, "out": p.flush(now=1020.0), **_state(p)}


@_case
def deep_detection_requires_repeats(pkg):
    p, s, _ = _processor(pkg, **{"deep_detection.level": 2})
    s.models[0].overlap = 2.2
    p.submit(_pred(pkg, 0, 0.9, t=1000.0))
    p.submit(_pred(pkg, 0, 0.9, t=1000.8))
    first = p.flush(now=1013.0)
    for i in range(3):
        p.submit(_pred(pkg, 0, 0.9, t=1020.0 + 0.8 * i))
    second = p.flush(now=1033.0)
    assert first == [] and len(second) == 1
    return {"first": first, "second": second, **_state(p)}


@_case
def privacy_filter_ge(pkg):
    p, _, _ = _processor(pkg, **{"privacy_filter.enabled": True})
    p.submit(_pred(pkg, 0, 0.9, t=1000.0))
    p.submit(_pred(pkg, 2, 0.06, t=1000.0))
    return {"out": p.flush(now=1013.0), **_state(p)}


@_case
def privacy_before_detection_passes(pkg):
    p, _, _ = _processor(pkg, **{"privacy_filter.enabled": True})
    p.submit(_pred(pkg, 2, 0.9, t=999.0))
    p.submit(_pred(pkg, 0, 0.9, t=1000.0))
    return {"out": p.flush(now=1013.0), **_state(p)}


@_case
def privacy_confidence_floor(pkg):
    p, _, _ = _processor(pkg, **{"privacy_filter.enabled": True})
    p.submit(_pred(pkg, 0, 0.9, t=1000.0))
    p.submit(_pred(pkg, 2, 0.04, t=1001.0))
    return {"out": p.flush(now=1013.0), **_state(p)}


@_case
def human_never_stored(pkg):
    p, _, _ = _processor(pkg)
    p.submit(_pred(pkg, 2, 0.99))
    assert p.pending_snapshot() == []
    return _state(p)


@_case
def dog_bark_window(pkg):
    p, _, _ = _processor(pkg, **{"dog_bark_filter.enabled": True})
    p.submit(_pred(pkg, 3, 0.5, t=1000.0))
    p.submit(_pred(pkg, 0, 0.9, t=1100.0))
    first = p.flush(now=1113.0)
    p.submit(_pred(pkg, 0, 0.9, t=1000.0 + 301.0))
    return {"first": first, "second": p.flush(now=1320.0), **_state(p)}


@_case
def dynamic_thresholds_learn_in_processor(pkg):
    """Approved detections above the trigger lower the species threshold
    (the snapshots after each flush), and a lower score then pends."""
    p, _, now = _processor(pkg, **{"dynamic_threshold.enabled": True})
    trace = []
    for i, t in enumerate((1000.0, 1030.0, 1060.0)):
        now[0] = t
        p.submit(_pred(pkg, 1, 0.95, t=t))
        trace.append((p.flush(now=t + 13.0), p.dynamic.snapshot()))
    now[0] = 1100.0
    p.submit(_pred(pkg, 1, 0.3, t=1100.0))
    trace.append(p.effective_threshold(M, _labels(pkg).species[1], 1100.0)
                 if hasattr(p, "effective_threshold") else None)
    return {"trace": trace, **_state(p)}


@pytest.mark.parametrize("cv,enabled", [(0.05, True), (0.149, True),
                                        (0.151, True), (0.05, False),
                                        (None, True)])
def test_ultrasonic_gate_equal_jax(cv, enabled):
    def case(pkg):
        p, s, _ = _processor(pkg)
        s.ultrasonic_filter.enabled = enabled
        w = _pred(pkg, 0, 0.9)
        w.ultrasonic_cv = cv
        p.submit(w)
        return _state(p)

    got = _both(case)
    assert bool(got["pending"]) == (cv is None or not enabled or cv > 0.15)


@_case
def window_pcm_carried(pkg):
    p, _, _ = _processor(pkg)
    w = _pred(pkg, 0, 0.9)
    w.pcm = np.full(16, 7, np.int16)
    w.pcm_rate = 256000
    p.submit(w)
    (item,) = p.pending_snapshot()
    return {"pcm": item.pcm, "rate": item.pcm_rate, **_state(p)}


@_case
def best_window_topk(pkg):
    p, _, _ = _processor(pkg)
    wp = pkg.processor.WindowPrediction
    p.submit(wp(source_id="src1", model_id=M, start_time=1000.0,
                end_time=1003.0, indices=[0, 4], confidences=[0.7, 0.3]))
    p.submit(wp(source_id="src1", model_id=M, start_time=1001.5,
                end_time=1004.5, indices=[0, 1], confidences=[0.9, 0.2]))
    p.submit(wp(source_id="src1", model_id=M, start_time=1003.0,
                end_time=1006.0, indices=[0, 4], confidences=[0.6, 0.5]))
    item = p._pending["src1:Turdus merula"]
    assert item.topk[1][0] == "Strix aluco"
    return {"topk": item.topk, "item": item, **_state(p)}


@pytest.mark.parametrize("name", sorted(PROCESSOR_CASES))
def test_processor_case_equal_jax(name):
    _both(PROCESSOR_CASES[name])


# -- dynamic thresholds (dynamic_threshold.py) ---------------------------------------

def _dt_levels(pkg):
    dt = pkg.dynamic.DynamicThresholds(trigger=0.9, floor=0.2,
                                       valid_hours=1.0,
                                       learning_cooldown_seconds=12.0)
    t0, trace = 10_000.0, []
    trace.append(dt.adjust(0.8, M, "X", now=t0))
    for dt_s, conf in ((0, 0.95), (1, 0.99), (13, 0.99), (26, 0.99),
                       (40, 0.99)):
        dt.learn(conf, M, "X", now=t0 + dt_s)
        trace.append((dt.adjust(0.8, M, "X", now=t0 + dt_s), dt.snapshot()))
    trace.append(dt.adjust(0.8, M, "X", now=t0 + 40 + 3601))
    return trace


def _dt_timer(pkg):
    dt = pkg.dynamic.DynamicThresholds(trigger=0.9, valid_hours=1.0,
                                       learning_cooldown_seconds=12.0)
    dt.learn(0.95, M, "X", now=0.0)
    dt.learn(0.95, M, "X", now=5.0)
    return [dt.adjust(0.8, M, "X", now=3603.0),
            dt.adjust(0.8, M, "X", now=3606.0), dt.snapshot()]


def _dt_low_and_custom(pkg):
    dt = pkg.dynamic.DynamicThresholds(trigger=0.9)
    out = []
    dt.learn(0.85, M, "X", now=0.0)
    dt.learn(0.90, M, "X", now=0.0)
    out.append(dt.adjust(0.8, M, "X", now=0.0))
    dt.learn(0.95, M, "Y", now=0.0, is_custom=True)
    out.append(dt.adjust(0.8, M, "Y", now=0.0))
    dt.learn(0.95, M, "Y", now=0.0)
    out += [dt.adjust(0.7, M, "Y", now=0.0, is_custom=True),
            dt.adjust(0.8, M, "Y", now=0.0), dt.stats()]
    return out


def _dt_events_clear_restore(pkg):
    events = []
    dt = pkg.dynamic.DynamicThresholds(trigger=0.9, floor=0.2,
                                       valid_hours=1.0,
                                       on_event=events.append)
    dt.learn(0.95, M, "X", now=0.0, base_threshold=0.8)
    dt.learn(0.95, M, "Y", now=0.0, base_threshold=0.8)
    dt.adjust(0.8, M, "X", now=7200.0)
    snap = dt.snapshot()
    cleared = dt.clear(scientific="Y")
    other = pkg.dynamic.DynamicThresholds()
    other.restore(snap)
    return [events, cleared, dt.snapshot(), other.snapshot()]


@pytest.mark.parametrize("case", [_dt_levels, _dt_timer, _dt_low_and_custom,
                                  _dt_events_clear_restore],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_dynamic_thresholds_equal_jax(case):
    _both(case)


# -- submit_batch: two models, shared sources, consensus ------------------------------

EXTRA = [("Pica pica", "Eurasian Magpie"), ("Corvus corax", "Common Raven"),
         ("Erithacus rubecula", "European Robin"),
         ("Cyanistes caeruleus", "Eurasian Blue Tit"),
         ("Fringilla coelebs", "Common Chaffinch"),
         ("Sturnus vulgaris", "Common Starling")]


def _topk_both(seed: int, n: int, species: int, k: int = 10,
               ties: bool = False):
    """Seeded confidences → top-k by ``lax.top_k`` and by ``torch.topk``:
    the values equal, and where values tie (`ties` sets a fifth of them to
    0.5) the index sets, since the two may order tied indices
    differently. Without ties the indices are equal too."""
    rng = np.random.default_rng(seed)
    conf = (rng.random((n, species)) ** 3).astype(np.float32)
    if ties:
        conf[rng.random((n, species)) < 0.2] = 0.5
    jv, ji = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(conf), k))
    tv, ti = (a.numpy() for a in torch.topk(torch.from_numpy(conf), k))
    np.testing.assert_array_equal(tv, jv)
    for r in range(n):
        for v in np.unique(jv[r]):
            tied = np.flatnonzero(conf[r] == v)
            assert np.sum(tv[r] == v) == np.sum(jv[r] == v)
            assert set(ti[r][tv[r] == v]) <= set(tied)
            assert set(ji[r][jv[r] == v]) <= set(tied)
            if np.sum(jv[r] == v) == len(tied):
                assert set(ti[r][tv[r] == v]) == set(ji[r][jv[r] == v])
    if not ties:
        np.testing.assert_array_equal(ti, ji)
    return (jv, ji.astype(np.int32)), (tv, ti.astype(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_topk_values_and_tied_index_sets_equal_jax(seed):
    _topk_both(seed, 64, 40, ties=True)


def _batch_case(pkg, batches, dynamic):
    s = pkg.settings.Settings()
    s.models = [pkg.settings.ModelSettings(model_id=M, threshold=0.5),
                pkg.settings.ModelSettings(model_id="Perch_V2",
                                           threshold=0.6)]
    s.export.clip_length_seconds = 15.0
    s.export.pre_capture_seconds = 3.0
    s.species.config = {"Pica pica": {"threshold": 0.15}}
    s.species.exclude = ["Corvus corax"]
    s.dynamic_threshold.enabled = dynamic
    s.privacy_filter.enabled = False      # a human is in most top-10s
    approved = []
    p = pkg.processor.Processor(
        s, {M: _labels(pkg, EXTRA), "Perch_V2": _labels(pkg, EXTRA)},
        on_approved=lambda d, item: approved.append(
            (d, item.count, sorted(item.contributions.items()))),
        clock=lambda: 1000.0)
    trace = []
    for model, sids, sts, vals, idx in batches:
        n = p.submit_batch(model, sids, sts, sts + 3.0, vals, idx)
        trace.append((n, p.pending_as_dicts()))
    out = p.flush(now=1e6)
    consensus = [a for a in approved if len(a[2]) >= 2]
    assert consensus, "no cross-model consensus"
    return {"trace": trace, "flushed": out, "approved": approved,
            **_state(p)}


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_submit_batch_two_models_equal_jax(seed, dynamic):
    rng = np.random.default_rng(100 + seed)
    n_species = 5 + len(EXTRA)
    jb, tb = [], []
    for b in range(6):
        model = (M, "Perch_V2")[b % 2]
        n = 32
        sids = [f"s{int(v)}" for v in rng.integers(0, 6, n)]
        sts = 1000.0 + np.sort(rng.uniform(0, 20, n))
        (jv, ji), (tv, ti) = _topk_both(seed * 10 + b, n, n_species)
        jb.append((model, sids, sts, jv, ji))
        tb.append((model, sids, sts, tv, ti))
    want = _batch_case(J, jb, dynamic)
    got = _batch_case(T, tb, dynamic)
    assert _plain(got) == _plain(want)


def test_submit_batch_equals_per_window_submit_in_port():
    """``tests/test_submit_batch.py``'s contract on the port: the batch
    path leaves the same state as per-window ``submit``."""
    (_, _), (vals, idx) = _topk_both(7, 48, 8, k=4)
    sids = [f"s{i % 5}" for i in range(48)]
    sts = 1000.0 + np.arange(48) * 1.5

    def run(batch):
        p, s, _ = _processor(T, **{"privacy_filter.enabled": True,
                                   "dog_bark_filter.enabled": True})
        p.labels_by_model[M] = _labels(T, EXTRA)
        if batch:
            p.submit_batch(M, sids, sts, sts + 3.0, vals, idx)
        else:
            for r in range(48):
                p.submit(T.processor.WindowPrediction(
                    source_id=sids[r], model_id=M, start_time=float(sts[r]),
                    end_time=float(sts[r]) + 3.0, indices=idx[r].tolist(),
                    confidences=vals[r].tolist()))
        return _state(p)

    assert _plain(run(True)) == _plain(run(False))


def test_prewarm_and_taxonomy_equal_jax():
    """``prewarm`` builds the gates from the same taxonomy tables; the
    non-bird categories, canonical names and daylight window agree."""
    def case(pkg):
        p, _, _ = _processor(pkg)
        p.prewarm()
        names = ["Human vocal", "Dog", "Engine", "Turdus merula",
                 "Power_tool", "Speech"]
        when = datetime.datetime(2024, 6, 21, 12, 0,
                                 tzinfo=datetime.timezone.utc)
        return {"cat": [pkg.nonbird.category_of(n) for n in names],
                "nonbird": [pkg.nonbird.is_nonbird_name(n) for n in names],
                "canonical": [pkg.openfauna.canonical_name(n) for n in
                              ("Turdus merula", "Parus caeruleus",
                               "Strix aluco")],
                "daylight": [pkg.suncalc.in_daylight_window(
                    when + datetime.timedelta(hours=h), 60.17, 24.94)
                    for h in range(0, 24, 3)],
                "gate": [a.tolist() if hasattr(a, "tolist") else a
                         for a in p._fast_gate(M, _labels(pkg))]}

    got = _both(case)
    assert any(got["nonbird"]) and not all(got["nonbird"])


def test_flushloop_runs_and_stops():
    def case(pkg):
        p, _, now = _processor(pkg)
        p.submit(_pred(pkg, 0, 0.9, t=1000.0))
        now[0] = 1013.0                 # past the 1012 s deadline
        loop = pkg.processor.FlushLoop(p, interval=0.05)
        loop.start()
        deadline = time.monotonic() + 5.0
        while p.stats.detections_approved == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        loop.stop()
        return p.stats

    got = _both(case)
    assert got.detections_approved == 1


# -- job queue -------------------------------------------------------------------------

def _counters(q):
    """The queue's counters without their wall-clock first-drop times."""
    st = q.stats
    return {"completed": st.completed, "dropped": st.dropped,
            "shed": st.shed, "retried": st.retried,
            "by_category": {c: {k: v for k, v in d.items()
                                if k != "first_drop_t"}
                            for c, d in st.by_category.items()}}


def _jq_shedding(pkg):
    """The JAX test's sequence on a full queue of 3, with the queue's
    counters after every enqueue (first-drop times tie at the clock's
    resolution, so the order is read from this trace)."""
    q = pkg.jobqueue.JobQueue(capacity=3, workers=1)
    trace = []
    for name, cat in (("log1", "log"), ("mqtt1", "mqtt"), ("clip1", "clip"),
                      ("clip2", "clip"), ("alert1", "alert"),
                      ("spect1", "spectrogram"), ("clip3", "clip"),
                      ("clip4", "clip")):
        trace.append((q.enqueue(lambda: None, name, category=cat),
                      q.pending(), _counters(q)))
    assert q.stats.dropped == 5 and q.stats.shed == 3
    return trace


def _jq_bands(pkg):
    q = pkg.jobqueue.JobQueue(capacity=16, workers=1)
    order = []
    for cat in ("log", "alert", "spectrogram", "database", "clip", "mqtt",
                "composite", "sse", "other"):
        q.enqueue(lambda c=cat: order.append(c), cat, category=cat)
    q.start()
    q.stop(drain=True)
    return {"order": order, **_counters(q)}


def _jq_retry_and_full(pkg):
    q = pkg.jobqueue.JobQueue(capacity=10, workers=1)
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")

    q.start()
    q.enqueue(flaky, "flaky", retry=pkg.jobqueue.RetryConfig(
        enabled=True, max_retries=5, initial_delay=0.01, max_delay=0.02))
    deadline = time.monotonic() + 5
    while len(attempts) < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    q.stop(drain=True)
    full = pkg.jobqueue.JobQueue(capacity=2, workers=1)
    enq = [full.enqueue(lambda: None, n) for n in "abc"]
    return {"attempts": len(attempts), "enq": enq, "retry": _counters(q),
            "full": _counters(full), "pending": full.pending()}


@pytest.mark.parametrize("case", [_jq_shedding, _jq_bands,
                                  _jq_retry_and_full],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_jobqueue_equal_jax(case):
    _both(case)


# -- actions and the datastore ---------------------------------------------------------

def _detection(pkg, sci="Turdus merula", common="Eurasian Blackbird",
               conf=0.9, ts=1_700_000_000.0, source="s1", model=M):
    return pkg.results.Detection(
        species=pkg.labels.Species(sci, common), confidence=conf,
        begin_seconds=ts, end_seconds=ts + 12, model_id=model,
        source_id=source, timestamp=datetime.datetime.fromtimestamp(ts),
        species_code=sci[:6].lower().replace(" ", ""))


def _dump(store) -> dict:
    """Every table of `store`, rows ordered by all their columns."""
    conn = store._conn
    tables = [r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name")]
    out = {}
    for t in tables:
        cols = [r[1] for r in conn.execute(f"PRAGMA table_info({t})")]
        order = ", ".join(cols)
        out[t] = [tuple(r) for r in conn.execute(
            f"SELECT * FROM {t} ORDER BY {order}")]
    return out


SIGHTINGS = [("Turdus merula", "Eurasian Blackbird", 0.91, 9 * 3600, "s1"),
             ("Strix aluco", "Tawny Owl", 0.84, 7 * 3600, "s2"),
             ("Turdus merula", "Eurasian Blackbird", 0.77, 22 * 3600, "s2"),
             ("Parus major", "Great Tit", 0.95, 12 * 3600, "s1"),
             ("Strix aluco", "Tawny Owl", 0.66, 86400 + 3600, "s3")]


def _store_case(pkg, path):
    store = pkg.sqlite.Datastore(path)
    day0 = 1_700_000_000.0 - (1_700_000_000.0 % 86400)
    ids = []
    for i, (sci, common, conf, dt_s, src) in enumerate(SIGHTINGS):
        d = _detection(pkg, sci, common, conf, day0 + dt_s, src)
        contrib = {M: pkg.processor.ModelContribution(M, 2 + i, conf),
                   "Perch_V2": pkg.processor.ModelContribution(
                       "Perch_V2", 1, conf - 0.1)}
        act = pkg.actions.DatabaseAction(
            detection=d, store=store, contributions=contrib,
            clip_name=f"clip_{i}.wav",
            results=[(sci, common, conf), ("Pica pica", "Magpie", 0.1)])
        act.execute()
        ids.append(act.assigned_id)
    queue = pkg.jobqueue.JobQueue(capacity=8, workers=2)
    queue.start()
    extra = _detection(pkg, "Pica pica", "Eurasian Magpie", 0.7,
                       day0 + 15 * 3600, "s4")
    n = pkg.actions.enqueue_actions(
        queue, [pkg.actions.DatabaseAction(detection=extra, store=store),
                pkg.actions.LogAction(detection=extra)],
        category="composite")
    queue.stop(drain=True)
    snap = {(M, "Strix aluco"): pkg.dynamic.ThresholdState(
        level=2, high_conf_count=2, expires_at=day0 + 3600.0,
        last_learned_at=day0)}
    store.save_dynamic_thresholds(snap)
    store.lock_detection(ids[1])
    names = [pkg.actions.clip_filename(_detection(pkg, sci, common, conf,
                                                  day0 + dt_s), fmt)
             for (sci, common, conf, dt_s, _), fmt in zip(
                 SIGHTINGS, ("wav", "flac", "", " .mp3", "wav"))]
    rec = {"ids": ids, "enqueued": n, "names": names,
           "results": store.get_results(ids[0]),
           "detection": store.get_detection(ids[0]),
           "loaded": store.load_dynamic_thresholds(),
           "count": store.count_detections(), "dump": _dump(store)}
    store.close()
    return rec


def test_database_action_into_both_datastores(tmp_path):
    """``DatabaseAction`` (and ``enqueue_actions`` on a job queue) writes
    the same rows into both datastores: every table dumped in order."""
    want = _store_case(J, str(tmp_path / "jax.db"))
    got = _store_case(T, str(tmp_path / "port.db"))
    assert _plain(got) == _plain(want)
    assert got["count"] == len(SIGHTINGS) + 1
    assert set(got["dump"]) >= {"detections", "model_contributions",
                                "results", "daily_events",
                                "dynamic_thresholds"}


def test_delete_detection_recomputes_daily_events(tmp_path):
    """The one divergence: after ``delete_detection`` JAX's daily_events
    row still counts the deleted row; the port's equals a recompute
    (``save_daily_events``), and the rest of both databases is equal."""
    dumps = {}
    for pkg, name in ((J, "jax"), (T, "port")):
        store = pkg.sqlite.Datastore(str(tmp_path / f"{name}.db"))
        day0 = 1_700_000_000.0 - (1_700_000_000.0 % 86400)
        ids = [store.insert_detection(_detection(pkg, sci, common, conf,
                                                 day0 + dt_s, src))
               for sci, common, conf, dt_s, src in SIGHTINGS]
        date = store.get_detection(ids[0])["date"]
        before = store.get_daily_events(date)
        assert before["detections"] == 4 and before["species"] == 3
        # the day's only Great Tit and one of two blackbirds
        assert store.delete_detection(ids[3]) is True
        assert store.delete_detection(ids[0]) is True
        assert store.delete_detection(ids[0]) is False
        store.lock_detection(ids[2])
        with pytest.raises(PermissionError):
            store.delete_detection(ids[2])
        after = store.get_daily_events(date)
        conn = sqlite3.connect(str(tmp_path / f"{name}.db"))
        recount = conn.execute(
            "SELECT COUNT(*), COUNT(DISTINCT scientific_name), MIN(time),"
            " MAX(time) FROM detections WHERE date = ?", (date,)).fetchone()
        conn.close()
        if pkg is J:
            assert after == before                       # stale
        else:
            assert (after["detections"], after["species"],
                    after["first_detection"], after["last_detection"]) \
                == recount == (2, 2, "07:00:00", "22:00:00")
            assert after == store.save_daily_events(date)
        d = _dump(store)
        d.pop("daily_events")
        dumps[name] = d
        store.close()
    assert dumps["port"] == dumps["jax"]


def test_daily_events_rollup_and_results_equal_jax():
    def case(pkg):
        ds = pkg.sqlite.Datastore(":memory:")
        day0 = 1_700_000_000.0 - (1_700_000_000.0 % 86400)
        for sci, common, conf, dt_s, src in SIGHTINGS:
            ds.insert_detection(_detection(pkg, sci, common, conf,
                                           day0 + dt_s, src))
        ds.save_daily_events("2031-01-01")
        ts = datetime.datetime(2031, 1, 1, 10, 30).timestamp()
        ds.insert_detection(_detection(pkg, ts=ts))
        dates = sorted({ds.get_detection(i + 1)["date"]
                        for i in range(len(SIGHTINGS) + 1)})
        rec = {d: (ds.get_daily_events(d), ds.save_daily_events(d))
               for d in dates}
        assert all(a == b for a, b in rec.values())
        rec["weather"] = ds.latest_hourly_weather()
        rec["locked"] = ds.locked_clip_names()
        ds.optimize()
        rec["dump"] = _dump(ds)
        ds.close()
        return rec

    _both(case)
