"""The port's span recorder (``utils/tracing.py``) and the spans and
counters that the loop, the batcher, the detection stack and the offline
analyzer give it, on the CPU.

The recorder alone runs on a fake clock where times are compared exactly;
the program's spans are read from ``GLOBAL_SPANS`` as deltas of its
aggregate and as events, which each test turns on for its own stretch.
"""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from birdnet_go_tpu_torch.analysis.offline import (
    OfflineAnalyzer,
    OfflineConfig,
)
from birdnet_go_tpu_torch.analysis.processor import Processor
from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.models import registry as treg
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    BlockSpec,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.scheduler import loop as tloop
from birdnet_go_tpu_torch.taxonomy.labels import synthetic_labels
from birdnet_go_tpu_torch.utils import tracing
from birdnet_go_tpu_torch.utils.metrics import MetricsRegistry

torch.set_num_threads(1)

SPEC = treg.BIRDNET_V24


class _Clock:
    """``perf_counter_ns`` that moves only when the test moves it."""

    def __init__(self):
        self.t = 1_000

    def perf_counter_ns(self) -> int:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(
        perf_counter_ns=c.perf_counter_ns, time=time.time))
    return c


@pytest.fixture
def global_events():
    """Events of ``GLOBAL_SPANS`` kept for the test's stretch."""
    tracing.record_events(True)
    try:
        yield
    finally:
        tracing.record_events(False)


def _by_name(events):
    out = {}
    for e in events:
        out.setdefault(e[0], []).append(e)
    return out


# -- the recorder ------------------------------------------------------------

def test_spans_nest_and_keep_self_time(clock):
    rec = tracing.SpanRecorder()
    rec.record_events(True)
    with rec.span("tick"):
        clock.t += 10
        with rec.span("launch", batch=7) as launch:
            clock.t += 5
            with rec.span("step"):
                clock.t += 20
            clock.t += 1
        clock.t += 3
        with rec.span("fill"):
            clock.t += 100
    assert (launch.t0, launch.t1) == (1_010, 1_036)
    spans = rec.snapshot()["spans"]
    got = {k: (s["calls"], s["total_ns"], s["self_ns"], s["max_ns"])
           for k, s in spans.items()}
    assert got == {"tick": (1, 139, 13, 139), "launch": (1, 26, 6, 26),
                   "step": (1, 20, 20, 20), "fill": (1, 100, 100, 100)}
    tid = threading.get_native_id()
    assert sorted(rec.events(), key=lambda e: e[2]) == [
        ("tick", tid, 1_000, 1_139, None, None),
        ("launch", tid, 1_010, 1_036, "tick", 7),
        ("step", tid, 1_015, 1_035, "launch", 7),
        ("fill", tid, 1_039, 1_139, "tick", None)]


def test_add_records_stored_times_outside_the_open_spans_self_time(clock):
    rec = tracing.SpanRecorder()
    rec.record_events(True)
    with rec.span("harvest", batch=3):
        clock.t += 50
        rec.add("inflight", 200, 900)
        rec.add("wait", 910, 950, batch=4, category="db")
    spans = rec.snapshot()["spans"]
    assert spans["harvest"]["self_ns"] == spans["harvest"]["total_ns"] == 50
    assert spans["inflight"]["total_ns"] == spans["inflight"]["self_ns"] == 700
    assert spans["wait{category=db}"] == {
        "name": "wait", "labels": {"category": "db"}, "calls": 1,
        "total_ns": 40, "self_ns": 40, "max_ns": 40}
    ev = _by_name(rec.events())
    assert ev["inflight"][0][2:] == (200, 900, "harvest", 3)
    assert ev["wait"][0][2:] == (910, 950, "harvest", 4)


def test_a_span_records_and_pops_when_its_block_raises(clock):
    rec = tracing.SpanRecorder()
    with pytest.raises(KeyError):
        with rec.span("outer"):
            with rec.span("inner"):
                clock.t += 4
                raise KeyError("x")
    assert rec._stack() == []
    spans = rec.snapshot()["spans"]
    assert spans["inner"]["calls"] == spans["outer"]["calls"] == 1
    assert spans["outer"]["self_ns"] == 0


def test_counters_and_snapshot_deltas(clock):
    rec = tracing.SpanRecorder()
    rec.count("ingest.windows", 5)
    with rec.span("loop.tick"):
        clock.t += 7
    before = rec.snapshot()
    rec.count("ingest.windows", 3)
    rec.count("kernels.built")
    for _ in range(2):
        with rec.span("loop.tick"):
            clock.t += 9
    with rec.span("job.run", category="composite"):
        clock.t += 1
    after = rec.snapshot()
    assert after["counters"] == {"ingest.windows": 8, "kernels.built": 1}
    d = tracing.delta(before, after)
    assert d["counters"] == {"ingest.windows": 3, "kernels.built": 1}
    assert {k: (s["calls"], s["total_ns"], s["self_ns"])
            for k, s in d["spans"].items()} == {
        "loop.tick": (2, 18, 18), "job.run{category=composite}": (1, 1, 1)}
    # a copy: what the recorder does later leaves it as it was
    rec.count("ingest.windows", 100)
    assert after["counters"]["ingest.windows"] == 8
    assert tracing.delta(after, after) == {"spans": {}, "counters": {}}


def test_events_are_bounded_and_counted_when_dropped(clock):
    rec = tracing.SpanRecorder()
    with rec.span("before"):           # events off: aggregate only
        pass
    assert rec.events() == []
    rec.record_events(True, capacity=3)
    for i in range(5):
        with rec.span(f"s{i}"):
            clock.t += 1
    assert [e[0] for e in rec.events()] == ["s0", "s1", "s2"]
    assert rec.events_dropped == 2
    rec.record_events(False)
    with rec.span("after"):
        pass
    assert len(rec.events()) == 3
    assert rec.snapshot()["spans"]["after"]["calls"] == 1
    rec.record_events(True, capacity=3)        # starts afresh
    assert rec.events() == [] and rec.events_dropped == 0


def test_threads_keep_stacks_of_their_own():
    """Eight threads nest spans at once, switching every few µs: every
    call is counted and every event names its own thread's parent and
    lies inside it."""
    rec = tracing.SpanRecorder()
    rec.record_events(True)
    n_threads, rounds = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(rounds):
                with rec.span("outer", batch=k * 1000 + i):
                    with rec.span("inner"):
                        rec.count("n")
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = rec.snapshot()
    assert snap["counters"]["n"] == n_threads * rounds
    assert snap["spans"]["outer"]["calls"] == n_threads * rounds
    assert snap["spans"]["inner"]["calls"] == n_threads * rounds
    ev = _by_name(rec.events())
    outer = {e[5]: e for e in ev["outer"]}
    assert len(outer) == n_threads * rounds
    assert len({e[1] for e in ev["outer"]}) == n_threads
    for name, tid, t0, t1, parent, batch in ev["inner"]:
        o = outer[batch]
        assert parent == "outer" and o[1] == tid and o[2] <= t0 <= t1 <= o[3]


def test_a_spans_times_lie_between_clock_reads_around_it():
    rec = tracing.SpanRecorder()
    rec.record_events(True)
    for _ in range(20):
        a = time.perf_counter_ns()
        with rec.span("s"):
            sum(range(100))
        b = time.perf_counter_ns()
        (_, _, t0, t1, _, _), = rec.events()[-1:]
        assert a <= t0 <= t1 <= b


def test_summary_covers_every_batch_past_the_ring():
    rec = tracing.SpanRecorder(capacity=512)
    for i in range(600):
        rec.record("m", 8, 1.0, float(i % 100), ok=i % 50 != 0)
    s = rec.summary()
    assert s["count"] == s["total"] == 600 and len(rec.recent(1000)) == 512
    assert s["errors"] == 12 and s["by_model"] == {"m": 600}
    assert s["max_ms"] == 99.0
    for key, exact in (("p50_ms", 50.0), ("p90_ms", 90.0), ("p99_ms", 99.0)):
        assert exact <= s[key] <= exact * 2 ** (1 / 8), key


# -- /metrics ----------------------------------------------------------------

def test_metrics_render_every_span_and_counter(clock):
    rec = tracing.SpanRecorder()
    for _ in range(2):
        with rec.span("job.run", category="composite"):
            clock.t += 1_500_000_000
    with rec.span("loop.tick"):
        with rec.span("loop.fill"):
            clock.t += 250_000_000
        clock.t += 250_000_000
    rec.count("loop.wake_late_ns", 42)
    reg = MetricsRegistry()
    rec.set_metrics(reg)
    lines = set(reg.render().splitlines())
    assert {
        'birdnet_span_calls_total{category="composite",span="job.run"} 2',
        'birdnet_span_seconds_total{category="composite",span="job.run"} 3',
        'birdnet_span_seconds_total{span="loop.tick"} 0.5',
        'birdnet_span_self_seconds_total{span="loop.tick"} 0.25',
        'birdnet_span_calls_total{span="loop.fill"} 1',
        "birdnet_trace_loop_wake_late_ns_total 42",
    } <= lines


def test_api_metrics_include_the_global_recorder():
    from birdnet_go_tpu_torch.api.server import ApiServer
    from birdnet_go_tpu_torch.utils.metrics import REGISTRY

    with tracing.span("db.commit"):
        pass
    tracing.count("kernels.built", 0)
    srv = ApiServer.__new__(ApiServer)
    srv.ctx = types.SimpleNamespace(processor=None, device_loop=None,
                                    jobqueue=None, datastore=None)
    srv._update_runtime_metrics()
    text = REGISTRY.render()
    calls = tracing.snapshot()["spans"]["db.commit"]["calls"]
    assert f'birdnet_span_calls_total{{span="db.commit"}} {calls}' in text
    assert "birdnet_trace_kernels_built_total" in text
    assert "# TYPE birdnet_span_self_seconds_total gauge" in text


# -- the program's spans -----------------------------------------------------

class _StubBatcher(tloop.HostBatcher):
    """A batcher whose device step is a numpy function of the staged rows,
    on a CPU whose results are ready at once."""

    def __init__(self, max_batch, depth):
        self._init_host(SPEC, max_batch, 5, None, depth)

    def _launch(self, staged, n):
        x = staged[:n].astype(np.float32)
        vals = np.stack([np.abs(x[:, i::5]).mean(axis=1) / 3e4
                         for i in range(5)], 1)
        return vals, np.argsort(-vals, axis=1).astype(np.int32)

    def _collect(self, handle, meta):
        return handle[0], handle[1], None

    def _ready(self, handle):
        return True


def test_device_loop_spans_a_batch_from_launch_to_submit(global_events):
    """The loop's own thread: its top-level spans are ``loop.tick`` and
    ``loop.sleep``; each batch's id runs from ``batch.launch`` through
    ``batch.inflight`` and ``batch.harvest`` to ``submit.batch``; launches
    and harvests equal ``batches_dispatched``; the ingest counters count
    every window staged."""
    labels = synthetic_labels(40)
    settings = Settings()
    settings.models = [ModelSettings(model_id=SPEC.model_id, threshold=0.5)]
    processor = Processor(settings, {SPEC.model_id: labels})
    b = _StubBatcher(max_batch=4, depth=2)
    b.on_batch = lambda meta, vals, idx, cv: processor.submit_batch(
        SPEC.model_id, [w.source_id for w in meta],
        [w.start_time for w in meta], [w.end_time for w in meta], vals, idx)
    rng = np.random.default_rng(3)
    clip = SPEC.clip_samples
    fed = {"fill": 0, "items": 0}
    t0 = time.time() - 10.0

    def fill(view):
        if fed["fill"] >= 30:
            return 0, (), ()
        n = min(len(view), 3, 30 - fed["fill"])
        view[:n] = rng.integers(-3000, 3000, (n, clip))
        fed["fill"] += n
        return n, [f"f{fed['fill'] + j}" for j in range(n)], \
            np.full(n, t0)

    def items():
        if fed["items"] >= 10:
            return []
        fed["items"] += 2
        pcm = rng.integers(-3000, 3000, (2, clip)).astype(np.int16)
        return [(SPEC.model_id, p, f"s{fed['items'] + j}", t0)
                for j, p in enumerate(pcm)]

    before = tracing.snapshot()
    loop = tloop.DeviceLoop(tick_seconds=0.005, max_dispatches_per_tick=2)
    loop.add_batcher(b)
    loop.add_fill_provider(SPEC.model_id, fill)
    loop.add_provider(items)
    loop.start()
    tid = loop._thread.native_id
    deadline = time.monotonic() + 30
    while b.stats.windows_processed < 40 and time.monotonic() < deadline:
        time.sleep(0.01)
    loop.stop()
    assert b.stats.windows_processed == 40
    d = tracing.delta(before, tracing.snapshot())
    n = b.stats.batches_dispatched
    for name in ("batch.launch", "batch.inflight", "batch.harvest",
                 "harvest.fanout", "submit.batch"):
        assert d["spans"][name]["calls"] == n, name
    assert d["counters"]["ingest.windows"] == 40
    assert d["counters"]["ingest.bytes"] == 40 * clip * 2
    # each window staged about 10 s after it ended
    wait_s = d["counters"]["ingest.wait_ns"] / 1e9 / 40
    assert 10 - SPEC.clip_seconds <= wait_s <= 10 - SPEC.clip_seconds + 30
    assert d["spans"]["loop.tick"]["calls"] >= d["spans"]["loop.sleep"][
        "calls"] > 0

    ev = tracing.events()
    on_loop = [e for e in ev if e[1] == tid]
    assert {e[0] for e in on_loop if e[4] is None} == {"loop.tick",
                                                       "loop.sleep"}
    assert {e[0] for e in on_loop if e[4] == "loop.tick"} >= {
        "loop.fill", "loop.commit", "batch.launch"}
    ticks = [e for e in on_loop if e[0] == "loop.tick"]
    for e in on_loop:
        if e[0] not in ("loop.tick", "loop.sleep", "batch.inflight"):
            assert any(t[2] <= e[2] <= e[3] <= t[3] for t in ticks), e
    by_batch: dict = {}
    for e in ev:
        if e[5] is not None:
            by_batch.setdefault(e[5], set()).add(e[0])
    assert len(by_batch) == n
    for names in by_batch.values():
        assert {"batch.launch", "batch.inflight", "batch.harvest",
                "harvest.fanout", "submit.batch"} <= names
    # the ring's record and the batcher's latency come from the same clock
    assert 0 < b.stats.last_latency_ms
    assert tracing.GLOBAL_SPANS.recent(1)[0]["duration_ms"] == round(
        b.stats.last_latency_ms, 2)


def _tiny_classifier():
    net = EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                             stem_channels=8, embedding_dim=16,
                             num_classes=12)
    m = MelCnnModel(12, MelConfig(sample_rate=48000, n_fft=512, hop=4096,
                                  n_mels=32), net, torch.float32)
    m.spec = SPEC
    m.init(torch.Generator().manual_seed(0))
    return TorchClassifier(m.eval(), "cpu")


def test_offline_analyzer_spans_on_the_cpu(global_events):
    an = OfflineAnalyzer(_tiny_classifier(), synthetic_labels(12),
                         OfflineConfig(batch_size=2, threshold=0.0))
    x = (np.random.default_rng(0).standard_normal(44100 * 10) * 0.1
         ).astype(np.float32)
    before = tracing.snapshot()
    rep = an.analyze_samples(x, 44100)
    d = tracing.delta(before, tracing.snapshot())["spans"]
    batches = -(-len(rep.windows) // 2)
    assert len(rep.windows) == 4 and batches == 2
    assert {k: v["calls"] for k, v in d.items()} == {
        "offline.analyze": 1, "offline.upload": 1, "offline.resample": 1,
        "predict.step": batches, "predict.sync": batches,
        "offline.results": batches}
    parents = {e[0]: e[4] for e in tracing.events()}
    assert parents == {"offline.analyze": None,
                       "offline.upload": "offline.analyze",
                       "offline.resample": "offline.analyze",
                       "predict.step": "offline.analyze",
                       "predict.sync": "offline.analyze",
                       "offline.results": "offline.analyze"}
    a = d["offline.analyze"]
    assert sum(v["total_ns"] for k, v in d.items()
               if k != "offline.analyze") + a["self_ns"] == a["total_ns"]
    assert a["total_ns"] <= rep.elapsed_seconds * 1e9


def test_job_queue_and_datastore_spans(tmp_path, global_events):
    from birdnet_go_tpu_torch.analysis.jobqueue import JobQueue
    from birdnet_go_tpu_torch.analysis.results import Detection
    from birdnet_go_tpu_torch.datastore.sqlite import Datastore

    store = Datastore(str(tmp_path / "birds.db"))
    sp = synthetic_labels(3)[1]
    q = JobQueue(capacity=8, workers=2)
    before = tracing.snapshot()
    for i in range(3):
        q.enqueue(lambda i=i: store.insert_detection(Detection(
            species=sp, confidence=0.9, begin_seconds=1e9 + i,
            end_seconds=1e9 + i + 3, model_id="m")), f"save {i}",
            category="database")
    q.start()
    q.stop(drain=True, timeout=30)
    store.close()
    d = tracing.delta(before, tracing.snapshot())["spans"]
    assert d["job.wait{category=database}"]["calls"] == 3
    assert d["job.run{category=database}"]["calls"] == 3
    assert d["db.commit"]["calls"] == 3
    assert {e[4] for e in tracing.events() if e[0] == "db.commit"} == {
        "job.run"}
