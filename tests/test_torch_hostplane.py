"""The port's host plane against the JAX package's, on the CPU.

The port keeps its own copies of ``AnalysisBuffer``, ``HostBatcher``,
``DeviceLoop`` and the span recorder, so that it imports nothing of
``birdnet_go_tpu``. These tests feed the same seeded sequences through the
copies and the originals and compare what comes out: windows, the order of
fanned-out results, the batchers' and loops' counters, span summaries. They
also show that no module of the port, and not ``chip_smoke.py``, imports the
JAX package, JAX, or the yaml, aiohttp, orbax and optax the card's machine
lacks.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import birdnet_go_tpu.scheduler.loop as jloop
from birdnet_go_tpu.audio.buffers import AnalysisBuffer as JBuffer
from birdnet_go_tpu.utils import tracing as jtracing
from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer as TBuffer
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.models import registry as treg
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import BlockSpec as TBlock
from birdnet_go_tpu_torch.models.efficientnet import EfficientNetConfig as TNet
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.scheduler import loop as tloop
from birdnet_go_tpu_torch.utils import tracing as ttracing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# -- AnalysisBuffer ------------------------------------------------------------

@pytest.mark.parametrize("overlap,read,cap,seed", [
    (0, 7, None, 0), (5, 7, None, 1), (50, 30, None, 2), (12, 12, 24, 3),
    (30, 10, 45, 4), (0, 1, 3, 5)])
def test_analysis_buffer_windows_equal_jax(overlap, read, cap, seed):
    rng = np.random.default_rng(seed)
    j, t = JBuffer(overlap, read, cap), TBuffer(overlap, read, cap)
    assert (t.window_size, t.capacity) == (j.window_size, j.capacity)
    now = 100.0
    for _ in range(300):
        if rng.random() < 0.55:
            # writes up to twice the capacity: wrap-around, clobbered unread
            # samples and oversized writes
            n = int(rng.integers(0, 2 * j.capacity + 2))
            x = rng.integers(-32768, 32768, n).astype(np.int16)
            now += float(rng.random())
            j.write(x, now=now)
            t.write(x, now=now)
        else:
            for _ in range(int(rng.integers(1, 4))):
                wj, wt = j.read(), t.read()
                assert (wj is None) == (wt is None)
                if wj is not None:
                    assert wt.dtype == np.int16
                    np.testing.assert_array_equal(wt, wj)
        assert t.available() == j.available()
        assert t.total_overwritten == j.total_overwritten
        assert t.overwrite_rate(60.0, now=now) == j.overwrite_rate(60.0,
                                                                   now=now)


def test_analysis_buffer_rejects_bad_dimensions():
    for args in ((0, 0), (-1, 5)):
        with pytest.raises(ValueError):
            JBuffer(*args)
        with pytest.raises(ValueError):
            TBuffer(*args)


# -- HostBatcher and DeviceLoop -------------------------------------------------

SPEC = dataclasses.replace(treg.BIRDNET_V24, clip_seconds=0.01,
                           num_species=40)


def _stub(base):
    """A batcher on `base` whose device step is a numpy function of the
    staged rows, so that the two host planes can be compared exactly."""

    class Stub(base):
        def __init__(self, max_batch, depth, ready):
            self._init_host(SPEC, max_batch, 5, None, depth)
            self.ready = ready
            self.launched = []

        def _launch(self, staged, n):
            self.launched.append(n)
            x = staged.astype(np.float32)
            vals = np.stack([x[:, i::5].mean(axis=1) for i in range(5)], 1)
            idx = np.argsort(-vals, axis=1).astype(np.int32)
            return vals, idx

        def _collect(self, handle, meta):
            return handle[0], handle[1], None

        def _ready(self, handle):
            return self.ready

    return Stub


def _drive(mod, batcher, seed, n_streams, n_ticks, dispatches, paths):
    """Offer seeded windows through `mod`'s DeviceLoop; returns the ordered
    fan-out and the loop."""
    rng = np.random.default_rng(seed)
    clip = SPEC.clip_samples
    out = []
    batcher.on_result = lambda w, v, i: out.append(
        ("w", w.source_id, w.start_time, w.end_time, w.pcm_rate,
         v.tolist(), i.tolist()))
    loop = mod.DeviceLoop(tick_seconds=0.01,
                          max_dispatches_per_tick=dispatches)
    loop.add_batcher(batcher)
    tick = {"n": 0}

    def windows(tag):
        k = int(rng.integers(0, n_streams + 1))
        pcm = rng.integers(-3000, 3000, (k, clip)).astype(np.int16)
        sids = [f"{tag}{i}" for i in range(k)]
        sts = [tick["n"] + 0.25 * i for i in range(k)]
        return pcm, sids, sts

    if "items" in paths:
        def provider():
            pcm, sids, sts = windows("s")
            items = [(SPEC.model_id, p, s, st) for p, s, st in
                     zip(pcm, sids, sts)]
            # a window for a model that is not loaded is dropped and counted
            items.append(("nope", pcm[:1], "x", 0.0))
            return items
        loop.add_provider(provider)
    if "block" in paths:
        loop.add_block_provider(SPEC.model_id, lambda: windows("b"))
    if "fill" in paths:
        def fill(view):
            pcm, sids, sts = windows("f")
            n = min(len(view), len(pcm))
            view[:n] = pcm[:n]
            return n, sids[:n], sts[:n]
        loop.add_fill_provider(SPEC.model_id, fill)
    for tick["n"] in range(n_ticks):
        loop.run_tick()
    loop.drain()
    return out, loop


def _counters(batcher, loop):
    stats = dataclasses.asdict(batcher.stats)
    stats.pop("last_latency_ms")
    info = loop.capacity_info()
    for k in ("tick_busy_ms", "tick_busy_ms_max", "stall_ms_max",
              "current_period_ms"):
        info.pop(k)
    return stats, info, loop.windows_dropped, loop.ticks, batcher.launched


@pytest.mark.parametrize("max_batch,depth,ready,dispatches,paths", [
    (4, 2, True, 8, ("items",)),
    (4, 2, None, 1, ("items",)),
    (3, 1, True, 2, ("block",)),
    (5, 3, None, 1, ("block", "items")),
    (4, 2, True, 2, ("fill", "items")),
    (2, 2, False, 1, ("fill", "block", "items")),
])
def test_host_plane_fans_out_as_jax(max_batch, depth, ready, dispatches,
                                    paths):
    results = []
    for mod in (jloop, tloop):
        b = _stub(mod.HostBatcher)(max_batch, depth, ready)
        out, loop = _drive(mod, b, 7, 9, 6, dispatches, paths)
        results.append((out, _counters(b, loop)))
    (want, wc), (got, gc) = results
    assert got == want and len(got) > 0
    assert gc == wc


def test_host_plane_records_spans_in_the_port():
    before_t, before_j = ttracing.GLOBAL_SPANS.total, \
        jtracing.GLOBAL_SPANS.total
    b = _stub(tloop.HostBatcher)(4, 2, True)
    _drive(tloop, b, 3, 6, 3, 8, ("items",))
    n = b.stats.batches_dispatched
    assert n > 0 and ttracing.GLOBAL_SPANS.total == before_t + n
    assert jtracing.GLOBAL_SPANS.total == before_j
    spans = ttracing.GLOBAL_SPANS.recent(n)
    assert {s["model_id"] for s in spans} == {SPEC.model_id}


def _narrow_batcher():
    net = TNet(blocks=(TBlock(1, 16, 3, 1, 1), TBlock(6, 24, 3, 2, 1)),
               stem_channels=16, embedding_dim=32, num_classes=40)
    m = MelCnnModel(40, MelConfig(), net, torch.float32)
    m.spec = dataclasses.replace(SPEC, clip_seconds=0.5)
    m.init(torch.Generator().manual_seed(0))
    return tloop.TorchModelBatcher(TorchClassifier(m.eval(), "cpu"),
                                   max_batch=3, top_k=5, pipeline_depth=2)


def test_to_device_takes_only_staging_buffers():
    """On the CPU the step reads each staging buffer in place; any other
    array is refused."""
    b = _narrow_batcher()
    assert len(b._staged_bufs) == 3
    for buf in b._staged_bufs:
        x = b._to_device(buf)
        assert x.data_ptr() == buf.ctypes.data and x.dtype == torch.int16
    with pytest.raises(ValueError):
        b._to_device(b._staged_bufs[0].copy())


def test_torch_batcher_in_port_loop_fans_out_as_jax_loop():
    """The CPU ``TorchModelBatcher`` in the port's ``DeviceLoop`` and the
    same batcher in the JAX package's ``DeviceLoop``: the same windows, in
    the same order, with the same results and counters."""
    runs = []
    for mod in (jloop, tloop):
        b = _narrow_batcher()
        b.launched = []
        launch = b._launch
        b._launch = lambda staged, n, f=launch, b=b: (b.launched.append(n),
                                                      f(staged, n))[1]
        clip = b.spec.clip_samples
        overlap, read = clip // 2, clip - clip // 2
        buffer = JBuffer if mod is jloop else TBuffer
        bufs = {f"m{i}": buffer(overlap, read) for i in range(4)}
        pos = dict.fromkeys(bufs, 0.0)
        out = []
        b.on_result = lambda w, v, i: out.append(
            (w.source_id, w.start_time, np.round(v, 6).tolist(),
             i.tolist()))

        def provider():
            items = []
            for sid, buf in bufs.items():
                while (win := buf.read()) is not None:
                    items.append((b.spec.model_id, win, sid, pos[sid]))
                    pos[sid] += read / b.spec.sample_rate
            return items

        loop = mod.DeviceLoop(tick_seconds=0.01, max_dispatches_per_tick=2)
        loop.add_batcher(b)
        loop.add_provider(provider)
        rng = np.random.default_rng(11)
        for _ in range(3):
            for buf in bufs.values():
                buf.write((rng.standard_normal(read) * 3000).astype(np.int16))
            loop.run_tick()
        loop.drain()
        runs.append((out, _counters(b, loop)))
    (want, wc), (got, gc) = runs
    assert len(got) == 12 and got == want
    assert gc == wc


def test_device_loop_run_logs_persistent_failure(caplog):
    """A tick that fails 30 times in a row tags one ``EnhancedError``: the
    port's ERROR records (logger, level, message) equal the JAX loop's."""
    records = []
    for mod in (jloop, tloop):
        loop = mod.DeviceLoop(tick_seconds=0.001)
        calls = {"n": 0}

        def provider(loop=loop, calls=calls):
            calls["n"] += 1
            if calls["n"] >= 31:
                loop._stop.set()
            raise RuntimeError("device gone")

        loop.add_provider(provider)
        caplog.clear()
        with caplog.at_level("ERROR", logger="birdnet_tpu"):
            loop._run()
        assert loop.consecutive_tick_failures == 31
        records.append([(r.name, r.levelno, r.getMessage())
                        for r in caplog.records if r.levelno >= 40])
    want, got = records
    assert got == want
    assert ("birdnet_tpu.scheduler", 40,
            "[scheduler/model] device gone {'traceback': 'RuntimeError: "
            "device gone'}") in got


@pytest.mark.parametrize("cause", [RuntimeError("device gone"),
                                   KeyError("stream"), "no device"])
def test_enhanced_error_equals_jax(cause, caplog):
    """``from_exception`` and the builder give the JAX package's error:
    the same ``as_dict`` (timestamp aside), ``str`` and log record."""
    from birdnet_go_tpu.utils import errors as jerrors
    from birdnet_go_tpu_torch.utils import errors as terrors

    out = []
    for mod in (jerrors, terrors):
        caplog.clear()
        with caplog.at_level("ERROR", logger="birdnet_tpu"):
            if isinstance(cause, BaseException):
                err = mod.from_exception(cause, "scheduler",
                                         mod.Category.MODEL)
            else:
                err = (mod.new(cause).component("capture")
                       .category(mod.Category.AUDIO)
                       .context("source", "rtsp:0").build())
        assert isinstance(err, mod.EnhancedError)
        d = err.as_dict()
        assert d.pop("timestamp") > 0
        out.append((d, str(err), [(r.name, r.levelno, r.getMessage())
                                  for r in caplog.records]))
    assert out[1] == out[0]

    def categories(mod):
        return {k: v for k, v in vars(mod.Category).items()
                if not k.startswith("_")}

    assert categories(terrors) == categories(jerrors)


# -- tracing ------------------------------------------------------------------

def test_span_recorder_summary_equals_jax():
    rng = np.random.default_rng(5)
    j, t = jtracing.SpanRecorder(capacity=40), ttracing.SpanRecorder(
        capacity=40)
    assert t.summary() == j.summary()
    for i in range(97):
        args = (f"m{i % 3}", int(rng.integers(1, 257)), float(rng.random()),
                float(rng.random() * 80), bool(rng.random() > 0.1),
                "" if i % 7 else "boom")
        j.record(*args)
        t.record(*args)
    assert t.summary() == j.summary()
    strip = [{k: v for k, v in s.items() if k != "ts"} for s in t.recent(40)]
    assert strip == [{k: v for k, v in s.items() if k != "ts"}
                     for s in j.recent(40)]


def test_predict_span_records_like_jax():
    spans = []
    for mod in (jtracing, ttracing):
        rec = mod.SpanRecorder()
        with mod.predict_span("m", 8, 0.5, recorder=rec):
            pass
        with pytest.raises(KeyError):
            with mod.predict_span("m", 4, recorder=rec):
                raise KeyError("x")
        spans.append([(s["model_id"], s["batch"], s["fill"], s["ok"],
                       s.get("error")) for s in rec.recent()])
    assert spans[0] == spans[1] == [("m", 8, 0.5, True, None),
                                    ("m", 4, 1.0, False, "'x'")]


# -- import guard ----------------------------------------------------------------

def _port_modules() -> list[str]:
    pkg = REPO / "birdnet_go_tpu_torch"
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in pkg.rglob("*.py"))


# the JAX package and what the card's machine lacks: JAX, and the yaml,
# aiohttp, orbax, optax and httpx the JAX host modules import
_BLOCKED = ("jax", "jaxlib", "birdnet_go_tpu", "yaml", "aiohttp", "orbax",
            "optax", "httpx")

_GUARDED_IMPORT = """
import importlib, sys
blocked = %r
for name in blocked:
    sys.modules[name] = None          # any import of them raises
for m in %r:
    importlib.import_module(m)
bad = [m for m, v in sys.modules.items() if v is not None and
       m.split(".")[0] in blocked]
assert not bad, bad
print("ok")
"""


def test_port_imports_with_jax_and_jax_package_blocked():
    mods = _port_modules()
    assert {"birdnet_go_tpu_torch.scheduler.loop",
            "birdnet_go_tpu_torch.audio.buffers",
            "birdnet_go_tpu_torch.utils.tracing",
            "birdnet_go_tpu_torch.__main__",
            "birdnet_go_tpu_torch.cli.__main__",
            "birdnet_go_tpu_torch.cli.main",
            "birdnet_go_tpu_torch.analysis.offline",
            "birdnet_go_tpu_torch.inference.loader",
            "birdnet_go_tpu_torch.inference.flatbuf",
            "birdnet_go_tpu_torch.inference.protowire",
            "birdnet_go_tpu_torch.inference.tflite_import",
            "birdnet_go_tpu_torch.inference.onnx_import",
            "birdnet_go_tpu_torch.inference.opaudit",
            "birdnet_go_tpu_torch.inference.verify_artifact",
            "birdnet_go_tpu_torch.diag.replicas",
            "birdnet_go_tpu_torch.taxonomy.labels",
            "birdnet_go_tpu_torch.train",
            "birdnet_go_tpu_torch.train.dataset",
            "birdnet_go_tpu_torch.train.trainer",
            "birdnet_go_tpu_torch.inference.checkpoint",
            "birdnet_go_tpu_torch.models.catalog"} <= set(mods)
    res = subprocess.run([sys.executable, "-c",
                          _GUARDED_IMPORT % (_BLOCKED, mods)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("where", ["chip_smoke.py", "birdnet_go_tpu_torch"])
def test_no_import_of_the_jax_package(where):
    path = REPO / where
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    assert files
    for f in files:
        for name in _imported_names(f):
            assert name.split(".")[0] not in _BLOCKED, (f, name)
