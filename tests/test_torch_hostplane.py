"""The port's host plane against the JAX package's, on the CPU.

The port keeps its own copies of ``AnalysisBuffer``, ``HostBatcher``,
``DeviceLoop`` and the span recorder, so that it imports nothing of
``birdnet_go_tpu``. These tests feed the same seeded sequences through the
copies and the originals and compare what comes out: windows, the order of
fanned-out results, the batchers' and loops' counters, span summaries. They
also show that no module of the port, and not ``chip_smoke.py``, imports the
JAX package, JAX, or the yaml, aiohttp, orbax, optax, httpx and Pillow
the card's machine lacks.
"""

import ast
import dataclasses
import subprocess
import sys
import types
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


class _Clock:
    """One fake ``time.monotonic`` for both loops. It moves only where a
    stub's launch moves it, by LAUNCH_S a window, so a batch's latency,
    and with it ``stats.overruns`` (latencies past the budget), follows
    from the windows launched and not from the host's load."""

    LAUNCH_S = 0.002

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def perf_counter_ns(self) -> int:
        return round(self.t * 1e9)


def _stub(base, clock=None):
    """A batcher on `base` whose device step is a numpy function of the
    staged rows, so that the two host planes can be compared exactly; a
    launch moves `clock` (a ``_Clock``) if one is given."""

    class Stub(base):
        def __init__(self, max_batch, depth, ready):
            self._init_host(SPEC, max_batch, 5, None, depth)
            self.ready = ready
            self.launched = []

        def _launch(self, staged, n):
            self.launched.append(n)
            if clock is not None:
                clock.t += clock.LAUNCH_S * n
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
                                    paths, monkeypatch):
    """Both loops on one fake clock each (``_Clock``), so that every
    counter, ``overruns`` included, is compared exactly."""
    results = []
    for mod in (jloop, tloop):
        clock = _Clock()
        # the port times a batch on the spans' clock, perf_counter_ns
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic, perf_counter_ns=clock.perf_counter_ns,
            time=clock.monotonic))
        b = _stub(mod.HostBatcher, clock)(max_batch, depth, ready)
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
    """``recent()`` equals JAX's ring. ``summary()`` diverges by design:
    JAX's covers the ring's last `capacity` batches, the port's every batch
    since the recorder started, its percentiles the upper edges of 9%-wide
    buckets (never above the max). With the ring holding every batch the
    two agree on the count, errors, models and max, and each percentile of
    the port's lies in [JAX's, JAX's × 2**(1/8)]."""
    rng = np.random.default_rng(5)
    j, t = jtracing.SpanRecorder(capacity=40), ttracing.SpanRecorder(
        capacity=40)
    whole = jtracing.SpanRecorder(capacity=1000)
    assert j.summary() == {"count": 0, "total": 0}
    assert t.summary() == {"count": 0, "total": 0}
    for i in range(97):
        args = (f"m{i % 3}", int(rng.integers(1, 257)), float(rng.random()),
                float(rng.random() * 80), bool(rng.random() > 0.1),
                "" if i % 7 else "boom")
        j.record(*args)
        t.record(*args)
        whole.record(*args)
    strip = [{k: v for k, v in s.items() if k != "ts"} for s in t.recent(40)]
    assert strip == [{k: v for k, v in s.items() if k != "ts"}
                     for s in j.recent(40)]
    got, last40, want = t.summary(), j.summary(), whole.summary()
    assert last40["count"] == 40 and got["count"] == want["count"] == 97
    for k in ("total", "errors", "by_model", "max_ms"):
        assert got[k] == want[k], k
    for k in ("p50_ms", "p90_ms", "p99_ms"):
        assert want[k] <= got[k] <= want[k] * 2 ** (1 / 8) + 1e-9, k


# -- import guard ----------------------------------------------------------------

def _port_modules() -> list[str]:
    pkg = REPO / "birdnet_go_tpu_torch"
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in pkg.rglob("*.py"))


# the JAX package and what the card's machine lacks: JAX, and the yaml,
# aiohttp, orbax, optax, httpx and Pillow the JAX host modules import; no
# port module imports any of them (yaml only through importlib where a
# config is read, and JSON where it is missing: _IMPORTLIB_ALLOWED)
_NEVER = ("jax", "jaxlib", "birdnet_go_tpu", "yaml", "aiohttp", "orbax",
          "optax", "httpx", "PIL", "websockets")
# cryptography is on the card's machine: the port imports it where JAX
# does, inside the functions of MySQL's RSA full auth, backup encryption,
# TLS certificates, ACME and the OIDC and Cloudflare tokens, and of the
# fake services' CA, identity provider and ACME directory
# (_FUNCTION_IMPORTS), never when a module loads
_BLOCKED = _NEVER + ("cryptography",)
_FUNCTION_IMPORTS = {
    "cryptography": {"birdnet_go_tpu_torch/datastore/mysql_wire.py",
                     "birdnet_go_tpu_torch/utils/backup.py",
                     "birdnet_go_tpu_torch/utils/tlscert.py",
                     "birdnet_go_tpu_torch/utils/acme.py",
                     "birdnet_go_tpu_torch/api/oidc.py",
                     "birdnet_go_tpu_torch/api/cloudflare.py",
                     "birdnet_go_tpu_torch/diag/fake_services.py"}}
# (module, files) the port may name to importlib.import_module
# (and chip_smoke.py's phase 15 reports whether Pillow imports on the
# machine)
_IMPORTLIB_ALLOWED = {"yaml": {"birdnet_go_tpu_torch/config/settings.py",
                               "birdnet_go_tpu_torch/cli/main.py"},
                      "PIL": {"chip_smoke.py"}}

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
            "birdnet_go_tpu_torch.models.catalog",
            "birdnet_go_tpu_torch.config",
            "birdnet_go_tpu_torch.config.settings",
            "birdnet_go_tpu_torch.taxonomy.nonbird",
            "birdnet_go_tpu_torch.taxonomy.openfauna",
            "birdnet_go_tpu_torch.utils.suncalc",
            "birdnet_go_tpu_torch.analysis.deep_detection",
            "birdnet_go_tpu_torch.analysis.dynamic_threshold",
            "birdnet_go_tpu_torch.analysis.processor",
            "birdnet_go_tpu_torch.analysis.jobqueue",
            "birdnet_go_tpu_torch.analysis.actions",
            "birdnet_go_tpu_torch.datastore",
            "birdnet_go_tpu_torch.datastore.sqlite",
            "birdnet_go_tpu_torch.scheduler.soak",
            "birdnet_go_tpu_torch.audio.resampler",
            "birdnet_go_tpu_torch.audio.audionorm",
            "birdnet_go_tpu_torch.audio.flac",
            "birdnet_go_tpu_torch.audio.encode",
            "birdnet_go_tpu_torch.audio.hlsmux",
            "birdnet_go_tpu_torch.utils.imports",
            "birdnet_go_tpu_torch.datastore.migration",
            "birdnet_go_tpu_torch.analysis.spectrogram",
            "birdnet_go_tpu_torch.analysis.soundlevel_worker",
            "birdnet_go_tpu_torch.ops.streams",
            "birdnet_go_tpu_torch.app",
            "birdnet_go_tpu_torch.utils.health",
            "birdnet_go_tpu_torch.utils.logsetup",
            "birdnet_go_tpu_torch.config.control",
            "birdnet_go_tpu_torch.audio.source",
            "birdnet_go_tpu_torch.audio.equalizer",
            "birdnet_go_tpu_torch.audio.sources_file",
            "birdnet_go_tpu_torch.audio.engine",
            "birdnet_go_tpu_torch.audio.liveness",
            "birdnet_go_tpu_torch.audio.quiet_hours",
            "birdnet_go_tpu_torch.analysis.eventtracker",
            "birdnet_go_tpu_torch.analysis.species_tracker",
            "birdnet_go_tpu_torch.analysis.pipeline_stats",
            "birdnet_go_tpu_torch.analysis.alerting",
            "birdnet_go_tpu_torch.utils.events",
            "birdnet_go_tpu_torch.utils.telemetry",
            "birdnet_go_tpu_torch.utils.circuit",
            "birdnet_go_tpu_torch.utils.httpclient",
            "birdnet_go_tpu_torch.utils.monitor",
            "birdnet_go_tpu_torch.utils.sysmonitor",
            "birdnet_go_tpu_torch.utils.backendprobe",
            "birdnet_go_tpu_torch.integrations",
            "birdnet_go_tpu_torch.integrations.notification",
            "birdnet_go_tpu_torch.integrations.push_urls",
            "birdnet_go_tpu_torch.utils.diskmanager",
            "birdnet_go_tpu_torch.analysis.recovery",
            "birdnet_go_tpu_torch.scheduler.crashleg",
            "birdnet_go_tpu_torch.utils.support",
            "birdnet_go_tpu_torch.config.schema",
            "birdnet_go_tpu_torch.api",
            "birdnet_go_tpu_torch.api.web",
            "birdnet_go_tpu_torch.api.sse",
            "birdnet_go_tpu_torch.api.auth",
            "birdnet_go_tpu_torch.api.security",
            "birdnet_go_tpu_torch.api.server",
            "birdnet_go_tpu_torch.api.handlers_ext",
            "birdnet_go_tpu_torch.utils.metrics",
            "birdnet_go_tpu_torch.utils.sysinfo",
            "birdnet_go_tpu_torch.utils.update",
            "birdnet_go_tpu_torch.api.terminal",
            "birdnet_go_tpu_torch.api.oidc",
            "birdnet_go_tpu_torch.api.github_auth",
            "birdnet_go_tpu_torch.api.cloudflare",
            "birdnet_go_tpu_torch.utils.tlscert",
            "birdnet_go_tpu_torch.utils.acme",
            "birdnet_go_tpu_torch.diag.ws_client",
            "birdnet_go_tpu_torch.analysis.insights",
            "birdnet_go_tpu_torch.taxonomy.speciesdict",
            "birdnet_go_tpu_torch.integrations.imageprovider",
            "birdnet_go_tpu_torch.audio.rtsp",
            "birdnet_go_tpu_torch.audio.capture",
            "birdnet_go_tpu_torch.audio.ffmpeg",
            "birdnet_go_tpu_torch.integrations.mqtt",
            "birdnet_go_tpu_torch.integrations.birdweather",
            "birdnet_go_tpu_torch.integrations.weather",
            "birdnet_go_tpu_torch.integrations.ebird",
            "birdnet_go_tpu_torch.datastore.mysql",
            "birdnet_go_tpu_torch.datastore.mysql_wire",
            "birdnet_go_tpu_torch.utils.backup",
            "birdnet_go_tpu_torch.diag.mysql_server",
            "birdnet_go_tpu_torch.diag.fake_services",
            "birdnet_go_tpu_torch.audio.opusogg",
            "birdnet_go_tpu_torch.audio.aacenc",
            "birdnet_go_tpu_torch.native.lib",
            "birdnet_go_tpu_torch.diag.import_data",
            "birdnet_go_tpu_torch.version"} <= set(mods)
    res = subprocess.run([sys.executable, "-c",
                          _GUARDED_IMPORT % (_BLOCKED, mods)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _imports(path: Path) -> list[tuple[str, bool]]:
    """Each module `path` imports, and whether the import sits inside a
    function."""
    out = []

    def visit(node, in_function: bool) -> None:
        if isinstance(node, ast.Import):
            out.extend((a.name, in_function) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.module or "", in_function))
        inner = in_function or isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(ast.parse(path.read_text()), False)
    return out


def _imported_names(path: Path) -> list[str]:
    return [name for name, _ in _imports(path)]


@pytest.mark.parametrize("where", ["chip_smoke.py", "birdnet_go_tpu_torch"])
def test_no_import_of_the_jax_package(where):
    """No import of what ``_NEVER`` names (JAX and its package; aiohttp,
    httpx and websockets, which the port's server, transport and socket
    stand in for); ``cryptography`` only inside a function of the files
    ``_FUNCTION_IMPORTS`` allows."""
    path = REPO / where
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    assert files
    for f in files:
        rel = f.relative_to(REPO).as_posix()
        for name, in_function in _imports(f):
            top = name.split(".")[0]
            assert top not in _NEVER, (f, name)
            if top in _FUNCTION_IMPORTS:
                assert in_function and rel in _FUNCTION_IMPORTS[top], \
                    (f, name)


def test_cryptography_imports_sit_in_their_functions():
    """The imports ``_FUNCTION_IMPORTS`` allows are there (MySQL's RSA
    full auth, backup encryption and decryption, TLS, ACME, the OIDC and
    Cloudflare tokens, the fake services), each inside a function."""
    found = {}
    for rel in _FUNCTION_IMPORTS["cryptography"]:
        found[rel] = [fn for name, fn in _imports(REPO / rel)
                      if name.split(".")[0] == "cryptography"]
    assert all(found.values()) and all(all(v) for v in found.values()), \
        found


def _import_module_calls(path: Path) -> list[tuple[str, int]]:
    """The first argument of each ``import_module(...)`` call in `path`
    (``?`` where it is not a string literal), with its line."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name == "import_module" and node.args:
                arg = node.args[0]
                out.append((arg.value if isinstance(arg, ast.Constant)
                            else "?", node.lineno))
    return out


@pytest.mark.parametrize("where", ["chip_smoke.py", "birdnet_go_tpu_torch"])
def test_no_import_module_of_a_blocked_name(where):
    """No ``importlib.import_module`` of a name of ``_BLOCKED`` (the AST
    check above sees no such import): yaml only where a config is read
    (``_IMPORTLIB_ALLOWED``), and the names a call takes from a variable
    are the port's own modules."""
    path = REPO / where
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    for f in files:
        rel = f.relative_to(REPO).as_posix()
        for name, line in _import_module_calls(f):
            if name == "?":
                src = f.read_text().splitlines()[line - 1]
                assert "birdnet_go_tpu_torch" in src or "f\"" in src, \
                    (rel, line, src)
                continue
            top = name.split(".")[0]
            if top in _BLOCKED:
                assert rel in _IMPORTLIB_ALLOWED.get(top, ()), (rel, name)


def test_only_the_bridge_imports_both_packages():
    """Outside the tests, ``convert_jax_checkpoint.py`` is the one file
    that imports both the JAX package and the port."""
    files = [*REPO.glob("*.py"), *(REPO / "birdnet_go_tpu").rglob("*.py"),
             *(REPO / "birdnet_go_tpu_torch").rglob("*.py")]
    assert REPO / "chip_smoke.py" in files
    both = [str(f.relative_to(REPO)) for f in sorted(files)
            if {"birdnet_go_tpu", "birdnet_go_tpu_torch"} <= {
                n.split(".")[0] for n in _imported_names(f)}]
    assert both == ["convert_jax_checkpoint.py"]
