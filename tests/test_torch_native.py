"""The port's copy of the native ingest plane against the JAX package's, on
the CPU.

``birdnet_go_tpu_torch.native`` builds the repository's ``native/*.cpp``
into ``build/torch_native/`` and binds them as the JAX package does. These
tests hold its ring buffer to the port's ``AnalysisBuffer`` and to the JAX
package's native ring, window for window; its stream farm to the JAX
package's farm at the same seed and configuration; and feed a farm through
``DeviceLoop.add_fill_provider`` into a narrow CPU ``TorchModelBatcher``.
"""

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_go_tpu.native import lib as jnative
from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    BlockSpec,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.native import lib as tnative
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.scheduler.loop import DeviceLoop, TorchModelBatcher

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RATE = 48000
WINDOW = 9600           # 0.2 s windows keep the farms fast
HOP = 4800


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    return jnative


@pytest.mark.parametrize("overlap,read,cap,seed", [
    (4, 4, None, 0), (7, 13, 64, 1), (0, 9, 27, 2), (30, 10, 45, 3),
    (2, 2, 8, 4)])
def test_native_buffer_windows_equal_python_and_jax(jax_native, overlap,
                                                    read, cap, seed):
    """Seeded writes (some wrapping the ring and clobbering unread samples)
    and reads: every window, and the overwrite counts, agree."""
    rng = np.random.default_rng(seed)
    bufs = (tnative.NativeAnalysisBuffer(overlap, read, cap),
            AnalysisBuffer(overlap, read, cap),
            jax_native.NativeAnalysisBuffer(overlap, read, cap))
    capacity = bufs[1].capacity
    n_windows = 0
    for _ in range(400):
        if rng.random() < 0.5:
            x = rng.integers(-32768, 32768,
                             int(rng.integers(1, capacity + 1))).astype(
                np.int16)
            for b in bufs:
                b.write(x)
        else:
            for _ in range(int(rng.integers(1, 4))):
                got = [b.read() for b in bufs]
                if got[0] is None:
                    assert got[1] is None and got[2] is None
                    break
                np.testing.assert_array_equal(got[0], got[1])
                np.testing.assert_array_equal(got[0], got[2])
                n_windows += 1
    assert n_windows > 20
    lost = [b.total_overwritten for b in bufs]
    assert lost[0] == lost[1] == lost[2]
    if cap is not None:
        assert lost[0] > 0


def test_native_buffer_read_batch_equals_reads():
    a = tnative.NativeAnalysisBuffer(3, 5, 64)
    b = AnalysisBuffer(3, 5, 64)
    x = np.arange(1, 38, dtype=np.int16)
    a.write(x)
    b.write(x)
    batch = a.read_batch(16)
    want = []
    while (w := b.read()) is not None:
        want.append(w)
    assert batch.shape == (len(want), 8) and len(want) == 7
    np.testing.assert_array_equal(batch, np.stack(want))
    assert a.read() is None and a.available() == b.available()


def _farm(mod, n_streams=4, timescale=40.0, **kw):
    # ring_seconds is stream time: 24 s is 0.6 s of wall time at 40x
    return mod.StreamFarm(n_streams, RATE, WINDOW, HOP, ring_seconds=24.0,
                          n_waveforms=4, seed=5, timescale=timescale, **kw)


def test_farm_windows_equal_jax_farm(jax_native):
    """Both farms at the same seed and configuration, drained side by
    side: every (stream, index) both collected holds the same window."""
    farms = (_farm(tnative, stagger_hops=2), _farm(jax_native,
                                                   stagger_hops=2))
    out = np.empty((128, WINDOW), np.int16)
    meta = np.empty((128, 3), np.int64)
    got = ({}, {})
    for f in farms:
        f.start()
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.2:
            for f, windows in zip(farms, got):
                n = f.collect(out, meta)
                for j in range(n):
                    windows[(int(meta[j, 0]), int(meta[j, 1]))] = (
                        int(meta[j, 2]), out[j].copy())
            time.sleep(0.02)
    finally:
        for f in farms:
            f.stop()
    stats = [f.stats() for f in farms]
    for f in farms:
        f.close()
    both = set(got[0]) & set(got[1])
    assert len(both) > 40 and {s for s, _ in both} == set(range(4))
    for key in both:
        assert got[0][key][0] == got[1][key][0]
        np.testing.assert_array_equal(got[0][key][1], got[1][key][1])
    assert stats[0]["n_streams"] == stats[1]["n_streams"] == 4
    assert stats[0]["ring_capacity"] == stats[1]["ring_capacity"]


def test_port_library_lands_in_its_own_build_directory(jax_native):
    path = tnative.build_native()
    assert path == REPO / "build" / "torch_native" / "libbirdnet_host.so"
    assert path.is_file() and tnative.available()
    lib = tnative._load()
    assert Path(lib._name) == path
    assert Path(jax_native._load()._name) != path
    # the rings, the farm and the RTSP plane; not the codecs
    assert hasattr(lib, "bn_farm_create") and hasattr(lib, "bn_rtspd_create")
    assert not hasattr(lib, "bn_opus_available")


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """With no sources to build, ``_load`` raises: no path quietly drops
    to the Python buffers."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_SRC_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB_PATH",
                        tmp_path / "build" / "libbirdnet_host.so")
    with pytest.raises(RuntimeError, match="native build failed"):
        tnative.StreamFarm(2, RATE, WINDOW, HOP)
    with pytest.raises(RuntimeError):
        tnative.NativeAnalysisBuffer(4, 4)
    with pytest.raises(RuntimeError):
        tnative.available()


def test_collect_and_fill_provider_reject_bad_arguments():
    farm = _farm(tnative, n_streams=2)
    try:
        meta = np.empty((4, 3), np.int64)
        for out in (np.empty((4, WINDOW), np.float32),
                    np.empty((4, WINDOW + 1), np.int16),
                    np.empty((4, 2 * WINDOW), np.int16)[:, ::2]):
            with pytest.raises(ValueError):
                farm.collect(out, meta)
        with pytest.raises(ValueError):
            farm.collect(np.empty((8, WINDOW), np.int16), meta)
        with pytest.raises(ValueError):
            tnative.fill_provider(farm, names=["only one"])
    finally:
        farm.close()


N_CLASSES = 12


def _narrow_batcher(max_batch):
    net = EfficientNetConfig(blocks=(BlockSpec(1, 16, 3, 1, 1),),
                             stem_channels=16, embedding_dim=24,
                             num_classes=N_CLASSES)
    m = MelCnnModel(N_CLASSES, MelConfig(), net, torch.float32)
    m.spec = dataclasses.replace(registry.BIRDNET_V24,
                                 clip_seconds=WINDOW / RATE,
                                 num_species=N_CLASSES)
    m.init(torch.Generator().manual_seed(0))
    return TorchModelBatcher(TorchClassifier(m, "cpu"), max_batch=max_batch,
                             top_k=5, pipeline_depth=2)


def test_farm_feeds_the_device_loop_through_a_fill_provider():
    """StreamFarm → ``fill_provider`` → ``DeviceLoop.add_fill_provider`` →
    a narrow CPU batcher: every window the farm emitted comes back with its
    top-5, none dropped or lost, start times in order per source, one hop
    apart."""
    batcher = _narrow_batcher(max_batch=8)
    results = {}

    def on_result(w, vals, idx):
        results.setdefault(w.source_id, []).append(w.start_time)
        assert vals.shape == (5,) and np.isfinite(vals).all()
        assert ((idx >= 0) & (idx < N_CLASSES)).all()

    batcher.on_result = on_result
    farm = _farm(tnative, n_streams=3, timescale=10.0)
    names = [f"mic{s}" for s in range(3)]
    loop = DeviceLoop(tick_seconds=0.02)
    loop.add_batcher(batcher)
    loop.add_fill_provider(batcher.spec.model_id,
                           tnative.fill_provider(farm, names, epoch=100.0))
    farm.start()
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.0:
            loop.run_tick()
            time.sleep(0.02)
        farm.stop()
        while loop.run_tick():
            pass
        loop.drain()
        stats = farm.stats()
    finally:
        farm.close()
    n = sum(len(v) for v in results.values())
    assert stats["samples_lost"] == 0 and loop.windows_dropped == 0
    assert n == stats["windows_emitted"] == batcher.stats.windows_processed
    assert n >= 30 and set(results) == set(names)
    hop_s = HOP / RATE
    for starts in results.values():
        d = np.diff(starts)
        np.testing.assert_allclose(d, hop_s, rtol=1e-9)
        # stream time: index 0 ends one hop after the stream's offset
        assert 100.0 - hop_s <= starts[0] < 100.0
