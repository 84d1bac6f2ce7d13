"""The port's realtime device step against the JAX package's, on the CPU.

Inputs come from a numpy seed; parameters from the JAX ``init`` through
``params_from_jax``. Covers a narrow EfficientNet end to end (int16 PCM →
logits), the torch batcher inside the JAX package's ``DeviceLoop`` against
``ModelBatcher``, one full-width float32 BirdNET v2.4 forward against the
``birdnet_v24_seed0_logits`` golden fingerprint (read only), the copied
model registry, and the port's freedom from JAX.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_go_tpu.audio.buffers import AnalysisBuffer
from birdnet_go_tpu.inference.backend import JaxClassifier
from birdnet_go_tpu.models import registry as jreg
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.scheduler.loop import DeviceLoop, ModelBatcher
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.inference.params import (
    load_jax_params,
    params_from_jax,
)
from birdnet_go_tpu_torch.models import registry as treg
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.efficientnet import BlockSpec as TBlock
from birdnet_go_tpu_torch.models.efficientnet import EfficientNetConfig as TNet
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.ops.pallas_melspec import melspec_fused
from birdnet_go_tpu_torch.scheduler.loop import TorchModelBatcher

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"

NARROW = ((1, 16, 3, 1, 1), (6, 24, 3, 2, 1), (6, 40, 5, 2, 1))
N_CLASSES = 64
CLIP = 48000


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _spec(reg):
    return dataclasses.replace(reg.BIRDNET_V24, clip_seconds=1.0,
                               num_species=N_CLASSES)


@pytest.fixture(scope="module")
def narrow():
    """(JAX model, JAX params, torch model), float32, same weights."""
    jm = JBirdNETv24(num_species=N_CLASSES, compute_dtype=jnp.float32)
    jm.net = JNet(blocks=tuple(JBlock(*b) for b in NARROW),
                  stem_channels=16, embedding_dim=48, num_classes=N_CLASSES)
    jm.spec = _spec(jreg)
    jm.use_fused_frontend = False
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    net = TNet(blocks=tuple(TBlock(*b) for b in NARROW), stem_channels=16,
               embedding_dim=48, num_classes=N_CLASSES)
    tm = MelCnnModel(N_CLASSES, MelConfig(**dataclasses.asdict(jm.mel)),
                     net, torch.float32)
    tm.spec = _spec(treg)
    load_jax_params(tm.backbone, _np_tree(params))
    return jm, params, tm.eval()


def _pcm16(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 48000.0
    tones = np.sin(2 * np.pi * rng.uniform(300, 9000, (shape[0], 1)) * t)
    x = 0.3 * tones + 0.05 * rng.standard_normal(shape)
    return (x * 32767).astype(np.int16)


def test_narrow_apply_int16_matches_jax(narrow):
    jm, params, tm = narrow
    pcm = _pcm16((3, CLIP), 0)
    ref = jax.jit(jm.apply_int16)(params, jnp.asarray(pcm))
    with torch.inference_mode():
        got = tm.apply_int16(torch.from_numpy(pcm))
    for key in ("logits", "embedding"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4)
    # float32 PCM through apply: the same numbers
    with torch.inference_mode():
        f32 = tm.apply(torch.from_numpy(pcm.astype(np.float32) / 32768.0))
    np.testing.assert_allclose(f32["logits"].numpy(),
                               got["logits"].numpy(), rtol=1e-6, atol=1e-6)


def test_classifier_matches_jax(narrow):
    jm, params, tm = narrow
    pcm = _pcm16((2, CLIP), 1).astype(np.float32) / 32768.0
    mask = (np.arange(N_CLASSES) % 3 != 0).astype(np.float32)
    jc = JaxClassifier(jm, params, range_mask=mask)
    tc = TorchClassifier(tm, "cpu", range_mask=mask)
    jv, ji = jc.predict_topk(pcm, sensitivity=0.8, k=5)
    tv, ti = tc.predict_topk(pcm, sensitivity=0.8, k=5)
    _assert_topk_match(tv, ti, jv, ji)
    assert ti.dtype == np.int32 and not np.isin(ti, np.arange(0, 64, 3)).any()
    np.testing.assert_allclose(tc.embed(pcm), jc.embed(pcm), rtol=1e-4,
                               atol=1e-4)
    tc.set_range_mask(None)
    assert tc._range_mask is None


def _assert_topk_match(v1, i1, v2, i2, tol=1e-5):
    """Values allclose; indices equal, as sets within runs of tied values
    (a tied run at the end may be cut differently by the two top-k's)."""
    np.testing.assert_allclose(v1, v2, atol=tol)
    for r in range(len(v1)):
        k = len(v1[r])
        start = 0
        for pos in range(1, k + 1):
            if pos < k and abs(v1[r, pos] - v1[r, pos - 1]) <= tol:
                continue
            if pos < k or pos - start == 1:
                assert set(i1[r, start:pos]) == set(i2[r, start:pos]), r
            start = pos


def _drive(batcher, n_streams=6, n_ticks=3):
    """Feed streams through AnalysisBuffers and DeviceLoop.run_tick; return
    {(source, start_time): (values, indices)} and the loop."""
    overlap, read = (b // 2 for b in batcher.spec.buffer_dimensions())
    bufs = {f"s{i}": AnalysisBuffer(overlap, read) for i in range(n_streams)}
    pos = {sid: 0.0 for sid in bufs}
    results = {}

    def on_result(w, vals, idx):
        results[(w.source_id, w.start_time)] = (vals.copy(), idx.copy())

    def provider():
        items = []
        for sid, buf in bufs.items():
            while (win := buf.read()) is not None:
                items.append((batcher.spec.model_id, win, sid, pos[sid]))
                pos[sid] += read / batcher.spec.sample_rate
        return items

    batcher.on_result = on_result
    loop = DeviceLoop(tick_seconds=0.01)
    loop.add_batcher(batcher)
    loop.add_provider(provider)
    for tick in range(n_ticks):
        for i, buf in enumerate(bufs.values()):
            buf.write(_pcm16((1, read), 100 * tick + i)[0])
        loop.run_tick()
    loop.drain()
    return results, loop


def test_torch_batcher_in_device_loop_matches_jax(narrow):
    jm, params, tm = narrow
    jb = ModelBatcher(JaxClassifier(jm, params), max_batch=4, top_k=10,
                      pipeline_depth=2)
    tb = TorchModelBatcher(TorchClassifier(tm, "cpu"), max_batch=4,
                           top_k=10, pipeline_depth=2)
    assert tb.warmup() >= 0.0
    want, _ = _drive(jb)
    got, loop = _drive(tb)
    assert loop.windows_dropped == 0
    assert set(got) == set(want) and len(got) == 18
    assert tb.stats.batches_dispatched == jb.stats.batches_dispatched == 6
    for key in sorted(want):
        v, i = got[key]
        assert i.dtype == np.int32 and len(v) == 10
        assert np.all(np.diff(v) <= 0)
        _assert_topk_match(v[None], i[None], want[key][0][None],
                           want[key][1][None])


def test_melspec_fused_rejects_other_devices():
    with pytest.raises(ValueError):
        melspec_fused(torch.zeros((1, 48000), dtype=torch.int16,
                                  device="meta"), MelConfig())


def _golden_check(name, values, atol, rtol):
    """Compare with a fingerprint of ``tests/golden``; never writes one."""
    path = GOLDEN / f"{name}.json"
    assert path.is_file(), f"golden {path} is missing"
    want = json.loads(path.read_text())
    flat = np.asarray(values, np.float64).ravel()
    assert list(np.asarray(values).shape) == want["shape"]
    np.testing.assert_allclose(np.linalg.norm(flat), want["norm"], rtol=rtol)
    np.testing.assert_allclose(flat[np.asarray(want["sample_idx"])],
                               np.asarray(want["sample"]), rtol=rtol,
                               atol=atol)


def test_full_width_v24_matches_golden_logits():
    jm = JBirdNETv24(compute_dtype=jnp.float32)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tm = BirdNETv24(compute_dtype=torch.float32)
    assert set(params_from_jax(params)) == set(tm.backbone.state_dict())
    load_jax_params(tm.backbone, params)
    t = np.arange(144000) / 48000.0
    tones = np.stack([np.sin(2 * np.pi * f * t) * 0.3
                      for f in (440.0, 2000.0, 7500.0)]).astype(np.float32)
    with torch.inference_mode():
        out = tm.eval().apply(torch.from_numpy(tones))
    assert out["logits"].shape == (3, 6522)
    assert out["embedding"].shape == (3, 1280)
    _golden_check("birdnet_v24_seed0_logits", out["logits"].numpy(),
                  atol=5e-3, rtol=5e-3)


def test_model_specs_equal_jax_registry():
    assert list(treg.MODEL_REGISTRY) == list(jreg.MODEL_REGISTRY)
    for mid, js in jreg.MODEL_REGISTRY.items():
        ts = treg.get_model_spec(mid)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert (ts.clip_samples, ts.effective_sample_rate, ts.clip_size_bytes,
                ts.buffer_dimensions(), ts.buffer_interval_seconds) == \
            (js.clip_samples, js.effective_sample_rate, js.clip_size_bytes,
             js.buffer_dimensions(), js.buffer_interval_seconds)
    with pytest.raises(KeyError):
        treg.get_model_spec("nope")


_BLOCKED_IMPORT = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "yaml", "aiohttp",
                                  "triton"}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import birdnet_go_tpu_torch
for m in %r:
    importlib.import_module(m)
bad = [m for m in sys.modules
       if m.split(".")[0] in {"jax", "jaxlib", "yaml", "aiohttp", "triton"}]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax_yaml_aiohttp_triton():
    pkg = REPO / "birdnet_go_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__") for p in pkg.rglob("*.py"))
    assert "birdnet_go_tpu_torch.scheduler.loop" in mods
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT % mods],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    for p in pkg.rglob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))), (p, line)
