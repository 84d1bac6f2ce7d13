"""The port's BattyBirdNET and BSG families, the ultrasonic CV and the
raw-rate step against the JAX package's, on the CPU.

Inputs come from numpy seeds; parameters from the JAX ``init`` through
``params_from_jax``. Tolerances: float32 logits, embeddings and CVs at
rtol/atol 1e-4 (the slice's tolerance, ``tests/test_torch_slice.py``): the
two frameworks sum the convolutions and the FFT in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_go_tpu.audio.buffers import AnalysisBuffer as JBuffer
from birdnet_go_tpu.inference.backend import JaxClassifier
from birdnet_go_tpu.models import registry as jreg
from birdnet_go_tpu.models.bat import BatClassifier as JBat
from birdnet_go_tpu.models.bsg import BSGFinland as JBSG
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.ops.ultrasonic import UltrasonicConfig as JUSConfig
from birdnet_go_tpu.ops.ultrasonic import ultrasonic_frame_cv as j_cv
from birdnet_go_tpu.scheduler import loop as jloop
from birdnet_go_tpu_torch import models as tmodels
from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer as TBuffer
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.inference.params import (
    load_jax_params,
    params_from_jax,
)
from birdnet_go_tpu_torch.models import registry as treg
from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.bsg import BSGFinland
from birdnet_go_tpu_torch.models.efficientnet import BlockSpec as TBlock
from birdnet_go_tpu_torch.models.efficientnet import EfficientNetConfig as TNet
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.ops.ultrasonic import (
    UltrasonicConfig,
    is_unlikely,
    ultrasonic_frame_cv,
)
from birdnet_go_tpu_torch.scheduler import loop as tloop

torch.set_num_threads(1)

NARROW = ((1, 16, 3, 1, 1), (6, 24, 3, 2, 1), (6, 40, 5, 2, 1))
N_CLASSES = 24
CLIP = 48000                   # 1 s at the nominal 48 kHz (0.19 s of 256 kHz)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def narrow_bat():
    """(JAX model, JAX params, port model), float32, 1 s clips, the same
    weights."""
    jm = JBat(num_species=N_CLASSES, compute_dtype=jnp.float32)
    jm.net = JNet(blocks=tuple(JBlock(*b) for b in NARROW),
                  stem_channels=16, embedding_dim=48, num_classes=N_CLASSES)
    jm.spec = dataclasses.replace(jreg.BAT, clip_seconds=1.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    net = TNet(blocks=tuple(TBlock(*b) for b in NARROW), stem_channels=16,
               embedding_dim=48, num_classes=N_CLASSES)
    tm = BatClassifier(N_CLASSES, MelConfig(**dataclasses.asdict(jm.mel)),
                       torch.float32, net=net)
    tm.spec = dataclasses.replace(treg.BAT, clip_seconds=1.0)
    load_jax_params(tm, _np_tree(params))
    return jm, params, tm.eval()


def _ultrasound(shape, seed):
    """Rows of 256 kHz capture: bursts of a 40 kHz call over noise, each
    row with its own burst rate, int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 256000.0
    rate = rng.uniform(10.0, 80.0, (shape[0], 1))
    gate = (np.sin(2 * np.pi * rate * t) > 0.6).astype(np.float64)
    x = 0.3 * gate * np.sin(2 * np.pi * 40000.0 * t)
    x += 0.02 * rng.standard_normal(shape)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def test_narrow_bat_apply_int16_matches_jax(narrow_bat):
    jm, params, tm = narrow_bat
    pcm = _ultrasound((3, CLIP), 0)
    ref = jax.jit(jm.apply_int16)(params, jnp.asarray(pcm))
    with torch.inference_mode():
        got = tm.apply_int16(torch.from_numpy(pcm))
        f32 = tm.apply(torch.from_numpy(pcm.astype(np.float32) / 32768.0))
    assert got["logits"].shape == (3, N_CLASSES)
    assert got["embedding"].shape == (3, 48)
    for key in ("logits", "embedding"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f32[key].numpy(), got[key].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("band_high,shape", [(None, (3, CLIP)),
                                             (60000.0, (2, 4096)),
                                             (None, (1, 2, 20000))])
def test_ultrasonic_frame_cv_matches_jax(band_high, shape):
    pcm = _ultrasound((int(np.prod(shape[:-1])), shape[-1]), 1).reshape(
        shape).astype(np.float32) / 32768.0
    jcfg = JUSConfig(band_high_hz=band_high)
    tcfg = UltrasonicConfig(band_high_hz=band_high)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    ref = np.asarray(jax.jit(lambda x: j_cv(x, jcfg))(jnp.asarray(pcm)))
    got = ultrasonic_frame_cv(torch.from_numpy(pcm), tcfg).numpy()
    assert got.shape == shape[:-1] and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_is_unlikely_flags_steady_noise():
    noise = np.random.default_rng(2).standard_normal(CLIP) * 0.1
    call = _ultrasound((1, CLIP), 3)[0] / 32768.0
    x = torch.from_numpy(np.stack([noise, call]).astype(np.float32))
    assert is_unlikely(x, UltrasonicConfig()).tolist() == [True, False]


def _drive(mod, batcher, buffer, n_streams=5, n_ticks=3):
    """Feed seeded ultrasound through `mod`'s DeviceLoop; returns
    {(source, start): (values, indices, cv)} and the loop."""
    overlap, read = (b // 2 for b in batcher.spec.buffer_dimensions())
    bufs = {f"bat{i}": buffer(overlap, read) for i in range(n_streams)}
    pos = dict.fromkeys(bufs, 0.0)
    rate = batcher.spec.effective_sample_rate
    results = {}

    def on_result(w, vals, idx):
        results[(w.source_id, w.start_time)] = (vals.copy(), idx.copy(),
                                                w.ultrasonic_cv)

    def provider():
        items = []
        for sid, buf in bufs.items():
            while (win := buf.read()) is not None:
                items.append((batcher.spec.model_id, win, sid, pos[sid],
                              rate))
                pos[sid] += read / rate
        return items

    batcher.on_result = on_result
    loop = mod.DeviceLoop(tick_seconds=0.01)
    loop.add_batcher(batcher)
    loop.add_provider(provider)
    for tick in range(n_ticks):
        for i, buf in enumerate(bufs.values()):
            buf.write(_ultrasound((1, read), 100 * tick + i)[0])
        loop.run_tick()
    loop.drain()
    return results, loop


def test_raw_rate_step_in_port_loop_matches_jax(narrow_bat):
    """The bat step in the port's loop against ``ModelBatcher`` in the JAX
    package's ``DeviceLoop``: the same windows, each with its top-k and its
    on-device ultrasonic CV."""
    jm, params, tm = narrow_bat
    jb = jloop.ModelBatcher(JaxClassifier(jm, params), max_batch=4,
                            top_k=5, pipeline_depth=2)
    tb = tloop.TorchModelBatcher(TorchClassifier(tm, "cpu"), max_batch=4,
                                 top_k=5, pipeline_depth=2)
    assert tb.warmup() >= 0.0
    want, _ = _drive(jloop, jb, JBuffer)
    got, loop = _drive(tloop, tb, TBuffer)
    assert loop.windows_dropped == 0 and len(got) == 15
    assert set(got) == set(want)
    assert tb.stats.batches_dispatched == jb.stats.batches_dispatched
    for key, (v, i, cv) in got.items():
        wv, wi, wcv = want[key]
        assert isinstance(cv, float) and np.isfinite(cv)
        np.testing.assert_allclose(cv, wcv, rtol=1e-4)
        np.testing.assert_allclose(v, wv, rtol=1e-4, atol=1e-5)
        assert i.dtype == np.int32
        np.testing.assert_array_equal(np.sort(i), np.sort(wi))


def test_raw_rate_batch_fan_out_carries_the_cv(narrow_bat):
    """With ``on_batch`` the CV reaches the batch callback, one per
    window, equal to the per-window path's."""
    _, _, tm = narrow_bat
    tb = tloop.TorchModelBatcher(TorchClassifier(tm, "cpu"), max_batch=4,
                                 top_k=3)
    pcm = _ultrasound((3, CLIP), 5)
    batches = []
    tb.on_batch = lambda meta, v, i, cv: batches.append((len(meta), cv))
    assert tb.offer_block(pcm, ["a", "b", "c"], [0.0, 1.0, 2.0]) == 3
    tb.dispatch()
    tb.harvest_all()
    (n, cv), = batches
    want = ultrasonic_frame_cv(torch.from_numpy(pcm.astype(np.float32)
                                                / 32768.0),
                               UltrasonicConfig()).numpy()
    assert n == 3 and cv.shape == (3,)
    np.testing.assert_allclose(cv, want, rtol=1e-6)


@pytest.mark.parametrize("jcls,tcls", [(JBat, BatClassifier),
                                       (JBSG, BSGFinland)])
def test_bat_and_bsg_configs_equal_jax(jcls, tcls):
    jm, tm = jcls(), tcls()
    assert dataclasses.asdict(tm.mel) == dataclasses.asdict(jm.mel)
    assert dataclasses.asdict(tm.net) == dataclasses.asdict(jm.net)
    assert tm.num_species == jm.num_species == jm.spec.num_species
    assert dataclasses.asdict(tm.spec) == dataclasses.asdict(jm.spec)
    assert tm.compute_dtype == torch.bfloat16 and not tm.fused_blocks
    assert getattr(tmodels, tcls.__name__) is tcls


@pytest.mark.parametrize("jcls,tcls", [(JBat, BatClassifier),
                                       (JBSG, BSGFinland)])
def test_full_width_param_tree_loads_strictly(jcls, tcls):
    """The whole JAX tree at full width (shapes only, no arithmetic) loads
    into the port's module with every key and shape matching."""
    jm = jcls()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = tcls()
    if tcls is BSGFinland:
        load_jax_params(tm.backbone, tree)
        keys = set(tm.backbone.state_dict())
    else:
        assert set(tree) == {"backbone", "head"}
        load_jax_params(tm, tree)
        keys = set(tm.state_dict())
        assert tm.head.w.shape == (128, 1024)
    assert set(params_from_jax(tree)) == keys
