"""The port's meshes and ``ShardedClassifier`` (``parallel/``) against
the JAX package's, on the CPU.

``tests/test_parallel_serving.py``'s four tests, ported: torch has no
virtual devices, so the port's meshes list the CPU device once per JAX
virtual device (``make_mesh(devices=...)``), and the JAX side runs on its
8-device host platform (``tests/conftest.py``). The model is that test's
tiny config (256 species, float32), with weights from the JAX init through
``params_from_jax``. Tolerances: indices equal; confidences within 2e-4
relative (and 2e-5 absolute), as the JAX test holds its sharded run to its
single-device one. ``TorchModelBatcher`` serves a ``ShardedClassifier``
unchanged, with results equal to its results over a ``TorchClassifier``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_go_tpu.config.settings import RealtimeSettings
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.ops.melspec import MelConfig as JMel
from birdnet_go_tpu.parallel.mesh import make_mesh as jmake_mesh
from birdnet_go_tpu.parallel.serving import (
    ShardedClassifier as JShardedClassifier,
)
from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.inference.loader import apply_serving_options
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.efficientnet import (
    BlockSpec,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.parallel import (
    ShardedClassifier,
    make_mesh,
    param_pspec_tree,
    shard_params,
)
from birdnet_go_tpu_torch.scheduler.loop import DeviceLoop, TorchModelBatcher

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@functools.lru_cache(maxsize=None)
def _tiny(num_species=256):
    """(JAX model, JAX params, port model): test_parallel_serving's tiny
    config, float32, the same weights."""
    jm = JBirdNETv24(num_species=num_species,
                     mel=JMel(sample_rate=48000, n_fft=256, hop=8192,
                              n_mels=16),
                     compute_dtype=jnp.float32)
    jm.net = JNet(blocks=(JBlock(1, 8, 3, 2, 1),), embedding_dim=64,
                  num_classes=num_species)
    params = jm.init(jax.random.PRNGKey(0))
    tm = BirdNETv24(num_species=num_species,
                    mel=MelConfig(**dataclasses.asdict(jm.mel)),
                    compute_dtype=torch.float32,
                    net=EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                                           embedding_dim=64,
                                           num_classes=num_species))
    load_jax_params(tm.backbone, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm.eval()


def _pcm(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 144000)).astype(np.float32) * 0.1


def test_sharded_matches_single_device_and_jax():
    jm, params, tm = _tiny()
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.shape == {"data": 4, "model": 2}
    single = TorchClassifier(tm, "cpu")
    sharded = ShardedClassifier(tm, mesh=mesh)
    assert sharded.device == torch.device("cpu")
    assert sharded.model_id == "BirdNET_V2.4" and sharded.num_species == 256
    jsharded = JShardedClassifier(jm, params, mesh=jmake_mesh(8))
    assert jsharded.mesh.shape == mesh.shape

    pcm = _pcm(8)
    v1, i1 = single.predict_topk(pcm, k=5)
    v2, i2 = sharded.predict_topk(pcm, k=5)
    v3, i3 = jsharded.predict_topk(pcm, k=5)
    assert i2.dtype == np.int32 and v2.shape == (8, 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(i3, i2)
    np.testing.assert_allclose(v3, v2, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d,m", [(4, 2), (2, 1), (1, 2), (2, 2), (1, 1)])
def test_sharded_pads_ragged_batch(d, m):
    """A batch of 5 on every split: the padding is dropped, and the rows
    equal the single-device classifier's."""
    _, _, tm = _tiny()
    sharded = ShardedClassifier(tm, mesh=make_mesh(d * m, d, m,
                                                   devices=CPU8))
    pcm = np.zeros((5, 144000), np.float32)      # 5 not divisible by 4
    vals, idx = sharded.predict_topk(pcm, k=3)
    assert vals.shape == idx.shape == (5, 3)
    pcm = _pcm(5, seed=3)
    v1, i1 = TorchClassifier(tm, "cpu").predict_topk(pcm, k=5)
    v2, i2 = sharded.predict_topk(pcm, k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=2e-4, atol=2e-5)
    out = sharded.model.apply(torch.from_numpy(pcm))
    assert out["logits"].shape == (5, 256) and out["embedding"].shape == (
        5, 64)


def test_head_params_are_tensor_parallel():
    _, _, tm = _tiny()
    specs = param_pspec_tree(tm.state_dict())
    # the species axis is dim 0 of the port's [out, in] weight
    assert specs["backbone.classifier.w"] == ("model", None)
    assert specs["backbone.classifier.b"] == ("model",)
    assert specs["backbone.stem_conv.w"] == ()
    assert specs["backbone.head_conv.w"] == ()

    mesh = make_mesh(8, devices=CPU8)
    sharded = ShardedClassifier(tm, mesh=mesh)
    w = sharded.model.head_shards["backbone.classifier.w"]
    assert w.shape == (4, 2)
    # 256 species / 2: each model column holds its own 128
    assert {tuple(t.shape) for t in w.flat} == {(128, 64)}
    np.testing.assert_array_equal(
        torch.cat([w[0, 0], w[0, 1]]).numpy(),
        tm.backbone.classifier.w.numpy())
    # one copy per piece on a device listed more than once
    assert w[0, 0] is w[3, 0] and w[0, 1] is w[2, 1]
    placed = shard_params(tm.state_dict(), mesh)
    assert placed["backbone.stem_conv.w"][2, 1] is placed[
        "backbone.stem_conv.w"][0, 0]
    # the replicas carry no head
    rep = sharded.model.replicas[torch.device("cpu")]
    assert not any("classifier" in k for k in rep.state_dict())

    bat = BatClassifier(num_species=12, net=EfficientNetConfig(
        blocks=(BlockSpec(1, 8, 3, 2, 1),), stem_channels=8,
        embedding_dim=16, num_classes=12))
    bspecs = param_pspec_tree(bat.state_dict())
    assert bspecs["head.w"] == ("model", None) and bspecs["head.b"] == (
        "model",)
    assert bspecs["backbone.classifier.w"] == ("model", None)
    assert bspecs["backbone.head_conv.w"] == ()


def test_mesh_odd_counts_and_overcommit(monkeypatch):
    """6 → 3×2, 1 → 1×1, 5 → 5×1; more devices than visible, or a split
    that does not cover them, raise as JAX's do. The default devices are
    the visible cards."""
    m6 = make_mesh(6, devices=CPU8)
    assert m6.size == 6 and m6.shape == {"data": 3, "model": 2}
    assert make_mesh(1, devices=CPU8).shape == {"data": 1, "model": 1}
    assert make_mesh(5, devices=CPU8).shape == {"data": 5, "model": 1}
    with pytest.raises(ValueError, match="only"):
        make_mesh(64, devices=CPU8)
    with pytest.raises(ValueError, match="mesh"):
        make_mesh(6, data_axis=4, model_axis=2, devices=CPU8)

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = make_mesh()
    assert m.shape == {"data": 2, "model": 2}
    assert m.devices.tolist() == [[torch.device("cuda", 0),
                                   torch.device("cuda", 1)],
                                  [torch.device("cuda", 2),
                                   torch.device("cuda", 3)]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="only 0"):
        make_mesh()


def _drive(classifier, n_streams=6, n_ticks=3):
    """Streams through the port's AnalysisBuffers and DeviceLoop into a
    TorchModelBatcher over `classifier`; {(source, start): (values,
    indices)}."""
    batcher = TorchModelBatcher(classifier, max_batch=4, top_k=10,
                                pipeline_depth=2)
    spec = batcher.spec
    overlap, read = (b // 2 for b in spec.buffer_dimensions())
    bufs = {f"s{i}": AnalysisBuffer(overlap, read) for i in range(n_streams)}
    pos = dict.fromkeys(bufs, 0.0)
    results = {}

    def on_result(w, vals, idx):
        results[(w.source_id, w.start_time)] = (vals.copy(), idx.copy())

    def provider():
        items = []
        for sid, buf in bufs.items():
            while (win := buf.read()) is not None:
                items.append((spec.model_id, win, sid, pos[sid]))
                pos[sid] += read / spec.sample_rate
        return items

    batcher.on_result = on_result
    loop = DeviceLoop(tick_seconds=0.01)
    loop.add_batcher(batcher)
    loop.add_provider(provider)
    rng = np.random.default_rng(9)
    for _ in range(n_ticks):
        for buf in bufs.values():
            buf.write((rng.standard_normal(read) * 3000).astype(np.int16))
        loop.run_tick()
    loop.drain()
    assert loop.windows_dropped == 0
    return results, batcher.stats.batches_dispatched


@pytest.mark.parametrize("act_int8", [False, True])
def test_batcher_serves_sharded_classifier_unchanged(act_int8):
    """The same windows through TorchModelBatcher over a TorchClassifier
    and over a ShardedClassifier on a 2x2 mesh (batches of 4, ragged last
    batches padded by the batcher): the same top-10s. With ``act_int8``
    set through ``apply_serving_options`` before the model is wrapped."""
    _, _, tm = _tiny()
    if act_int8:
        # as the JAX app: the options first, then the sharded classifier
        apply_serving_options(tm, RealtimeSettings(act_int8=True))
        assert tm.act_int8 is True
    try:
        sharded = ShardedClassifier(tm, mesh=make_mesh(4, devices=CPU8))
        assert all(r.act_int8 is act_int8
                   for r in sharded.model.replicas.values())
        want, nb = _drive(TorchClassifier(tm, "cpu"))
        got, nb2 = _drive(sharded)
    finally:
        tm.act_int8 = False
    assert nb == nb2 > 0 and set(got) == set(want) and len(got) == 18
    for key, (v, i) in want.items():
        np.testing.assert_array_equal(got[key][1], i)
        np.testing.assert_allclose(got[key][0], v, rtol=2e-4, atol=2e-5)


def test_sharded_bat_family_and_headless_model():
    """The bat family's regional head is what the mesh splits (its
    backbone classifier is dropped from the replicas); a model without a
    head (an imported graph's interface) is replicated whole and takes
    the float32 PCM on the int16 path."""
    net = EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                             stem_channels=8, embedding_dim=16,
                             num_classes=12)
    bat = BatClassifier(num_species=12, compute_dtype=torch.float32,
                        net=net).init(torch.Generator().manual_seed(1))
    bat.eval()
    sharded = ShardedClassifier(bat, mesh=make_mesh(4, devices=CPU8))
    assert sharded.model.head_name == "head"
    x = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (3, 144000)) * 3000).astype(np.int16))
    with torch.inference_mode():
        want = bat.apply_int16(x)
        got = sharded.model.apply_int16(x)
    np.testing.assert_allclose(got["logits"].numpy(),
                               want["logits"].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["embedding"].numpy(),
                                  want["embedding"].numpy())

    class Headless(torch.nn.Module):
        spec = registry.BIRDNET_V24
        num_species = 6

        def apply(self, pcm):
            s = pcm[:, :6] * 2.0
            return {"logits": s, "embedding": pcm[:, :3]}

    hs = ShardedClassifier(Headless(), mesh=make_mesh(4, devices=CPU8))
    assert hs.model.heads is None
    with torch.inference_mode():
        out = hs.model.apply_int16(x)
    np.testing.assert_array_equal(out["logits"].numpy(),
                                  x[:, :6].numpy() / 32768.0 * 2.0)
