"""The port's custom-classifier training against the JAX package's, on the
CPU.

The same seeded numpy inputs go through the JAX function and its port: the
directory dataset (windows, labels, split, batch order), the multilabel
loss, the train step (float32, five steps of batch 4 from the JAX
``init``'s parameters carried over, with BN on its stored statistics and
on the batch's), the bf16 step against JAX's float32 one (JAX cannot
differentiate its bf16 convolutions), the evaluator, and the checkpoint
format served by the loader.

Tolerances: resampled windows 1e-6 absolute (``test_torch_offline.py``'s
resampler); the loss 1e-6 relative; the float32 step's loss, grad norm and
mean confidence 1e-5 relative and its parameters 2e-5 absolute; the bf16
step's first loss 1e-2 and grad norm 5e-2 relative; evaluation 1e-5;
checkpoints exact, and logits served from one 1e-4 of their scale.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import birdnet_go_tpu.inference.loader as jloader
from birdnet_go_tpu import train as jtrain_pkg
from birdnet_go_tpu.audio.wav import write_wav
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.ops.melspec import MelConfig as JMel
from birdnet_go_tpu.train import dataset as jdataset
from birdnet_go_tpu.train import trainer as jtrainer
from birdnet_go_tpu_torch import train as ttrain_pkg
from birdnet_go_tpu_torch.inference import checkpoint as tckpt
from birdnet_go_tpu_torch.inference import loader as tloader
from birdnet_go_tpu_torch.inference.params import (
    load_jax_params,
    params_from_jax,
)
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.efficientnet import BlockSpec as TBlock
from birdnet_go_tpu_torch.models.efficientnet import EfficientNetConfig as TNet
from birdnet_go_tpu_torch.models.geomodel import Geomodel, GeomodelConfig
from birdnet_go_tpu_torch.ops.melspec import MelConfig as TMel
from birdnet_go_tpu_torch.train import dataset as tdataset
from birdnet_go_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

LR = 3e-3
TINY_MEL = dict(sample_rate=48000, n_fft=512, hop=4096, n_mels=32)
TINY_BLOCKS = ((1, 8, 3, 2, 1), (4, 16, 3, 2, 1))


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


# -- dataset -------------------------------------------------------------------

def _tone(seconds, rate, freq, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    return (0.05 * np.sin(2 * np.pi * freq * t)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One directory through both loaders: three classes; a 44.1 kHz file
    (resampled), a 2 s file (padded to one window), a 1 s file (dropped:
    not over half a clip), a file over ``max_windows_per_file``, and a
    directory without WAVs that still names a class."""
    root = tmp_path_factory.mktemp("ds")
    files = {"alpha": [("a.wav", 10.0, 48000, 500.0),
                       ("b.wav", 7.0, 44100, 900.0)],
             "beta": [("pad.wav", 2.0, 48000, 3000.0),
                      ("short.wav", 1.0, 48000, 3000.0),
                      ("long.wav", 66.0, 48000, 4000.0)],
             "gamma": [("c.wav", 9.5, 48000, 7000.0)],
             "empty": []}
    seed = 0
    for cls, entries in files.items():
        (root / cls).mkdir()
        for name, seconds, rate, freq in entries:
            write_wav(root / cls / name, _tone(seconds, rate, freq, seed),
                      rate)
            seed += 1
    (root / "gamma" / "notes.txt").write_text("not audio")
    return (jdataset.load_directory_dataset(root),
            tdataset.load_directory_dataset(root))


def test_directory_dataset_matches_jax(datasets):
    jd, td = datasets
    assert td.class_names == jd.class_names == ["alpha", "beta", "empty",
                                                "gamma"]
    # 3 + 2 (resampled) | 1 (padded) + 20 (capped) | 3
    assert len(td) == len(jd) == 29
    np.testing.assert_array_equal(td.labels, jd.labels)
    assert td.labels.dtype == jd.labels.dtype == np.int32
    assert td.windows.dtype == np.float32
    np.testing.assert_allclose(td.windows, jd.windows, rtol=0, atol=1e-6)
    # only the resampled file's windows are not bit-equal
    differ = np.nonzero((td.windows != jd.windows).any(axis=1))[0]
    assert set(differ) <= {3, 4}
    np.testing.assert_array_equal(td.one_hot(), jd.one_hot())


@pytest.mark.parametrize("val_fraction, seed", [(0.1, 0), (0.25, 3),
                                                (0.5, 7)])
def test_split_matches_jax(datasets, val_fraction, seed):
    jd, td = datasets
    for tpart, jpart in zip(td.split(val_fraction, seed),
                            jd.split(val_fraction, seed)):
        assert isinstance(tpart, tdataset.WindowDataset)
        np.testing.assert_array_equal(tpart.labels, jpart.labels)
        np.testing.assert_allclose(tpart.windows, jpart.windows, atol=1e-6)
        assert tpart.class_names == jpart.class_names


@pytest.mark.parametrize("batch_size, seed, epochs", [
    (4, 0, 2), (7, 5, 1), (29, 1, 2), (64, 0, 3)],
    ids=["b4", "ragged tail", "one full batch", "smaller than a batch"])
def test_batches_match_jax(datasets, batch_size, seed, epochs):
    jd, td = datasets
    tb = list(td.batches(batch_size, seed=seed, epochs=epochs))
    jb = list(jd.batches(batch_size, seed=seed, epochs=epochs))
    per_epoch = len(td) // batch_size if len(td) >= batch_size else 1
    assert len(tb) == len(jb) == per_epoch * epochs
    for (tw, tl), (jw, jl) in zip(tb, jb):
        assert len(tw) == min(batch_size, len(td))
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(tw, jw, atol=1e-6)


def test_dataset_errors_match_jax(tmp_path):
    with pytest.raises(ValueError, match="no class directories"):
        tdataset.load_directory_dataset(tmp_path)
    (tmp_path / "cls").mkdir()
    write_wav(tmp_path / "cls" / "tiny.wav", _tone(0.5, 48000, 500.0, 0),
              48000)
    (tmp_path / "cls" / "bad.wav").write_bytes(b"RIFF0000WAVEjunk")
    with pytest.raises(ValueError, match="no usable audio"):
        tdataset.load_directory_dataset(tmp_path)
    with pytest.raises(ValueError, match="no usable audio"):
        jdataset.load_directory_dataset(tmp_path)


# -- loss ------------------------------------------------------------------------

def test_multilabel_loss_matches_optax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((8, 16)) * 5).astype(np.float32)
    logits[0, :4] = [100.0, -100.0, 100.0, -100.0]
    labels = (rng.random((8, 16)) < 0.3).astype(np.float32)
    labels[0, :4] = [1.0, 0.0, 0.0, 1.0]            # right, right, wrong, wrong
    labels[1] = 0.25                                # soft labels
    want = float(jtrainer.multilabel_loss(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = ttrainer.multilabel_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    assert got.shape == () and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# -- train step ------------------------------------------------------------------

def _jax_tiny(n_classes=2):
    jm = JBirdNETv24(num_species=n_classes, mel=JMel(**TINY_MEL),
                     compute_dtype=jnp.float32)
    jm.net = JNet(blocks=tuple(JBlock(*b) for b in TINY_BLOCKS),
                  embedding_dim=32, num_classes=n_classes)
    return jm, jm.init(jax.random.PRNGKey(0))


def _port_tiny(params, dtype=torch.float32, n_classes=2):
    tm = BirdNETv24(num_species=n_classes, mel=TMel(**TINY_MEL),
                    compute_dtype=dtype,
                    net=TNet(blocks=tuple(TBlock(*b) for b in TINY_BLOCKS),
                             embedding_dim=32, num_classes=n_classes))
    load_jax_params(tm.backbone, _np_tree(params))
    return tm


def _tone_batch(rng, n=4):
    """Two tone classes over noise: PCM [n, 144000] and one-hot labels."""
    f = rng.choice([500.0, 6000.0], n)
    t = np.arange(144000) / 48000.0
    pcm = (0.4 * np.sin(2 * np.pi * f[:, None] * t)
           + 0.01 * rng.standard_normal((n, 144000))).astype(np.float32)
    labels = np.stack([f == 6000.0, f == 500.0], 1).astype(np.float32)
    return pcm, labels


def _run_both(train, dtype=torch.float32, steps=5):
    jm, params = _jax_tiny()
    opt = optax.adamw(LR)
    jstate = jtrainer.init_train_state(params, opt)
    jstep = jax.jit(jtrainer.make_train_step(jm.apply, opt, train=train))
    tm = _port_tiny(params, dtype)
    tstate = ttrainer.init_train_state(tm, LR)
    tstep = ttrainer.make_train_step(tm.apply, train=train)
    rng = np.random.default_rng(11)
    metrics, batches = [], []
    for _ in range(steps):
        pcm, labels = _tone_batch(rng)
        batches.append(pcm)
        jstate, jm_ = jstep(jstate, jnp.asarray(pcm), jnp.asarray(labels))
        tstate, tm_ = tstep(tstate, torch.from_numpy(pcm),
                            torch.from_numpy(labels))
        metrics.append(({k: float(v) for k, v in jm_.items()},
                        {k: float(v) for k, v in tm_.items()}))
    assert tstate.step == steps and int(jstate.step) == steps
    return jm, jstate, tm, metrics, params, batches


def _first_grads(jm, params, train):
    """JAX's gradient of the first step, keyed as the port's state."""
    pcm, labels = _tone_batch(np.random.default_rng(11))
    g = jax.grad(lambda p: jtrainer.multilabel_loss(
        jm.apply(p, jnp.asarray(pcm), train)["logits"],
        jnp.asarray(labels)))(params)
    return params_from_jax(_np_tree(g))


@pytest.mark.parametrize("train", [False, True],
                         ids=["stored BN statistics", "batch statistics"])
def test_float32_train_step_matches_jax(train):
    """Five AdamW steps from the same parameters: per-step loss, grad norm
    (every gradient, BN statistics included) and mean confidence within
    1e-5, the parameters within 2e-5. With batch statistics the stored
    BN statistics get no gradient and are only decayed, on both sides;
    and a BN bias whose output feeds a 1×1 convolution and then a
    batch-statistics BN has a gradient that is zero in exact arithmetic
    (the next BN removes any per-channel shift): JAX's is 1e-8, rounding
    noise, which Adam turns into steps of about the learning rate in
    either direction. Those biases are held to 2·steps·lr instead, and
    the two trained models to the same logits."""
    jm, jstate, tm, metrics, params, batches = _run_both(train)
    for want, got in metrics:
        for k in ("loss", "grad_norm", "mean_confidence"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    jp = params_from_jax(_np_tree(jstate.params))
    tp = tm.backbone.state_dict()
    assert set(tp) == set(jp)
    g0 = _first_grads(jm, params, train)
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in g0.values())))
    noise = {k for k, g in g0.items()
             if 0 < float(g.abs().max()) < 1e-6 * norm}
    assert noise == ({"blocks.0.project_bn.bias", "blocks.1.project_bn.bias"}
                     if train else set())
    for k in tp:
        if k.endswith((".mean", ".var")) and train:
            assert float(g0[k].abs().max()) == 0.0, k
        tol = 2 * len(metrics) * LR if k in noise else 2e-5
        np.testing.assert_allclose(tp[k].numpy(), jp[k].numpy(), rtol=0,
                                   atol=tol, err_msg=k)
    pcm = batches[-1]
    want = np.asarray(jm.apply(jstate.params, jnp.asarray(pcm),
                               train)["logits"])
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(pcm), train)["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bn_train_mode_uses_batch_statistics():
    """``BatchNorm(train=True)`` ignores the stored statistics and
    normalizes each channel over batch and space, as ``apply_bn``."""
    from birdnet_go_tpu.models import layers as jlayers
    from birdnet_go_tpu_torch.models import layers as tlayers

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 7, 6)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.random(6).astype(np.float32) + 0.5,
         "bias": rng.standard_normal(6).astype(np.float32),
         "mean": rng.standard_normal(6).astype(np.float32),
         "var": rng.random(6).astype(np.float32) + 0.5}
    bn = load_jax_params(tlayers.BatchNorm(6), p)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for train in (False, True):
        want = np.asarray(jlayers.apply_bn(p, jnp.asarray(x), train))
        got = bn(xt, train).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got = bn(xt, True).numpy()
    np.testing.assert_allclose(
        ((got - p["bias"][None, :, None, None])
         / p["scale"][None, :, None, None]).mean(axis=(0, 2, 3)), 0,
        atol=1e-5)


def test_bf16_step_against_jax_float32():
    """JAX has no bf16 step (``jax.grad`` of its bf16 convolution fails
    under jax 0.9.0), so the port's bf16 step is held loosely to JAX's
    float32 one from the same parameters: the first loss within 1e-2,
    the first grad norm within 5e-2."""
    *_, metrics, _, _ = _run_both(False, torch.bfloat16, steps=2)
    for want, got in metrics:
        assert np.isfinite(list(got.values())).all()
    want, got = metrics[0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-2)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=5e-2)


def test_optimizer_is_optax_adamw():
    """One group with every parameter, optax's defaults (torch's weight
    decay default is 1e-2), every parameter trainable."""
    _, params = _jax_tiny()
    tm = _port_tiny(params)
    assert not any(p.requires_grad for p in tm.parameters())
    state = ttrainer.init_train_state(tm, 1e-3)
    (group,) = state.optimizer.param_groups
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert len(group["params"]) == len(list(tm.parameters()))
    assert all(p.requires_grad for p in tm.parameters())


def test_train_exports_as_jax():
    assert ttrain_pkg.__all__ == jtrain_pkg.__all__
    for name in ttrain_pkg.__all__:
        assert getattr(ttrain_pkg, name) is getattr(ttrainer, name)


# -- evaluate --------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [4, 5, 64],
                         ids=["full batches", "ragged tail", "one batch"])
def test_evaluate_matches_jax(batch_size):
    jm, params = _jax_tiny(3)
    tm = _port_tiny(params, n_classes=3)
    rng = np.random.default_rng(4)
    t = np.arange(144000) / 48000.0
    labels = rng.integers(0, 3, 13).astype(np.int32)
    freqs = np.asarray([500.0, 2000.0, 6000.0])[labels]
    windows = (0.3 * np.sin(2 * np.pi * freqs[:, None] * t)
               + 0.01 * rng.standard_normal((13, 144000))).astype(np.float32)
    names = ["a", "b", "c"]
    want = jtrainer.evaluate(jax.jit(jtrainer.make_eval_step(jm.apply)),
                             params, jdataset.WindowDataset(windows, labels,
                                                            names),
                             batch_size=batch_size)
    got = ttrainer.evaluate(ttrainer.make_eval_step(tm.apply),
                            tdataset.WindowDataset(windows, labels, names),
                            batch_size=batch_size)
    assert got["n"] == want["n"] == (13 // batch_size * batch_size
                                     if batch_size <= 13 else 13)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert 0.0 < got["accuracy"] < 1.0            # not a degenerate case


# -- checkpoints -----------------------------------------------------------------

def test_checkpoint_round_trip_is_exact(tmp_path):
    _, params = _jax_tiny()
    tm = _port_tiny(params)
    stale = tmp_path / "ckpt" / "old.bin"
    stale.parent.mkdir()
    stale.write_bytes(b"x")
    path = tckpt.save_params(tm, tmp_path / "ckpt")
    assert path == tmp_path / "ckpt" / "params.npz"
    assert sorted(p.name for p in path.parent.iterdir()) == ["params.npz"]
    with np.load(path, allow_pickle=False) as z:
        assert set(z.files) == set(tm.state_dict())
        assert all(z[k].dtype == np.float32 for k in z.files)
        np.testing.assert_array_equal(z["backbone.stem_conv.w"],
                                      np.asarray(params["stem_conv"]["w"]
                                                 ).transpose(3, 2, 0, 1))
    fresh = _port_tiny(_jax_tiny()[1])
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    tckpt.load_params(tmp_path / "ckpt", like=fresh)
    want = tm.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    wrong = BirdNETv24(num_species=3, mel=TMel(**TINY_MEL),
                       net=TNet(blocks=(TBlock(*TINY_BLOCKS[0]),),
                                embedding_dim=32, num_classes=3))
    with pytest.raises(RuntimeError, match="state_dict"):
        tckpt.load_params(tmp_path / "ckpt", like=wrong)


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """A full-width float32 v2.4 with 3 species (JAX ``init``), written
    with the port's ``save_params``, and JAX's logits for one window."""
    jm = JBirdNETv24(num_species=3, compute_dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5))
    tm = BirdNETv24(num_species=3, compute_dtype=torch.float32)
    load_jax_params(tm.backbone, _np_tree(params))
    root = tmp_path_factory.mktemp("full")
    tckpt.save_params(tm, root / "ckpt")
    pcm = _tone_batch(np.random.default_rng(6), n=1)[0]
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(pcm))["logits"])
    return root / "ckpt", pcm, want


def _served_logits(model, pcm):
    with torch.inference_mode():
        return model.apply(torch.from_numpy(pcm))["logits"].numpy()


@pytest.mark.parametrize("where", ["checkpoint", "installed",
                                   "installed beside a tflite"])
def test_load_model_serves_the_checkpoint_as_jax(full_width, where,
                                                 monkeypatch, tmp_path):
    """The head width is the checkpoint's (3 rows of
    ``backbone.classifier.w``), as JAX restores the tree as saved; an
    installed ``params.npz`` is served unless a .tflite/.onnx is there."""
    ckpt, pcm, want = full_width
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path))
    kw = dict(compute_dtype=torch.float32)
    if where == "checkpoint":
        model = tloader.load_model("BirdNET_V2.4", checkpoint=str(ckpt), **kw)
    else:
        home = tmp_path / "BirdNET_V2.4"
        home.mkdir()
        (home / "params.npz").write_bytes((ckpt / "params.npz").read_bytes())
        if where != "installed":
            from tests.test_torch_cli import _tflite_artifact

            _tflite_artifact(home / "model.tflite")
            assert isinstance(tloader.load_model("BirdNET_V2.4"),
                              tloader.ImportedModel)
            return
        model = tloader.load_model("BirdNET_V2.4", **kw)
    assert isinstance(model, BirdNETv24) and model.num_species == 3
    got = _served_logits(model, pcm)
    assert got.shape == want.shape == (1, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", ["checkpoint", "installed"])
def test_dir_without_params_npz_still_raises(case, monkeypatch, tmp_path):
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path))
    d = tmp_path / "BirdNET_V2.4"
    d.mkdir()
    (d / "checkpoint").write_bytes(b"orbax")
    with pytest.raises(NotImplementedError, match="not orbax"):
        if case == "checkpoint":
            tloader.load_model("BSG", checkpoint=str(d))
        else:
            tloader.load_model("BirdNET_V2.4")


@pytest.mark.parametrize("where", ["checkpoint", "installed"])
def test_load_geomodel_serves_the_checkpoint_as_jax(where, monkeypatch,
                                                    tmp_path):
    """JAX Geomodel weights through the port's format: the scores equal
    JAX's, and the width is the checkpoint's, not `num_species`."""
    jg, params = jloader.load_geomodel(num_species=40, seed=3)
    g = load_jax_params(Geomodel(GeomodelConfig(num_species=40)),
                        _np_tree(params))
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path))
    if where == "checkpoint":
        tckpt.save_params(g, tmp_path / "geo")
        assert tloader.geomodel_weights_installed(str(tmp_path / "geo"))
        got = tloader.load_geomodel(str(tmp_path / "geo"), num_species=6522)
    else:
        assert not tloader.geomodel_weights_installed()
        tckpt.save_params(g, tmp_path / "Geomodel")
        assert tloader.geomodel_weights_installed()
        got = tloader.load_geomodel(num_species=6522)
    assert got.cfg.num_species == 40
    coords = np.asarray([[60.17, 24.94, 20.0], [-33.9, 151.2, -1.0]],
                        np.float32)
    want = np.asarray(jax.jit(jg.apply)(params, jnp.asarray(coords)))
    with torch.inference_mode():
        scores = got(torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-6)


def test_trained_checkpoint_labels_and_loader(tmp_path):
    """What ``train`` writes (``params.npz`` and ``labels.json``) is one
    directory the loader reads; ``labels.json`` is not a parameter."""
    _, params = _jax_tiny()
    tm = _port_tiny(params)
    tckpt.save_params(tm, tmp_path)
    (tmp_path / "labels.json").write_text(json.dumps(["x", "y"]))
    assert tckpt.has_params(tmp_path)
    assert set(tckpt.read_params(tmp_path)) == set(tm.state_dict())
