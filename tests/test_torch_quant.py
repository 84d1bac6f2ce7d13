"""The port's int8 quantization (``ops/quant.py``) and ``act_int8``
boundary against the JAX package's, on the CPU.

The model is ``tests/test_quantized.py``'s tiny config (three stages, 40
classes, float32); weights come from the JAX init through
``params_from_jax``, with the BN statistics drawn from a numpy seed so that
folding is not the identity. Mel features come from the JAX front end, so
both packages quantize and run the same input.

Tolerances: weight codes, weight scales and folded biases exactly equal;
calibration scales within 1e-5 relative (float32 sums in another order);
the int32 accumulators of every int8 conv exactly equal given the same int8
input; the int8 forward's logits within 1e-3 of the logits' scale (a
float32 epilogue value one ulp apart may round to the neighbouring code);
``act_int8``: the boundary bit for bit on the same input; logits within
1e-4 of their scale in float32, and JAX's boundary contract in bf16
(``test_act_int8_matches_jax`` says why).
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import birdnet_go_tpu.ops.pallas_mbconv as JM
import birdnet_go_tpu.ops.quant as JQ
from birdnet_go_tpu.config.settings import RealtimeSettings
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.models.efficientnet import apply_efficientnet
from birdnet_go_tpu.ops.melspec import MelConfig as JMel
from birdnet_go_tpu_torch.inference.loader import (
    ImportedModel,
    apply_serving_options,
)
from birdnet_go_tpu_torch.inference.params import (
    load_jax_params,
    quant_from_jax,
)
from birdnet_go_tpu_torch.models import efficientnet as TE
from birdnet_go_tpu_torch.models import layers as L
from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.ops import quant as TQ
from birdnet_go_tpu_torch.ops.melspec import MelConfig

torch.set_num_threads(1)

BLOCKS = ((1, 8, 3, 1, 1), (4, 16, 3, 2, 2), (4, 24, 5, 2, 1))
N_CLASSES = 40
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _random_bn(tree, rng):
    """Every BN of a numpy parameter tree with seeded statistics."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(0, 0.1, c).astype(np.float32),
                    "mean": rng.normal(0, 0.1, c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_bn(v, rng) for v in tree]
    return tree


@functools.lru_cache(maxsize=None)
def _tiny():
    """(JAX model, numpy params with seeded BN, port model), float32, the
    same weights."""
    jm = JBirdNETv24(
        num_species=N_CLASSES,
        mel=JMel(sample_rate=48000, n_fft=256, hop=4096, n_mels=32),
        compute_dtype=jnp.float32)
    jm.net = JNet(blocks=tuple(JBlock(*b) for b in BLOCKS),
                  embedding_dim=32, num_classes=N_CLASSES)
    params = _random_bn(_np_tree(jm.init(jax.random.PRNGKey(0))),
                        np.random.default_rng(5))
    net = TE.EfficientNetConfig(blocks=tuple(TE.BlockSpec(*b)
                                             for b in BLOCKS),
                                embedding_dim=32, num_classes=N_CLASSES)
    tm = BirdNETv24(num_species=N_CLASSES,
                    mel=MelConfig(**dataclasses.asdict(jm.mel)),
                    compute_dtype=torch.float32, net=net)
    load_jax_params(tm.backbone, params)
    return jm, params, tm.eval()


def _mels(jm, n=3, batch=4, seed=0):
    """JAX mel features [B, T, M, 1] of noise, as test_quantized builds
    them."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jm.features(jnp.asarray(
        rng.standard_normal((batch, 48000)).astype(np.float32) * 0.3)))
        for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _quantized():
    """(JAX scales, JAX quantized tree as numpy, port scales, port module)
    from the same calibration batches."""
    jm, params, tm = _tiny()
    cal = _mels(jm, n=3, batch=4, seed=1)
    jscales = JQ.calibrate_efficientnet(params, jm.net, cal)
    jq = _np_tree(JQ.quantize_efficientnet(params, jm.net, jscales))
    tscales = TQ.calibrate_efficientnet(tm.backbone, cal)
    return jscales, jq, tscales, TQ.quantize_efficientnet(tm.backbone,
                                                          tscales)


def _hwio(a):
    """A port weight (OIHW, (C, 1, k, k) or [out, in]) in JAX's layout."""
    a = a.numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T


def _jax_leaves(jq):
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = np.asarray(t)

    walk({k: v for k, v in jq.items() if k != "act_scales"}, "")
    return out


def test_calibration_scales_match_jax():
    jscales, _, tscales, _ = _quantized()
    assert set(tscales) == set(jscales)
    assert {"stem", "b0.in", "b0.dw", "b0.proj", "head"} <= set(tscales)
    for k, v in jscales.items():
        np.testing.assert_allclose(tscales[k], v, rtol=1e-5, err_msg=k)


def test_weight_codes_and_scales_equal_jax_bit_for_bit():
    """quantize_efficientnet from the same float32 weights and the same
    activation scales: every leaf equal after the layout transpose."""
    jm, params, tm = _tiny()
    jscales, jq, _, _ = _quantized()
    tq = TQ.quantize_efficientnet(tm.backbone, jscales)
    want = _jax_leaves(jq)
    got = tq.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == (torch.int8 if k.endswith("w_q") else
                           torch.float32), k
        g = _hwio(v) if v.ndim >= 2 else v.numpy()
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)
    assert tq.act_scales == {k: float(np.float32(v))
                             for k, v in jscales.items()}
    # the backbone really is int8; the stem stays float
    assert all(c.w_q.dtype == torch.int8 for c in TQ.int8_layers(tq))


def test_int8_forward_on_jax_weights_matches_jax(monkeypatch):
    """JAX's quantized tree through ``quant_from_jax`` and the port's int8
    forward: every int8 conv's int32 sums equal JAX's on the int8 input
    JAX gave it, and the logits agree."""
    jm, _, tm = _tiny()
    _, jq, _, _ = _quantized()
    tq = quant_from_jax(jq, tm.backbone)
    mel = _mels(jm, n=1, batch=8, seed=7)[0]

    seen = []
    orig = JQ._conv_i8

    def record(x_q, layer, s_in, stride=1, groups=1):
        seen.append((np.asarray(x_q), layer, stride, groups))
        return orig(x_q, layer, s_in, stride=stride, groups=groups)

    monkeypatch.setattr(JQ, "_conv_i8", record)
    ref = JQ.apply_efficientnet_int8(jq, jnp.asarray(mel), jm.net)
    layers = TQ.int8_layers(tq)
    assert len(seen) == len(layers) == 2 * len(tq.blocks) + 1 + sum(
        b.expand is not None for b in tq.blocks)
    for (x_q, layer, stride, groups), tl in zip(seen, layers):
        s = (stride, stride)
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x_q), jnp.asarray(layer["w_q"]), s, "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups, preferred_element_type=jnp.int32))
        assert tl.stride == stride and tl.depthwise == (groups > 1)
        got = TQ._acc_i8(torch.from_numpy(x_q.copy()), tl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    with torch.inference_mode():
        out = tq(torch.from_numpy(mel))
    r = np.asarray(ref["logits"])
    assert out["logits"].dtype == torch.float32
    assert np.abs(out["logits"].numpy() - r).max() <= 1e-3 * max(
        1.0, np.abs(r).max())
    np.testing.assert_allclose(out["embedding"].numpy(),
                               np.asarray(ref["embedding"]), atol=1e-3)


def test_port_int8_backbone_passes_jax_gates():
    """test_quantized.py's detection-level contract, on the port alone:
    top-5 overlap >= 0.6, post-sigmoid < 0.15, logit correlation >= 0.9
    against the float32 forward."""
    jm, _, tm = _tiny()
    _, _, tscales, tq = _quantized()
    assert tscales["stem"] > 0 and "b0.in" in tscales and "head" in tscales
    assert tq.stem.w.dtype == torch.float32
    mel = torch.from_numpy(_mels(jm, n=1, batch=8, seed=7)[0])
    with torch.inference_mode():
        ref = tm.backbone(mel)["logits"].numpy()
        got = tq(mel)["logits"].numpy()
    assert got.shape == ref.shape
    k = 5
    rt, qt = (np.argsort(-a, axis=1)[:, :k] for a in (ref, got))
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(rt, qt)])
    assert overlap >= 0.6, overlap
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))          # noqa: E731
    assert np.abs(sig(ref) - sig(got)).max() < 0.15
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] >= 0.9
    # deterministic, as the JAX test's jitted step
    with torch.inference_mode():
        np.testing.assert_array_equal(tq(mel)["logits"].numpy(), got)


@pytest.mark.parametrize("cout", [6522, 14795])
def test_int8_dense_head_full_width_matches_jax(cout):
    """The full-width int8 heads (1280 → 6522, v2.4's; 1280 → 14795,
    Perch's): codes equal JAX's, logits JAX's within float32 rounding, and
    JAX's gate against the float32 head (post-sigmoid < 0.02, top-10
    overlap >= 9 per row)."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((1280, cout)) * 0.03).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    emb = np.abs(rng.standard_normal((8, 1280))).astype(np.float32)
    jqh = JQ.quantize_dense_head({"w": w, "b": b})
    dense = L.Dense(1280, cout)
    dense.load_state_dict({"w": torch.from_numpy(w.T.copy()),
                           "b": torch.from_numpy(b)})
    q = TQ.quantize_dense_head(dense)
    np.testing.assert_array_equal(q["w_q"].numpy().T, jqh["w_q"])
    np.testing.assert_array_equal(q["w_scale"].numpy(), jqh["w_scale"])
    want = np.asarray(JQ.apply_dense_int8(jqh, jnp.asarray(emb)))
    got = TQ.apply_dense_int8(q, torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = dense(torch.from_numpy(emb), torch.float32).numpy()
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))          # noqa: E731
    assert np.abs(sig(ref) - sig(got)).max() < 0.02
    for r in range(len(emb)):
        assert len(set(np.argsort(ref[r])[-10:])
                   & set(np.argsort(got[r])[-10:])) >= 9


@pytest.mark.parametrize("m,k,n", [(5, 20, 3), (8, 1280, 6522),
                                   (16, 16, 96), (17, 24, 40), (1, 7, 1),
                                   (300, 1280, 14795)])
def test_int_mm_pads_refused_shapes_and_slices_back(m, k, n):
    """``_int_mm`` on CUDA takes M > 16 and K, N multiples of 8; the
    padded route returns exactly the unpadded int32 product."""
    rng = np.random.default_rng(m * 7 + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    got = TQ.int_mm(a, w)
    assert got.shape == (m, n) and got.dtype == torch.int32
    want = a.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_depthwise_float_route_equals_int32_tap_sums(k, stride):
    """The depthwise int8 conv as a float32 convolution of int8 values
    equals int32 tap sums over TF-SAME padding, at full-scale codes
    (|sum| up to k² · 127²)."""
    rng = np.random.default_rng(k + 10 * stride)
    c, h, w = 24, 13, 10
    x = rng.integers(-127, 128, (2, h, w, c)).astype(np.int8)
    x[0] = 127
    wq = rng.integers(-127, 128, (c, 1, k, k)).astype(np.int8)
    wq[:4] = 127
    layer = TQ.QConv(c, c, k, stride, depthwise=True)
    layer.w_q.copy_(torch.from_numpy(wq))
    got = TQ._acc_i8(torch.from_numpy(x), layer).numpy()
    ho, wo = -(-h // stride), -(-w // stride)
    ph = max((ho - 1) * stride + k - h, 0)
    pw = max((wo - 1) * stride + k - w, 0)
    xp = np.pad(x.astype(np.int32), ((0, 0), (ph // 2, ph - ph // 2),
                                     (pw // 2, pw - pw // 2), (0, 0)))
    want = np.zeros((2, ho, wo, c), np.int64)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + stride * ho:stride, dx:dx + stride * wo:stride]
            want += tap * wq[:, 0, dy, dx].astype(np.int64)
    assert np.abs(want).max() == k * k * 127 * 127
    np.testing.assert_array_equal(got, want)


def _jax_act_int8(dt, feats, fused=False, train=False):
    jm, params, _ = _tiny()
    jdt = DTYPES[dt][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "mbconv_fused", functools.partial(
            JM.mbconv_fused, interpret=True, dot_dtype=jdt))
        out = apply_efficientnet(params, jnp.asarray(feats).astype(jdt),
                                 jm.net, compute_dtype=jdt, act_int8=True,
                                 fused_blocks=fused, train=train)
    return np.asarray(out["logits"])


def _port_backbone(dt):
    _, params, _ = _tiny()
    net = TE.EfficientNet(_tiny()[2].net, compute_dtype=DTYPES[dt][1])
    load_jax_params(net, params)
    return net.eval()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_boundary_equals_jax_bit_for_bit(dt):
    """The boundary on the same input in the compute dtype: equal
    dequantised values (so equal codes), at random values, at every half
    step between codes and beyond the clip."""
    from birdnet_go_tpu.models.efficientnet import _int8_boundary

    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(2)
    inv = 127.0 / 8.0
    h = np.concatenate([rng.standard_normal(4096) * 4.0,
                        (np.arange(-130, 130) + 0.5) / inv,
                        np.arange(-130, 130) / inv, [-40.0, 40.0]])
    ht = torch.from_numpy(h.astype(np.float32)).to(tdt)
    want = np.asarray(_int8_boundary(jnp.asarray(ht.float().numpy(), jdt),
                                     jdt).astype(jnp.float32))
    codes = TE.quantize_boundary(ht, tdt)
    assert codes.dtype == torch.int8
    got = TE.int8_boundary(ht, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dt == "bf16":
        assert TE.dequantize_boundary(torch.ones(1, dtype=torch.int8),
                                      tdt).item() == 0.06298828125


@pytest.mark.parametrize("dt", list(DTYPES))
def test_act_int8_matches_jax(dt):
    """The backbone with the boundary against JAX's. float32: logits within
    1e-4 of their scale. bf16: the two frameworks round bf16 activations in
    other places, and an activation one bf16 ulp apart may fall on the
    other side of a half step, a code step 8 times the ulp; so bf16 is held
    to JAX's own contract for the boundary (post-sigmoid < 0.02, top-5
    overlap >= 4 per row) against JAX's boundary forward."""
    jm, _, _ = _tiny()
    feats = _mels(jm, n=1)[0]
    ref = _jax_act_int8(dt, feats)
    net = _port_backbone(dt)
    x = torch.from_numpy(feats).to(DTYPES[dt][1])
    with torch.inference_mode():
        got = net(x, act_int8=True)["logits"].numpy()
        plain = net(x)["logits"].numpy()
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))          # noqa: E731

    def jax_contract(a, b):
        assert np.abs(sig(a) - sig(b)).max() < 0.02
        for r in range(len(a)):
            assert len(set(np.argsort(a[r])[-5:])
                       & set(np.argsort(b[r])[-5:])) >= 4

    if dt == "f32":
        assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    else:
        jax_contract(got, ref)
    # JAX's gate for the boundary, on the port: against the unquantised
    # forward
    jax_contract(got, plain)
    assert not np.array_equal(got, plain)


def test_act_int8_never_quantizes_in_training():
    jm, _, _ = _tiny()
    feats = torch.from_numpy(_mels(jm, n=1)[0])
    net = _port_backbone("f32")
    with torch.no_grad():
        tr = net(feats, train=True, act_int8=True)["logits"]
        want = net(feats, train=True)["logits"]
    np.testing.assert_array_equal(tr.numpy(), want.numpy())


def test_act_int8_fused_matches_jax_and_keeps_channels_last(monkeypatch):
    """Fused blocks with the boundary: every boundary tensor is int8, the
    dequantised activation entering a fused block keeps channels_last,
    and the logits match JAX's fused path (Pallas in interpret mode)."""
    jm, _, _ = _tiny()
    feats = _mels(jm, n=1, batch=2, seed=4)[0]
    ref = _jax_act_int8("f32", feats, fused=True)
    net = _port_backbone("f32")
    codes, fused_inputs = [], []
    orig_q, orig_f = TE.quantize_boundary, TE.mbconv_fused

    def q(h, dtype):
        out = orig_q(h, dtype)
        codes.append(out)
        return out

    def f(blk, h, **kw):
        fused_inputs.append(h)
        return orig_f(blk, h, **kw, dot_dtype=torch.float32)

    monkeypatch.setattr(TE, "quantize_boundary", q)
    monkeypatch.setattr(TE, "mbconv_fused", f)
    with torch.inference_mode():
        got = net(torch.from_numpy(feats), fused_blocks=True,
                  act_int8=True)["logits"].numpy()
    assert len(codes) == 1 + len(net.blocks)
    assert all(c.dtype == torch.int8 for c in codes)
    assert fused_inputs and all(
        h.is_contiguous(memory_format=torch.channels_last)
        for h in fused_inputs)
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_model_step_passes_act_int8_and_bat_ignores_it():
    """``MelCnnModel.act_int8`` reaches the backbone from ``apply`` and
    ``apply_int16``; the bat family takes the knob and ignores it, as in
    JAX."""
    _, _, tm = _tiny()
    pcm = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (2, 48000)) * 3000).astype(np.int16))
    assert BirdNETv24.act_int8 is False
    with torch.inference_mode():
        a = tm.apply_int16(pcm)["logits"]
        tm.act_int8 = True
        b = tm.apply_int16(pcm)["logits"]
        c = tm.apply(pcm.float() / 32768.0)["logits"]
        tm.act_int8 = False
        d = tm.apply(pcm.float() / 32768.0)["logits"]
    assert not torch.equal(a, b) and not torch.equal(c, d)
    np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=1e-4, atol=1e-4)

    net = TE.EfficientNetConfig(blocks=(TE.BlockSpec(1, 8, 3, 2, 1),),
                                stem_channels=8, embedding_dim=16,
                                num_classes=12)
    bat = BatClassifier(num_species=12, compute_dtype=torch.float32,
                        net=net).init(torch.Generator().manual_seed(0))
    bat.eval()
    x = torch.from_numpy((np.random.default_rng(4).standard_normal(
        (2, 144000)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        want = bat.apply(x)["logits"]
        apply_serving_options(bat, SimpleNamespace(act_int8=True))
        assert bat.act_int8 is True
        np.testing.assert_array_equal(bat.apply(x)["logits"].numpy(),
                                      want.numpy())


def test_apply_serving_options_matches_jax_wiring():
    _, _, tm = _tiny()
    assert tm.act_int8 is False
    apply_serving_options(tm, RealtimeSettings(act_int8=True))
    assert tm.act_int8 is True
    tm.act_int8 = False
    apply_serving_options(tm, RealtimeSettings())
    assert tm.act_int8 is False
    apply_serving_options(tm, SimpleNamespace(act_int8=True))
    assert tm.act_int8 is True
    tm.act_int8 = False
    apply_serving_options(tm, SimpleNamespace())
    assert tm.act_int8 is False

    class NoKnob:
        spec = None

    nk = NoKnob()
    apply_serving_options(nk, RealtimeSettings(act_int8=True))
    assert not hasattr(nk, "act_int8")
    assert not hasattr(ImportedModel, "act_int8")


def _bn_from_batch(model, pcm):
    """Every BN's statistics from its input over `pcm` (float32 windows),
    so that the random-weight network's activations are O(1) at every
    depth, as a trained network's are."""
    stats = {}

    def note(mod, args):
        stats[mod] = torch.var_mean(args[0].float(), dim=(0, 2, 3),
                                    correction=0)

    hooks = [m.register_forward_pre_hook(note) for m in model.modules()
             if isinstance(m, L.BatchNorm)]
    with torch.no_grad():
        model.apply(pcm, train=True)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for m, (var, mean) in stats.items():
            m.mean.copy_(mean)
            m.var.copy_(var)


def test_full_width_int8_fidelity_matches_jax():
    """The full-width v2.4 backbone (B0, float32, seeded weights, BN
    statistics from field-level tones), calibrated and quantized by both
    packages on the same mel batches: the scales agree within 1e-5, and
    the int8 forward's logit correlation with the float32 forward is the
    JAX package's within 0.05 (at full depth both are far below the tiny
    net's 0.9: the max-abs scales leave most codes 0)."""
    from birdnet_go_tpu_torch.ops.pallas_melspec import melspec_fused

    rng = np.random.default_rng(30)
    t = np.arange(144000) / 48000.0

    def tones(n):
        f = rng.uniform(200.0, 12000.0, (n, 1))
        x = 0.05 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(
            (n, 144000))
        return torch.from_numpy((x * 32767).astype(np.int16))

    tm = BirdNETv24(compute_dtype=torch.float32).init(
        torch.Generator().manual_seed(0)).eval()
    _bn_from_batch(tm, tones(8).float() / 32768.0)
    with torch.inference_mode():
        cal, mel = ([melspec_fused(tones(n), tm.mel)[..., None].numpy()
                     for _ in range(k)] for n, k in ((4, 2), (2, 1)))
    mel = mel[0]
    jm = JBirdNETv24(compute_dtype=jnp.float32)
    sd = {k: v.numpy() for k, v in tm.backbone.state_dict().items()}

    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        return _hwio(torch.from_numpy(sd[prefix[:-1]])) if sd[
            prefix[:-1]].ndim >= 2 else sd[prefix[:-1]]

    params = fill(_np_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    jscales = JQ.calibrate_efficientnet(params, jm.net, cal)
    tscales = TQ.calibrate_efficientnet(tm.backbone, cal)
    for k, v in jscales.items():
        np.testing.assert_allclose(tscales[k], v, rtol=1e-5, err_msg=k)
    jq = JQ.quantize_efficientnet(params, jm.net, jscales)
    j8 = np.asarray(JQ.apply_efficientnet_int8(jq, jnp.asarray(mel),
                                               jm.net)["logits"])
    j32 = np.asarray(apply_efficientnet(params, jnp.asarray(mel), jm.net,
                                        compute_dtype=jnp.float32)["logits"])
    with torch.inference_mode():
        x = torch.from_numpy(mel)
        t8 = TQ.quantize_efficientnet(tm.backbone, tscales)(x)["logits"]
        t32 = tm.backbone(x)["logits"]
    corr = lambda a, b: np.corrcoef(np.ravel(a), np.ravel(b))[0, 1]  # noqa
    assert abs(corr(t8.numpy(), t32.numpy()) - corr(j8, j32)) < 0.05
    assert corr(t32.numpy(), j32) > 0.999999
