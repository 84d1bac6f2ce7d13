"""The port's CNN layers against ``birdnet_go_tpu.models.layers``, float32.

Parameters come from the JAX init (or numpy, for BatchNorm statistics) and
reach the port through ``params_from_jax``; activations are NHWC on the
JAX side and NCHW in the port. Tolerance: atol 1e-5, float32 sums taken in
another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_go_tpu.models import layers as JL
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models import layers as TL

torch.set_num_threads(1)
F32 = jnp.float32
ATOL = 1e-5


def _jit(fn, **static):
    """One XLA compile per reference call instead of one per op."""
    return jax.jit(functools.partial(fn, **static))


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _nhwc(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _random_bn(c, rng):
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.1, c).astype(np.float32),
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


def _randomize_bn(tree, rng):
    """Replace every BN dict of a parameter pytree by random statistics."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            return _random_bn(len(tree["scale"]), rng)
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    return tree


def test_same_pad_stride2_pads_bottom_right():
    x = torch.arange(278 * 96, dtype=torch.float32).reshape(1, 1, 278, 96)
    y = TL.same_pad(x, 3, 2)
    assert y.shape == (1, 1, 279, 97)
    assert torch.equal(y[..., :278, :96], x)
    assert not y[..., 278, :].any() and not y[..., :, 96].any()
    # stride 1, odd kernel: symmetric
    y1 = TL.same_pad(x[..., :10, :10], 5, 1)
    assert y1.shape == (1, 1, 14, 14)
    assert torch.equal(y1[..., 2:12, 2:12], x[..., :10, :10])


def test_stem_conv_matches_jax():
    """278×96 → 139×48 at stride 2: TF-SAME pads (0, 1), (0, 1)."""
    p = JL.init_conv(jax.random.PRNGKey(0), 3, 3, 1, 8)
    x = _nhwc((2, 278, 96, 1), 1)
    ref = np.asarray(_jit(JL.apply_conv, stride=2, compute_dtype=F32)(
        p, jnp.asarray(x)))
    conv = load_jax_params(TL.Conv(1, 8, 3, stride=2), _np_tree(p))
    got = _to_nhwc(conv(_to_nchw(x), torch.float32))
    assert got.shape == ref.shape == (2, 139, 48, 8)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("k,stride,hw", [(5, 2, (35, 12)), (5, 2, (34, 13)),
                                         (3, 2, (17, 6)), (5, 1, (9, 6)),
                                         (3, 1, (8, 8))])
def test_depthwise_matches_jax(k, stride, hw):
    c = 12
    p = JL.init_depthwise(jax.random.PRNGKey(1), k, c)
    x = _nhwc((2, *hw, c), 2)
    ref = np.asarray(_jit(JL.apply_depthwise, stride=stride,
                          compute_dtype=F32)(p, jnp.asarray(x)))
    dw = load_jax_params(TL.depthwise(c, k, stride), _np_tree(p))
    got = _to_nhwc(dw(_to_nchw(x), torch.float32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_bn_dense_se_match_jax():
    rng = np.random.default_rng(3)
    c = 24
    x = _nhwc((2, 7, 5, c), 4)
    bn = _random_bn(c, rng)
    ref = np.asarray(_jit(JL.apply_bn)(bn, jnp.asarray(x)))
    got = _to_nhwc(load_jax_params(TL.BatchNorm(c), bn)(_to_nchw(x)))
    np.testing.assert_allclose(got, ref, atol=ATOL)

    pd = JL.init_dense(jax.random.PRNGKey(2), c, 10)
    pd = {"w": np.asarray(pd["w"]), "b": rng.normal(0, 1, 10).astype(
        np.float32)}
    v = x[:, 0, 0, :]
    ref = np.asarray(_jit(JL.apply_dense, compute_dtype=F32)(
        pd, jnp.asarray(v)))
    dense = load_jax_params(TL.Dense(c, 10), pd)
    np.testing.assert_allclose(dense(torch.from_numpy(v), torch.float32),
                               ref, atol=ATOL)

    ps = JL.init_se(jax.random.PRNGKey(3), c, 6)
    ref = np.asarray(_jit(JL.apply_se, compute_dtype=F32)(
        ps, jnp.asarray(x)))
    se = load_jax_params(TL.SqueezeExcite(c, 6), _np_tree(ps))
    np.testing.assert_allclose(_to_nhwc(se(_to_nchw(x), torch.float32)),
                               ref, atol=ATOL)


def test_dense_bf16_keeps_float32_accumulator():
    """bf16 Dense: the float32 sum of products of bf16-rounded operands, as
    JAX's apply_dense (rounding the product to bf16 first was 3.8e-3 off)."""
    rng = np.random.default_rng(9)
    pd = {"w": rng.normal(0, 1280 ** -0.5, (1280, 300)).astype(np.float32),
          "b": rng.normal(0, 0.1, 300).astype(np.float32)}
    v = rng.standard_normal((4, 1280)).astype(np.float32)
    ref = np.asarray(_jit(JL.apply_dense, compute_dtype=jnp.bfloat16)(
        pd, jnp.asarray(v)))
    got = load_jax_params(TL.Dense(1280, 300), pd)(torch.from_numpy(v),
                                                   torch.bfloat16)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


@pytest.mark.parametrize("cin,cout,k,expand,stride,hw",
                         [(16, 16, 3, 1, 1, (12, 8)),     # no expand, residual
                          (16, 24, 3, 6, 2, (13, 9)),     # expand, stride 2
                          (24, 24, 5, 6, 1, (9, 7)),      # expand, residual
                          (24, 40, 5, 6, 2, (10, 6))])    # k5 stride 2
def test_mbconv_matches_jax(cin, cout, k, expand, stride, hw):
    rng = np.random.default_rng(5)
    p = _randomize_bn(_np_tree(JL.init_mbconv(
        jax.random.PRNGKey(4), cin, cout, k, expand)), rng)
    x = _nhwc((2, *hw, cin), 6)
    ref = np.asarray(_jit(JL.apply_mbconv, stride=stride, compute_dtype=F32)(
        p, jnp.asarray(x)))
    blk = load_jax_params(TL.MBConv(cin, cout, k, expand, stride), p)
    got = _to_nhwc(blk(_to_nchw(x), torch.float32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_init_is_fan_in_truncated_normal_and_seeded():
    def draw(seed):
        blk = TL.MBConv(32, 40, 5, 6, 2)
        blk.init(torch.Generator().manual_seed(seed))
        return blk

    a, b, c = draw(0), draw(0), draw(1)
    sa = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sa.items())
    assert not torch.equal(sa["dw.w"], c.state_dict()["dw.w"])
    w = sa["expand_conv.w"]                         # fan-in 32
    std = (2.0 / 32) ** 0.5
    assert w.abs().max() <= 2 * std + 1e-6
    # a standard normal truncated at ±2 has std 0.8796
    assert abs(w.std().item() / std - 0.8796) < 0.05
    assert torch.equal(sa["dw_bn.scale"], torch.ones(192))
    assert torch.equal(sa["dw_bn.var"], torch.ones(192))
    assert not sa["se.reduce.b"].any()
