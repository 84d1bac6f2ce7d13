"""The port's fused MBConv path against the JAX package's, on the CPU.

On a CPU tensor ``expand_dw_pool`` and ``scale_project`` take their plain
versions; the JAX side runs the Pallas kernels in interpret mode. Inputs and
parameters are made with numpy from a seed (the JAX init for whole blocks)
and handed to both packages. The shapes are those of
``tests/test_pallas_mbconv.py`` plus B1's expand-less residual block.

Tolerances:
- float32 with float32 dot: |Δ| <= 1e-5 · |ref| + 1e-6. The float32 sums
  are taken in another order (and XLA may contract a multiply and an add),
  which leaves about 1e-7 of absolute noise on values of order 1; near a
  zero of the output that noise is 4e-5 to 2e-4 of (|ref| + 1e-3), so a
  relative bound alone cannot hold there;
- bf16: < 2^-7 + 1e-3, one bf16 step (a float32 value one ulp off may round
  to the next bf16 value);
- pool (float32 sum over S): |Δ| < 1e-4 · (|ref| + S · 1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import birdnet_go_tpu.ops.pallas_mbconv as JM
from birdnet_go_tpu.models import layers as JL
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models import layers as TL
from birdnet_go_tpu_torch.ops import pallas_mbconv as TM

torch.set_num_threads(1)

CASES = [
    # (cin, cout, kernel, expand, H, W)
    (32, 16, 3, 1, 20, 12),     # stage-1-like (no expand, cin != cout)
    (24, 24, 3, 6, 17, 12),     # small-C residual block (odd H)
    (40, 40, 5, 6, 9, 6),       # 5×5 depthwise
    (80, 112, 5, 6, 6, 6),      # channel change (no residual)
    (16, 16, 3, 1, 12, 8),      # B1 stage 1, repeat 2: no expand, residual
]
MODES = {  # name: (activation dtype, dot dtype) in JAX and torch
    "f32": ((jnp.float32, jnp.float32), (torch.float32, torch.float32)),
    "bf16": ((jnp.bfloat16, jnp.bfloat16), (torch.bfloat16, torch.bfloat16)),
}
BATCH = 2


def _assert_close(ref, got, mode):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert ref.shape == got.shape
    if mode == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        rel = np.abs(ref - got) / (np.abs(ref) + 1e-3)
        assert rel.max() < 2.0 ** -7 + 1e-3, rel.max()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _bn_consts(rng, c):
    return (rng.uniform(0.5, 1.5, (1, c)).astype(np.float32),
            rng.normal(0.0, 0.2, (1, c)).astype(np.float32))


def _case_a(case):
    cin, _, k, expand, h, w = case
    rng = np.random.default_rng(sum(case))
    cm = cin * expand
    x = rng.standard_normal((BATCH, h * w, cin)).astype(np.float32)
    wexp = (rng.standard_normal((cin, cm)) / np.sqrt(cin)).astype(
        np.float32) if expand > 1 else None
    kexp, bexp = _bn_consts(rng, cm)
    dwk = (rng.standard_normal((k * k, cm)) / k).astype(np.float32)
    kdw, bdw = _bn_consts(rng, cm)
    return x, wexp, kexp, bexp, dwk, kdw, bdw


def _case_b(case):
    cin, cout, *_ = case
    expand = case[3]
    rng = np.random.default_rng(100 + sum(case))
    cm = cin * expand
    y = rng.standard_normal((BATCH, case[4] * case[5], cm)).astype(np.float32)
    se = rng.uniform(0.0, 1.0, (BATCH, cm)).astype(np.float32)
    wproj = (rng.standard_normal((cm, cout)) / np.sqrt(cm)).astype(np.float32)
    kpr, bpr = _bn_consts(rng, cout)
    res = (rng.standard_normal((BATCH, case[4] * case[5], cout)).astype(
        np.float32) if cin == cout else None)
    return y, se, wproj, kpr, bpr, res


@functools.lru_cache(maxsize=None)
def _jax_a(case, mode):
    """JAX kernel A in interpret mode: (y, pool) as float32 numpy."""
    x, wexp, *consts = _case_a(case)
    (adt, ddt), _ = MODES[mode]
    _, _, k, _, h, w = case
    fn = jax.jit(lambda x, wexp, *c: JM.expand_dw_pool(
        x, wexp, *c, height=h, width=w, kernel=k, out_dtype=adt,
        dot_dtype=ddt, interpret=True))
    y, pool = fn(jnp.asarray(x).astype(adt), wexp, *consts)
    return np.asarray(y.astype(jnp.float32)), np.asarray(pool)


@functools.lru_cache(maxsize=None)
def _jax_b(case, mode):
    y, se, wproj, kpr, bpr, res = _case_b(case)
    (adt, ddt), _ = MODES[mode]
    fn = jax.jit(lambda y, se, w, k, b, r: JM.scale_project(
        y, se, w, k, b, r, out_dtype=adt, dot_dtype=ddt, interpret=True))
    out = fn(jnp.asarray(y).astype(adt), se, wproj, kpr, bpr,
             None if res is None else jnp.asarray(res).astype(adt))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", CASES)
def test_expand_dw_pool_matches_jax(case, mode):
    x, wexp, *consts = _case_a(case)
    _, (adt, ddt) = MODES[mode]
    _, _, k, _, h, w = case
    y, pool = TM.expand_dw_pool(
        _t(x, adt), None if wexp is None else _t(wexp),
        *map(_t, consts), height=h, width=w, kernel=k, out_dtype=adt,
        dot_dtype=ddt)
    assert y.dtype == adt and pool.dtype == torch.float32
    ref_y, ref_pool = _jax_a(case, mode)
    _assert_close(ref_y, y.float(), mode)
    err = np.abs(pool.numpy() - ref_pool)
    assert (err < 1e-4 * (np.abs(ref_pool) + h * w * 1e-3)).all(), err.max()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", CASES)
def test_scale_project_matches_jax(case, mode):
    y, se, wproj, kpr, bpr, res = _case_b(case)
    _, (adt, ddt) = MODES[mode]
    out = TM.scale_project(_t(y, adt), _t(se), _t(wproj), _t(kpr), _t(bpr),
                           None if res is None else _t(res, adt),
                           out_dtype=adt, dot_dtype=ddt)
    assert out.dtype == adt
    _assert_close(_jax_b(case, mode), out.float(), mode)


def _random_bn(tree, rng):
    """Non-trivial BN statistics for every BN dict of a block's pytree."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = len(tree["scale"])
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(0, 0.1, c).astype(np.float32),
                    "mean": rng.normal(0, 0.1, c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    return np.asarray(tree)


def _block(case):
    cin, cout, k, expand, h, w = case
    p = _random_bn(JL.init_mbconv(jax.random.PRNGKey(sum(case)), cin, cout,
                                  k, expand), np.random.default_rng(7))
    x = np.random.default_rng(8).standard_normal(
        (BATCH, h, w, cin)).astype(np.float32)
    return p, x, load_jax_params(TL.MBConv(cin, cout, k, expand), p)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_glue_matches_jax(case, dt):
    """mbconv_fused, SE mid included, with bf16 dot operands in both
    dtypes (the JAX backbone never passes dot_dtype). A float32 value one
    ulp off may round to the next bf16 operand, so both dtypes are held to
    one bf16 step of the output's scale."""
    p, x, blk = _block(case)
    (jdt, _), (tdt, _) = MODES[dt]
    k = case[2]
    ref = np.asarray(jax.jit(functools.partial(
        JM.mbconv_fused, kernel=k, compute_dtype=jdt, interpret=True))(
        p, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    xt = _t(x, tdt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = TM.mbconv_fused(blk, xt, kernel=k, compute_dtype=tdt)
    assert got.dtype == tdt and got.shape == (BATCH, case[1], *case[4:])
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).float().numpy()
    err = np.abs(got - ref).max()
    assert err < (2.0 ** -7 + 1e-3) * max(1.0, np.abs(ref).max()), err
    # the unfused block computes the same function
    unfused = blk(xt, tdt).permute(0, 2, 3, 1).float().numpy()
    assert np.abs(unfused - got).max() < 0.1 * max(1.0, np.abs(ref).max())


def _nhwc_to_channels_last(x):
    return _t(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _count_calls(monkeypatch, name):
    """Record every call of TM.<name> (which still runs)."""
    calls = []
    orig = getattr(TM, name)
    monkeypatch.setattr(TM, name, lambda t: calls.append(t) or orig(t))
    return calls


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_glue_folds_its_constants_once(case, monkeypatch):
    """Folded BN and the weights in the kernels' layouts, the packed bf16
    fragments included, are made on the first call only. Made in inference
    mode, they serve a later call outside it too."""
    _, x, blk = _block(case)
    folds = _count_calls(monkeypatch, "fold_bn")
    packs = _count_calls(monkeypatch, "pack_fragments")
    xt = _nhwc_to_channels_last(x)
    kw = dict(kernel=case[2], compute_dtype=torch.float32)
    n_folds, n_packs = (2, 1) if blk.expand_conv is None else (3, 2)
    with torch.inference_mode():
        first = TM.mbconv_fused(blk, xt, **kw)
    assert (len(folds), len(packs)) == (n_folds, n_packs)
    second = TM.mbconv_fused(blk, xt, **kw)
    assert (len(folds), len(packs)) == (n_folds, n_packs)
    assert torch.equal(first, second)
    consts = blk._fused_consts[1]
    assert not any(t.is_inference() for t in consts if t is not None)
    # the packed weights are those of the block's own
    wexp, wproj, wexp_frags, wproj_frags = (consts[0], consts[6],
                                            *consts[9:])
    assert torch.equal(wproj_frags, TM.pack_fragments(wproj))
    assert (wexp_frags is None) == (wexp is None)
    if wexp is not None:
        assert torch.equal(wexp_frags, TM.pack_fragments(wexp))


def test_glue_folds_again_after_the_weights_change():
    """An in-place write (``load_state_dict``) and a new tensor behind a
    parameter both refold: the result equals a fresh block's."""
    case = CASES[1]
    cin, cout, k, expand = case[:4]
    p, x, blk = _block(case)
    xt = _nhwc_to_channels_last(x)
    kw = dict(kernel=k, compute_dtype=torch.float32)
    before = TM.mbconv_fused(blk, xt, **kw)
    packed = blk._fused_consts[1][9:]
    other = load_jax_params(TL.MBConv(cin, cout, k, expand),
                            _random_bn(p, np.random.default_rng(9)))
    for name in ("expand_conv", "project_conv"):      # new weights, too
        w = getattr(other, name).w
        w.data = w.data.flip(0)
    blk.load_state_dict(other.state_dict())
    got = TM.mbconv_fused(blk, xt, **kw)
    assert torch.equal(got, TM.mbconv_fused(other, xt, **kw))
    assert not torch.equal(got, before)
    # packed again, from the loaded weights
    repacked = blk._fused_consts[1][9:]
    for old, new, want in zip(packed, repacked,
                              other._fused_consts[1][9:]):
        assert torch.equal(new, want) and not torch.equal(new, old)
    for m in (blk, other):
        m.dw.w.data = m.dw.w.data * 2.0
    doubled = TM.mbconv_fused(blk, xt, **kw)
    assert torch.equal(doubled, TM.mbconv_fused(other, xt, **kw))
    assert not torch.equal(doubled, got)


def test_glue_folds_inference_mode_parameters_on_every_call(monkeypatch):
    """A block made in inference mode has parameters that keep no version:
    its constants are folded on each call, and the result is the same."""
    case = CASES[1]
    cin, cout, k, expand = case[:4]
    _, x, blk = _block(case)
    xt = _nhwc_to_channels_last(x)
    kw = dict(kernel=k, compute_dtype=torch.float32)
    with torch.inference_mode():
        made_inside = TL.MBConv(cin, cout, k, expand)
        made_inside.load_state_dict(blk.state_dict())
        folds = []
        orig = TM.fold_bn
        monkeypatch.setattr(TM, "fold_bn",
                            lambda bn: folds.append(bn) or orig(bn))
        got = [TM.mbconv_fused(made_inside, xt, **kw) for _ in range(2)]
    assert len(folds) == 6
    want = TM.mbconv_fused(blk, xt, **kw)
    assert all(torch.equal(g, want) for g in got)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(3)
    p = _random_bn(JL.init_bn(24), rng)
    bn = load_jax_params(TL.BatchNorm(24), p)
    for got, want in zip(TM.fold_bn(bn), JM._fold_bn(p)):
        assert got.shape == (1, 24) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_fused_block_ok_equals_jax():
    for stride in (1, 2):
        for h in (1, 7, 8, 9, 21, 22, 139):
            for w in (1, 3, 6, 8, 48):
                for train in (False, True):
                    assert (TM.fused_block_ok(stride, h, w, train)
                            == JM.fused_block_ok(stride, h, w, train))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, wexp, *consts = _case_a(CASES[1])
    h, w = CASES[1][4:]
    xt, wt, ct = _t(x), _t(wexp), list(map(_t, consts))
    kw = dict(height=h, width=w, kernel=3)
    # an NCHW-contiguous activation seen as [B, S, C] is not contiguous
    nchw = xt.view(BATCH, h, w, -1).permute(0, 3, 1, 2).contiguous()
    bad = [
        (nchw.permute(0, 2, 3, 1).view(BATCH, h * w, -1), wt, kw),
        (xt.to(torch.float16), wt, kw),
        (xt, wt, dict(kw, kernel=7)),
        (xt, wt, dict(kw, height=h + 1)),
        (xt, wt[:, :-1], kw),
        (xt, None, kw),                       # Cm != C without an expand
    ]
    for xa, wa, kwa in bad:
        with pytest.raises(ValueError):
            TM.expand_dw_pool(xa, wa, *ct, **kwa)
    with pytest.raises(ValueError):
        TM.expand_dw_pool(xt, wt, *ct, **kw, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        TM.expand_dw_pool(xt.to("meta"), wt.to("meta"),
                          *(c.to("meta") for c in ct), **kw)

    y, se, wproj, kpr, bpr, res = map(
        lambda a: None if a is None else _t(a), _case_b(CASES[1]))
    for args in ((y.transpose(1, 2).contiguous().transpose(1, 2), se),
                 (y.to(torch.float16), se), (y, se.to(torch.bfloat16)),
                 (y, se[:1])):
        with pytest.raises(ValueError):
            TM.scale_project(*args, wproj, kpr, bpr, res)
    with pytest.raises(ValueError):
        TM.scale_project(y, se, wproj, kpr, bpr, res[:, :-1])


# -- work and bound ------------------------------------------------------------

# (C, Cm, k, H, W, C') and count of the fused blocks of one full-width step
V24_FUSED = [((32, 32, 3, 139, 48, 16), 1), ((24, 144, 3, 70, 24, 24), 1),
             ((40, 240, 5, 35, 12, 40), 1), ((80, 480, 3, 18, 6, 80), 2),
             ((80, 480, 5, 18, 6, 112), 1), ((112, 672, 5, 18, 6, 112), 2)]
V3_FUSED = [((32, 32, 3, 124, 64, 16), 1), ((16, 16, 3, 124, 64, 16), 1),
            ((24, 144, 3, 62, 32, 24), 2), ((40, 240, 5, 31, 16, 40), 2),
            ((80, 480, 3, 16, 8, 80), 3), ((80, 480, 5, 16, 8, 112), 1),
            ((112, 672, 5, 16, 8, 112), 3)]
PERCH_FUSED = [((32, 32, 3, 124, 80, 16), 1), ((16, 16, 3, 124, 80, 16), 1),
               ((24, 144, 3, 62, 40, 24), 2), ((40, 240, 5, 31, 20, 40), 2),
               ((80, 480, 3, 16, 10, 80), 3), ((80, 480, 5, 16, 10, 112), 1),
               ((112, 672, 5, 16, 10, 112), 3)]


def _step_work(shapes):
    """Kernels A's and B's work summed over one step's fused blocks at
    B = 256, bf16: ((flops by type, bytes) of A, the same of B)."""
    out = []
    for fn in ("a", "b"):
        flops, nbytes = {}, 0.0
        for (c, cm, k, h, w, c2), n in shapes:
            if fn == "a":
                f, b = TM.expand_dw_pool_work(256, h, w, c, cm, k,
                                              expand=cm != c)
            else:
                f, b = TM.scale_project_work(256, h * w, cm, c2,
                                             residual=c2 == c)
            for t, v in f.items():
                flops[t] = flops.get(t, 0.0) + n * v
            nbytes += n * b
        out.append((flops, nbytes))
    return out


@pytest.mark.parametrize("shapes,a_bytes,b_bytes", [
    (V24_FUSED, 606e6, 601e6), (V3_FUSED, 1179e6, 1283e6)],
    ids=["v24", "v3"])
def test_mbconv_work_counts(shapes, a_bytes, b_bytes):
    """The counts of the bring-up plan: A's expand (bf16) and depthwise
    (float32) operations exactly, its bytes and B's within 1% (they also
    count the constants and B's SE scale); both memory-bound."""
    from birdnet_go_tpu_torch.ops.roofline import bound_ms

    (fa, ba), (fb, bb) = _step_work(shapes)
    assert sum(n for _, n in shapes) in (8, 13)
    if shapes is V24_FUSED:
        assert round(fa["bf16"] / 1e9, 1) == 19.7
        assert round(fa["f32"] / 1e9, 1) == 6.4
        assert round(fb["bf16"] / 1e9, 1) == 22.3
    assert abs(ba / a_bytes - 1) < 0.01 and abs(bb / b_bytes - 1) < 0.01
    for f, b in ((fa, ba), (fb, bb)):
        ms, by = bound_ms(f, b)
        assert by == "bytes" and ms == pytest.approx(b / 3.35e12 * 1e3)


def test_mbconv_work_follows_dtypes():
    f, b = TM.expand_dw_pool_work(2, 4, 4, 8, 8, 3, expand=False,
                                  x_dtype=torch.float32,
                                  out_dtype=torch.float32)
    assert f == {"f32": 2.0 * 32 * 8 * 9}
    assert b == 32 * 8 * 4 * 2 + 2 * 8 * 4 + 4 * (9 * 8 + 4 * 8)
    f, _ = TM.expand_dw_pool_work(2, 4, 4, 8, 16, 3,
                                  dot_dtype=torch.float32)
    assert f == {"f32": 2.0 * 32 * 16 * 9 + 2.0 * 32 * 8 * 16}
    f, b = TM.scale_project_work(2, 16, 8, 4, residual=False,
                                 dot_dtype=torch.float32)
    assert f == {"f32": 2.0 * 32 * 8 * 4}
    assert b == 32 * 8 * 2 + 2 * 8 * 4 + 4 * (32 + 8) + 32 * 4 * 2


# -- packed weights and the fused shapes ---------------------------------------

def _unpack(frags):
    """The [K, N] bf16 matrix behind packed fragments, read off the
    definition of the mma.sync m16n8k16 B fragment: lane 4·g + t of k16
    step s and column tile j holds, as its elements 0 to 3, rows
    16·s + 2·t + (0, 1, 8, 9) of column 8·j + g."""
    ks, nt = frags.shape[:2]
    w = torch.full((ks * 16, nt * 8), float("nan"), dtype=torch.bfloat16)
    for lane in range(32):
        g, t = divmod(lane, 4)
        cols = torch.arange(nt) * 8 + g
        for e, dk in enumerate((0, 1, 8, 9)):
            rows = torch.arange(ks) * 16 + 2 * t + dk
            w[rows[:, None], cols[None, :]] = frags[:, :, lane, e]
    return w


@pytest.mark.parametrize("k,n", [
    (20, 100), (24, 144), (40, 240), (112, 672),     # wexp [C, Cm]
    (144, 16), (100, 28), (672, 112),                # wproj [Cm, C']
])
def test_pack_fragments_unpacks_to_the_bf16_weights(k, n):
    """Unpacking gives back w rounded to bf16 exactly, zeros past K and
    N, and every element of the padded matrix is written once."""
    w = torch.from_numpy(np.random.default_rng(k * n).standard_normal(
        (k, n)).astype(np.float32))
    frags = TM.pack_fragments(w)
    assert frags.shape == (-(-k // 16), -(-n // 8), 32, 4)
    assert frags.dtype == torch.bfloat16 and frags.is_contiguous()
    full = _unpack(frags)
    assert not torch.isnan(full.float()).any()
    assert torch.equal(full[:k, :n], w.to(torch.bfloat16))
    assert not full[k:].float().any() and not full[:, n:].float().any()


@pytest.mark.parametrize("family,want", [
    ("BirdNET_V2.4", V24_FUSED), ("BirdNET_V3.0", V3_FUSED),
    ("Perch_V2", PERCH_FUSED)])
def test_fused_block_shapes_read_off_the_models(family, want):
    """The shapes at which the card's checks and diagnostics hold kernels A
    and B are those of each model's full-width fused step."""
    from birdnet_go_tpu_torch.diag.mbconv_cases import (
        FAMILIES,
        fused_block_shapes,
    )

    cls = {c.spec.model_id: c for c in FAMILIES}[family]
    assert fused_block_shapes(cls) == want
