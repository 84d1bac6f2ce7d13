"""The port's mel front end against the JAX package's.

Inputs come from a numpy seed and go through both packages: the port's
plain mel (``melspec_fused`` on a CPU tensor takes it) against the JAX XLA
path and against the Pallas kernel in interpret mode, at the tolerances of
``tests/test_pallas_melspec.py``; the copied numpy constant builders and
the kernel constants array for array; and the ``melspec_v24`` golden
fingerprint, read only.
"""

import dataclasses
import importlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_go_tpu.ops import pcm as jpcm
from birdnet_go_tpu.ops import postprocess as jpost
from birdnet_go_tpu.ops.pallas_melspec import _kernel_consts
from birdnet_go_tpu.ops.pallas_melspec import melspec_fused as jax_fused
from birdnet_go_tpu_torch.ops import pcm as tpcm
from birdnet_go_tpu_torch.ops import postprocess as tpost
from birdnet_go_tpu_torch.ops.pallas_melspec import (
    kernel_consts,
    melspec_fused,
)

# the packages' `ops/__init__` re-export the function `melspec`, which
# shadows the submodule of the same name as an attribute
jmel = importlib.import_module("birdnet_go_tpu.ops.melspec")
tmel = importlib.import_module("birdnet_go_tpu_torch.ops.melspec")

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"

V24 = dict(sample_rate=48000, n_fft=2048, hop=512, n_mels=96,
           fmax=15000.0, mag_scale="nonlinear")
LOG = dict(sample_rate=48000, n_fft=2048, hop=512, n_mels=64,
           fmax=12000.0, mag_scale="log")
FULL = dict(sample_rate=48000, n_fft=2048, hop=512, n_mels=96,
            fmax=24000.0, mag_scale="nonlinear")

# (config, batch shape, seed, amplitude) as in tests/test_pallas_melspec.py
CASES = {
    "v24": (V24, (2, 144000), 0, 0.05 * 32767),
    "log": (LOG, (1, 48000), 1, 3000.0),
    "fullband": (FULL, (1, 48000), 3, 0.1 * 32767),
    "v24_seed3": (V24, (1, 144000), 3, 0.05 * 32767),
}


def _pcm16(shape, seed, amp):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * amp).astype(np.int16)


def _assert_close(name, got, ref):
    if name == "log":
        np.testing.assert_allclose(got, ref, atol=2e-4)
    else:
        rel = np.abs(ref - got) / (np.abs(ref) + 1e-3)
        assert rel.max() < 1e-3, (name, rel.max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_mel_matches_jax_xla_and_pallas_interpret(name):
    kw, shape, seed, amp = CASES[name]
    pcm16 = _pcm16(shape, seed, amp)
    got = melspec_fused(torch.from_numpy(pcm16), tmel.MelConfig(**kw)).numpy()
    jcfg = jmel.MelConfig(**kw)
    ref = np.asarray(jmel.melspec(jnp.asarray(pcm16, jnp.float32) / 32768.0,
                                  jcfg))
    assert got.shape == ref.shape
    _assert_close(name, got, ref)
    interp = np.asarray(jax_fused(jnp.asarray(pcm16), jcfg, interpret=True))
    _assert_close(name, got, interp)


def test_fused_bf16_output_is_plain_rounded():
    pcm16 = torch.from_numpy(_pcm16((1, 48000), 4, 3000.0))
    cfg = tmel.MelConfig(**V24)
    got = melspec_fused(pcm16, cfg, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = melspec_fused(pcm16, cfg).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(n_fft=1024, hop=512),
                                dict(n_fft=2048, hop=500),
                                dict(n_fft=2048, hop=512, power=1.0)])
def test_fused_rejects_unsupported_config(kw):
    pcm = torch.zeros((1, 48000), dtype=torch.int16)
    with pytest.raises(ValueError):
        jax_fused(jnp.zeros((1, 48000), jnp.int16), jmel.MelConfig(**kw),
                  interpret=True)
    with pytest.raises(ValueError):
        melspec_fused(pcm, tmel.MelConfig(**kw))


def test_fused_rejects_unknown_mag_scale():
    # the TPU kernel treats an unknown scale as linear; the port refuses it
    with pytest.raises(ValueError, match="mag_scale"):
        melspec_fused(torch.zeros((1, 48000), dtype=torch.int16),
                      tmel.MelConfig(mag_scale="cubic"))


@pytest.mark.parametrize("kw", [V24, LOG, FULL], ids=["v24", "log", "full"])
def test_kernel_consts_equal_jax(kw):
    args = (kw["sample_rate"], kw["n_fft"], kw["n_mels"], 0.0, kw["fmax"])
    wpk, ta, tb, fb2, j2 = kernel_consts(*args)
    (jwb,), (jta, jtb), jfb2, jj2 = _kernel_consts(*args, 1, True)
    assert j2 == jj2
    for a, b in ((wpk, jwb), (ta, jta), (tb, jtb), (fb2, jfb2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_kernel_consts_trim_to_filterbank_support():
    args = (48000, 2048, 96, 0.0)
    assert kernel_consts(*args, 15000.0)[-1] == 40
    assert kernel_consts(*args, 24000.0)[-1] == 64


@pytest.mark.parametrize("n_fft,a_sz", [(2048, None), (2048, 16),
                                        (1024, None), (512, 8)])
def test_copied_dft_builders_equal_jax(n_fft, a_sz):
    got = tmel._rdft_matmul_consts(n_fft, a_sz)
    want = jmel._rdft_matmul_consts(n_fft, a_sz)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert tmel._choose_radix(n_fft) == jmel._choose_radix(n_fft)


@pytest.mark.parametrize("args", [(48000, 2048, 96, 0.0, 15000.0),
                                  (48000, 2048, 64, 0.0, 12000.0),
                                  (32000, 1024, 128, 50.0, 16000.0)])
def test_copied_filterbanks_equal_jax(args):
    np.testing.assert_array_equal(tmel._mel_filterbank_np(*args),
                                  jmel._mel_filterbank_np(*args))
    for a_sz in (None, 16):
        np.testing.assert_array_equal(
            tmel._mel_filterbank_permuted_np(*args, a_sz),
            jmel._mel_filterbank_permuted_np(*args, a_sz))


@pytest.mark.parametrize("window", ["hann", "hamming", "rect"])
def test_copied_window_and_config_equal_jax(window):
    t, j = tmel.MelConfig(window=window), jmel.MelConfig(window=window)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert (t.n_bins, t.num_frames(144000), t.num_frames(100)) == \
        (j.n_bins, j.num_frames(144000), j.num_frames(100))
    np.testing.assert_array_equal(tmel._window_fn(t), jmel._window_fn(j))
    with pytest.raises(ValueError):
        tmel._window_fn(tmel.MelConfig(window="kaiser"))


@pytest.mark.parametrize("kw", [dict(use_matmul_fft=False),
                                dict(power=1.0),
                                dict(mag_scale="db"),
                                dict(mag_scale="linear", window="hamming")])
def test_plain_mel_other_paths_match_jax(kw):
    x = np.random.default_rng(6).standard_normal((2, 12000)).astype(
        np.float32) * 0.2
    got = tmel.melspec(torch.from_numpy(x), tmel.MelConfig(**kw)).numpy()
    ref = np.asarray(jmel.melspec(jnp.asarray(x), jmel.MelConfig(**kw)))
    rel = np.abs(ref - got) / (np.abs(ref) + 1e-3)
    assert rel.max() < 1e-3, rel.max()


def test_frame_signal_matches_jax():
    x = np.arange(2 * 6000, dtype=np.float32).reshape(2, 6000)
    cfg = dict(n_fft=2048, hop=512)
    got = tmel.frame_signal(torch.from_numpy(x), tmel.MelConfig(**cfg))
    want = np.asarray(jmel.frame_signal(jnp.asarray(x), jmel.MelConfig(**cfg)))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tmel.frame_signal(torch.zeros(100), tmel.MelConfig())


def test_pcm_and_postprocess_match_jax():
    rng = np.random.default_rng(7)
    pcm16 = rng.integers(-32768, 32768, (3, 500)).astype(np.int16)
    f = tpcm.pcm16_to_float32(torch.from_numpy(pcm16)).numpy()
    np.testing.assert_array_equal(
        f, np.asarray(jpcm.pcm16_to_float32(jnp.asarray(pcm16))))
    x = (rng.standard_normal(700) * 1.2).astype(np.float32)
    np.testing.assert_array_equal(
        tpcm.float32_to_pcm16(torch.from_numpy(x)).numpy(),
        np.asarray(jpcm.float32_to_pcm16(jnp.asarray(x))))

    logits = rng.standard_normal((4, 300)).astype(np.float32) * 4
    conf = tpost.sigmoid_confidence(torch.from_numpy(logits), 0.7)
    jconf = jpost.sigmoid_confidence(jnp.asarray(logits), 0.7)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-6,
                               atol=1e-7)
    vals, idx = tpost.top_k_results(conf, 10)
    jvals, jidx = jpost.top_k_results(jconf, 10)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    mask = (rng.random(300) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tpost.apply_range_mask(torch.from_numpy(np.asarray(jconf)),
                               torch.from_numpy(mask)).numpy(),
        np.asarray(jpost.apply_range_mask(jconf, jnp.asarray(mask))))
    scores = rng.random(300).astype(np.float32)
    np.testing.assert_array_equal(
        tpost.occurrence_mask(torch.from_numpy(scores), 0.3).numpy(),
        np.asarray(jpost.occurrence_mask(jnp.asarray(scores), 0.3)))


def _tone_batch():
    t = np.arange(144000) / 48000.0
    rows = [np.sin(2 * np.pi * f * t) * 0.3 for f in (440.0, 2000.0, 7500.0)]
    return np.stack(rows).astype(np.float32)


def _golden_check(name, values, atol=1e-4, rtol=1e-3):
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


def test_plain_mel_matches_golden_fingerprint():
    m = tmel.melspec(torch.from_numpy(_tone_batch()),
                     tmel.MelConfig(**V24)).numpy()
    _golden_check("melspec_v24", m)


@pytest.mark.parametrize("kw,t_len,gflop,io_mb,f32_bound,bound", [
    (V24, 144000, 60.0, 87.4, 0.90, 0.405),
    (dict(sample_rate=32000, n_fft=2048, hop=640, n_mels=128, fmax=15000.0,
          mag_scale="nonlinear"), 160000, 87.0, 98.1, 1.30, 0.564),
    (dict(sample_rate=32000, n_fft=2048, hop=640, n_mels=160, fmin=60.0,
          fmax=10000.0, mag_scale="log"), 160000, 58.5, 102.2, 0.87, 0.391)],
    ids=["v24", "v3", "perch"])
def test_melspec_work_counts(kw, t_len, gflop, io_mb, f32_bound, bound):
    """The counts of the bring-up plan at B = 256, bf16 output: float32
    multiply-adds (the plan's GFLOP and its all-CUDA-core bound), PCM plus
    mel bytes, and the bound with stage 1 on CUDA cores and stage 2 and the
    mel projection as 3xTF32 on the tensor cores (operations)."""
    from birdnet_go_tpu_torch.ops.pallas_melspec import melspec_fused_work
    from birdnet_go_tpu_torch.ops.roofline import bound_ms

    cfg = tmel.MelConfig(**kw)
    flops, nbytes = melspec_fused_work(256, t_len, cfg, torch.bfloat16)
    assert set(flops) == {"f32", "tf32"}
    # stage 1 is 33 K of a frame's float32 multiply-adds, whatever J2
    frames = 256 * cfg.num_frames(t_len)
    assert flops["f32"] == 2 * 128 * 16 * 16 * frames
    f32_work = flops["f32"] + flops["tf32"] / 3
    assert round(f32_work / 1e9, 1) == gflop
    *_, j2 = kernel_consts(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                           cfg.fmax)
    consts = 4 * (2048 + 256 + 2 * 16 * 128 * 2 * j2 + 16 * j2 * cfg.n_mels)
    assert round((nbytes - consts) / 1e6, 1) == io_mb
    ms, by = bound_ms(flops, nbytes)
    assert by == "operations" and round(ms, 3) == bound
    assert round(bound_ms({"f32": f32_work}, nbytes)[0], 2) == f32_bound
    f32 = melspec_fused_work(256, t_len, cfg, torch.float32)[1]
    assert f32 - nbytes == 2 * 256 * cfg.num_frames(t_len) * cfg.n_mels


# -- the CUDA kernel's arithmetic, emulated on the CPU --------------------------
#
# The kernel runs stage 2 and the mel projection on the tensor cores in
# 3xTF32: each float32 operand x is split as hi = tf32(x), lo = tf32(x - hi)
# (cvt.rna: round to nearest, ties away from zero, 10-bit mantissa), and the
# product is lo·hi + hi·lo + hi·hi with float32 sums. Stage 2 sums runs of 16
# k-terms (two k8 steps) into a fresh partial that is then added to the
# total. These tests repeat that arithmetic with numpy on a few rows and hold
# it to the HIGHEST plain mel at the card's gates.


def _tf32(x):
    """cvt.rna.tf32.f32 on finite float32 values."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma3(a, b, split=True):
    """[..., m, 8] × [8, n] in 3xTF32, products summed in float32; with
    `split` False, one TF32 pass."""
    if not split:
        return np.matmul(_tf32(a), _tf32(b))
    (ah, al), (bh, bl) = _split(a), _split(b)
    acc = np.matmul(al, bh)
    acc = acc + np.matmul(ah, bl)
    return acc + np.matmul(ah, bh)


def _emulated_kernel(pcm16, cfg, split=True):
    from birdnet_go_tpu_torch.ops.pallas_melspec import group_consts

    wpk, twa, twb, fb2, j2 = kernel_consts(cfg.sample_rate, cfg.n_fft,
                                           cfg.n_mels, cfg.fmin, cfg.fmax)
    bg, fbg = group_consts(twa, twb, fb2)
    x = pcm16.astype(np.float32) * np.float32(1 / 32768)
    frames = tmel.frame_signal(torch.from_numpy(x), cfg).numpy()
    fw = (frames * tmel._window_fn(cfg)).reshape(*frames.shape[:-1], 16, 128)
    s = np.einsum("pa,...ab->...pb", wpk, fw).astype(np.float32)  # stage 1
    mel = np.zeros((*frames.shape[:-1], fbg.shape[-1]), np.float32)
    for g in range(8):
        if g == 0:
            a = np.concatenate([s[..., 0, :], s[..., 8, :]], axis=-1)
        else:                                 # k = 2·b + row
            a = np.stack([s[..., g, :], s[..., 8 + g, :]], axis=-1).reshape(
                *s.shape[:-2], 256)
        tot = 0.0
        for k0 in range(0, 256, 16):
            part = _mma3(a[..., k0:k0 + 8], bg[g, k0:k0 + 8], split)
            part = part + _mma3(a[..., k0 + 8:k0 + 16],
                                bg[g, k0 + 8:k0 + 16], split)
            tot = tot + part
        re_im = tot.reshape(*tot.shape[:-1], 2, 2, j2)       # [.., h, re/im, j]
        power = (re_im[..., 0, :] ** 2 + re_im[..., 1, :] ** 2).reshape(
            *tot.shape[:-1], 2 * j2)
        for k0 in range(0, 2 * j2, 8):
            mel = mel + _mma3(power[..., k0:k0 + 8], fbg[g, k0:k0 + 8],
                              split)
    return tmel.scale_mag(torch.from_numpy(mel[..., :cfg.n_mels]),
                          cfg).numpy()


def _loud_tones(n_rows, t_len, seed, rate=48000):
    """-10 dBFS tones over -26 dBFS noise, int16: their leakage into quiet
    bins cancels in the stage-2 sums, the hardest case for precision."""
    rng = np.random.default_rng(seed)
    t = np.arange(t_len, dtype=np.float32) / rate
    f = rng.uniform(200.0, 12000.0, (n_rows, 1)).astype(np.float32)
    x = 0.3 * np.sin(2 * np.pi * f * t) + rng.standard_normal(
        (n_rows, t_len), dtype=np.float32) * 0.05
    return (x * 32767).astype(np.int16)


@pytest.mark.parametrize("name,kw,pcm", [
    ("v24 loud tones", V24, lambda: _loud_tones(2, 48000, 2)),
    ("fullband loud tones", FULL, lambda: _loud_tones(2, 48000, 3)),
    ("v24 field level", V24, lambda: _pcm16((2, 48000), 0, 0.05 * 32767)),
    ("log", LOG, lambda: _pcm16((1, 48000), 1, 3000.0)),
])
def test_emulated_3xtf32_kernel_meets_the_card_gates(name, kw, pcm):
    pcm16 = pcm()
    cfg = tmel.MelConfig(**kw)
    got = _emulated_kernel(pcm16, cfg)
    ref = melspec_fused(torch.from_numpy(pcm16), cfg).numpy()
    assert got.shape == ref.shape
    if kw["mag_scale"] == "log":
        assert np.abs(got - ref).max() < 2e-4
    else:
        rel = np.abs(ref - got) / (np.abs(ref) + 1e-3)
        assert rel.max() < 1e-3, (name, rel.max())


def test_emulated_single_tf32_misses_the_gate():
    """Why the split: one TF32 pass over the same sums fails the gate on
    loud tones, which the 3xTF32 emulation passes."""
    pcm16 = _loud_tones(2, 48000, 2)
    cfg = tmel.MelConfig(**V24)
    ref = melspec_fused(torch.from_numpy(pcm16), cfg).numpy()
    got = _emulated_kernel(pcm16, cfg, split=False)
    rel = np.abs(ref - got) / (np.abs(ref) + 1e-3)
    assert rel.max() > 1e-3, rel.max()


@pytest.mark.parametrize("kw", [V24, FULL, LOG], ids=["v24", "full", "log"])
def test_twiddle_split_is_exact_and_tf32(kw):
    """The pre-split twiddles and filterbank the kernel reads: hi + lo gives
    back every value to float32 rounding, hi and lo have no bits below
    TF32's 10-bit mantissa, and the split is cvt.rna's (emulated here)."""
    from birdnet_go_tpu_torch.ops.pallas_melspec import (
        group_consts,
        tf32_split,
    )

    _, twa, twb, fb2, _ = kernel_consts(kw["sample_rate"], kw["n_fft"],
                                        kw["n_mels"], 0.0, kw["fmax"])
    bg, fbg = group_consts(twa, twb, fb2)
    for w in (bg, fbg):
        pair = tf32_split(w)
        assert pair.dtype == np.float32 and pair.shape == (*w.shape, 2)
        hi, lo = pair[..., 0], pair[..., 1]
        for a, b in zip((hi, lo), _split(w)):
            np.testing.assert_array_equal(a, b)
        assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
        assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
        err = np.abs((hi.astype(np.float64) + lo) - w)
        assert (err <= np.abs(w) * 2.0 ** -21 + 1e-30).all()


@pytest.mark.parametrize("kw", [V24, FULL, LOG], ids=["v24", "full", "log"])
def test_group_consts_hold_every_residue(kw):
    """bg and fbg are kernel_consts rearranged: each residue's twiddle pair
    and filterbank slab appears once, in the group and half the kernel
    reads it from, and nothing else is non-zero."""
    from birdnet_go_tpu_torch.ops.pallas_melspec import (
        group_consts,
        residue_groups,
    )

    wpk, twa, twb, fb2, j2 = kernel_consts(kw["sample_rate"], kw["n_fft"],
                                           kw["n_mels"], 0.0, kw["fmax"])
    bg, fbg = group_consts(twa, twb, fb2)
    assert bg.shape == (8, 256, 4 * j2)
    assert fbg.shape == (8, 2 * j2, -(-kw["n_mels"] // 8) * 8)
    groups = residue_groups()
    assert sorted(r for p in groups for r in p) == list(range(16))
    for g, (r1, r2) in enumerate(groups):
        for h, r in enumerate((r1, r2)):
            cols = bg[g, :, h * 2 * j2:(h + 1) * 2 * j2]
            rr = r if r <= 8 else 16 - r
            # group 0: rows 0..127 multiply packed row 0, 128..255 row 8;
            # else row 2·b multiplies packed row g, 2·b + 1 row 8 + g
            if g == 0:
                want = np.zeros_like(cols)
                want[h * 128:(h + 1) * 128] = twa[r]
            else:
                assert rr == g
                want = np.stack([twa[r], twb[r]], axis=1).reshape(256, -1)
            np.testing.assert_array_equal(cols, want)
            np.testing.assert_array_equal(
                fbg[g, h * j2:(h + 1) * j2, :kw["n_mels"]], fb2[r])
    assert not fbg[..., kw["n_mels"]:].any()


def test_plain_mel_in_float64_is_the_float32_path_more_precisely():
    """A float64 signal runs the same plain algorithm in float64 (the card
    holds the kernel to it): same shape, float64 out, within the float32
    gate of the float32 result."""
    pcm16 = _pcm16((2, 48000), 8, 0.05 * 32767)
    for kw in (V24, LOG):
        cfg = tmel.MelConfig(**kw)
        x = torch.from_numpy(pcm16.astype(np.float64) / 32768.0)
        m64 = tmel.melspec(x, cfg)
        m32 = tmel.melspec(x.float(), cfg)
        assert m64.dtype == torch.float64 and m32.dtype == torch.float32
        _assert_close("log" if kw is LOG else "v24", m32.numpy(),
                      m64.numpy())
