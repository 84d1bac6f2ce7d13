"""Card-only tests of the port: the CUDA mel and MBConv kernels against
their plain versions, the wrappers' checks, the torch batcher's CUDA
events, the offline path's resampling and analyzer against the CPU, and an
imported graph (the v2.4 replica of ``diag/replicas.py``) on the card:
float32 under TF32 defaults, its constants read where they lie, and
through ``TorchClassifier``; the training step: ``train --tiny``'s
float32 step on the card against the CPU, and no kernel launched by a
train step; and int8 and meshes: ``int_mm`` exact at the shapes
``_int_mm`` refuses, the depthwise float route equal to int32 tap sums,
the ``act_int8`` step against the CPU, and ``ShardedClassifier`` on meshes
that list the card more than once; the soak on the card, its aux planes
(spectrogram index and sound levels against the CPU, a kitchen-sink leg)
and its RTSP leg; the realtime app serving on the card, with MQTT and
MySQL on against the loopback fakes; and a crash leg
on the card (its victim SIGKILLed, recovered, restarted), with the crash
leg and ``support`` refusing or naming no device with the card hidden.

Every test needs a CUDA card and skips without one. The file imports no
JAX, so it also runs where JAX is missing:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances of the mel kernel are those of the TPU kernel's parity tests
(``tests/test_pallas_melspec.py``), against its plain version computed in
float64; bf16 output adds one bf16 step. The
MBConv kernels see the same rounded operands as their plain versions and
sum in another order (cuBLAS blocks its sums; the kernels sum in sequence,
over up to 1,152 terms): float32 output within 1e-4 · (|ref| + 0.1), bf16
output within one bf16 step, the pool within 1e-4 · (|ref| + S · 1e-3).
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    BlockSpec,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.models.layers import MBConv
from birdnet_go_tpu_torch.ops import pallas_mbconv as M
from birdnet_go_tpu_torch.ops.melspec import MelConfig, melspec
from birdnet_go_tpu_torch.ops.pallas_melspec import melspec_fused
from birdnet_go_tpu_torch.ops.pcm import pcm16_to_float32
from birdnet_go_tpu_torch.scheduler.loop import TorchModelBatcher

pytestmark = pytest.mark.cuda

V24 = dict(sample_rate=48000, n_fft=2048, hop=512, n_mels=96, fmax=15000.0,
           mag_scale="nonlinear")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _plain64(x, cfg):
    """The mel kernel's plain version in float64: its reference here. The
    float32 plain path is itself up to 2.6e-4 off it on log configs."""
    return melspec(pcm16_to_float32(x).double(), cfg)


def _pcm(shape, seed, amp=0.05 * 32767):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * amp).astype(
        np.int16))


@pytest.mark.parametrize("kw,shape", [
    (V24, (3, 144000)),
    (dict(V24, fmax=24000.0), (2, 48000)),
    (dict(V24, hop=1024, mag_scale="db"), (2, 50001)),
    (dict(V24, window="hamming", mag_scale="linear"), (1, 2048)),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dev, kw, shape, out_dtype):
    cfg = MelConfig(**kw)
    x = _pcm(shape, 0).to(dev)
    before = melspec_fused.launches
    got = melspec_fused(x, cfg, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert melspec_fused.launches == before + 1
    ref = _plain64(x, cfg)
    assert got.shape == ref.shape and got.dtype == out_dtype
    tol = 1e-3 + (2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0)
    if kw["mag_scale"] in ("db",):
        # log-domain output: an absolute bound, as for the log config
        err = (got.float() - ref).abs().max().item()
        assert err < 2e-4 + (2.0 ** -7 * ref.abs().max().item()
                             if out_dtype == torch.bfloat16 else 0.0)
    else:
        rel = ((got.float() - ref).abs() / (ref.abs() + 1e-3)).max().item()
        assert rel < tol, rel


def _assert_mel_gate(got, ref, mag_scale, out_dtype):
    """f32: rel < 1e-3 (log and db: abs < 2e-4); bf16 adds one bf16 step."""
    ref = ref.double()
    bf16 = out_dtype == torch.bfloat16
    if mag_scale in ("log", "db"):
        err = (got.float() - ref).abs().max().item()
        assert err < 2e-4 + (2.0 ** -7 * ref.abs().max().item()
                             if bf16 else 0.0), err
    else:
        rel = ((got.float() - ref).abs() / (ref.abs() + 1e-3)).max().item()
        assert rel < 1e-3 + (2.0 ** -7 if bf16 else 0.0), rel


# 97 frames at hop 512: three 32-frame tiles and one ragged frame
RAGGED = 2048 + 96 * 512


@pytest.mark.parametrize("mag", ["linear", "log", "db", "nonlinear"])
@pytest.mark.parametrize("fmax", [15000.0, 24000.0], ids=["j2_40", "j2_64"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_tiles_and_scales(dev, mag, fmax, out_dtype):
    cfg = MelConfig(**dict(V24, fmax=fmax, mag_scale=mag))
    x = _pcm((2, RAGGED), 5).to(dev)
    before = melspec_fused.launches
    got = melspec_fused(x, cfg, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert melspec_fused.launches == before + 1
    assert got.shape == (2, 97, 96) and got.dtype == out_dtype
    _assert_mel_gate(got, _plain64(x, cfg), mag, out_dtype)


@pytest.mark.parametrize("shape", [(1, 48000), (1, RAGGED), (257, 48000)],
                         ids=["b1_90_frames", "b1_97_frames", "b257"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_ragged_tiles_and_batch_edges(dev, shape, out_dtype):
    cfg = MelConfig(**V24)
    x = _pcm(shape, 6).to(dev)
    before = melspec_fused.launches
    got = melspec_fused(x, cfg, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert melspec_fused.launches == before + 1
    assert got.shape == (shape[0], cfg.num_frames(shape[1]), 96)
    _assert_mel_gate(got, _plain64(x, cfg), "nonlinear",
                     out_dtype)


def test_kernel_odd_mel_count_and_refusal(dev):
    x = _pcm((2, 48000), 7).to(dev)
    cfg = MelConfig(**dict(V24, n_mels=37))
    _assert_mel_gate(melspec_fused(x, cfg), _plain64(x, cfg),
                     "nonlinear", torch.float32)
    # J2 = 40 runs 10 warps of at most 3 mel tiles each: 240 bands
    wide = MelConfig(**dict(V24, n_mels=240))
    _assert_mel_gate(melspec_fused(x, wide), _plain64(x, wide),
                     "nonlinear", torch.float32)
    before = melspec_fused.launches
    with pytest.raises(RuntimeError, match="melspec_fused"):
        melspec_fused(x, MelConfig(**dict(V24, n_mels=248)))
    assert melspec_fused.launches == before


def test_kernel_log_config_atol(dev):
    cfg = MelConfig(sample_rate=48000, n_fft=2048, hop=512, n_mels=64,
                    fmax=12000.0, mag_scale="log")
    x = _pcm((1, 48000), 1, 3000.0).to(dev)
    got = melspec_fused(x, cfg)
    ref = _plain64(x, cfg)
    assert (got - ref).abs().max().item() < 2e-4


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg = MelConfig(**V24)
    x = _pcm((2, 48000), 2).to(dev)
    for bad in (x.float(), x[:, ::2], x[0], x[:, :1000]):
        with pytest.raises(ValueError):
            melspec_fused(bad, cfg)
    with pytest.raises(ValueError):
        melspec_fused(x, cfg, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        melspec_fused(x, MelConfig(hop=500))


def test_batcher_events_and_step_on_card(dev):
    net = EfficientNetConfig(blocks=(BlockSpec(1, 16, 3, 1, 1),
                                     BlockSpec(6, 24, 3, 2, 1)),
                             stem_channels=16, embedding_dim=32,
                             num_classes=50)
    spec = dataclasses.replace(registry.BIRDNET_V24, clip_seconds=1.0,
                               num_species=50)

    def make():
        m = MelCnnModel(50, MelConfig(**V24), net, torch.float32)
        m.spec = spec
        return m.init(torch.Generator().manual_seed(0))

    cpu_b = TorchModelBatcher(TorchClassifier(make(), "cpu"), max_batch=4)
    gpu_b = TorchModelBatcher(TorchClassifier(make(), dev), max_batch=4)
    pcm = _pcm((4, 48000), 3).numpy()
    gpu_b._staged[:] = pcm
    cpu_b._staged[:] = pcm
    h = gpu_b._launch(gpu_b._staged, 4)
    assert h[2] is not None
    v, i, cv = gpu_b._collect(h, None)
    assert gpu_b._ready(h) is True and cv is None
    want_v, want_i, _ = cpu_b._collect(cpu_b._launch(cpu_b._staged, 4),
                                       None)
    np.testing.assert_allclose(v, want_v, atol=1e-4)
    assert i.dtype == np.int32


def test_kernel_matches_plain_on_loud_tones(dev):
    """-10 dBFS tones: their leakage into quiet bins cancels in the
    float32 stage-2 sums, the hardest case for the kernel's accuracy."""
    rng = np.random.default_rng(2)
    t = np.arange(144000, dtype=np.float32) / 48000.0
    f = rng.uniform(200.0, 12000.0, (64, 1)).astype(np.float32)
    x = 0.3 * np.sin(2 * np.pi * f * t) + rng.standard_normal(
        (64, 144000), dtype=np.float32) * 0.05
    pcm = torch.from_numpy((x * 32767).astype(np.int16)).to(dev)
    for kw in (V24, dict(V24, fmax=24000.0)):
        cfg = MelConfig(**kw)
        got = melspec_fused(pcm, cfg)
        ref = _plain64(pcm, cfg)
        rel = ((got - ref).abs() / (ref.abs() + 1e-3)).max().item()
        assert rel < 1e-3, rel


# (C, Cm, k, H, W, C'): Cm == C means no expand, C' == C a residual
MBCONV_SHAPES = [
    (24, 144, 3, 23, 3, 24),       # ragged S = 69, W = 3, odd H
    (20, 100, 5, 9, 8, 28),        # the last 48-channel tile holds 4
    (192, 1152, 5, 22, 3, 192),    # stage-6-like, at a longer input
    (16, 16, 3, 31, 16, 16),       # no expand, residual
    (32, 32, 3, 139, 48, 16),      # v2.4 block 0: several bands per image
    (112, 672, 5, 16, 8, 112),     # v3.0's largest block
    (24, 120, 5, 12, 10, 16),      # 48-channel tiles, the last holds 24; C' 16
    (16, 16, 3, 124, 64, 16),      # v3.0's expand-less 16 -> 16 block
]
BF16, F32 = torch.bfloat16, torch.float32


def _mbconv_inputs(shape, dev, x_dt, seed=0):
    c, cm, k, h, w, c2 = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=g, device=dev) * scale

    def bn(n):
        return (0.5 + torch.rand((1, n), generator=g, device=dev),
                0.2 * randn(1, n))

    a = [randn(2, h * w, c).to(x_dt),
         randn(c, cm, scale=c ** -0.5) if cm != c else None, *bn(cm),
         randn(k * k, cm, scale=1.0 / k), *bn(cm)]
    b = [randn(2, h * w, cm).to(x_dt), torch.rand((2, cm), generator=g,
                                                  device=dev),
         randn(cm, c2, scale=cm ** -0.5), *bn(c2),
         randn(2, h * w, c2).to(x_dt) if c2 == c else None]
    return a, b


def _assert_mbconv_close(ref, got, dt):
    ref, got = ref.float(), got.float()
    d = (ref - got).abs()
    if dt == BF16:
        assert (d / (ref.abs() + 1e-3)).max().item() < 2.0 ** -7 + 1e-3
    else:
        assert (d / (ref.abs() + 0.1)).max().item() < 1e-4


@pytest.mark.parametrize("x_dt,out_dt,dot_dt", [
    (BF16, BF16, BF16), (F32, F32, F32), (BF16, F32, F32), (F32, BF16, BF16),
])
@pytest.mark.parametrize("shape", MBCONV_SHAPES)
def test_mbconv_kernels_match_plain(dev, shape, x_dt, out_dt, dot_dt):
    _, _, k, h, w, _ = shape
    a, b = _mbconv_inputs(shape, dev, x_dt)
    kw = dict(height=h, width=w, kernel=k, out_dtype=out_dt, dot_dtype=dot_dt)
    before = (M.expand_dw_pool.launches, M.scale_project.launches)
    y, pool = M.expand_dw_pool(*a, **kw)
    out = M.scale_project(*b, out_dtype=out_dt, dot_dtype=dot_dt)
    torch.cuda.synchronize()
    assert (M.expand_dw_pool.launches, M.scale_project.launches) == (
        before[0] + 1, before[1] + 1)
    y_ref, pool_ref = M.expand_dw_pool_plain(*a, **kw)
    assert y.dtype == out.dtype == out_dt and y.shape == y_ref.shape
    _assert_mbconv_close(y_ref, y, out_dt)
    _assert_mbconv_close(M.scale_project_plain(
        *b, out_dtype=out_dt, dot_dtype=dot_dt), out, out_dt)
    err = (pool - pool_ref).abs() / (pool_ref.abs() + h * w * 1e-3)
    assert err.max().item() < 1e-4


@pytest.mark.parametrize("shape", [MBCONV_SHAPES[0], MBCONV_SHAPES[4]])
def test_mbconv_pool_is_deterministic(dev, shape):
    _, _, k, h, w, _ = shape
    a, _ = _mbconv_inputs(shape, dev, BF16, seed=1)
    kw = dict(height=h, width=w, kernel=k)
    y1, p1 = M.expand_dw_pool(*a, **kw)
    y2, p2 = M.expand_dw_pool(*a, **kw)
    assert torch.equal(p1, p2) and torch.equal(y1, y2)


def test_mbconv_glue_on_card_matches_cpu(dev):
    blk = MBConv(24, 24, 5, 6)
    blk.init(torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(blk).to(dev)
    x = torch.randn((2, 24, 17, 12), generator=torch.Generator().manual_seed(
        1)).contiguous(memory_format=torch.channels_last)
    for dt in (F32, BF16):
        want = M.mbconv_fused(blk, x.to(dt), kernel=5, compute_dtype=dt)
        got = M.mbconv_fused(on_card, x.to(dev, dt), kernel=5,
                             compute_dtype=dt)
        assert got.is_contiguous(memory_format=torch.channels_last)
        scale = max(1.0, want.float().abs().max().item())
        assert (got.cpu().float() - want.float()).abs().max().item() < (
            2.0 ** -7 + 1e-3) * scale


def test_mbconv_band_rows_at_the_models_shapes(dev):
    """Kernel A's band choice (csrc/mbconv.cu) at B = 256: only the
    expand-less blocks of the models' fused steps are cut into bands, each
    of at least 16 rows and none empty; on 132 SMs (H100 SXM) the 124- and
    139-row images take bands of 42 and 47 rows."""
    from birdnet_go_tpu_torch.diag.mbconv_cases import (
        FAMILIES,
        fused_block_shapes,
    )

    lib = M._build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for cls in FAMILIES:
        for (c, cm, _, h, _, _), _ in fused_block_shapes(cls):
            rows = lib.expand_dw_pool_band_rows(256, h, cm, int(cm != c))
            n_bands = -(-h // rows)
            assert (n_bands > 1) == (cm == c), (cls.spec.model_id, h, cm)
            assert rows >= 16 and (n_bands - 1) * rows < h
            if sms == 132 and cm == c:
                assert rows == {124: 42, 139: 47}[h]


def test_mbconv_wrappers_reject_what_the_kernels_do_not_take(dev):
    shape = MBCONV_SHAPES[0]
    _, _, k, h, w, _ = shape
    (x, *ca), (y, *cb) = _mbconv_inputs(shape, dev, BF16)
    kw = dict(height=h, width=w, kernel=k)
    nchw = x.view(2, h, w, -1).permute(0, 3, 1, 2).contiguous()
    for bad in (nchw.permute(0, 2, 3, 1).view(2, h * w, -1),
                x.to(torch.float16), x.transpose(0, 1)):
        with pytest.raises(ValueError):
            M.expand_dw_pool(bad, *ca, **kw)
    with pytest.raises(ValueError):
        M.expand_dw_pool(x, *ca, **kw, dot_dtype=torch.float16)
    with pytest.raises(ValueError):
        M.expand_dw_pool(x, *(t.cpu() for t in ca), **kw)
    with pytest.raises(ValueError):
        M.expand_dw_pool(x, *ca, **dict(kw, kernel=7))
    for bad in (y.transpose(1, 2).contiguous().transpose(1, 2),
                y.to(torch.float16)):
        with pytest.raises(ValueError):
            M.scale_project(bad, *cb)
    with pytest.raises(ValueError):
        M.scale_project(y, cb[0].to(BF16), *cb[1:])
    # rows too wide for kernel A's shared memory: at C 192 -> Cm 1152, k5,
    # bf16 operands, passes of 2 rows, a ring of 6 slots and a zero row of
    # (W rounded up to 4) + 4 columns of 56 floats, 768 bytes of pool sums,
    # two bf16 staging buffers of 2·W positions (rounded up to 16) × 200
    # channels and 12 k16 steps × 1,536 bytes of B fragments take 228,224
    # bytes at W = 64 and 247,296 at W = 65, over the 232,448 a block may
    # have: the launcher takes the first and refuses the second
    for width, fits in ((64, True), (65, False)):
        (x, *ca), _ = _mbconv_inputs((192, 1152, 5, 3, width, 192), dev, BF16)
        before = M.expand_dw_pool.launches
        if fits:
            M.expand_dw_pool(x, *ca, height=3, width=width, kernel=5)
            assert M.expand_dw_pool.launches == before + 1
            continue
        with pytest.raises(RuntimeError, match="invalid argument"):
            M.expand_dw_pool(x, *ca, height=3, width=width, kernel=5)
        assert M.expand_dw_pool.launches == before


# -- pinned, asynchronous H2D and the raw-rate step ----------------------------

def _narrow_model(cls=MelCnnModel, n_classes=50, **kw):
    net = EfficientNetConfig(blocks=(BlockSpec(1, 16, 3, 1, 1),
                                     BlockSpec(6, 24, 3, 2, 1)),
                             stem_channels=16, embedding_dim=32,
                             num_classes=n_classes)
    if cls is MelCnnModel:
        m = MelCnnModel(n_classes, MelConfig(**V24), net, torch.float32)
        m.spec = dataclasses.replace(registry.BIRDNET_V24, clip_seconds=1.0,
                                     num_species=n_classes)
    else:
        m = cls(n_classes, MelConfig(**V24), torch.float32, net=net)
        m.spec = dataclasses.replace(m.spec, clip_seconds=1.0)
    return m.init(torch.Generator().manual_seed(0))


def test_staging_buffers_are_pinned(dev):
    b = TorchModelBatcher(TorchClassifier(_narrow_model(), dev), max_batch=4,
                          pipeline_depth=2)
    assert len(b._host_bufs) == len(b._staged_bufs) == 3
    for host, view in zip(b._host_bufs, b._staged_bufs):
        assert host.is_pinned() and host.dtype == torch.int16
        assert view.ctypes.data == host.data_ptr()
    assert b._staged is b._staged_bufs[0]


def test_async_copies_at_depth_2_equal_sync_copies(dev):
    """A loop at depth 2 with the asynchronous copy returns, per window,
    what the same batcher returns with a synchronous copy: the staging
    buffers are not rewritten while a copy from them is in flight."""

    def run(sync):
        b = TorchModelBatcher(TorchClassifier(_narrow_model(), dev),
                              max_batch=8, top_k=5, pipeline_depth=2)
        if sync:
            def to_device(staged):
                x = torch.from_numpy(staged.copy()).to(dev)
                torch.cuda.synchronize()
                return x
            b._to_device = to_device
        out = {}
        b.on_result = lambda w, v, i: out.__setitem__(
            (w.source_id, w.start_time), (v.copy(), i.copy()))
        rng = np.random.default_rng(9)
        for tick in range(12):
            block = (rng.standard_normal((20, 48000)) * 2000).astype(np.int16)
            sids = [f"s{j}" for j in range(20)]
            pos = 0
            while pos < 20:
                pos += b.offer_block(block[pos:], sids[pos:],
                                     [float(tick)] * (20 - pos))
                b.dispatch()
        b.harvest_all()
        return out, b.stats.batches_dispatched

    (want, n_sync), (got, n_async) = run(True), run(False)
    assert n_sync == n_async == 36 and len(got) == len(want) == 240
    for key, (v, i) in want.items():
        np.testing.assert_allclose(got[key][0], v, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[key][1], i)


def test_bat_step_cv_on_card_matches_cpu(dev):
    """The raw-rate step on the card: top-k against the CPU's, and the
    per-window ultrasonic CV (cuFFT) against the CPU's (pocketfft) within
    rtol 1e-4 on bursty input, whose CVs are far from 0."""
    from birdnet_go_tpu_torch.models.bat import BatClassifier

    rng = np.random.default_rng(3)
    t = np.arange(48000) / 256000.0
    gate = np.sin(2 * np.pi * rng.uniform(10, 80, (6, 1)) * t) > 0.6
    x = 0.3 * gate * np.sin(2 * np.pi * 40000.0 * t) + 0.02 * \
        rng.standard_normal((6, 48000))
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    out = []
    for where in ("cpu", dev):
        b = TorchModelBatcher(TorchClassifier(_narrow_model(BatClassifier,
                                                            24), where),
                              max_batch=8, top_k=5)
        got = []
        b.on_batch = lambda meta, v, i, cv: got.append((v, i, cv))
        assert b.offer_block(pcm, [f"b{j}" for j in range(6)],
                             [0.0] * 6) == 6
        b.dispatch()
        b.harvest_all()
        out.append(got[0])
    (v0, i0, cv0), (v1, i1, cv1) = out
    assert cv1.shape == (6,) and np.isfinite(cv1).all() and cv0.min() > 0.1
    np.testing.assert_allclose(cv1, cv0, rtol=1e-4)
    np.testing.assert_allclose(v1, v0, atol=1e-4)


def test_resample_on_card_keeps_float32_under_tf32_defaults(dev):
    """The resampler turns cuDNN's TF32 off for its convolution: with
    PyTorch's default (TF32 allowed) the card stays within 1e-6 of the
    peak of the CPU's result at 44.1 → 48 kHz and 48 → 32 kHz."""
    from birdnet_go_tpu_torch.ops.resample import (
        ResampleConfig,
        polyphase_resample,
    )

    rng = np.random.default_rng(4)
    for rate, out_rate in ((44100, 48000), (48000, 32000)):
        x = torch.from_numpy((rng.standard_normal((2, rate * 4)) * 0.3
                              ).astype(np.float32))
        cfg = ResampleConfig(rate, out_rate)
        want = polyphase_resample(x, cfg)
        torch.backends.cudnn.allow_tf32 = True
        try:
            got = polyphase_resample(x.to(dev), cfg)
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = False
        assert got.shape == want.shape and got.device.type == "cuda"
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), (rate, err)


def test_offline_analyzer_on_card_matches_cpu(dev):
    """Device windows, the device-tensor input of ``predict_topk`` and the
    analyzer's results on the card against the CPU's, float32."""
    from birdnet_go_tpu_torch.analysis.offline import (
        OfflineAnalyzer,
        OfflineConfig,
    )
    from birdnet_go_tpu_torch.taxonomy.labels import synthetic_labels

    cpu = _narrow_model()
    card = copy.deepcopy(cpu)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(44100 * 7) * 0.1).astype(np.float32)
    cfg = OfflineConfig(threshold=0.0, overlap=1.5, batch_size=4)
    an = [OfflineAnalyzer(TorchClassifier(m, where), synthetic_labels(50),
                          cfg) for m, where in ((cpu, "cpu"), (card, dev))]
    wc, wg = (a._device_windows(x, 44100, 24000) for a in an)
    assert wg.device.type == "cuda" and wg.shape == wc.shape == (13, 48000)
    torch.testing.assert_close(wg.cpu(), wc, rtol=0, atol=1e-6)
    v_np, i_np = an[1].classifier.predict_topk(wc[:4].numpy())
    v_t, i_t = an[1].classifier.predict_topk(wg[:4])
    np.testing.assert_allclose(v_t, v_np, atol=1e-6)
    want, got = (a.analyze_samples(x, 44100) for a in an)
    assert [w.begin_seconds for w in got.windows] == \
        [w.begin_seconds for w in want.windows]
    np.testing.assert_allclose([w.confidences for w in got.windows],
                               [w.confidences for w in want.windows],
                               atol=1e-4)


@functools.lru_cache(maxsize=2)
def _v24_replica(batch: int) -> bytes:
    from birdnet_go_tpu_torch.diag import replicas

    return replicas.v24_tflite(np.random.default_rng(424), batch=batch)


def _replica_inputs() -> np.ndarray:
    from birdnet_go_tpu_torch.diag import replicas

    rng = np.random.default_rng(3)
    return np.stack([replicas.two_tones(), (rng.standard_normal(144000)
                                            * 0.05).astype(np.float32)])


def test_imported_graph_on_card_keeps_float32_under_tf32(dev):
    """The v2.4 replica (convolutions, depthwise, dense) on the card with
    TF32 allowed for cuDNN and cuBLAS: within 1e-5 of the logits' scale of
    the CPU's float64 run and of its float32 run (TF32 operands would put
    it near 3e-4; the CPU's float32 is 1.1e-7 off float64)."""
    from birdnet_go_tpu_torch.inference.tflite_import import load_tflite

    x = _replica_inputs()
    ref = load_tflite(_v24_replica(2)).double()(x.astype(np.float64))[0]
    cpu = load_tflite(_v24_replica(2))(x)[0]
    g = load_tflite(_v24_replica(2)).to(dev)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = g(torch.from_numpy(x).to(dev))[0]
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    assert got.device.type == "cuda" and got.dtype == torch.float32
    scale = float(ref.abs().max())
    got = got.cpu().double()
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert float((got - cpu.double()).abs().max()) <= 1e-5 * scale


def test_imported_graph_reads_its_buffers_where_they_lie(dev):
    """After ``.to(cuda)`` a forward on a device input copies nothing from
    the host: no HtoD copy in its profile, the buffers where they were."""
    from birdnet_go_tpu_torch.inference.tflite_import import load_tflite

    g = load_tflite(_v24_replica(2)).to(dev)
    assert all(b.device.type == "cuda" for b in g.buffers())
    ptrs = {k: v.data_ptr() for k, v in g.named_buffers()}
    x = torch.from_numpy(_replica_inputs()).to(dev)
    g(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = g(x)[0]
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("conv" in n.lower() for n in names), names[:20]
    assert not [n for n in names if "HtoD" in n], names
    assert out.device.type == "cuda"
    assert {k: v.data_ptr() for k, v in g.named_buffers()} == ptrs


def test_imported_model_through_classifier_on_card(dev):
    """``ImportedModel`` through ``TorchClassifier.predict_topk`` on the
    card against the CPU: top-10 confidences within 1e-5, the same
    indices where the values are apart."""
    from birdnet_go_tpu_torch.inference.loader import ImportedModel
    from birdnet_go_tpu_torch.inference.tflite_import import load_tflite

    x = _replica_inputs()
    clf = [TorchClassifier(ImportedModel(load_tflite(_v24_replica(2)),
                                         "BirdNET_V2.4"), where)
           for where in ("cpu", dev)]
    assert clf[1].num_species == 6522
    (vc, ic), (vg, ig) = (c.predict_topk(x) for c in clf)
    np.testing.assert_allclose(vg, vc, rtol=0, atol=1e-5)
    apart = np.abs(np.diff(vc, axis=1)) > 1e-5
    np.testing.assert_array_equal(ig[:, :-1][apart], ic[:, :-1][apart])


# -- training ------------------------------------------------------------------

def _tone_batch(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(144000) / 48000.0
    cls = np.arange(n) % 3
    f = np.asarray([700.0, 2500.0, 6000.0])[cls][:, None]
    pcm = (0.05 * np.sin(2 * np.pi * f * t)
           + 0.01 * rng.standard_normal((n, 144000))).astype(np.float32)
    return torch.from_numpy(pcm), torch.from_numpy(
        np.eye(3, dtype=np.float32)[cls])


def test_tiny_float32_train_step_on_card_matches_cpu(dev):
    """``train --tiny``'s float32 model, three AdamW steps from the same
    weights on the card and the CPU under ``full_float32``: losses within
    1e-5, parameters within 1e-4 of the largest magnitude."""
    from birdnet_go_tpu_torch.cli.main import _tiny_v24
    from birdnet_go_tpu_torch.ops.precision import full_float32
    from birdnet_go_tpu_torch.train.trainer import (
        init_train_state,
        make_train_step,
    )

    cpu = _tiny_v24(3).init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    states = [init_train_state(m, 3e-3) for m in (cpu, card)]
    steps = [make_train_step(m.apply, train=False) for m in (cpu, card)]
    with full_float32():
        for i in range(3):
            pcm, labels = _tone_batch(4, i)
            _, mc = steps[0](states[0], pcm, labels)
            _, mk = steps[1](states[1], pcm.to(dev), labels.to(dev))
            np.testing.assert_allclose(float(mk["loss"]), float(mc["loss"]),
                                       rtol=1e-5)
    want = cpu.state_dict()
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in card.state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_train_step_launches_no_kernel(dev, train):
    """A train step takes float32 PCM through the plain mel and unfused
    blocks (with batch statistics the fused gate refuses even a model
    that asks for fused blocks): none of the three kernels launches."""
    from birdnet_go_tpu_torch.train.trainer import (
        init_train_state,
        make_train_step,
    )

    model = _narrow_model(n_classes=3).to(dev)
    model.fused_blocks = train
    state = init_train_state(model, 1e-3)
    step = make_train_step(model.apply, train=train)
    kernels = (melspec_fused, M.expand_dw_pool, M.scale_project)
    for k in kernels:
        k.launches = 0
    pcm, labels = _tone_batch(4, 0)
    _, m = step(state, pcm[:, :48000].to(dev), labels.to(dev))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert [k.launches for k in kernels] == [0, 0, 0]


# -- int8: _int_mm, the depthwise float route, act_int8, meshes ---------------

@pytest.mark.parametrize("m,k,n", [(8, 1280, 6522), (256, 1280, 14795),
                                   (5, 20, 3), (4096, 16, 96),
                                   (4096, 96, 24)])
def test_int_mm_on_card_is_exact(dev, m, k, n):
    """``int_mm`` on the card (padding what ``_int_mm`` refuses) equals the
    int64 product exactly."""
    from birdnet_go_tpu_torch.ops.quant import int_mm

    rng = np.random.default_rng(m + n)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    got = int_mm(torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev))
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("c,h,w,k,stride", [(96, 139, 48, 3, 2),
                                            (240, 35, 12, 5, 1),
                                            (672, 18, 6, 5, 2)])
def test_depthwise_float_route_exact_on_card(dev, c, h, w, k, stride):
    """The int8 depthwise sums as a float32 cuDNN convolution of int8 values
    equal int32 tap sums over TF-SAME padding, at v2.4 shapes, codes at
    ±127 included."""
    from birdnet_go_tpu_torch.models.layers import same_pad
    from birdnet_go_tpu_torch.ops import quant as Q

    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.integers(-127, 128, (16, h, w, c),
                                      dtype=np.int8))
    x[0] = 127
    layer = Q.QConv(c, c, k, stride, depthwise=True)
    layer.w_q.copy_(torch.from_numpy(rng.integers(-127, 128, (c, 1, k, k),
                                                  dtype=np.int8)))
    got = Q._acc_i8(x.to(dev), copy.deepcopy(layer).to(dev))
    assert got.dtype == torch.int32
    xp = same_pad(x.permute(0, 3, 1, 2).to(torch.int32), k, stride)
    ho, wo = got.shape[1:3]
    want = torch.zeros((16, c, ho, wo), dtype=torch.int32)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, :, dy:dy + stride * ho:stride,
                     dx:dx + stride * wo:stride]
            want += tap * layer.w_q[:, 0, dy, dx].to(torch.int32)[:, None,
                                                                  None]
    assert torch.equal(got.cpu(), want.permute(0, 2, 3, 1))


def test_act_int8_step_on_card_matches_cpu(dev):
    """The narrow float32 model's int16 step with the boundary: card (mel
    kernel) against CPU (plain mel); codes may differ where the two mel
    paths put a value on either side of a half step."""
    cpu = _narrow_model()
    cpu.act_int8 = True
    card = copy.deepcopy(cpu).to(dev)
    pcm = _pcm((4, 48000), 3)
    with torch.inference_mode():
        want = cpu.apply_int16(pcm)["logits"]
        got = card.apply_int16(pcm.to(dev))["logits"].cpu()
        plain = card.apply(pcm16_to_float32(pcm).to(dev))["logits"].cpu()
    assert torch.isfinite(got).all()
    dconf = float((torch.sigmoid(got) - torch.sigmoid(want)).abs().max())
    assert dconf < 0.02, dconf
    assert float((torch.sigmoid(got) - torch.sigmoid(plain)).abs().max()
                 ) < 0.02


@pytest.mark.parametrize("d,m", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_classifier_on_repeated_card(dev, d, m):
    """Meshes that list the card d·m times serve what ``TorchClassifier``
    serves, a ragged batch included."""
    from birdnet_go_tpu_torch.parallel import ShardedClassifier, make_mesh

    model = _narrow_model()
    single = TorchClassifier(copy.deepcopy(model), dev)
    sharded = ShardedClassifier(model, mesh=make_mesh(
        d * m, d, m, devices=[dev] * (d * m)))
    assert sharded.device == dev
    pcm = pcm16_to_float32(_pcm((7, 48000), 4)).numpy()
    v1, i1 = single.predict_topk(pcm, k=5)
    v2, i2 = sharded.predict_topk(pcm, k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_boundary_on_card_equals_cpu(dev, dtype):
    """The act_int8 boundary on one input, card against CPU: equal codes
    and equal dequantised values, half steps and clipping included; a
    channels_last input stays channels_last."""
    from birdnet_go_tpu_torch.models.efficientnet import (
        int8_boundary,
        quantize_boundary,
    )

    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((4, 24, 35, 12)).astype(
        np.float32) * 4.0)
    h.view(-1)[:260] = torch.arange(-130, 130) * (8.0 / 127.0) + 4.0 / 127.0
    h = h.to(dtype).contiguous(memory_format=torch.channels_last)
    q = quantize_boundary(h.to(dev), dtype)
    assert q.dtype == torch.int8
    assert q.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(q.cpu(), quantize_boundary(h, dtype))
    assert torch.equal(int8_boundary(h.to(dev), dtype).cpu(),
                       int8_boundary(h, dtype))


def test_soak_on_card_launches_the_mel_kernel_once_a_batch(dev, tmp_path):
    """A short ``run_soak(device="cuda")``: full-width v2.4 on the card,
    64 streams; no sample lost, no window dropped, the mel kernel launched
    once for every batch dispatched, and the card named in the record."""
    from birdnet_go_tpu_torch.scheduler.soak import run_soak

    rec = run_soak(streams=64, seconds=6.0, device="cuda",
                   db_path=str(tmp_path / "soak.db"), sample_seconds=2.0)
    da, cal = rec["drop_accounting"], rec["calibration"]
    assert da["farm_samples_lost"] == da["scheduler_windows_dropped"] == 0
    assert rec["windows_processed"] > 0
    assert cal["mel_kernel_launches"] == cal["batches_dispatched"] > 0
    assert cal["mode"] == "device step (cuda)" and "H100" in cal["card"]


def test_rtsp_soak_on_card_serves_its_sessions(dev, tmp_path):
    """A short ``run_soak(device="cuda", ingest="rtsp")``: 64 realtime L16
    sessions from the load server through the native demux into
    full-width v2.4 on the card; every session connected at the end, none
    restarted, nothing dropped by the server or the rings, every sample
    sent received but one 50 ms packet a session in flight (the counters
    are read at one instant), the mel kernel once a
    batch."""
    from birdnet_go_tpu_torch.scheduler.soak import run_soak

    rec = run_soak(streams=64, seconds=6.0, device="cuda", ingest="rtsp",
                   db_path=str(tmp_path / "soak.db"), sample_seconds=2.0)
    ing, da, cal = rec["ingest"], rec["drop_accounting"], rec["calibration"]
    assert ing["connected_at_end"] == 64 and ing["session_restarts"] == 0
    assert ing["samples_dropped_by_server"] == 0
    assert ing["samples_received"] >= ing["samples_sent"] - 0.05 * 48000 * 64
    assert da["farm_samples_lost"] == da["scheduler_windows_dropped"] == 0
    assert rec["windows_processed"] > 0
    assert cal["mel_kernel_launches"] == cal["batches_dispatched"] > 0


def test_soak_cli_refuses_without_a_card(monkeypatch, capsys, tmp_path):
    """Without a card, ``soak`` (cuda by default) exits 1 and names
    ``--device cpu``; ``run_soak(device="cuda")`` raises. Runs on the CPU
    too: the card is hidden."""
    from birdnet_go_tpu_torch.cli import main as tcli
    from birdnet_go_tpu_torch.scheduler import soak

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(soak, "run_soak", lambda **kw: called.append(kw))
    for argv in (["soak"], ["soak", "--device", "cuda", "--streams", "8"]):
        assert tcli.main(argv) == 1
        assert "pass --device cpu" in capsys.readouterr().err
    assert called == []
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        soak.run_soak(streams=4, seconds=1.0, device="cuda",
                      db_path=str(tmp_path / "x.db"))


def test_aux_planes_on_card_match_cpu(dev, tmp_path):
    """The aux planes' device work on the card against the CPU: a bird
    and a bat spectrogram's colour index within 1 level at no more than
    1e-3 of the pixels, a sound-level pass within 0.05 dB; then a short
    ``run_soak(device="cuda", kitchen_sink=True)`` whose aux planes run
    on the card with no error."""
    from birdnet_go_tpu_torch.analysis.spectrogram import (
        FrequencyProfile,
        spectrogram_index,
    )
    from birdnet_go_tpu_torch.ops.soundlevel import (
        SoundLevelConfig,
        band_levels_db,
    )
    from birdnet_go_tpu_torch.scheduler.soak import run_soak

    rng = np.random.default_rng(0)
    for rate, seconds, profile in ((48000, 3.0, FrequencyProfile.bird()),
                                   (256000, 1.0, FrequencyProfile.bat())):
        t = np.arange(int(rate * seconds)) / rate
        x = (0.3 * np.sin(2 * np.pi * 2500 * t)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        for width in (400, 800):
            got = spectrogram_index(x, rate, width, profile=profile,
                                    device=dev)
            want = spectrogram_index(x, rate, width, profile=profile,
                                     device="cpu")
            gap = np.abs(got.astype(int) - want)
            assert gap.max() <= 1 and (gap > 0).mean() <= 1e-3
    x = torch.from_numpy(rng.standard_normal(480000).astype(np.float32)
                         * 0.1)
    cfg = SoundLevelConfig()
    got = band_levels_db(x.to(dev), cfg)[0].cpu()
    assert (got - band_levels_db(x, cfg)[0]).abs().max() <= 0.05

    rec = run_soak(streams=64, seconds=6.0, device="cuda", kitchen_sink=True,
                   db_path=str(tmp_path / "soak.db"), sample_seconds=2.0)
    aux = rec["aux_planes"]
    assert aux["aux_errors"] == 0 and aux["spectrograms_rendered"] > 0
    assert aux["soundlevel_blocks"] > 0 and aux["hls_segments"] > 0
    assert aux["migration"]["state"] == "migrating"
    cal = rec["calibration"]
    assert cal["mel_kernel_launches"] == cal["batches_dispatched"] > 0


def test_app_serves_on_card(dev, tmp_path):
    """The realtime app on the card: the full-width v2.4 (seeded weights)
    at batch 64 over four tone sources for 6 s. Every window the loop
    offered is served, none dropped and no overrun, the mel kernel launched
    once for each batch and the warm-up, and ``stop()`` returns within
    15 s."""
    import time

    from birdnet_go_tpu_torch.app import Application
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings

    s = Settings()
    s.models = [ModelSettings(model_id="BirdNET_V2.4")]
    s.database.path = str(tmp_path / "app.db")
    s.export.path = str(tmp_path / "clips")
    s.webserver.enabled = s.imageprovider.enabled = False
    s.realtime.max_batch = 64
    s.realtime.sources = [{"type": "tone", "id": f"t{k}",
                           "freq": 1000.0 + 700.0 * k} for k in range(4)]
    app = Application(s)
    app.setup()
    melspec_fused.launches = 0
    app.start()
    time.sleep(6.0)
    t0 = time.monotonic()
    app.stop()
    assert time.monotonic() - t0 < 15.0
    st = app.device_loop.batchers["BirdNET_V2.4"].stats
    assert st.windows_processed > 0 and st.overruns == 0
    assert app.device_loop.windows_dropped == 0
    assert melspec_fused.launches == st.batches_dispatched + 1


def test_app_with_mqtt_and_mysql_on_card(dev, tmp_path):
    """The realtime app on the card with MQTT and MySQL on, against the
    fake services of ``diag/fake_services.py`` in this process: the
    full-width v2.4 at batch 64 over four tone sources for 8 s, every
    approval saved to MySQL once (the server's rows) and published on the
    topic once (the broker's subscriber), the Home Assistant configs
    retained, the mel kernel launched once a batch and a warm-up, and
    ``stop()`` within 15 s."""
    import time

    from birdnet_go_tpu_torch.app import Application
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
    from birdnet_go_tpu_torch.diag.fake_services import Services
    from birdnet_go_tpu_torch.integrations.mqtt import ha_discovery_payloads

    services = Services(tmp_path / "services").start()
    ports = services.ports()
    try:
        s = Settings()
        s.models = [ModelSettings(model_id="BirdNET_V2.4", threshold=0.0)]
        s.database.type, s.database.host = "mysql", "127.0.0.1"
        s.database.port, s.database.name = ports["mysql"], ""
        s.database.user = ports["mysql_user"]
        s.database.password = ports["mysql_password"]
        s.mqtt.enabled, s.mqtt.host, s.mqtt.port = True, "127.0.0.1", \
            ports["mqtt"]
        s.mqtt.topic = ports["topic"]
        s.export.enabled = False
        s.webserver.enabled = s.imageprovider.enabled = False
        s.realtime.interval_seconds = 0.0
        s.realtime.max_batch = 64
        s.realtime.sources = [{"type": "tone", "id": f"t{k}",
                               "freq": 1000.0 + 700.0 * k}
                              for k in range(4)]
        app = Application(s)
        app.setup()
        approved = []
        on_approved = app.processor.on_approved
        app.processor.on_approved = lambda d, item: (
            approved.append(d), on_approved(d, item))[1]
        melspec_fused.launches = 0
        app.start()
        time.sleep(8.0)
        t0 = time.monotonic()
        app.stop()
        assert time.monotonic() - t0 < 15.0
        st = app.device_loop.batchers["BirdNET_V2.4"].stats
        assert st.windows_processed > 0 and st.overruns == 0
        assert melspec_fused.launches == st.batches_dispatched + 1
        time.sleep(0.5)
        rows = [i for i, _ in services.mysql.committed]
        dets = [t for t, _, _ in services.received
                if t == f"{ports['topic']}/detections"]
        assert len(approved) == len(rows) == len(dets) > 0
        assert sorted(services.broker.retained) == sorted(
            ha_discovery_payloads(ports["topic"]))
    finally:
        services.stop()


def test_crash_leg_on_card(dev, tmp_path):
    """A short crash leg on the card: a durable ``soak --device cuda`` of
    2,000 streams SIGKILLed after 20 rows and 1 threshold, recovered
    twice, then a 15 s restart leg on the card in the recovered database.
    The record passes, no process of the victim's is left, and the
    restart leg launched the mel kernel once a batch. (The restart leg
    calibrates anew, three passes of 1,024 windows, before it approves
    anything: 6 s of 500 streams offer too few windows.)"""
    from birdnet_go_tpu_torch.scheduler.crashleg import run_crash_leg

    rec = run_crash_leg(streams=2000, kill_min_rows=20, restart_seconds=15.0,
                        workdir=str(tmp_path), device="cuda")
    r = rec["restart"]
    assert rec["pass"], rec
    assert not rec["victim"]["group_alive_after_kill"]
    assert r["exact_count_equation_holds"] and r["detections_persisted"] > 0
    assert r["mel_kernel_launches"] == r["batches_dispatched"] > 0
    assert "H100" in rec["card"]


def test_crash_leg_and_support_without_a_card(monkeypatch, tmp_path,
                                              capsys):
    """With the card hidden ``crashleg --device cuda`` (the default)
    raises before it starts a victim, and ``support`` writes a bundle
    whose ``system.json`` names no device and says why. Runs on the CPU
    too: the card is hidden."""
    import io
    import json
    import tarfile

    from birdnet_go_tpu_torch.cli import main as tcli
    from birdnet_go_tpu_torch.scheduler import crashleg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = tmp_path / "work"
    for argv in ([], ["--device", "cuda", "--workdir", str(work)]):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            crashleg.main(argv)
    assert not work.exists()                 # no victim was started
    assert tcli.main(["support", "--output", str(tmp_path)]) == 0
    assert "support bundle written" in capsys.readouterr().out
    (bundle,) = tmp_path.glob("support-bundle-*.tar.gz")
    with tarfile.open(fileobj=io.BytesIO(bundle.read_bytes())) as tar:
        sysinfo = json.loads(tar.extractfile("system.json").read())
    assert sysinfo["devices"] == []
    assert "no CUDA card" in sysinfo["devices_error"]
