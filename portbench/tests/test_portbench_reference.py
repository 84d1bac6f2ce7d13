"""The plain reference agrees with the port at a small width on the CPU,
and the yardstick's counts with hand counts."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import program, sources, weights, work
from portbench.reference import model as ref
from portbench.tests.tiny import TINY_NET

MEL = {"sample_rate": 48000, "n_fft": 2048, "hop": 512, "n_mels": 96,
       "fmin": 0.0, "fmax": 15000.0, "mag_scale": "nonlinear"}
CFG = {"family": "BirdNET_V2.4", "sample_rate": 48000,
       "clip_samples": 144000, "mel": MEL,
       "net": {**TINY_NET, "compute_dtype": "float32"},
       "serving": {"fused_blocks": False, "act_int8": False}}


def _pcm(n=3, seed=5):
    bank = sources.waveform_bank(seed, 4, 48000, torch.device("cpu"))
    return torch.from_numpy(np.stack([np.resize(bank[i % 4], 144000)
                                      for i in range(n)])).float() / 32768


def test_mel_features_equal_the_ports_plain_mel():
    from birdnet_go_tpu_torch.ops.melspec import melspec

    x = _pcm()
    got = ref.mel_features(x, MEL)
    want = melspec(x.double(), program.mel_config(MEL)).float()
    assert torch.allclose(got, want, rtol=2e-4, atol=1e-3 * want.max())


def test_confidences_equal_the_ports_float32_model():
    x = _pcm(4)
    p = weights.make(CFG["net"], MEL, 11, torch.device("cpu"), x)
    model = program.build_model(CFG, p)
    mask = sources.range_mask(3, 64, 0.5, torch.device("cpu"))
    with torch.inference_mode():
        port = torch.sigmoid(model.apply(x)["logits"]) * mask
        port16 = torch.sigmoid(model.apply_int16(
            torch.round(x * 32768).to(torch.int16))["logits"]) * mask
    mine = ref.confidences(x, p, CFG, mask)
    assert float((port - mine).abs().max()) < 2e-4
    assert float((port16 - mine).abs().max()) < 2e-4
    # the batch norm statistics came out near unit scale: logits spread
    assert 1.0 < float(torch.logit(mine[mine > 0].clamp(1e-6, 1 - 1e-6))
                       .std()) < 4.0


def test_resample_equals_the_ports_polyphase_resampler():
    from birdnet_go_tpu_torch.ops.resample import (
        ResampleConfig,
        polyphase_resample,
    )

    x = torch.from_numpy(sources.field_recording(
        0.5, 44100, 9, torch.device("cpu")))
    for a, b in ((44100, 48000), (48000, 32000)):
        want = polyphase_resample(x, ResampleConfig(a, b))
        got = ref.resample(x, a, b)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) < 1e-5


def test_int8_control_differs_where_float32_does_not():
    x = _pcm(2)
    p = weights.make(CFG["net"], MEL, 11, torch.device("cpu"), x)
    c32 = ref.confidences(x, p, CFG, None)
    c8 = ref.confidences(x, p, CFG, None, precision="int8")
    assert float((c32 - c8).abs().max()) > 1e-2


def test_work_counts_by_hand():
    mel = {**MEL, "n_fft": 8, "hop": 4, "n_mels": 2, "sample_rate": 16,
           "fmin": 0.0, "fmax": 8.0}
    nnz = work.filterbank_nonzeros(mel)
    ops, nbytes = work.mel_work(mel, 16, out_dtype="float32")
    frames = (16 - 8) // 4 + 1                         # 3
    per = 2.5 * 8 * 3 + 8 + 3 * 5 + 2 * nnz + 2
    assert frames == 3 and ops == per * frames
    assert nbytes == 2 * 16 + 4 * frames * 2
    net = {"blocks": [[1, 4, 3, 1, 1]], "stem_channels": 2,
           "embedding_dim": 8, "num_classes": 5, "se_ratio": 0.25,
           "compute_dtype": "bfloat16", "dense_dtype": "float32"}
    # mel 3 frames x 2 bands → stem stride 2: 2 x 1
    flops = work.backbone_work(net, mel, 16)
    h, w = 2, 1
    conv = (2 * 9 * 2 * h * w            # stem, 1 input channel
            + 2 * 9 * 2 * h * w          # depthwise 3x3 over 2 channels
            + 2 * 2 * 4 * h * w          # project 2 → 4
            + 2 * 4 * 8 * h * w)         # head 1x1 4 → 8
    dense = 2 * 2 * 2 * 1 + 2 * 8 * 5    # SE 2 → 1 → 2, classifier
    assert flops == {"bfloat16": conv, "float32": dense}
    assert math.isclose(work.peak_seconds(flops),
                        conv / 989e12 + dense / 67e12)
    assert work.bound_seconds({"float32": 67e12}, 3.35e12 * 2) == (
        2.0, "bytes")
