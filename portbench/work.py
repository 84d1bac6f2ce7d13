"""The yardstick: the operations and bytes a configuration's computation
needs, counted from its shapes whatever implements it, and the peaks of
one NVIDIA H100 SXM.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates at its 700 W
power limit (a card set to a lower limit runs slower under load; the
benchmark prints the card's ``power.limit`` beside every share).

Counts, per window:

- mel front end, in float32: the real FFT of each frame at 2.5·n·log2(n)
  operations (half the 5·n·log2(n) of a complex FFT), the window's n
  products, the power's 3 operations a bin, two a nonzero entry of the
  filterbank, and one a band for the scaling. Bytes: the int16 input read
  once and the mel rows written once in the served type.
- backbone: 2 operations a multiply-add of every convolution (in the
  configuration's ``compute_dtype``) and of every dense layer (in its
  ``dense_dtype``: the port multiplies the rounded operands in float32).
  Batch norm, activations, pooling and the squeeze-excite gate are
  elementwise and not counted, as model FLOPs go.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference import model as ref

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12, "fp8": 1979e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12            # HBM3, bytes/s
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def num_frames(mel: dict, clip: int) -> int:
    return (clip - mel["n_fft"]) // mel["hop"] + 1


def filterbank_nonzeros(mel: dict) -> int:
    fb = ref.mel_filterbank(mel["sample_rate"], mel["n_fft"], mel["n_mels"],
                            mel["fmin"], mel["fmax"])
    return int(np.count_nonzero(fb))


def mel_work(mel: dict, clip: int, out_dtype: str = "bfloat16"
             ) -> tuple[float, float]:
    """(float32 operations, bytes) of one window's mel features."""
    n = mel["n_fft"]
    bins = n // 2 + 1
    per_frame = (2.5 * n * math.log2(n) + n + 3 * bins
                 + 2 * filterbank_nonzeros(mel) + mel["n_mels"])
    frames = num_frames(mel, clip)
    nbytes = 2 * clip + DTYPE_BYTES[out_dtype] * frames * mel["n_mels"]
    return per_frame * frames, float(nbytes)


def backbone_work(net: dict, mel: dict, clip: int) -> dict[str, float]:
    """Operations of one window's backbone and head, by type."""
    h, w = num_frames(mel, clip), mel["n_mels"]

    def out(n, s):
        return -(-n // s)

    conv = 0.0
    h, w = out(h, 2), out(w, 2)
    conv += 2 * 9 * net["stem_channels"] * h * w
    dense = 0.0
    for b in ref.block_layout(net):
        if b["expand"] != 1:
            conv += 2 * b["cin"] * b["cmid"] * h * w
        h, w = out(h, b["stride"]), out(w, b["stride"])
        conv += 2 * b["k"] ** 2 * b["cmid"] * h * w
        dense += 2 * 2 * b["cmid"] * b["squeeze"]
        conv += 2 * b["cmid"] * b["cout"] * h * w
    conv += 2 * ref.block_layout(net)[-1]["cout"] * net["embedding_dim"] \
        * h * w
    dense += 2 * net["embedding_dim"] * net["num_classes"]
    out_ops: dict[str, float] = {}
    for dtype, n in ((net["compute_dtype"], conv),
                     (net["dense_dtype"], dense)):
        out_ops[dtype] = out_ops.get(dtype, 0.0) + n
    return out_ops


def peak_seconds(flops: dict[str, float]) -> float:
    """Seconds the card needs at its peaks for `flops` by type."""
    return sum(n / PEAK_FLOPS[t] for t, n in flops.items())


def bound_seconds(flops: dict[str, float], nbytes: float
                  ) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes"): the larger of the two."""
    ops_s, mem_s = peak_seconds(flops), nbytes / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= mem_s else (mem_s, "bytes")


def window_peak_seconds(cfg: dict) -> float:
    """Peak seconds of one window's whole step: mel and backbone."""
    clip = cfg["clip_samples"]
    mel_ops, _ = mel_work(cfg["mel"], clip)
    flops = backbone_work(cfg["net"], cfg["mel"], clip)
    flops["float32"] = flops.get("float32", 0.0) + mel_ops
    return peak_seconds(flops)
