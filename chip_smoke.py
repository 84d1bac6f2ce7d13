#!/usr/bin/env python3
"""Drive the PyTorch port's realtime device step on one CUDA card: BirdNET
v2.4 (EfficientNet-B0), and BirdNET v3.0 and Perch v2 (B1) through the fused
MBConv kernels; then its offline analysis and CLI, imported .tflite and
.onnx artifacts, and custom-classifier training with the model gallery.

    python3 chip_smoke.py

Phases, in order; any failure propagates and exits non-zero:
1. the device: fails at once without a CUDA card; prints the card, its
   power limit and the toolchain;
2. the build: compiles ``birdnet_go_tpu_torch/csrc/*.cu`` for sm_90a into
   ``build/torch_kernels/``;
3. the mel kernel against its plain PyTorch version computed in float64 on
   the card (the float32 plain path's own error is printed beside it), at
   the main path's shape [256, 144000], at v3.0's and Perch v2's configs at
   [256, 160000], and on the other configs the JAX kernel's tests use, with
   CUDA-event times of both, the library yardstick's (``mel_library``:
   cuFFT, |X|², a float32 product) at B = 256, and the bound from the
   kernel's work (``melspec_fused_work``);
4. the fused MBConv kernels A (``expand_dw_pool``) and B
   (``scale_project``) against their plain versions at B = 256 at each
   distinct fused block shape of the v2.4, v3.0 and Perch v2 steps (read
   off the models, ``diag/mbconv_cases``) and one float32 case, then in
   float32 at every shape; each timed in two ways (``diag/timing``): per
   call by CUDA events, as the mel kernel (``kernel_ms``, ``plain_ms``: at
   most of these shapes the wrapper's host work is longer than the kernel,
   so this measures the host), and by replaying a CUDA graph of 10 calls
   between events (``device_ms``, ``plain_device_ms``: the device time);
5. the full-width BirdNET v2.4 step (B0, 6,522 classes, bf16, random
   weights from a seed) through the mel kernel, checked finite and compared
   with the plain mel on field-level audio, in bf16 and again with the same
   weights in float32; then float32 on the card against the CPU; then the
   same step with fused blocks against the CPU's plain fused path, in
   float32 and bf16; then one full-width fused step each of v3.0 and
   Perch v2, held against the CPU's plain fused path in bf16, and the
   fused and unfused step times of the three models;
6. the server's device loop: ``DeviceLoop.run_tick`` over a few hundred
   ``AnalysisBuffer`` streams into one ``TorchModelBatcher``, with every
   window's top-10 checked and the kernel's launches counted; once for
   v2.4 (48 kHz), and once for v3.0 with fused blocks (32 kHz), where the
   MBConv kernels must run 13 times per batch;
7. the v2.4 loop fed by the native stream farm (``native.StreamFarm``,
   built from ``native/*.cpp`` into ``build/torch_native/`` in phase 2):
   2,048 streams pack their windows straight into the batcher's pinned
   staging buffers; every window's top-10 checked, none dropped, the mel
   kernel launched once a batch; at 4x real time the loop must serve
   3,200 windows/s, at 2x it must lose no sample; then the copy of one
   staging buffer to the card, pinned and asynchronous against pageable;
8. the BattyBirdNET step at full width (256 kHz capture) against the CPU's
   plain path on the same weights, its ultrasonic CV against the CPU's, a
   bat loop whose windows all carry a finite CV, and one BSG Finland step;
9. the Geomodel range filter at full width on the card against the CPU,
   over a 2-degree lat/lon grid, and its mask on the served v2.4 step;
10. offline analysis and the CLI on the card, on field-level WAVs written
   under ``build/offline_smoke/``: ``python -m birdnet_go_tpu_torch
   analyze`` in its own process (PyTorch's default TF32 settings) on 10
   minutes of 44.1 kHz mono for v2.4 (resampled 160/147, 200 rows), the
   CLI in this process on 10 minutes of 48 kHz stereo for v3.0 at overlap
   1.5 (resampled to 32 kHz, 239 rows), the resampled signal, top-10s and
   sound levels on the card against the CPU, a warm v2.4 analysis of the
   whole file, and the CLI's ``benchmark`` and ``rangefilter`` (card
   against ``--device cpu``); none of the three kernels runs here, as in
   the JAX package, whose offline path takes float32 PCM through the
   plain mel;
11. imported artifacts, the full-scale replicas of ``diag/replicas.py``
   written under ``build/import_smoke/`` (seeded weights, the graphs whose
   outputs ``tests/golden/`` records): the BirdNET v2.4 TFLite replica
   (its mel front end in the graph) at batch 1 on the JAX test's two
   tones, loaded by ``load_model(..., checkpoint=...)``; the Perch v2-scale
   ONNX at batch 1 and through ``TorchClassifier.predict_topk`` at batch
   256; the float16 MData range filter. Each meets its golden and the
   CPU's run (with cuDNN and cuBLAS allowed TF32, which the executors turn
   off; the error without that guard printed beside it). Then the v2.4
   replica built at batch 16, installed as ``BirdNET_V2.4/model.tflite``
   under a ``BIRDNET_TPU_MODELS`` of its own and served by the loop
   (``phase_loop``); then ``verify-artifact`` twice (recorded, match),
   ``verify-artifact --audit`` and ``analyze --checkpoint --batch-size 1``,
   each in a process of its own. None of the three kernels launches: an
   imported graph runs its own front end as plain torch ops;
12. training, under ``build/train_smoke/``: ``python -m
   birdnet_go_tpu_torch train`` at full v2.4 width (B0, bf16, batch 16) in
   its own process on a directory of three tone classes over noise at
   field level (one file at 44.1 kHz, resampled), whose loss must fall;
   its checkpoint served by ``load_model(..., checkpoint=...)`` on the
   card and held to held-out tones of each class; the full-width step
   (forward, backward, AdamW) timed at batch 16 and 64 with its peak
   memory; the float32 ``--tiny`` step on the card against the CPU from
   the same weights; and ``model install --from-file`` of the v2.4
   replica, ``model list`` and ``model remove`` in processes of their own,
   with the JAX command's lines. None of the three kernels launches: the
   training path takes float32 PCM through the plain mel and unfused
   blocks, as in the JAX package.

Every kernel line carries its bound (``ops/roofline.py``: the larger of its
bytes over the memory rate and its operations over the peak for their type)
and its share of it. The last lines are one JSON object for the kernels (the
MBConv kernels' times, bounds and errors summed over the fused blocks of one
v3.0 step, whose loop counts their launches; ``ms`` and ``plain_ms`` per
call for every kernel, and for the MBConv kernels also ``device_ms`` and
``plain_device_ms`` by graph replay), the card's ``name, power.limit`` line
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from birdnet_go_tpu_torch import native
from birdnet_go_tpu_torch.analysis.offline import (
    OfflineAnalyzer,
    OfflineConfig,
)
from birdnet_go_tpu_torch.analysis.raven import format_csv, format_raven_table
from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer
from birdnet_go_tpu_torch.audio.wav import read_wav
from birdnet_go_tpu_torch.cli import main as cli
from birdnet_go_tpu_torch.diag import replicas
from birdnet_go_tpu_torch.diag.mbconv_cases import (
    ARGS_A,
    ARGS_B,
    BATCH,
    FAMILIES,
    fused_block_shapes,
    mbconv_inputs,
    packed_kwargs,
)
from birdnet_go_tpu_torch.diag.timing import (
    REPS,
    event_ms,
    graph_ms_pair,
    median_ms_pair,
    timed_pair,
)
from birdnet_go_tpu_torch.inference.backend import (
    TorchClassifier,
    TorchRangeFilter,
    range_mask,
)
from birdnet_go_tpu_torch.inference import onnx_import, tflite_import
from birdnet_go_tpu_torch.inference.loader import ImportedModel, load_model
from birdnet_go_tpu_torch.inference.opaudit import audit_table
from birdnet_go_tpu_torch.models import efficientnet
from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.bsg import BSGFinland
from birdnet_go_tpu_torch.models.catalog import catalog_entries
from birdnet_go_tpu_torch.models.geomodel import Geomodel
from birdnet_go_tpu_torch.models.perch_v2 import PerchV2
from birdnet_go_tpu_torch.ops import _build
from birdnet_go_tpu_torch.ops.melspec import (
    MelConfig,
    _mel_filterbank_np,
    _window_fn,
    melspec,
    scale_mag,
)
from birdnet_go_tpu_torch.ops.pallas_mbconv import (
    expand_dw_pool,
    expand_dw_pool_plain,
    expand_dw_pool_work,
    scale_project,
    scale_project_plain,
    scale_project_work,
)
from birdnet_go_tpu_torch.ops.pallas_melspec import (
    melspec_fused,
    melspec_fused_plain,
    melspec_fused_work,
)
from birdnet_go_tpu_torch.ops.pcm import pcm16_to_float32
from birdnet_go_tpu_torch.ops.precision import full_float32
from birdnet_go_tpu_torch.ops.postprocess import (
    sigmoid_confidence,
    top_k_results,
)
from birdnet_go_tpu_torch.ops.resample import (
    ResampleConfig,
    polyphase_resample,
)
from birdnet_go_tpu_torch.ops.roofline import bound_ms
from birdnet_go_tpu_torch.ops.soundlevel import (
    SoundLevelConfig,
    band_levels_db,
)
from birdnet_go_tpu_torch.ops.ultrasonic import ultrasonic_frame_cv
from birdnet_go_tpu_torch.ops.windows import slice_overlapped_windows
from birdnet_go_tpu_torch.scheduler.loop import DeviceLoop, TorchModelBatcher
from birdnet_go_tpu_torch.taxonomy.labels import load_labels
from birdnet_go_tpu_torch.train.trainer import (
    init_train_state,
    make_train_step,
)
from birdnet_go_tpu_torch.utils.tracing import GLOBAL_SPANS

REPO = Path(__file__).resolve().parent
SEED = 0
CLIP = 144000                # 3 s at 48 kHz
CLIP32 = 160000              # 5 s at 32 kHz (v3.0, Perch v2)
V24 = dict(sample_rate=48000, n_fft=2048, hop=512, n_mels=96, fmax=15000.0,
           mag_scale="nonlinear")
V3 = dict(sample_rate=32000, n_fft=2048, hop=640, n_mels=128, fmax=15000.0,
          mag_scale="nonlinear")
PERCH = dict(sample_rate=32000, n_fft=2048, hop=640, n_mels=160, fmin=60.0,
             fmax=10000.0, mag_scale="log")
N_STREAMS = 640
N_TICKS = 8
V3_STREAMS = 512
V3_TICKS = 4
V3_FUSED = 13                # fused blocks of the full-width B1 step
# the farm-fed loop: 2,048 streams at 4x real time offer 5,461 windows/s;
# their rings hold 10 s of stream time (2.5 s of wall time), 1.97 GB. The
# loop must serve FARM_FLOOR of them, samples lost or not: on H100 hosts
# it served 4,061 to 5,161, losing none where its thread packed and
# dispatched a batch in 38 to 42 ms, and 5 to 15% of the samples where
# that took 49 to 56 ms. At 2x (2,731 offered, under two thirds of the
# least it served) it must lose nothing, every window once and one hop
# apart.
FARM_STREAMS = 2048
FARM_TIMESCALE = 4.0
FARM_FLOOR = 3200.0
FARM_KEEP_UP = 2.0
FARM_RING_SECONDS = 10.0
FARM_SECONDS = 8.0
BAT_STREAMS = 256
BAT_TICKS = 4
GRID_STEP = 2.0              # degrees of the range filter's lat/lon grid
OFFLINE_SECONDS = 600        # the offline phase's recordings: 10 minutes
OFFLINE_CPU_SECONDS = 60     # ... of which the card-vs-CPU check takes
LEVEL_WINDOWS = 256          # sound levels: 3 s windows at a 1.5 s hop
# float32 step with fused blocks on bf16 operands, card vs CPU: how many of
# its 2 x 6,522 logits may differ by 1e-3 of their scale or more
BF16_OPERAND_OUTLIERS = 130

def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def pcm_batch(shape: tuple[int, int], seed: int, tone: float = 0.05,
              noise: float = 0.01, rate: int = 48000) -> np.ndarray:
    """One tone (200 Hz to 12 kHz) plus white noise per row, int16 at
    `rate`.

    The default levels (a -26 dBFS tone over -40 dBFS noise) are those of
    field recordings. Louder input drives the random-weight network into a
    regime where a 1e-5 relative change of the mel moves post-sigmoid
    outputs by up to 1.0 (measured on the card, float32), so the loud
    levels feed only the kernel-vs-plain comparison.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(shape[1], dtype=np.float32) / rate
    f = rng.uniform(200.0, 12000.0, (shape[0], 1)).astype(np.float32)
    x = tone * np.sin(2 * np.pi * f * t)
    x += rng.standard_normal(shape, dtype=np.float32) * noise
    return (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)


def mel_library(pcm: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """The mel kernel's yardstick, never called by the port: torch.stft
    (cuFFT, the window, center=False) → |X|² → a float32 product with the
    natural-order filterbank → the magnitude scale, all in float32."""
    dev = pcm.device
    x = pcm.float() * (1.0 / 32768.0)
    spec = torch.stft(x, cfg.n_fft, hop_length=cfg.hop,
                      window=torch.from_numpy(_window_fn(cfg)).to(dev),
                      center=False, return_complex=True)
    power = spec.real.square() + spec.imag.square()        # [B, bins, F]
    fb = torch.from_numpy(_mel_filterbank_np(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(dev)
    return scale_mag(torch.matmul(power.transpose(1, 2), fb), cfg)


def plain64(pcm: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """The mel kernel's plain version computed in float64 (same constants):
    the reference its gates hold it to. The float32 plain path is itself
    up to 2.6e-4 off it at Perch's log config (a quiet band whose stage-2
    terms cancel), more than the log gate."""
    return melspec(pcm16_to_float32(pcm).double(), cfg)


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    return float(((ref - got).abs() / (ref.abs() + 1e-3)).max())


def phase_device(card: str) -> None:
    print(f"device: {torch.cuda.get_device_name(0)}  "
          f"count={torch.cuda.device_count()}")
    print(f"card: {card}")
    driver = _run(["nvidia-smi", "--query-gpu=driver_version",
                   "--format=csv,noheader"]).splitlines()[0]
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    print(f"toolchain: torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" nvcc {nvcc}, driver {driver}")


def phase_build() -> None:
    """The CUDA kernels (one nvcc per source, in parallel) and, beside
    them, the native host library (make and g++ on ``native/*.cpp``)."""
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build_native)
        _build.load()
        print(f"build: {_build.library_path().name} built (if absent) and "
              f"loaded in {time.monotonic() - t0:.2f} s")
        path = host.result()
    print(f"build: {path.relative_to(path.parents[2])} built (if absent) "
          f"in {time.monotonic() - t0:.2f} s")
    for line in _build.build_log().read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")


def phase_kernel(dev: torch.device, card: str) -> dict:
    """Kernel vs plain; returns the main path's (bf16 v24) numbers."""
    pcm = torch.from_numpy(pcm_batch((BATCH, CLIP), SEED)).to(dev)
    # -10 dBFS tones: their leakage into quiet bins is the hardest case
    # for the float32 sums
    loud = torch.from_numpy(pcm_batch((BATCH, CLIP), SEED + 2, tone=0.3,
                                      noise=0.05)).to(dev)
    full = dict(V24, fmax=24000.0)
    log = dict(sample_rate=48000, n_fft=2048, hop=512, n_mels=64,
               fmax=12000.0, mag_scale="log")
    short = torch.from_numpy(pcm_batch((1, 48000), SEED + 1)).to(dev)
    pcm32 = torch.from_numpy(pcm_batch((BATCH, CLIP32), SEED + 4,
                                       rate=32000)).to(dev)
    cases = [("v24 f32", V24, pcm, torch.float32),
             ("v24 f32 loud tones", V24, loud, torch.float32),
             ("fullband f32 loud tones", full, loud, torch.float32),
             ("log n_mels64 [1,48000]", log, short, torch.float32),
             ("v3.0 f32", V3, pcm32, torch.float32),
             ("v3.0 bf16", V3, pcm32, torch.bfloat16),
             ("perch f32", PERCH, pcm32, torch.float32),
             ("perch bf16", PERCH, pcm32, torch.bfloat16),
             ("v24 bf16 (main path)", V24, pcm, torch.bfloat16)]
    main = {}
    for name, kw, x, dt in cases:
        cfg = MelConfig(**kw)
        got = melspec_fused(x, cfg, out_dtype=dt)
        ref = plain64(x, cfg)
        ref32 = melspec_fused_plain(x, cfg)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dt, name
        assert torch.isfinite(got.float()).all(), name
        abs_err = float((ref - got.double()).abs().max())
        rel = rel_err(ref, got)
        # the float32 plain path against the same float64 reference
        plain_err = float((ref - ref32.double()).abs().max()) \
            if kw["mag_scale"] == "log" else rel_err(ref, ref32)
        if kw["mag_scale"] == "log" and dt == torch.bfloat16:
            # log output: the f32 bound plus one bf16 step of the largest
            # magnitude
            lim = 2e-4 + 2.0 ** -7 * float(ref.abs().max())
            ok, tol = abs_err < lim, f"abs < {lim:.3e}"
        elif kw["mag_scale"] == "log":
            ok, tol = abs_err < 2e-4, "abs < 2e-4"
        elif dt == torch.bfloat16:
            # one bf16 step (2^-7 relative) on top of the f32 tolerance
            ok, tol = rel < 2.0 ** -7 + 1e-3, "rel < 2^-7 + 1e-3"
        else:
            ok, tol = rel < 1e-3, "rel < 1e-3"
        plain_ms, ms = median_ms_pair(
            lambda: melspec_fused_plain(x, cfg, out_dtype=dt),
            lambda: melspec_fused(x, cfg, out_dtype=dt))
        bound, by = bound_ms(*melspec_fused_work(*x.shape, cfg, dt))
        extra = ""
        if x.shape[0] == BATCH:
            # the library yardstick, against the same kernel once more
            lib = mel_library(x, cfg)
            lib_err = rel_err(ref, lib) if kw["mag_scale"] != "log" else \
                float((ref - lib.double()).abs().max())
            library_ms, ms2 = median_ms_pair(
                lambda: mel_library(x, cfg),
                lambda: melspec_fused(x, cfg, out_dtype=dt))
            extra = (f" library_ms={library_ms:.4f} (kernel {ms2:.4f} in "
                     f"turns; library err {lib_err:.3e})")
        print(f"kernel {name} {tuple(x.shape)}: against the float64 plain "
              f"path max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} ({tol})"
              f", float32 plain path {plain_err:.3e}; kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}{extra} bound_ms={bound:.4f} "
              f"({by}) share={bound / ms:.3f} [{card}]")
        assert ok, f"melspec kernel disagrees with plain ({name})"
        if name == "v24 bf16 (main path)":
            main = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, library_ms=library_ms)
    return main


def _mbconv_err(ref: torch.Tensor, got: torch.Tensor, dt: torch.dtype
                ) -> tuple[float, float, float]:
    """(max |Δ|, the normalised error, its limit): one bf16 step for bf16;
    1e-4 · (|ref| + 0.1) for float32, whose sums cuBLAS takes in another
    order than the kernels."""
    ref, got = ref.float(), got.float()
    d = (ref - got).abs()
    if dt == torch.bfloat16:
        return float(d.max()), float((d / (ref.abs() + 1e-3)).max()), \
            2.0 ** -7 + 1e-3
    return float(d.max()), float((d / (ref.abs() + 0.1)).max()), 1e-4


def phase_mbconv(dev: torch.device, card: str) -> dict:
    """Kernels A and B vs their plain versions at every distinct fused
    block shape of the three models. Returns, per model and kernel, the
    largest bf16 error and the times summed over the fused blocks of one
    step."""
    cases = []
    for cls in FAMILIES:
        model_id = cls.spec.model_id
        shapes = fused_block_shapes(cls)
        cases += [(model_id, shape, n, torch.bfloat16)
                  for shape, n in shapes]
        if cls is BirdNETv24:
            f32_shape = shapes[2][0]          # (40, 240, k5, 35x12)
    cases.append(("BirdNET_V2.4 f32 and f32 dot", f32_shape, 0,
                  torch.float32))
    out = {cls.spec.model_id: {
        name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0,
                   plain_device_ms=0.0, library_ms=None, flops={},
                   nbytes=0.0, blocks=0)
        for name in ("expand_dw_pool", "scale_project")}
        for cls in FAMILIES}
    for seed, (label, shape, n_blocks, dt) in enumerate(cases):
        c, cm, k, h, w, c2 = shape
        a, b = mbconv_inputs(shape, SEED + seed, dev, dt)
        kw = dict(height=h, width=w, kernel=k, out_dtype=dt, dot_dtype=dt)
        args_a, args_b = [a[n] for n in ARGS_A], [b[n] for n in ARGS_B]
        # the kernels are timed with their weights packed once, as the glue
        # passes them; these first calls pack on the call
        pk_a, pk_b = packed_kwargs(a, b)
        y, pool = expand_dw_pool(*args_a, **kw)
        y_ref, pool_ref = expand_dw_pool_plain(*args_a, **kw)
        o = scale_project(*args_b, out_dtype=dt, dot_dtype=dt)
        o_ref = scale_project_plain(*args_b, out_dtype=dt, dot_dtype=dt)
        torch.cuda.synchronize()
        assert y.shape == y_ref.shape and y.dtype == dt and o.dtype == dt
        pool_err = (pool - pool_ref).abs()
        pool_rel = float((pool_err / (pool_ref.abs() + h * w * 1e-3)).max())
        if seed == 0:
            # the pool is summed in a fixed order: a second run is equal
            assert torch.equal(pool, expand_dw_pool(*args_a, **kw)[1]), \
                "kernel A's pool differs between two runs"
        kinds = (("expand_dw_pool", _mbconv_err(y_ref, y, dt),
                  lambda: expand_dw_pool_plain(*args_a, **kw),
                  lambda: expand_dw_pool(*args_a, **kw, **pk_a)),
                 ("scale_project", _mbconv_err(o_ref, o, dt),
                  lambda: scale_project_plain(*args_b, out_dtype=dt,
                                              dot_dtype=dt),
                  lambda: scale_project(*args_b, out_dtype=dt,
                                        dot_dtype=dt, **pk_b)))
        work = {"expand_dw_pool": expand_dw_pool_work(
                    BATCH, h, w, c, cm, k, expand=cm != c, x_dtype=dt,
                    out_dtype=dt, dot_dtype=dt),
                "scale_project": scale_project_work(
                    BATCH, h * w, cm, c2, residual=c2 == c, y_dtype=dt,
                    out_dtype=dt, dot_dtype=dt)}
        for name, (abs_err, err, lim), plain, kern in kinds:
            # per call, the wrapper's host work included (the kernels
            # line's ms, as for the mel kernel), and by graph replay
            plain_ms, ms = median_ms_pair(plain, kern)
            plain_dev, dev_ms = graph_ms_pair(plain, kern)
            bound, by = bound_ms(*work[name])
            extra = (f", pool {pool_rel:.3e} (< 1e-4)"
                     if name == "expand_dw_pool" else "")
            print(f"mbconv {name} {label} x{n_blocks} {dt} (C {c}, Cm {cm}, "
                  f"k{k}, {h}x{w}, C' {c2}) [{BATCH}]: max_abs_err="
                  f"{abs_err:.3e} err={err:.3e} (< {lim:.3e}){extra} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} device_ms="
                  f"{dev_ms:.4f} plain_device_ms={plain_dev:.4f} bound_ms="
                  f"{bound:.4f} ({by}) share={bound / ms:.3f} device_share="
                  f"{bound / dev_ms:.3f} [{card}]")
            assert err < lim, f"{name} disagrees with plain ({label})"
            if n_blocks:
                r = out[label][name]
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
                r["ms"] += n_blocks * ms
                r["plain_ms"] += n_blocks * plain_ms
                r["device_ms"] += n_blocks * dev_ms
                r["plain_device_ms"] += n_blocks * plain_dev
                flops, nbytes = work[name]
                for t, v in flops.items():
                    r["flops"][t] = r["flops"].get(t, 0.0) + n_blocks * v
                r["nbytes"] += n_blocks * nbytes
                r["blocks"] += n_blocks
        assert pool_rel < 1e-4, f"kernel A's pool disagrees ({label})"
    # float32 activations at every fused shape, with float32 and bf16
    # matrix operands: the float32 gate
    worst = {"expand_dw_pool": 0.0, "scale_project": 0.0, "pool": 0.0}
    for seed, (label, shape, _, dt) in enumerate(cases):
        if dt != torch.bfloat16:
            continue
        c, cm, k, h, w, c2 = shape
        a, b = mbconv_inputs(shape, SEED + 100 + seed, dev, torch.float32)
        args_a, args_b = [a[n] for n in ARGS_A], [b[n] for n in ARGS_B]
        for dot in (torch.float32, torch.bfloat16):
            kw = dict(height=h, width=w, kernel=k, out_dtype=torch.float32,
                      dot_dtype=dot)
            (y, pool), (y_ref, pool_ref) = (
                fn(*args_a, **kw) for fn in (expand_dw_pool,
                                             expand_dw_pool_plain))
            o, o_ref = (fn(*args_b, out_dtype=torch.float32, dot_dtype=dot)
                        for fn in (scale_project, scale_project_plain))
            torch.cuda.synchronize()
            for name, ref, got in (("expand_dw_pool", y_ref, y),
                                   ("scale_project", o_ref, o)):
                err = _mbconv_err(ref, got, torch.float32)[1]
                worst[name] = max(worst[name], err)
                assert err < 1e-4, f"{name} f32 disagrees ({label} {shape})"
            pool_rel = float(((pool - pool_ref).abs() / (
                pool_ref.abs() + h * w * 1e-3)).max())
            worst["pool"] = max(worst["pool"], pool_rel)
            assert pool_rel < 1e-4, f"f32 pool disagrees ({label} {shape})"
    print(f"mbconv float32 at all {sum(dt == torch.bfloat16 for *_, dt in cases)}"
          f" fused shapes, float32 and bf16 operands: largest err "
          f"expand_dw_pool {worst['expand_dw_pool']:.3e}, scale_project "
          f"{worst['scale_project']:.3e} (< 1e-4), pool "
          f"{worst['pool']:.3e} (< 1e-4) [{card}]")
    for model_id, kernels in out.items():
        for name, r in kernels.items():
            n = r.pop("blocks")
            # the bound of the step's summed work
            r["bound_ms"], r["bound_by"] = bound_ms(r.pop("flops"),
                                                    r.pop("nbytes"))
            print(f"mbconv {name}: per call {r['ms']:.4f} ms against plain "
                  f"{r['plain_ms']:.4f} ms, device {r['device_ms']:.4f} ms "
                  f"against plain {r['plain_device_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms (share {r['bound_ms'] / r['ms']:.3f}"
                  f" per call, {r['bound_ms'] / r['device_ms']:.3f} device) "
                  f"over the {n} fused blocks of one {model_id} step, "
                  f"max_abs_err {r['max_abs_err']:.3e} [{card}]")
    return out


def _agreement(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max post-sigmoid difference, mean top-10 overlap of the logits)."""
    dconf = float((torch.sigmoid(a) - torch.sigmoid(b)).abs().max())
    ia = torch.topk(a, 10).indices.cpu().numpy()
    ib = torch.topk(b, 10).indices.cpu().numpy()
    overlap = float(np.mean([len(set(x) & set(y)) / 10.0
                             for x, y in zip(ia, ib)]))
    return dconf, overlap


def _device_step(model, pcm: torch.Tensor, fused: bool):
    """The batcher's step without the host: int16 → top-10 on the card."""
    model.fused_blocks = fused
    logits = model.apply_int16(pcm)["logits"]
    return top_k_results(sigmoid_confidence(logits, 1.0), 10)


@contextlib.contextmanager
def _dot_dtype(dot_dtype: torch.dtype | None):
    """Run the backbone's fused blocks with `dot_dtype` matrix operands
    (the backbone, as the JAX one, always takes bf16); None changes
    nothing."""
    orig = efficientnet.mbconv_fused
    if dot_dtype is not None:
        efficientnet.mbconv_fused = functools.partial(orig,
                                                      dot_dtype=dot_dtype)
    try:
        yield
    finally:
        efficientnet.mbconv_fused = orig


def _cpu_copy(model, compute_dtype: torch.dtype):
    """The same weights on the CPU, with fused blocks (plain versions)."""
    m = type(model)(compute_dtype=compute_dtype)
    m.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    m.fused_blocks = True
    return m.eval()


def phase_slice(dev: torch.device, card: str) -> None:
    model = BirdNETv24().init(torch.Generator().manual_seed(SEED))
    m32 = BirdNETv24(compute_dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    m32.eval()
    model.to(dev).eval()
    pcm = torch.from_numpy(pcm_batch((BATCH, CLIP), SEED + 2)).to(dev)
    with torch.inference_mode():
        t0 = time.monotonic()
        out = model.apply_int16(pcm)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        mel32 = melspec_fused_plain(pcm, model.mel)
        ref = model.backbone(mel32.to(torch.bfloat16)[..., None])
        lk, lp = out["logits"], ref["logits"]
        assert lk.shape == (BATCH, 6522)
        assert out["embedding"].shape == (BATCH, 1280)
        assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
        d16, o16 = _agreement(lk, lp)
        # the bf16 backbone's own rounding spread: bf16 vs float32 weights
        # and activations on one and the same mel
        m32.to(dev)
        l32 = m32.backbone(mel32[..., None])["logits"]
        dfl, ofl = _agreement(lp, l32)
        # the fused blocks (MBConv kernels) against the unfused step
        model.fused_blocks = True
        lf = model.apply_int16(pcm)["logits"]
        model.fused_blocks = False
        assert torch.isfinite(lf).all()
        dfu, ofu = _agreement(lf, lk)
        print(f"slice v2.4 B0 bf16 [{BATCH},{CLIP}]: first step {dt:.2f} s; "
              f"kernel vs plain mel: max post-sigmoid diff {d16:.3e} "
              f"(< 0.02), top-10 overlap {o16:.4f} (>= 0.9); bf16 vs f32 "
              f"backbone on the plain mel: {dfl:.3e}, {ofl:.4f}; fused vs "
              f"unfused blocks: {dfu:.3e}, {ofu:.4f} [{card}]")
        # the same check with the float32 backbone (TF32 off)
        k32 = m32.apply_int16(pcm)["logits"]
        assert torch.isfinite(k32).all()
        d32, o32 = _agreement(k32, l32)
    print(f"slice v2.4 B0 f32 [{BATCH},{CLIP}]: kernel vs plain mel: max "
          f"post-sigmoid diff {d32:.3e} (< 0.02), top-10 overlap {o32:.4f} "
          f"(>= 0.9)")
    assert d16 < 0.02 and o16 >= 0.9, "bf16 slice: kernel vs plain mel"
    assert d32 < 0.02 and o32 >= 0.9, "f32 slice: kernel vs plain mel"

    # float32 on the card (kernels) vs the same weights on the CPU (plain
    # versions), which the CPU tests tie to the JAX package, within 1e-3 of
    # the logits' scale: unfused, with fused blocks on float32 matrix
    # operands, and with fused blocks as the JAX backbone runs them, on
    # bf16 operands. There a float32 value one ulp apart on the two devices
    # now and then rounds to the other bf16 neighbour, which moves that
    # product by one bf16 step (2^-7): that case is held to 1e-3 for all
    # but BF16_OPERAND_OUTLIERS of the logits, and to 2^-7 for those.
    x = pcm[:2].cpu()
    cpu32 = _cpu_copy(m32, torch.float32)
    for fused, dot in ((False, None), (True, torch.float32),
                       (True, torch.bfloat16)):
        m32.fused_blocks = cpu32.fused_blocks = fused
        with torch.inference_mode(), _dot_dtype(dot):
            got = m32.apply_int16(x.to(dev))["logits"].cpu()
            want = cpu32.apply_int16(x)["logits"]
        d = (got - want).abs()
        err = float(d.max())
        scale = max(1.0, float(want.abs().max()))
        n_out = int((d >= 1e-3 * scale).sum())
        allowed = BF16_OPERAND_OUTLIERS if dot == torch.bfloat16 else 0
        what = f"fused blocks, {dot} operands" if fused else "unfused"
        print(f"slice v2.4 f32 card vs CPU [2,{CLIP}], {what}: max |dlogit| "
              f"{err:.3e}, {n_out} of {d.numel()} logits >= 1e-3 x "
              f"{scale:.2f} (<= {allowed}; all < 2^-7 x {scale:.2f})")
        assert torch.isfinite(got).all() and n_out <= allowed
        assert err < 2.0 ** -7 * scale

    # bf16 with fused blocks: the card against the CPU's plain fused path
    x8 = pcm[:8].cpu()
    with torch.inference_mode():
        want = _cpu_copy(model, torch.bfloat16).apply_int16(x8)["logits"]
    dcpu, ocpu = _agreement(lf[:8].cpu(), want)
    print(f"slice v2.4 bf16 fused card vs CPU [8,{CLIP}]: max post-sigmoid "
          f"diff {dcpu:.3e} (< 0.02), top-10 overlap {ocpu:.4f} (>= 0.9)")
    assert dcpu < 0.02 and ocpu >= 0.9, "bf16 fused slice: card vs CPU"

    # one full-width fused step of each B1 family, then the step times
    pcm32 = torch.from_numpy(pcm_batch((BATCH, CLIP32), SEED + 5,
                                       rate=32000)).to(dev)
    steps = [("v2.4", model, pcm)]
    for cls in (BirdNETv3, PerchV2):
        m = cls().init(torch.Generator().manual_seed(SEED)).to(dev).eval()
        m.fused_blocks = True
        with torch.inference_mode():
            o = m.apply_int16(pcm32)
        assert o["logits"].shape == (BATCH, m.spec.num_species)
        assert o["embedding"].shape == (BATCH, 1280)
        assert torch.isfinite(o["logits"]).all()
        assert torch.isfinite(o["embedding"]).all()
        # the card against the CPU's plain fused path, as for v2.4
        with torch.inference_mode():
            want = _cpu_copy(m, torch.bfloat16).apply_int16(
                pcm32[:8].cpu())["logits"]
        dcpu, ocpu = _agreement(o["logits"][:8].cpu(), want)
        print(f"slice {m.spec.model_id} bf16 fused [{BATCH},{CLIP32}]: "
              f"logits {tuple(o['logits'].shape)}, embedding "
              f"{tuple(o['embedding'].shape)}, finite; card vs CPU [8]: max "
              f"post-sigmoid diff {dcpu:.3e} (< 0.02), top-10 overlap "
              f"{ocpu:.4f} (>= 0.9) [{card}]")
        assert dcpu < 0.02 and ocpu >= 0.9, \
            f"{m.spec.model_id} bf16 fused step: card vs CPU"
        steps.append((m.spec.model_id, m, pcm32))
    with torch.inference_mode():
        for label, m, x in steps:
            # eager steps of ~1,000 launches: the host's launch rate shows
            # in these times, so each comes with the range of its samples
            unfused, fused = (
                f"{np.median(t):.4f} ms [{min(t):.4f}, {max(t):.4f}]"
                for t in timed_pair(lambda: _device_step(m, x, False),
                                    lambda: _device_step(m, x, True)))
            print(f"step {label} bf16 [{BATCH},{x.shape[1]}]: unfused "
                  f"{unfused}, fused blocks {fused} (median [min, max] of "
                  f"{REPS}) [{card}]")


KERNELS = (melspec_fused, expand_dw_pool, scale_project)


def phase_loop(model, dev: torch.device, card: str, n_streams: int,
               n_ticks: int, batch: int = BATCH) -> tuple[dict, int, float]:
    """Returns each kernel's launches during the loop run, the number of
    batches and the loop's windows/s. A raw-rate (bat) model's streams
    carry ultrasound at its capture rate, and every window must come back
    with a finite ultrasonic CV. A mel-CNN model launches the mel kernel
    once a batch; an imported graph (float32 PCM, no int16 path) launches
    none of the three kernels."""
    batcher = TorchModelBatcher(TorchClassifier(model, dev), max_batch=batch,
                                top_k=10, pipeline_depth=2)
    spec = batcher.spec
    rate = spec.effective_sample_rate
    overlap, read = (n // 2 for n in spec.buffer_dimensions())   # samples
    bufs = {f"mic{i:03d}": AnalysisBuffer(overlap, read)
            for i in range(n_streams)}
    pos = dict.fromkeys(bufs, 0.0)
    pool = (ultrasound_batch((32, read), SEED + 3) if spec.raw_sample_rate
            else pcm_batch((32, read), SEED + 3, rate=rate))
    offered, results = [], {}

    def provider():
        items = []
        for sid, buf in bufs.items():
            while (win := buf.read()) is not None:
                items.append((spec.model_id, win, sid, pos[sid], rate))
                offered.append((sid, pos[sid]))
                pos[sid] += read / rate
        return items

    def on_result(w, vals, idx):
        results[(w.source_id, w.start_time)] = (vals, idx, w.ultrasonic_cv)

    batcher.on_result = on_result
    loop = DeviceLoop(tick_seconds=0.1)
    loop.add_batcher(batcher)
    loop.add_provider(provider)
    warm = batcher.warmup()

    for k in KERNELS:
        k.launches = 0
    n_spans = GLOBAL_SPANS.total
    t0 = time.monotonic()
    for tick in range(n_ticks):
        for i, buf in enumerate(bufs.values()):
            buf.write(pool[(i + tick) % len(pool)])
        loop.run_tick()
    loop.drain()
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    launches = {k.__name__: k.launches for k in KERNELS}

    n = len(offered)
    assert n == n_streams * n_ticks and loop.windows_dropped == 0
    assert set(results) == set(offered), "windows missing from the results"
    for vals, idx, cv in results.values():
        assert vals.shape == (10,) and idx.shape == (10,)
        assert np.isfinite(vals).all() and (vals >= 0).all() and (
            vals <= 1).all()
        assert np.all(np.diff(vals) <= 0)
        assert (idx >= 0).all() and (idx < spec.num_species).all()
        if spec.raw_sample_rate:
            assert cv is not None and np.isfinite(cv), "ultrasonic CV"
        else:
            assert cv is None
    batches = batcher.stats.batches_dispatched
    mel = batches if hasattr(model, "apply_int16") else 0
    assert batches > 0 and launches["melspec_fused"] == mel, (
        launches, batches)
    if mel == 0:
        assert not any(launches.values()), launches
    lat = sorted(s["duration_ms"] for s in GLOBAL_SPANS.recent(
        GLOBAL_SPANS.total - n_spans))
    wps = n / elapsed

    # the device step alone (CUDA events, PCM already on the card) and the
    # synchronous host-to-device copy of one staging buffer (host clock)
    staged = batcher._staged_bufs[0]
    x = batcher._to_device(staged)
    steps = [event_ms(lambda: batcher._step(x, batcher.sensitivity, 10,
                                            None)) for _ in range(REPS)]
    step_ms = float(np.median(steps))
    h2d = []
    for _ in range(REPS):
        t1 = time.perf_counter()
        batcher._to_device(staged)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t1) * 1e3)
    fused = getattr(model, "fused_blocks", False)
    label = (f"{spec.model_id}{' fused blocks' if fused else ''}"
             f"{'' if mel else ' imported graph'}")
    print(f"step {label} [{batch},{spec.clip_samples}] on the card: "
          f"{step_ms:.4f} ms [{min(steps):.4f}, {max(steps):.4f}] ("
          f"{batch / step_ms * 1e3:.1f} windows/s device-bound); H2D "
          f"(pinned, to completion) {float(np.median(h2d)):.4f} ms per batch"
          f" [{card}]")
    # a stream yields a window every clip/2 seconds (1.5 s for v2.4's 3 s
    # clips, 2.5 s for v3.0's 5 s)
    print(f"loop {label}: {n_streams} streams x {n_ticks} ticks = {n} "
          f"windows in {batches} batches, warmup {warm:.2f} s, "
          f"{elapsed:.3f} s -> {wps:.1f} windows/s, streams = "
          f"{wps * spec.buffer_interval_seconds:.1f}, batch latency p50 "
          f"{lat[len(lat) // 2]:.2f} ms, "
          f"dropped {loop.windows_dropped}, kernel launches {launches} "
          f"[{card}]")
    return launches, batches, wps


def ultrasound_batch(shape: tuple[int, int], seed: int) -> np.ndarray:
    """Rows of 256 kHz bat-detector capture, int16: bursts of a 40 kHz call,
    each row at its own burst rate (10 to 80 Hz), at ``pcm_batch``'s field
    levels (a -26 dBFS call over -40 dBFS noise; a -10 dBFS call drives
    the random-weight network where bf16 and float32 steps part by 0.16
    post-sigmoid). Their ultrasonic CVs lie far from 0, where the CV is
    well conditioned."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[1], dtype=np.float32) / 256000.0
    rate = rng.uniform(10.0, 80.0, (shape[0], 1)).astype(np.float32)
    gate = np.sin(2 * np.pi * rate * t) > 0.6
    x = 0.05 * gate * np.sin(2 * np.pi * 40000.0 * t)
    x += rng.standard_normal(shape, dtype=np.float32) * 0.01
    return (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)


def _h2d_ms(batcher: TorchModelBatcher) -> dict:
    """One staging buffer to the card, both ways, in turns (host clock):
    the pinned buffer through ``_to_device`` (the time until it returns,
    and until the copy is done) and a pageable copy of the same bytes."""
    staged = batcher._staged_bufs[0]
    pageable = staged.copy()
    ret, pinned, paged = [], [], []
    batcher._to_device(staged)
    torch.cuda.synchronize()
    for _ in range(REPS):
        t0 = time.perf_counter()
        batcher._to_device(staged)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        torch.from_numpy(pageable).to(batcher.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ret.append((t1 - t0) * 1e3)
        pinned.append((t2 - t0) * 1e3)
        paged.append((t3 - t2) * 1e3)
    return {k: (float(np.median(v)), min(v), max(v))
            for k, v in (("returns", ret), ("pinned", pinned),
                         ("pageable", paged))}


def phase_farm(model, dev: torch.device, card: str, python_wps: float,
               timescale: float, keep_up: bool) -> None:
    """v2.4 served unfused, fed by the native stream farm: FARM_STREAMS
    streams at `timescale` times real time pack their windows straight
    into the batcher's pinned staging buffers (``fill_provider`` →
    ``DeviceLoop.add_fill_provider``), the loop on its own thread at a
    0.1 s tick, as the server runs it. Every served window is checked and
    none may be dropped; with `keep_up` no sample may be lost either, else
    the loop must serve FARM_FLOOR windows/s. The H2D is timed after the
    `keep_up` run."""
    batcher = TorchModelBatcher(TorchClassifier(model, dev), max_batch=BATCH,
                                top_k=10, pipeline_depth=2)
    spec = batcher.spec
    assert dev.type != "cuda" or all(t.is_pinned()
                                     for t in batcher._host_bufs)
    hop = spec.clip_samples // 2
    farm = native.StreamFarm(FARM_STREAMS, spec.sample_rate,
                             spec.clip_samples, hop,
                             ring_seconds=FARM_RING_SECONDS, n_waveforms=32,
                             seed=SEED + 11, timescale=timescale)
    names = [f"farm{s:04d}" for s in range(FARM_STREAMS)]
    batches = []

    def on_batch(meta, vals, idx, cv):
        batches.append(([(w.source_id, w.start_time) for w in meta], vals,
                         idx))

    batcher.on_batch = on_batch
    # where the loop thread's time goes: the farm's packing into staging
    # (fill), the step's dispatch (the batcher's _launch: the copy and
    # about a thousand eager launches) and the waits for finished steps
    # (its _collect)
    spent = {"fill": 0.0, "launch": 0.0, "collect": 0.0}

    def timed(name, fn):
        def call(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[name] += time.perf_counter() - t
        return call

    batcher._launch = timed("launch", batcher._launch)
    batcher._collect = timed("collect", batcher._collect)
    loop = DeviceLoop(tick_seconds=0.1)
    loop.add_batcher(batcher)
    loop.add_fill_provider(spec.model_id,
                           timed("fill", native.fill_provider(farm, names)))
    warm = batcher.warmup()

    for k in KERNELS:
        k.launches = 0
    n_spans = GLOBAL_SPANS.total
    t0 = time.monotonic()
    farm.start()
    loop.start()
    try:
        time.sleep(FARM_SECONDS)
        farm.stop()
        loop.stop()
        while loop.run_tick():
            pass
        loop.drain()
        torch.cuda.synchronize()
        elapsed = time.monotonic() - t0
        stats = farm.stats()
    finally:
        farm.stop()
        loop.stop()
        farm.close()
    launches = {k.__name__: k.launches for k in KERNELS}

    n = sum(len(m) for m, _, _ in batches)
    lost = stats["samples_lost"]
    n_batches = batcher.stats.batches_dispatched
    lat = sorted(s["duration_ms"] for s in GLOBAL_SPANS.recent(
        GLOBAL_SPANS.total - n_spans))
    wps = n / elapsed
    offered = FARM_STREAMS * timescale / spec.buffer_interval_seconds
    print(f"farm loop v2.4 unfused: {FARM_STREAMS} native streams at "
          f"{timescale:g}x real time (offering {offered:.1f} windows/s)"
          f" for {FARM_SECONDS:g} s, rings {FARM_RING_SECONDS:g} s of "
          f"stream time: {n} windows in {n_batches} batches (fill "
          f"{n / (n_batches * BATCH):.3f}), warmup {warm:.2f} s, "
          f"{elapsed:.3f} s -> {wps:.1f} windows/s "
          + ("(no sample may be lost)" if keep_up else
             f"(>= {FARM_FLOOR:g}, samples lost or not)")
          + f", streams = "
          f"{wps * spec.buffer_interval_seconds:.1f}, batch latency p50 "
          f"{lat[len(lat) // 2]:.2f} ms, tick busy EWMA "
          f"{loop.tick_busy_ms:.2f} ms, max {loop.tick_busy_ms_max:.2f} ms "
          f"(tick 100 ms), windows_dropped {loop.windows_dropped}, "
          f"samples_lost {lost} (backlog high water "
          f"{stats['backlog_high_water']} of {stats['ring_capacity']} "
          f"samples), kernel launches {launches}; the Python "
          f"AnalysisBuffer loop of v2.4 above: {python_wps:.1f} windows/s "
          f"[{card}]")
    print(f"farm loop thread: {loop.ticks} ticks; packing windows into "
          f"staging {spent['fill'] * 1e3 / n_batches:.2f} ms a batch, "
          f"dispatching the step {spent['launch'] * 1e3 / n_batches:.2f} "
          f"ms a batch, "
          f"waiting for and copying back results "
          f"{spent['collect'] * 1e3 / n_batches:.2f} ms a batch, of "
          f"{elapsed * 1e3 / n_batches:.2f} ms of wall time a batch "
          f"[{card}]")
    assert n == stats["windows_emitted"] == batcher.stats.windows_processed
    assert loop.windows_dropped == 0, loop.windows_dropped
    starts: dict[str, list[float]] = {}
    for meta, vals, idx in batches:
        assert vals.shape == (len(meta), 10) and idx.shape == vals.shape
        assert np.isfinite(vals).all() and (vals >= 0).all() and (
            vals <= 1).all()
        assert np.all(np.diff(vals, axis=1) <= 0)
        assert (idx >= 0).all() and (idx < spec.num_species).all()
        for sid, st in meta:
            starts.setdefault(sid, []).append(st)
    # every stream's windows in order, one hop apart, or whole hops where
    # samples were lost
    assert len(starts) == FARM_STREAMS
    hop_s = hop / spec.sample_rate
    for st in starts.values():
        hops = np.diff(st) / hop_s
        assert (np.abs(hops - np.round(hops)) < 1e-6).all() and (
            hops > 0.5).all()
        assert not keep_up or np.allclose(hops, 1.0, rtol=1e-9)
    assert launches["melspec_fused"] == n_batches > 0, (launches, n_batches)
    if not keep_up:
        assert wps >= FARM_FLOOR, (wps, FARM_FLOOR)
        return
    assert lost == 0, lost
    h2d = _h2d_ms(batcher)
    nbytes = batcher._staged_bufs[0].nbytes
    print(f"H2D of one staging buffer [{BATCH},{spec.clip_samples}] int16 "
          f"({nbytes / 1e6:.1f} MB), median [min, max] of {REPS}: pinned "
          f"non_blocking returns in {h2d['returns'][0]:.4f} ms "
          f"[{h2d['returns'][1]:.4f}, {h2d['returns'][2]:.4f}], done in "
          f"{h2d['pinned'][0]:.4f} ms [{h2d['pinned'][1]:.4f}, "
          f"{h2d['pinned'][2]:.4f}] ({nbytes / h2d['pinned'][0] / 1e6:.2f} "
          f"GB/s); pageable {h2d['pageable'][0]:.4f} ms "
          f"[{h2d['pageable'][1]:.4f}, {h2d['pageable'][2]:.4f}] "
          f"({nbytes / h2d['pageable'][0] / 1e6:.2f} GB/s) [{card}]")


def phase_families(dev: torch.device, card: str) -> None:
    """The BattyBirdNET step at full width against the CPU's plain path on
    the same weights (the v2.4 slice's tolerance), its ultrasonic CV
    against ``ultrasonic_frame_cv`` on the CPU, a short bat loop, and one
    BSG Finland step."""
    bat = BatClassifier().init(torch.Generator().manual_seed(SEED))
    cpu = BatClassifier().eval()
    cpu.load_state_dict(bat.state_dict())
    bat.to(dev).eval()
    batcher = TorchModelBatcher(TorchClassifier(bat, dev), max_batch=BATCH,
                                top_k=10)
    pcm_np = ultrasound_batch((BATCH, CLIP), SEED + 7)
    pcm = torch.from_numpy(pcm_np).to(dev)
    with torch.inference_mode():
        out = bat.apply_int16(pcm)
        vals, idx, cv = batcher._step(pcm, 1.0, 10, None)
        torch.cuda.synchronize()
        assert out["logits"].shape == (BATCH, 128)
        assert out["embedding"].shape == (BATCH, 1024)
        assert torch.isfinite(out["logits"]).all()
        assert torch.isfinite(out["embedding"]).all()
        assert cv.shape == (BATCH,) and torch.isfinite(cv).all()
        want = cpu.apply_int16(pcm[:8].cpu())["logits"]
        want_cv = ultrasonic_frame_cv(pcm16_to_float32(pcm.cpu()),
                                      batcher._us_cfg)
        step = [event_ms(lambda: batcher._step(pcm, 1.0, 10, None))
                for _ in range(REPS)]
        cv_ms = [event_ms(lambda: ultrasonic_frame_cv(
            pcm16_to_float32(pcm), batcher._us_cfg)) for _ in range(REPS)]
    dcpu, ocpu = _agreement(out["logits"][:8].cpu(), want)
    cv_err = float(((cv.cpu() - want_cv).abs() / want_cv.abs()).max())
    print(f"bat BattyBirdNET bf16 [{BATCH},{CLIP}] (256 kHz capture): "
          f"logits {tuple(out['logits'].shape)}, embedding "
          f"{tuple(out['embedding'].shape)}, finite; card vs CPU [8]: max "
          f"post-sigmoid diff {dcpu:.3e} (< 0.02), top-10 overlap "
          f"{ocpu:.4f} (>= 0.9); ultrasonic CV card vs CPU: max rel err "
          f"{cv_err:.3e} (< 1e-4), CV in [{float(want_cv.min()):.3f}, "
          f"{float(want_cv.max()):.3f}]; step with CV "
          f"{np.median(step):.4f} ms [{min(step):.4f}, {max(step):.4f}], "
          f"CV alone {np.median(cv_ms):.4f} ms [{min(cv_ms):.4f}, "
          f"{max(cv_ms):.4f}] (median [min, max] of {REPS}) [{card}]")
    assert dcpu < 0.02 and ocpu >= 0.9, "bat step: card vs CPU"
    assert cv_err < 1e-4, "bat ultrasonic CV: card vs CPU"

    launches, batches, _ = phase_loop(bat, dev, card, BAT_STREAMS, BAT_TICKS)
    assert launches["melspec_fused"] == batches

    bsg = BSGFinland().init(torch.Generator().manual_seed(SEED)).to(
        dev).eval()
    x = torch.from_numpy(pcm_batch((BATCH, CLIP), SEED + 8)).to(dev)
    with torch.inference_mode():
        before = melspec_fused.launches
        o = bsg.apply_int16(x)
        torch.cuda.synchronize()
        assert melspec_fused.launches == before + 1
        assert o["logits"].shape == (BATCH, 380)
        assert o["embedding"].shape == (BATCH, 1280)
        assert torch.isfinite(o["logits"]).all()
        assert torch.isfinite(o["embedding"]).all()
        t = [event_ms(lambda: _device_step(bsg, x, False))
             for _ in range(REPS)]
    print(f"bsg BSG Finland bf16 [{BATCH},{CLIP}]: logits "
          f"{tuple(o['logits'].shape)}, embedding "
          f"{tuple(o['embedding'].shape)}, finite; step "
          f"{np.median(t):.4f} ms [{min(t):.4f}, {max(t):.4f}] (median "
          f"[min, max] of {REPS}) [{card}]")


def phase_range(dev: torch.device, card: str, v24) -> None:
    """The range filter at full width (6,522 species) on the card against
    the CPU, over a lat/lon grid, and its mask on the served v2.4 step."""
    geo = Geomodel().init(torch.Generator().manual_seed(SEED))
    cpu = Geomodel().eval()
    cpu.load_state_dict(geo.state_dict())
    rf, rf_cpu = TorchRangeFilter(geo), TorchRangeFilter(cpu, "cpu")
    assert rf.device.type == dev.type     # the card, by default
    rng = np.random.default_rng(SEED + 9)
    coords = np.stack([rng.uniform(-90, 90, 64), rng.uniform(-180, 180, 64),
                       rng.integers(-1, 49, 64)], 1).astype(np.float32)
    got, want = rf.predict_batch(coords), rf_cpu.predict_batch(coords)
    err = float(np.abs(got - want).max())
    one = rf.predict(float(coords[5, 0]), float(coords[5, 1]),
                     int(coords[5, 2]))
    one_err = float(np.abs(one - got[5]).max())
    assert got.shape == (64, 6522) and np.isfinite(got).all()
    lat, lon = np.meshgrid(np.arange(-90.0, 90.1, GRID_STEP),
                           np.arange(-180.0, 180.1, GRID_STEP),
                           indexing="ij")
    grid = np.stack([lat.ravel(), lon.ravel(),
                     np.full(lat.size, 23.0)], 1).astype(np.float32)
    rf.predict_batch(grid[:256])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    scores = rf.predict_batch(grid)
    grid_s = time.monotonic() - t0
    assert scores.shape == (len(grid), 6522) and np.isfinite(scores).all()
    assert (scores >= 0).all() and (scores <= 1).all()

    # the mask of Helsinki in week 23 on the served v2.4 step: every index
    # returned with a nonzero confidence lies inside it
    mask = range_mask(rf, 60.17, 24.94, 23, threshold=0.5)
    inside = int(mask.sum())
    assert 0 < inside < 6522
    clf = TorchClassifier(v24, dev)
    pcm = pcm_batch((BATCH, CLIP), SEED + 10)
    seen = []
    for m in (None, mask):
        clf.set_range_mask(m)
        b = TorchModelBatcher(clf, max_batch=BATCH, top_k=10)
        b.on_batch = lambda meta, v, i, cv: seen.append((v, i))
        assert b.offer_block(pcm, ["geo"] * BATCH, [0.0] * BATCH) == BATCH
        b.dispatch()
        b.harvest_all()
    (v0, i0), (v1, i1) = seen
    outside_before = int((mask[i0] == 0).sum())
    assert (mask[i1[v1 > 0]] == 1).all() and (v1 > 0).any()
    assert outside_before > 0, "the mask removed nothing from the top-10"
    print(f"range filter Geomodel f32 (6,522 species): card vs CPU max "
          f"|dscore| {err:.3e} (< 1e-5) over 64 points, predict against "
          f"its batch row {one_err:.3e} (< 1e-6); grid "
          f"{GRID_STEP:g} deg ({len(grid)} points) in {grid_s:.4f} s "
          f"({len(grid) / grid_s:.1f} points/s, H2D and D2H included); "
          f"Helsinki week 23 mask at 0.5 keeps {inside} species: "
          f"{outside_before} of the unmasked top-10 fell outside it, none "
          f"with a nonzero confidence once it is set [{card}]")
    assert err < 1e-5, "range filter: card vs CPU"
    assert one_err < 1e-6, "predict vs predict_batch"


def field_recording(seconds: float, rate: int, channels: int,
                    seed: int) -> np.ndarray:
    """int16 frames [n, channels] of a field-level recording: 10 s linear
    tone sweeps between random frequencies from 200 Hz to 12 kHz at -26
    dBFS, the same in every channel, over -40 dBFS white noise of each
    channel's own."""
    rng = np.random.default_rng(seed)
    n, seg = int(seconds * rate), 10 * rate
    ends = rng.uniform(200.0, 12000.0, (2, -(-n // seg)))
    k = np.arange(n)
    f0, f1 = ends[:, k // seg]
    freq = f0 + (f1 - f0) * ((k % seg) / seg)
    tone = 0.05 * np.sin(2 * np.pi * np.cumsum(freq / rate))
    out = np.empty((n, channels), np.int16)
    for c in range(channels):
        x = tone + rng.standard_normal(n, dtype=np.float32) * 0.01
        out[:, c] = np.clip(x * 32767, -32768, 32767)
    return out


def write_pcm16(path: Path, frames: np.ndarray, rate: int) -> None:
    """16-bit PCM WAV of int16 frames [n, channels]."""
    ch = frames.shape[1]
    data = frames.astype("<i2").tobytes()
    path.write_bytes(struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
        1, ch, rate, rate * 2 * ch, 2 * ch, 16, b"data", len(data)) + data)


_SUMMARY = re.compile(r"^(.+): (\d+)s audio, (\d+) windows, (\d+) detections "
                      r"in (\d+\.\d\d)s \((\d+)x realtime\)$", re.M)


def _summary(stdout: str, name: str) -> tuple[int, int, float, int]:
    """(windows, detections, elapsed s, realtime factor) of the CLI's line
    for file `name`."""
    found = {m[0]: m for m in _SUMMARY.findall(stdout)}
    _, _, windows, dets, elapsed, rtf = found[name]
    return int(windows), int(dets), float(elapsed), int(rtf)


def _check_tables(out: Path, wav: str, n_rows: int, hop_s: float) -> None:
    """The Raven table and the CSV of one file: the header, one row per
    window, begin times k·hop, finite confidences in [0, 1]."""
    table = (out / f"{wav}.txt").read_text(encoding="utf-8").splitlines()
    csv = (out / f"{Path(wav).stem}.csv").read_text(
        encoding="utf-8").splitlines()
    assert table[0] == format_raven_table([], wav).strip()
    assert csv[0] == format_csv([]).strip()
    assert len(table) == len(csv) == n_rows + 1, (len(table), len(csv))
    for k, (row, crow) in enumerate(zip(table[1:], csv[1:])):
        f = row.split("\t")
        assert f[0] == str(k + 1) and f[3] == wav, row
        assert f[4] == f"{k * hop_s:.1f}" == crow.split(",")[0], row
        conf = float(f[10])
        assert np.isfinite(conf) and 0.0 <= conf <= 1.0, row


def _cli(argv: list[str]) -> str:
    """The port's CLI in this process; its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0, (argv, rc, buf.getvalue())
    return buf.getvalue()


def _rangefilter_rows(stdout: str) -> dict[str, float]:
    lines = stdout.splitlines()
    assert lines[0] == "scientific_name,common_name,score"
    return {ln.rsplit(",", 1)[0]: float(ln.rsplit(",", 1)[1])
            for ln in lines[1:]}


def _offline_gap(dev: torch.device, card: str, v24, cpu24, signal, labels,
                 head: np.ndarray) -> None:
    """Where the card's bf16 top-10s part from the CPU's: the float32 mel
    features of the same windows, the bf16 embeddings and logits, the
    card's backbone fed the CPU's features, and the analyzer again on the
    same weights in float32 (TF32 off), which must agree to 1e-5."""
    wins = slice_overlapped_windows(signal, CLIP, CLIP)
    with torch.inference_mode():
        mel_p = cpu24.features(wins)
        mel_c = v24.features(wins.to(dev)).cpu()
        out_p = cpu24.apply(wins)
        out_c = {k: v.cpu() for k, v in v24.apply(wins.to(dev)).items()}
        lg_s = v24.backbone(mel_p.to(dev, v24.compute_dtype))["logits"].cpu()
    mel_err = float((mel_c - mel_p).abs().max() / mel_p.abs().max())
    emb_p = out_p["embedding"]
    emb_err = float((out_c["embedding"] - emb_p).abs().max()
                    / emb_p.abs().max())
    lg_p = out_p["logits"]
    lg_err = float((out_c["logits"] - lg_p).abs().max())
    top = lg_p.topk(10).indices
    tp, ts = lg_p.gather(1, top), lg_s.gather(1, top)
    same_err = float((torch.sigmoid(ts) - torch.sigmoid(tp)).abs().max())
    conf = []
    for model, where in ((v24, dev), (cpu24, torch.device("cpu"))):
        m32 = BirdNETv24(compute_dtype=torch.float32).eval()
        m32.load_state_dict(model.state_dict())
        a = OfflineAnalyzer(TorchClassifier(m32, where), labels,
                            OfflineConfig(threshold=0.0, batch_size=len(wins)))
        conf.append(np.array([w.confidences
                              for w in a.analyze_samples(head, 44100).windows]))
    f32_err = float(np.abs(conf[0] - conf[1]).max())
    print(f"offline v2.4 card vs CPU, where the bf16 gap comes from: float32 "
          f"mel features max rel err {mel_err:.3e}; bf16 embeddings max rel "
          f"err {emb_err:.3e}, logits max diff {lg_err:.3e} (CPU's logits: "
          f"std {float(lg_p.std()):.3e}, each window's top-10 in "
          f"[{float(tp.min()):.4f}, {float(tp.max()):.4f}]); the card's bf16 "
          f"backbone on the CPU's features: top-10 confidences max diff "
          f"{same_err:.3e}; the analyzer in float32 on the same weights: "
          f"top-10 confidences max diff {f32_err:.3e} (<= 1e-5) [{card}]")
    assert f32_err <= 1e-5, "float32 analysis: card vs CPU"


def phase_offline(dev: torch.device, card: str) -> None:
    """Offline analysis and the CLI on the card (see the module docstring,
    phase 10). The kernels' launch counts must not move."""
    root = REPO / "build" / "offline_smoke"
    shutil.rmtree(root, ignore_errors=True)
    d24, d3, out = root / "v24", root / "v3", root / "out"
    d24.mkdir(parents=True)
    d3.mkdir()
    t0 = time.monotonic()
    write_pcm16(d24 / "field44k.wav",
                field_recording(OFFLINE_SECONDS, 44100, 1, SEED + 12), 44100)
    write_pcm16(d3 / "field48k_stereo.wav",
                field_recording(OFFLINE_SECONDS, 48000, 2, SEED + 13), 48000)
    print(f"offline: two {OFFLINE_SECONDS} s field recordings written in "
          f"{time.monotonic() - t0:.2f} s")
    before = {k.__name__: k.launches for k in KERNELS}
    # one row a window at threshold 0: 3 s windows back to back for v2.4,
    # 5 s windows at a 2.5 s hop for v3.0 (200 and 239 for 10 minutes)
    n24 = OFFLINE_SECONDS // 3
    n3 = (OFFLINE_SECONDS * 2 - 10) // 5 + 1

    # v2.4 through `python -m birdnet_go_tpu_torch analyze`, a process of
    # its own with PyTorch's default TF32 settings
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "birdnet_go_tpu_torch", "analyze", str(d24),
         "--output", str(out), "--threshold", "0", "--rtype", "both"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    wall = time.monotonic() - t0
    assert res.returncode == 0, res.stderr[-4000:]
    n_win, n_det, elapsed, rtf = _summary(res.stdout, "field44k.wav")
    assert n_win == n_det == n24, res.stdout
    _check_tables(out, "field44k.wav", n24, 3.0)
    print(f"offline v2.4 analyze CLI (own process), {OFFLINE_SECONDS} s of "
          f"44.1 kHz mono resampled 160/147 to 48 kHz: {n_win} windows, "
          f"{n_det} rows in the Raven table and the CSV; analysis "
          f"{elapsed:.2f} s as the CLI prints it ({n_win / elapsed:.1f} "
          f"windows/s, {rtf}x realtime), process {wall:.2f} s with start-up "
          f"[{card}]")

    # v3.0 through the CLI in this process: 48 kHz stereo, overlap 1.5
    text = _cli(["analyze", str(d3), "--output", str(out), "--model",
                 "BirdNET_V3.0", "--overlap", "1.5", "--threshold", "0",
                 "--rtype", "both"])
    n_win, n_det, elapsed, rtf = _summary(text, "field48k_stereo.wav")
    assert n_win == n_det == n3, text
    _check_tables(out, "field48k_stereo.wav", n3, 2.5)
    print(f"offline v3.0 analyze CLI, {OFFLINE_SECONDS} s of 48 kHz stereo "
          f"(downmixed, resampled 2/3 to 32 kHz), overlap 1.5 (hop 2.5 s): "
          f"{n_win} windows, {n_det} rows; analysis {elapsed:.2f} s "
          f"({n_win / elapsed:.1f} windows/s, {rtf}x realtime) [{card}]")

    # the card against the CPU on the same seeded v2.4 weights: the
    # resampled signal (on the card at PyTorch's default, TF32 allowed:
    # the resampler must turn it off), then each window's top-10
    x44, info = read_wav(d24 / "field44k.wav")
    assert info.sample_rate == 44100 and len(x44) == OFFLINE_SECONDS * 44100
    head = torch.from_numpy(x44[:OFFLINE_CPU_SECONDS * 44100])
    rcfg = ResampleConfig(44100, 48000)
    want = polyphase_resample(head, rcfg)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = polyphase_resample(head.to(dev), rcfg).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    peak = float(want.abs().max())
    rs_err = float((got - want).abs().max())
    x_dev = torch.from_numpy(x44).to(dev)
    rs_ms = [event_ms(lambda: polyphase_resample(x_dev, rcfg))
             for _ in range(REPS)]
    v24 = load_model("BirdNET_V2.4")
    cpu24 = BirdNETv24().eval()
    cpu24.load_state_dict(v24.state_dict())
    labels = load_labels(expected_count=v24.num_species)
    cfg = OfflineConfig(threshold=0.0, batch_size=OFFLINE_CPU_SECONDS // 3)
    on_card = OfflineAnalyzer(TorchClassifier(v24, dev), labels, cfg)
    on_cpu = OfflineAnalyzer(TorchClassifier(cpu24, "cpu"), labels, cfg)
    rc, rp = (a.analyze_samples(head.numpy(), 44100)
              for a in (on_card, on_cpu))
    vc, vp = (np.array([w.confidences for w in r.windows]) for r in (rc, rp))
    ic, ip = (np.array([w.indices for w in r.windows]) for r in (rc, rp))
    conf_err = float(np.abs(vc - vp).max())
    n_over = int((np.abs(vc - vp) > 1e-3).sum())
    clear = (vp[:, 0] - vp[:, 1]) > 2e-3
    print(f"offline v2.4 card vs CPU, first {OFFLINE_CPU_SECONDS} s: "
          f"resampled signal max abs err {rs_err:.3e} (<= 1e-6 x peak "
          f"{peak:.4f}, the card at TF32-allowed defaults); {len(vc)} "
          f"windows' top-10 confidences max diff {conf_err:.3e} (<= 2e-3; "
          f"{n_over} of {vc.size} above 1e-3), "
          f"top-1 equal in {int((ic[:, 0] == ip[:, 0]).sum())} of "
          f"{len(vc)} ({int(clear.sum())} with a top-1/top-2 gap > 2e-3, "
          f"all equal there); resample of the whole {OFFLINE_SECONDS} s "
          f"({len(x44)} → {rcfg.out_len(len(x44))} samples) "
          f"{np.median(rs_ms):.4f} ms [{min(rs_ms):.4f}, {max(rs_ms):.4f}] "
          f"(median [min, max] of {REPS}, CUDA events) [{card}]")
    assert rs_err <= 1e-6 * peak, "resample: card vs CPU"
    assert len(vc) == OFFLINE_CPU_SECONDS // 3 and conf_err <= 2e-3
    assert (ic[clear, 0] == ip[clear, 0]).all(), "top-1: card vs CPU"
    _offline_gap(dev, card, v24, cpu24, want, labels, head.numpy())

    # the whole file again, in this process (warm): the analyzer's own time
    on_card.config = OfflineConfig(threshold=0.0)
    on_card.analyze_samples(x44, 44100)
    warm = on_card.analyze_samples(x44, 44100)
    assert len(warm.windows) == n24
    wps = len(warm.windows) / warm.elapsed_seconds
    print(f"offline v2.4 warm, {OFFLINE_SECONDS} s at 44.1 kHz, batch 64: "
          f"{warm.elapsed_seconds:.4f} s ({wps:.1f} windows/s, "
          f"{warm.realtime_factor:.1f}x realtime) [{card}]")

    # sound levels on 3 s windows of the 48 kHz file, card against CPU
    x48, info = read_wav(d3 / "field48k_stereo.wav")
    assert info.channels == 2 and len(x48) == OFFLINE_SECONDS * 48000
    win = slice_overlapped_windows(torch.from_numpy(x48).to(dev), CLIP,
                                   CLIP // 2)[:LEVEL_WINDOWS]
    scfg = SoundLevelConfig()
    lv, centers = band_levels_db(win, scfg)
    lv_cpu, _ = band_levels_db(win.cpu(), scfg)
    lv_err = float((lv.cpu() - lv_cpu).abs().max())
    lv_ms = [event_ms(lambda: band_levels_db(win, scfg)) for _ in range(REPS)]
    print(f"sound levels [{LEVEL_WINDOWS}, {CLIP}] ({len(centers)} bands): "
          f"card vs CPU max |d dB| {lv_err:.3e} (<= 1e-3), levels in "
          f"[{float(lv_cpu.min()):.1f}, {float(lv_cpu.max()):.1f}] dBFS; "
          f"{np.median(lv_ms):.4f} ms [{min(lv_ms):.4f}, {max(lv_ms):.4f}] "
          f"[{card}]")
    assert lv.shape == (LEVEL_WINDOWS, len(centers))
    assert torch.isfinite(lv).all() and lv_err <= 1e-3

    # the CLI's benchmark and rangefilter
    bench = json.loads(_cli(["benchmark", "--batch-size", "256", "--iters",
                             "10"]).strip())
    assert bench["model"] == "BirdNET_V2.4" and bench["windows_per_second"] > 0
    print(f"benchmark CLI: {json.dumps(bench)} [{card}]")
    geo = ["rangefilter", "--latitude", "60.17", "--longitude", "24.94",
           "--week", "23", "--csv"]
    on_card_rows = _rangefilter_rows(_cli(geo))
    on_cpu_rows = _rangefilter_rows(_cli(geo + ["--device", "cpu"]))
    # a score within 1e-5 of the threshold 0.01 prints as 0.0100
    near = {k for k, v in {**on_card_rows, **on_cpu_rows}.items()
            if abs(v - 0.01) < 5e-5}
    assert on_card_rows.keys() - near == on_cpu_rows.keys() - near
    step = max(abs(on_card_rows[k] - on_cpu_rows[k])
               for k in on_card_rows.keys() - near)
    print(f"rangefilter CLI, Helsinki week 23: {len(on_card_rows)} species "
          f"on the card, {len(on_cpu_rows)} with --device cpu, the same "
          f"rows ({len(near)} printed at the threshold set aside), scores "
          f"at most {step:.4f} apart [{card}]")
    assert step <= 1e-4 + 1e-9

    launches = {k.__name__: k.launches for k in KERNELS}
    assert launches == before, (before, launches)


# phase 11: imported artifacts
IMPORTED_BATCH = 256         # the Perch replica through predict_topk
SERVED_BATCH = 16            # the installed v2.4 replica's batch in the loop
SERVED_STREAMS = 64
SERVED_TICKS = 4
ANALYZE_SECONDS = 30         # analyze --checkpoint: 10 windows of 3 s
# card against CPU on the replicas, in float32 with TF32 allowed: the
# largest difference over the output's largest magnitude (predicted in
# PERF.md before the first run)
CARD_CPU_REL = 1e-5


def golden_gap(name: str, values: np.ndarray, atol: float,
               rtol: float = 1e-3) -> tuple[float, float]:
    """`values` against ``tests/golden/<name>.json`` as
    ``tests/test_golden_parity.py::_golden_check`` compares them (the
    norm within rtol, the 64 sampled values within atol + rtol·|v|), read
    only; returns (the norm's relative gap, the largest sample gap)."""
    want = json.loads((REPO / "tests" / "golden" / f"{name}.json"
                       ).read_text())
    flat = np.asarray(values, np.float64).ravel()
    assert want["shape"] == list(np.asarray(values).shape), name
    norm = abs(float(np.linalg.norm(flat)) - want["norm"]) / want["norm"]
    sample = np.asarray(want["sample"])
    gap = np.abs(flat[np.asarray(want["sample_idx"])] - sample)
    assert norm <= rtol, (name, norm)
    assert (gap <= atol + rtol * np.abs(sample)).all(), (name, gap.max())
    return norm, float(gap.max())


def _card_and_cpu(path: Path, model_id: str, x: np.ndarray, dev):
    """The artifact through ``load_model`` on the card, with cuDNN and
    cuBLAS allowed TF32 (the executors must turn it off), and on the CPU:
    (card logits, CPU logits, the card's model). Also prints what the card
    gives with the executors' guard taken out."""
    cpu = load_model(model_id, checkpoint=str(path))
    card = load_model(model_id, checkpoint=str(path)).to(dev)
    xd = torch.from_numpy(x).to(dev)
    with torch.inference_mode():
        want = cpu.apply(x)["logits"].numpy()
        with _tf32_allowed():
            got = card.apply(xd)["logits"].cpu().numpy()
            with _unguarded():
                bare = card.apply(xd)["logits"].cpu().numpy()
    scale = float(np.abs(want).max())
    return got, want, card, float(np.abs(bare - want).max()) / scale


@contextlib.contextmanager
def _tf32_allowed():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@contextlib.contextmanager
def _unguarded():
    """The graph executors without their float32 guard: what TF32 does to
    an imported graph on this card."""
    saved = tflite_import.full_float32, onnx_import.full_float32
    tflite_import.full_float32 = onnx_import.full_float32 = \
        contextlib.nullcontext
    try:
        yield
    finally:
        tflite_import.full_float32, onnx_import.full_float32 = saved


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _run_cli(argv: list[str], env: dict | None = None) -> str:
    """``python -m birdnet_go_tpu_torch`` in a process of its own; its
    standard output (exit 0 required)."""
    res = subprocess.run([sys.executable, "-m", "birdnet_go_tpu_torch",
                          *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, (argv, res.stdout[-2000:],
                                 res.stderr[-4000:])
    return res.stdout


def phase_imported(dev: torch.device, card: str) -> None:
    """Imported .tflite and .onnx artifacts on the card (see the module
    docstring, phase 11). None of the three kernels launches."""
    root = REPO / "build" / "import_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for k in KERNELS:
        k.launches = 0

    # the v2.4 replica at batch 1, the JAX test's two tones
    t0 = time.monotonic()
    v24 = root / "v24_b1.tflite"
    v24.write_bytes(replicas.v24_tflite(np.random.default_rng(424)))
    x = replicas.two_tones()[None, :]
    got, want, card24, bare = _card_and_cpu(v24, "BirdNET_V2.4", x, dev)
    assert got.shape == (1, replicas.NUM_SPECIES) and np.isfinite(got).all()
    norm, gap = golden_gap("v24_fullscale_replica_logits", got, atol=1e-4)
    rel = _rel(got, want)
    xd = torch.from_numpy(x).to(dev)
    with torch.inference_mode():
        card24.apply(xd)
        ms = [event_ms(lambda: card24.apply(xd)) for _ in range(REPS)]
    print(f"imported v2.4 replica ({v24.stat().st_size} bytes, built and "
          f"loaded in {time.monotonic() - t0:.2f} s) at batch 1 on the card, "
          f"TF32 allowed: golden v24_fullscale_replica_logits norm gap "
          f"{norm:.3e} (<= 1e-3), sample gap {gap:.3e} (<= 1e-4 + 1e-3|v|); "
          f"card vs CPU max rel err {rel:.3e} (<= {CARD_CPU_REL:g}; without "
          f"the executors' float32 guard {bare:.3e}); forward "
          f"{np.median(ms):.4f} ms [{min(ms):.4f}, {max(ms):.4f}] (median "
          f"[min, max] of {REPS}, CUDA events) [{card}]")
    assert rel <= CARD_CPU_REL, "v2.4 replica: card vs CPU"
    del card24

    # the Perch v2-scale ONNX: batch 1 against its golden, then batch 256
    # through TorchClassifier.predict_topk against the CPU
    rng = np.random.default_rng(99)
    perch = root / "perch.onnx"
    perch.write_bytes(replicas.perch_onnx(rng))
    mel = rng.standard_normal(replicas.PERCH_MEL).astype(np.float32)
    got, want, card_p, bare = _card_and_cpu(perch, "Perch_V2", mel, dev)
    norm, gap = golden_gap("perch_fullscale_onnx_logits", got, atol=1e-4)
    rel = _rel(got, want)
    big = np.random.default_rng(SEED + 20).standard_normal(
        (IMPORTED_BATCH,) + replicas.PERCH_MEL[1:]).astype(np.float32)
    clf = TorchClassifier(card_p, dev)
    assert clf.num_species == replicas.PERCH_SPECIES
    big_d = torch.from_numpy(big).to(dev)
    with _tf32_allowed():
        vc, ic = clf.predict_topk(big_d)
        ms = [event_ms(lambda: clf.predict_topk(big_d)) for _ in range(REPS)]
    vp, ip = TorchClassifier(load_model("Perch_V2", checkpoint=str(perch)),
                             "cpu").predict_topk(big)
    conf_err = float(np.abs(vc - vp).max())
    apart = np.abs(np.diff(vp, axis=1)) > 1e-5
    print(f"imported Perch-scale ONNX ({perch.stat().st_size} bytes): batch "
          f"1 golden perch_fullscale_onnx_logits norm gap {norm:.3e}, sample "
          f"gap {gap:.3e}; card vs CPU max rel err {rel:.3e} (without the "
          f"guard {bare:.3e}); predict_topk [{IMPORTED_BATCH}, 1, 160, 128] "
          f"→ top-10 of {replicas.PERCH_SPECIES}: {np.median(ms):.4f} ms "
          f"[{min(ms):.4f}, {max(ms):.4f}] (input on the card, results "
          f"back on the host), top-10 confidences card vs CPU max diff "
          f"{conf_err:.3e} (<= 1e-5), indices equal where apart "
          f"({int(apart.sum())} of {apart.size} gaps > 1e-5) [{card}]")
    assert rel <= CARD_CPU_REL and conf_err <= 1e-5
    assert vc.shape == (IMPORTED_BATCH, 10)
    assert (ic[:, :-1][apart] == ip[:, :-1][apart]).all()
    del card_p, clf, big_d

    # the float16 MData range filter
    rng = np.random.default_rng(77)
    mdata = root / "mdata.tflite"
    mdata.write_bytes(replicas.mdata_tflite(rng))
    feats = rng.standard_normal((1, 96)).astype(np.float32)
    got, want, _, _ = _card_and_cpu(mdata, "Geomodel", feats, dev)
    norm, gap = golden_gap("mdata_fullscale_scores", got, atol=1e-3)
    rel = _rel(got, want)
    print(f"imported MData float16 replica: golden mdata_fullscale_scores "
          f"norm gap {norm:.3e}, sample gap {gap:.3e} (<= 1e-3); card vs "
          f"CPU max rel err {rel:.3e} [{card}]")
    assert rel <= CARD_CPU_REL

    # the v2.4 replica built at batch 16, installed, served by the loop
    home = root / "models"
    (home / "BirdNET_V2.4").mkdir(parents=True)
    (home / "BirdNET_V2.4" / "model.tflite").write_bytes(
        replicas.v24_tflite(np.random.default_rng(424), batch=SERVED_BATCH))
    prev_home = os.environ.get("BIRDNET_TPU_MODELS")
    os.environ["BIRDNET_TPU_MODELS"] = str(home)
    try:
        served = load_model("BirdNET_V2.4")
    finally:
        if prev_home is None:
            del os.environ["BIRDNET_TPU_MODELS"]
        else:
            os.environ["BIRDNET_TPU_MODELS"] = prev_home
    assert isinstance(served, ImportedModel)
    assert served.num_species == replicas.NUM_SPECIES
    with _tf32_allowed():
        launches, batches, _ = phase_loop(served, dev, card, SERVED_STREAMS,
                                          SERVED_TICKS, batch=SERVED_BATCH)
    assert batches == SERVED_STREAMS * SERVED_TICKS // SERVED_BATCH
    del served

    # the CLI, each command in its own process
    env = dict(os.environ, BIRDNET_TPU_MODELS=str(root / "empty"))
    gold = root / "golden"
    lines = []
    for want_status in ("recorded", "match"):
        t0 = time.monotonic()
        out = _run_cli(["verify-artifact", str(v24), "--golden", str(gold)],
                       env)
        fields = {ln[:12].strip(): ln[12:] for ln in out.splitlines()}
        assert fields["golden"] == want_status, out
        assert out.splitlines()[-1] == "PASS", out
        lines.append(f"{want_status} in {time.monotonic() - t0:.2f} s")
    audit = _run_cli(["verify-artifact", "--audit"], env)
    rows = audit.strip().splitlines()
    assert audit.strip() == audit_table() and len(rows) > 2
    assert all(r.endswith("— (ready) |") for r in rows[2:]), audit
    wav = root / "field48k.wav"
    write_pcm16(wav, field_recording(ANALYZE_SECONDS, 48000, 1, SEED + 21),
                48000)
    out_dir = root / "out"
    t0 = time.monotonic()
    text = _run_cli(["analyze", str(wav), "--checkpoint", str(v24),
                     "--batch-size", "1", "--threshold", "0", "--rtype",
                     "both", "--output", str(out_dir)], env)
    n_win, n_det, elapsed, _ = _summary(text, wav.name)
    n = ANALYZE_SECONDS // 3
    assert n_win == n_det == n, text
    _check_tables(out_dir, wav.name, n, 3.0)
    print(f"CLI on the imported v2.4 replica, each command its own process: "
          f"verify-artifact {fields['fingerprint'][:16]}… "
          f"{', then '.join(lines)}, PASS; verify-artifact --audit equals "
          f"the audit table; analyze --checkpoint --batch-size 1 on "
          f"{ANALYZE_SECONDS} s of 48 kHz: {n_win} windows, {n_det} rows in "
          f"the Raven table and the CSV, analysis {elapsed:.2f} s, process "
          f"{time.monotonic() - t0:.2f} s with start-up [{card}]")

    launches = {k.__name__: k.launches for k in KERNELS}
    print(f"imported artifacts: kernel launches {launches} (none expected)")
    assert not any(launches.values()), launches


# phase 12: three tone classes (Hz), each TRAIN_FILES files of
# TRAIN_SECONDS (10 windows of 3 s); "low"'s first file is at 44.1 kHz
TRAIN_FREQS = {"high": 6000.0, "low": 700.0, "mid": 2500.0}
TRAIN_FILES = 6
TRAIN_SECONDS = 30
HELD_OUT = 8                 # held-out windows a class
TRAIN_ACCURACY = 0.9         # the trained checkpoint on held-out windows
TIMED_BATCHES = (16, 64)     # the full-width step, timed
TINY_STEPS = 3
# the float32 tiny step, card against CPU after TINY_STEPS: the largest
# parameter difference over the largest parameter magnitude (predicted in
# PERF.md before the first run)
TINY_GAP = 1e-4
_STEP = re.compile(r"^step (\d+): loss=([\d.]+) grad_norm=([\d.]+)$", re.M)
_VALIDATION = re.compile(
    r"^validation: accuracy=([\d.]+) loss=([\d.]+) \(n=(\d+)\)$", re.M)


def tone_windows(n: int, seconds: float, rate: int, freq: float,
                 seed: int) -> np.ndarray:
    """float32 [n, seconds·rate]: a tone within 5% of `freq` at -26 dBFS
    with a random phase over -40 dBFS white noise, one draw a row."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f = freq * rng.uniform(0.95, 1.05, (n, 1))
    x = 0.05 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi, (n, 1)))
    return (x + rng.standard_normal(x.shape) * 0.01).astype(np.float32)


def _train_batch(batch: int, seed: int, dev) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """A batch of the three classes' tones and one-hot labels on `dev`."""
    names = sorted(TRAIN_FREQS)
    labels = np.arange(batch) % len(names)
    pcm = np.concatenate([tone_windows(1, 3.0, 48000,
                                       TRAIN_FREQS[names[c]], seed + i)
                          for i, c in enumerate(labels)])
    return (torch.from_numpy(pcm).to(dev),
            torch.from_numpy(np.eye(len(names), dtype=np.float32)[labels]
                             ).to(dev))


def _max_rel_gap(a: torch.nn.Module, b: torch.nn.Module) -> float:
    sa = {k: v.detach().cpu() for k, v in a.state_dict().items()}
    sb = b.state_dict()
    gap = max(float((sa[k] - sb[k]).abs().max()) for k in sb)
    return gap / max(float(v.abs().max()) for v in sb.values())


def phase_train(dev: torch.device, card: str) -> None:
    """Training and the model gallery on the card (see the module
    docstring, phase 12). None of the three kernels launches."""
    root = REPO / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    for k in KERNELS:
        k.launches = 0
    names = sorted(TRAIN_FREQS)
    seed = SEED + 30
    for name in names:
        (root / "ds" / name).mkdir(parents=True)
        for i in range(TRAIN_FILES):
            rate = 44100 if (name, i) == ("low", 0) else 48000
            x = tone_windows(1, TRAIN_SECONDS, rate, TRAIN_FREQS[name], seed)
            write_pcm16(root / "ds" / name / f"{i}.wav",
                        np.clip(x.T * 32767, -32768, 32767).astype(np.int16),
                        rate)
            seed += 1

    # train at full width in a process of its own
    ckpt = root / "ckpt"
    t0 = time.monotonic()
    out = _run_cli(["train", str(root / "ds"), "--output", str(ckpt),
                    "--batch-size", "16"])
    proc_s = time.monotonic() - t0
    per_class = TRAIN_FILES * TRAIN_SECONDS // 3
    n_val = len(names) * max(1, round(per_class * 0.1))
    n_train = len(names) * per_class - n_val
    lines = out.splitlines()
    assert lines[0] == (f"dataset: {n_train} train / {n_val} val windows, "
                        f"{len(names)} classes: {names}"), out
    steps = [(int(m[0]), float(m[1]), float(m[2]))
             for m in _STEP.findall(out)]
    n_steps = n_train // 16 * 10
    assert [s[0] for s in steps] == list(range(1, n_steps + 1, 10)), out
    val_acc, val_loss, val_n = _VALIDATION.search(out).groups()
    assert lines[-1] == (f"trained {n_steps} steps; checkpoint + labels "
                         f"written to {ckpt}"), out
    assert json.loads((ckpt / "labels.json").read_text()) == names
    print(f"train, full-width v2.4 (B0, bf16, 3 classes), its own process: "
          f"{n_train} windows (one file resampled from 44.1 kHz), "
          f"{n_steps} steps of batch 16; loss {steps[0][1]:.4f} at step 1 → "
          f"{steps[-1][1]:.4f} at step {steps[-1][0]} (grad norm "
          f"{steps[0][2]:.3f} → {steps[-1][2]:.3f}); validation accuracy "
          f"{val_acc} loss {val_loss} (n={val_n}); process "
          f"{proc_s:.2f} s [{card}]")
    assert steps[-1][1] < steps[0][1], "train: the loss did not fall"

    # the checkpoint served on the card, on held-out tones
    model = load_model("BirdNET_V2.4", checkpoint=str(ckpt)).to(dev)
    assert isinstance(model, BirdNETv24) and model.num_species == 3
    held = np.concatenate([tone_windows(HELD_OUT, 3.0, 48000,
                                        TRAIN_FREQS[n], SEED + 90 + c)
                           for c, n in enumerate(names)])
    want = np.repeat(np.arange(len(names)), HELD_OUT)
    with torch.inference_mode():
        logits = model.apply(torch.from_numpy(held).to(dev))["logits"]
    assert torch.isfinite(logits).all()
    acc = float((logits.argmax(-1).cpu().numpy() == want).mean())
    print(f"trained checkpoint served by load_model on the card: held-out "
          f"accuracy {acc:.3f} over {len(want)} windows (>= "
          f"{TRAIN_ACCURACY}) [{card}]")
    assert acc >= TRAIN_ACCURACY, "train: held-out accuracy"
    del model

    # the full-width step (forward, backward, AdamW), timed
    for batch in TIMED_BATCHES:
        # what earlier phases left allocated, apart from the step's peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        model = BirdNETv24(num_species=len(names)).init(
            torch.Generator().manual_seed(SEED)).to(dev)
        state = init_train_state(model, 1e-3)
        step = make_train_step(model.apply, train=False)
        pcm, labels = _train_batch(batch, SEED + 40, dev)
        for _ in range(3):
            step(state, pcm, labels)
        ms = [event_ms(lambda: step(state, pcm, labels))
              for _ in range(REPS)]
        _, metrics = step(state, pcm, labels)
        assert np.isfinite(float(metrics["loss"]))
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(ms))
        print(f"train step, full-width v2.4 bf16 [{batch}, {CLIP}] (forward, "
              f"backward, AdamW): {med:.4f} ms [{min(ms):.4f}, "
              f"{max(ms):.4f}] (median [min, max] of {REPS}, CUDA events), "
              f"{batch / med * 1e3:.1f} windows/s trained, peak memory "
              f"{peak / 2**30:.3f} GiB (max_memory_allocated), "
              f"{(peak - held) / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held before the model [{card}]")
        del model, state, step, pcm, labels, metrics

    # the float32 tiny step, card against CPU, from the same weights
    cpu = cli._tiny_v24(3).init(torch.Generator().manual_seed(SEED))
    on_card = copy.deepcopy(cpu).to(dev)
    states = [init_train_state(m, 3e-3) for m in (cpu, on_card)]
    stepfns = [make_train_step(m.apply, train=False) for m in (cpu, on_card)]
    loss_gap = 0.0
    with full_float32():
        for i in range(TINY_STEPS):
            pcm, labels = _train_batch(4, SEED + 50 + 4 * i, "cpu")
            _, mc = stepfns[0](states[0], pcm, labels)
            _, mk = stepfns[1](states[1], pcm.to(dev), labels.to(dev))
            loss_gap = max(loss_gap, abs(float(mk["loss"]) -
                                         float(mc["loss"])) /
                           float(mc["loss"]))
    gap = _max_rel_gap(on_card, cpu)
    print(f"train --tiny float32 step, card against CPU over {TINY_STEPS} "
          f"steps from the same weights, TF32 off: parameters max rel gap "
          f"{gap:.3e} (<= {TINY_GAP:g}), loss max rel gap {loss_gap:.3e} "
          f"[{card}]")
    assert gap <= TINY_GAP, "train: the tiny step on the card vs the CPU"

    # the model gallery, each command in its own process
    replica = root / "v24.tflite"
    replica.write_bytes(replicas.v24_tflite(np.random.default_rng(424)))
    home = root / "models"
    env = dict(os.environ, BIRDNET_TPU_MODELS=str(home))
    dest = home / "BirdNET_V2.4" / "model.tflite"
    out = _run_cli(["model", "install", "BirdNET_V2.4", "--from-file",
                    str(replica)], env)
    assert out == f"installed to {dest}\n", out
    assert dest.read_bytes() == replica.read_bytes()
    staged = len(list((home / "BirdNET_V2.4" / "labels").glob("*.txt")))
    listing = _run_cli(["model", "list"], env).splitlines()
    assert listing == [f"{'model':<18} {'installed':<10} description"] + [
        f"{e.model_id:<18} "
        f"{'yes' if e.model_id == 'BirdNET_V2.4' else '-':<10} "
        f"{e.description}" for e in catalog_entries()], listing
    assert _run_cli(["model", "remove", "BirdNET_V2.4"], env) == \
        "removed\n"
    assert not (home / "BirdNET_V2.4").exists()
    print(f"model gallery, each command its own process: install "
          f"--from-file of the v2.4 replica ({replica.stat().st_size} bytes, "
          f"{staged} label files staged), list ({len(listing) - 1} entries, "
          f"BirdNET_V2.4 installed), remove: the JAX command's lines")

    launches = {k.__name__: k.launches for k in KERNELS}
    print(f"training: kernel launches {launches} (none expected)")
    assert not any(launches.values()), launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    t0 = time.monotonic()
    phase_device(card)
    phase_build()
    main_path = {"melspec_fused": phase_kernel(dev, card)}
    mbconv = phase_mbconv(dev, card)
    # the MBConv kernels' launches are counted on the v3.0 loop, so their
    # times and errors in the kernels line are those of a v3.0 step
    main_path.update(mbconv[BirdNETv3.spec.model_id])
    assert sum(n for _, n in fused_block_shapes(BirdNETv3)) == V3_FUSED
    phase_slice(dev, card)
    # v2.4 as the server runs it (unfused blocks): the mel kernel's path
    v24 = BirdNETv24().init(torch.Generator().manual_seed(SEED))
    launches, _, python_wps = phase_loop(v24, dev, card, N_STREAMS,
                                         N_TICKS)
    # v3.0 with fused blocks: the MBConv kernels' path
    v3 = BirdNETv3().init(torch.Generator().manual_seed(SEED))
    v3.fused_blocks = True
    fused, batches, _ = phase_loop(v3, dev, card, V3_STREAMS, V3_TICKS)
    for name in ("expand_dw_pool", "scale_project"):
        assert fused[name] == V3_FUSED * batches, (fused, batches)
        launches[name] = fused[name]
    del v3
    # v2.4 fed by the native stream farm, then the bat and BSG families,
    # then the range filter and its mask on the v2.4 step
    phase_farm(v24, dev, card, python_wps, FARM_TIMESCALE, keep_up=False)
    phase_farm(v24, dev, card, python_wps, FARM_KEEP_UP, keep_up=True)
    phase_families(dev, card)
    phase_range(dev, card, v24)
    del v24
    phase_offline(dev, card)
    phase_imported(dev, card)
    phase_train(dev, card)
    print(f"total {time.monotonic() - t0:.1f} s")
    print(f"kernels line: melspec_fused at the v2.4 main path's [{BATCH}, "
          f"{CLIP}] bf16; expand_dw_pool and scale_project summed over the "
          f"{V3_FUSED} fused blocks of one v3.0 step [{BATCH}, {CLIP32}] "
          f"bf16 (ms, plain_ms, bound_ms) and their largest error there; "
          f"ms and plain_ms by CUDA events around one call (the wrapper's "
          f"host work included), device_ms and plain_device_ms by replaying "
          f"a CUDA graph of 10 calls (diag/timing.py); bound_ms from the "
          f"*_work counts at H100 SXM peaks (ops/roofline.py)")
    sources = {"melspec_fused": ("melspec.cu", "pallas_melspec.py:149"),
               "expand_dw_pool": ("mbconv.cu", "pallas_mbconv.py:87"),
               "scale_project": ("mbconv.cu", "pallas_mbconv.py:168")}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"birdnet_go_tpu_torch/csrc/{src}",
        "replaces": f"birdnet_go_tpu/ops/{tpu}",
        "launches": launches[name], **main_path[name]}
        for name, (src, tpu) in sources.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
