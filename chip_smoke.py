#!/usr/bin/env python3
"""Drive the PyTorch port's realtime device step on one CUDA card: BirdNET
v2.4 (EfficientNet-B0), and BirdNET v3.0 and Perch v2 (B1) through the fused
MBConv kernels; then its offline analysis and CLI, imported .tflite and
.onnx artifacts, custom-classifier training with the model gallery, int8
quantization with mesh-sharded serving, the whole realtime server in a
2,000-stream soak, the clip and aux planes (spectrograms, sound levels,
clip export, live HLS) with the soak's kitchen-sink leg, the realtime
app and ``serve``, crash recovery: a durable soak SIGKILLed on the card,
recovered and restarted, the REST/SSE API with its device handlers
driven over HTTP, live RTSP sources: 2,000 sessions into the soak and
the app on the port's RTSP client, the integrations: MQTT,
BirdWeather, weather, eBird, backups and MySQL against loopback fakes,
and the importers and native codecs: BirdNET-Pi and BirdNET-Go imports
over the API, Opus/AAC/MP3 clips, live Opus and AAC HLS.

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
   blocks, as in the JAX package;
13. int8 and meshes (``phase_int8``), bf16 unless stated, on field-level
   audio: the ``act_int8`` step of v2.4 (unfused) and of v3.0 (fused
   blocks) at [256, T], their launches (mel 1; A and B 13 on v3.0), the
   CPU's boundary step on the same weights (8 rows) and the gap to the
   step without the boundary against JAX's contract, both steps timed;
   the int8 PTQ backbone of v2.4 (``ops/quant.py``) calibrated on two
   batches of 32 and run on the mel kernel's float32 features, every int8
   conv's int32 sums equal to the CPU's on the same int8 input, its
   logits the CPU's within ``INT8_LOGIT_GAP``, against bf16 (printed) and
   timed; ``apply_dense_int8`` at 1280 → 6522 and 1280 → 14795 under
   JAX's head gate, timed against the bf16 ``Dense``; ``ShardedClassifier``
   on ``make_mesh()`` and on meshes that list the card 2, 2 and 4 times
   (2x1, 1x2, 2x2) against ``TorchClassifier`` on a ragged batch of 255
   (gated in float32, printed in bf16), and a ``TorchModelBatcher``
   serving the 2x2 mesh through ``DeviceLoop`` (the mel kernel twice a
   batch, one launch per data row). No exception is caught and nothing
   falls back to the CPU or to a float product;
14. the full-pipeline soak (``phase_soak``): the v2.4 unfused int16 step
   timed at B = 64 and 256 (the stub's latency model, ``base_ms`` and
   ``per_window_us``), then ``python -m birdnet_go_tpu_torch soak
   --device cuda --streams 2000 --seconds 30`` in its own process: the
   native stream farm, ``DeviceLoop``, the device step, the ``Processor``,
   ``FlushLoop``, the job queue with the realistic action mix and a SQLite
   file under ``build/soak_smoke/``. It must exit 0 (no sample lost, no
   window dropped, no critical job dropped), hold latency p95 from each
   window's realtime end below 1,500 ms and steady windows/s at 0.95 of
   those offered, calibrate a threshold, persist every approval (the
   db's rows), and launch the mel kernel once for every batch;
15. the clip and aux planes (``phase_aux``): whether Pillow imports;
   spectrograms (bird: 3 s at 48 kHz, widths 400 and 800; bat: 1 s at
   256 kHz) on the card and on the CPU, the colour index within 1 level at
   no more than 1e-3 of the pixels, each PNG inflated with zlib equal to
   the array, the device part's CUDA-event time and ``generate_png``'s
   wall time; ``SoundLevelWorker.sample_once`` over 64 sources of 10 s at
   48 kHz on the card and the CPU, the raw levels within 0.05 dB, ms a
   pass; a 256 kHz capture exported by ``SaveAudioAction`` (downsampled to
   48 kHz, normalised) as FLAC that decodes bit for bit to the PCM
   encoded, and the file an ``.opus`` request writes; four 2 s FLAC HLS
   segments that each decode to the captured PCM; then the soak again with
   ``--kitchen-sink`` (every aux plane in the soak's process, its device
   work on the card), with phase 14's gates and no aux error, at least 20
   HLS segments, 40 sound-level and LUFS blocks and 20 renders (none
   dropped), and a migration copying with dual-write installed; its
   numbers printed beside phase 14's. The aux planes launch none of the
   three kernels;
16. the realtime app and ``serve`` (``phase_app``): ``probe_backend`` names
   the card and raises with the card hidden from its child; then, in a
   process of its own (``app_leg``), ``Application`` on the card at full
   width, its API off: 48 tone and 16 file sources, BirdNET v2.4 (batch 256)
   alone for 12 s, with v3.0 loaded at runtime for 15 s, then 5 s after
   v3.0's unload; the range filter at a fixed place, Deep Detection level
   2, dynamic thresholds, FLAC clips and PNGs, a SQLite file under
   ``build/app_smoke/``, thresholds calibrated as the soak's. Every window
   the engine made is served (none dropped, no overrun), v2.4's latency
   p95 stays below 1,500 ms across the load, v3.0 is served after its
   load and not after its unload, the mel kernel launches once a batch
   (and once a warm-up), approvals = rows, every clip decodes and has its
   PNG, every health check is ok, the range filter's card set is the
   CPU's, no critical job is dropped, ``stop()`` returns within 15 s and
   nothing is logged at ERROR; then ``python -m birdnet_go_tpu_torch
   serve --config app.json`` over 8 tone sources with its API on
   127.0.0.1, which answers ``/api/v2/health`` and names the card in
   ``/api/v2/system/info``, stopped by SIGTERM, exits 0 with its probe and
   serving lines and rows in its db;
17. crash recovery (``phase_crash``): ``python -m
   birdnet_go_tpu_torch.scheduler.crashleg --device cuda --streams 2000
   --kill-min-rows 200 --restart-seconds 10`` in a process of its own
   (record, tree and logs under ``build/crash_smoke/``): a durable soak
   of v2.4 at full width on the card SIGKILLed once 200 rows and a
   learned threshold have landed, ``recover_startup`` twice, then a 10 s
   restart leg on the card in the recovered database. Gated on the
   record's ``pass``, the kill, no process of the victim's left, the
   ledger (integrity, no duplicate, a threshold restored, a species
   resynced), idempotency, ``after == before + persisted``, no sample or
   critical job lost, p95 below 1,500 ms, the mel kernel once a batch;
   then ``recover --ignore-recency`` (nothing left to heal), ``db
   doctor`` (healthy) and ``support`` (its ``system.json`` names the
   card) on the tree the leg left;
18. the API (``phase_api``): in a process of its own (``api_leg``,
   ``build/api_smoke/``), ``Application`` on the card at full width with
   its API on 127.0.0.1 behind a password: 16 tone and 4 file sources,
   v2.4 at batch 256 for 30 s, with clients held on the detection and
   sound-level SSE streams while a logged-in client walks
   ``diag/api_walk.py`` twice (v3.0 loaded and, 10 s later, unloaded over
   HTTP; a range heatmap of 90 x 180 points; a spectrogram rendered on
   a cache miss; a clip's Range; HLS; a settings PATCH; the metrics and
   the SPA), then blocks of 6 heatmaps in turns, on the range filter's
   stream into pinned memory and on the served step's stream with a
   pageable copy; the v2.4 latency during each request and block is
   printed. Every status as the walk holds it, ``system/info`` naming
   the card, the heatmap within 1e-5 a score of the CPU's Geomodel, the
   PNG the card's render and its index the CPU's to phase 15's
   tolerance, the HLS segment the PCM it encodes bit for bit, SSE
   detection
   events = approvals = rows, no window dropped, v2.4's p95 below
   1,500 ms, the mel kernel once a batch and a warm-up, ``stop()``
   within 15 s with both SSE clients connected, nothing logged at ERROR;
   each route's p50/p95 printed. Each HLS segment ends in no more than
   0.60 s of zeros, and the largest gap between two returns of a
   source's ``engine.ingest`` during v3.0's loads is within one tick of
   the largest outside every request, and no closing of the engine's
   gate, from any thread, met a warm-up (a warm-up holds the gate open
   and a tick waits for it; v2.4's largest latency during each load is
   printed);
19. live sources (``phase_live``): what the machine offers (the ALSA
   shim and its capture devices, ``ffmpeg``, ``ffprobe``; no leg runs on
   them); then ``soak --device cuda --ingest rtsp`` over 2,000 realtime
   L16 sessions (48 kHz, 50 ms packets) from the port's
   ``RtspLoadServer`` over loopback TCP through one ``RtspDemux`` into
   the v2.4 step, with phase 14's gates, all 2,000 connected at the end,
   no restart, nothing dropped by the server and every sample sent
   received but one 50 ms packet a session in flight
   (``build/rtsp_soak_smoke/``);
   then, in a process of its own (``live_leg``, ``build/live_smoke/``),
   the app with its API on 127.0.0.1 and 32 ``rtsp`` sources on the
   port's native client (24 at 48 kHz, 8 at 44.1 kHz, so the engine
   resamples) from two load servers, v2.4 at batch 256 for 30 s, v3.0
   loaded over HTTP at 10 s and unloaded at 20 s: every window served,
   v2.4's p95 below 1,500 ms, the largest ingest stall during the load
   within one tick of the largest outside it and no closing of the
   engine's gate beside a warm-up (``_gate_record``, which also prints
   how much of the largest stalls the gate was closed and a garbage
   collection ran), nothing dropped by the
   servers, no restart, every source's samples ingested but 0.25 s in
   flight, approvals = rows, the mel kernel once a batch and a warm-up,
   health ok, ``stop()`` within 15 s, nothing logged at ERROR;
20. the integrations (``phase_integrations``): ``cryptography`` present;
   the fake services (``python -m birdnet_go_tpu_torch.diag.fake_services``:
   an MQTT broker with a subscriber recording each message and its
   arrival, ``diag/mysql_server.py`` with caching_sha2 and RSA full auth
   on the first connect, loopback BirdWeather, yr.no and eBird recording
   their requests, an OIDC provider, an ACME directory and Cloudflare
   Access's key endpoint over HTTPS, with a CA of their own) in a process
   of their own; then, in another (``integrations_leg``,
   ``build/integrations_smoke/``, trusting the fakes' CA through
   ``SSL_CERT_FILE``), the app with its API behind a password, 16 tone
   and 4 file sources, v2.4 unfused at batch 256, MQTT (retained, Home
   Assistant discovery), BirdWeather (its client's base URL set after
   ``setup``), yr.no weather polled at start, sound levels and eBird on;
   leg 1 serves 20 s on MySQL over HTTP and obtains an ACME certificate
   for ``localhost`` while it serves (the directory validates through the
   app's own challenge route); leg 2 serves 15 s on SQLite with
   encrypted backups, over HTTPS on that cached certificate
   (``tls_mode: acme``), with the OIDC, GitHub and Cloudflare logins;
   each leg walks ``diag/api_walk.integrations_walk`` once (leg 2's
   backup run is its backup), leg 2 then ``logins_walk`` (an OIDC login,
   a Cloudflare token and a forged one, GitHub's redirect and a wrong
   state, each TLS route, the terminal over ``wss://``) and leaves a
   terminal open across ``stop()``. Gated: every window served, none
   dropped, v2.4's p95 below 1,500 ms, the mel kernel once a batch and a
   warm-up, every walked status, ``stop()`` within 15 s, nothing logged
   at ERROR; leg 1: approvals = the server's rows = MQTT detection
   messages = SSE events (each = the event tracker's passes),
   BirdWeather's POSTs = its passes, the Home Assistant configs
   retained, a sound-level message an interval, an hourly weather row in
   MySQL, the ACME certificate validated through the app; leg 2: the
   archive verifies with its passphrase, holding the rows committed
   before the request; the certificate served is leg 1's (a client that
   trusts only the fakes' CA verifies it), one ACME order in all, plain
   HTTP to the port fails, the OIDC login ends authenticated, the
   Cloudflare token is served and the forged one refused, the terminal
   reads its size and markers back, closes with 1000, refuses another
   origin, gets 1001 at ``stop()``, and no shell of it is left after
   5 s. Printed: each leg's v2.4 p50/p95/max beside phase 18's (and
   during leg 2's walk), a row's time from approval to commit and a
   detection's to the MQTT subscriber, the backup's wall time, bytes and
   the latency during it, the MQTT and job-queue threads' CPU, the TLS
   handshake and a ping over HTTP and HTTPS (p50, p95), the ACME order's
   and the OIDC login's wall time, the terminal's echo round trips and
   ``cryptography``'s version.
21. the importers and the native codecs (``phase_codecs_imports``):
   what the machine offers (``find_library`` of opus, mp3lame and
   avcodec, ``avcodec_version()``, the port's ``opus_available()``,
   ``mp3_available()``, ``aacenc.available()``; its codec library built
   from ``csrc/codecs.cpp`` with g++ and no codec header); for each codec
   offered, a 6 s tone over noise at 48 kHz through the port and back
   (Opus: Ogg CRCs, its length, SNR above 25 dB; AAC: an ``.m4a`` loading
   at its length, correlation above 0.99; MP3: frame sync and length);
   then, in a process of its own (``codecs_leg``, ``build/codecs_smoke/``),
   the app with its API, 16 tone sources, v2.4 unfused at batch 256,
   clips in the first lossy codec offered (``flac`` without one), 30 s
   served, while ``imports/birdnet-pi`` takes a 10,000-row ``BirdDB.txt``
   (polled until completed), takes it again (every row skipped),
   ``imports/birdnet-go`` a 2,000-note database with results, reviews,
   comments and locks, ``audio/live/tone0?format=opus`` is read 2 s and
   an HLS session runs. Gated: every window served, none dropped, v2.4's
   p95 below 1,500 ms, the mel kernel once a batch and a warm-up, the
   import counts and the database's rows, results, reviews, comments and
   locks, every approval's clip in the chosen format decoding to its
   length, the live Ogg pages and their granule, AAC HLS decoding where
   AAC is offered, ``stop()`` within 15 s, nothing logged at ERROR.
   Printed: import rows/s, v2.4's latency during the imports and outside
   them, each codec's encode ms a clip.

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
import dataclasses
import datetime
import functools
import gc
import importlib
import io
import json
import os
import re
import shutil
import signal
import socket
import sqlite3
import ssl
import struct
import subprocess
import sys
import tarfile
import threading
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from birdnet_go_tpu_torch import native
from birdnet_go_tpu_torch.analysis.offline import (
    OfflineAnalyzer,
    OfflineConfig,
)
from birdnet_go_tpu_torch.analysis.actions import SaveAudioAction
from birdnet_go_tpu_torch.analysis.raven import format_csv, format_raven_table
from birdnet_go_tpu_torch.analysis.soundlevel_worker import SoundLevelWorker
from birdnet_go_tpu_torch.analysis.spectrogram import (
    FrequencyProfile,
    generate_png,
    render_spectrogram,
    spectrogram_index,
)
from birdnet_go_tpu_torch.audio import encode, hlsmux
from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer, CaptureBuffer
from birdnet_go_tpu_torch.audio.flac import decode_flac, streaminfo_block
from birdnet_go_tpu_torch.audio.hlsmux import HlsSession
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
    graph_ms,
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
from birdnet_go_tpu_torch.models import layers as L
from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.bsg import BSGFinland
from birdnet_go_tpu_torch.models.catalog import catalog_entries
from birdnet_go_tpu_torch.models.geomodel import Geomodel
from birdnet_go_tpu_torch.models.perch_v2 import PerchV2
from birdnet_go_tpu_torch.ops import _build, quant
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
from birdnet_go_tpu_torch.parallel import ShardedClassifier, make_mesh
from birdnet_go_tpu_torch.scheduler.loop import DeviceLoop, TorchModelBatcher
from birdnet_go_tpu_torch.taxonomy.labels import load_labels
from birdnet_go_tpu_torch.train.trainer import (
    init_train_state,
    make_train_step,
)
from birdnet_go_tpu_torch.utils.tracing import GLOBAL_SPANS

T_START = time.monotonic()
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
               n_ticks: int, batch: int = BATCH,
               classifier=None) -> tuple[dict, int, float]:
    """Returns each kernel's launches during the loop run, the number of
    batches and the loop's windows/s. A raw-rate (bat) model's streams
    carry ultrasound at its capture rate, and every window must come back
    with a finite ultrasonic CV. A mel-CNN model launches the mel kernel
    once a batch, and once a batch per data row when `classifier` (serving
    `model` in place of a ``TorchClassifier``) is a ``ShardedClassifier``;
    an imported graph (float32 PCM, no int16 path) launches none of the
    three kernels."""
    classifier = classifier or TorchClassifier(model, dev)
    rows = classifier.mesh.shape["data"] if hasattr(classifier, "mesh") \
        else 1
    batcher = TorchModelBatcher(classifier, max_batch=batch, top_k=10,
                                pipeline_depth=2)
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
    mel = batches * rows if hasattr(model, "apply_int16") else 0
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
             f"{'' if mel else ' imported graph'}"
             + (f" on a {'x'.join(map(str, classifier.mesh.shape.values()))}"
                f" mesh" if hasattr(classifier, "mesh") else ""))
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


# phase 13: int8 and meshes
INT8_CAL = (2, 32)           # calibration: 2 batches of 32 field-level windows
INT8_EXACT_ROWS = 16         # rows whose int32 sums are held to the CPU's
INT8_CPU_ROWS = 8            # rows of the int8 step held to the CPU's logits
# card vs CPU with the card's codes forced at every int8 quantization (the
# act_int8 boundaries; the int8 backbone's requantizations): the share of
# positions where the CPU's own code differs, a value one ulp apart on the
# two devices falling on the other side of a half step
INT8_FLIPS = 1e-2
# the int8 backbone so forced, card vs CPU: |dlogit| <= INT8_LOGIT_GAP x
# max(1, max|logit|) (the int32 sums are exact on both; the float32
# epilogues after the last requantization may differ by ulps)
INT8_LOGIT_GAP = 1e-2
MESH_STREAMS = 256
MESH_TICKS = 4
MESH_SPLITS = ((2, 1), (1, 2), (2, 2))


def _counted(fn):
    """fn() with each kernel's launches counted from 0."""
    for k in KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in KERNELS}


def _boundary_contract(a: torch.Tensor, b: torch.Tensor
                       ) -> tuple[float, int]:
    """(max post-sigmoid difference, least top-5 overlap of a row): JAX's
    contract for the boundary is < 0.02 and >= 4."""
    dconf = float((torch.sigmoid(a) - torch.sigmoid(b)).abs().max())
    ia = torch.topk(a, 5).indices.cpu().numpy()
    ib = torch.topk(b, 5).indices.cpu().numpy()
    return dconf, min(len(set(x) & set(y)) for x, y in zip(ia, ib))


def _bn_from_batch(model, pcm: torch.Tensor) -> None:
    """Set every BN's statistics to those of its input over the int16
    windows `pcm` (one forward with batch statistics), as a trained
    network's BN holds its inputs' statistics. With identity statistics the
    random-weight backbone's block outputs shrink with depth below half the
    boundary's step (8/127 · 1/2), so every code of the deep boundaries is
    0, and so are the logits: the boundary would be checked on zeros."""
    stats = {}

    def note(mod, args):
        stats[mod] = torch.var_mean(args[0].float(), dim=(0, 2, 3),
                                    correction=0)

    hooks = [m.register_forward_pre_hook(note) for m in model.modules()
             if isinstance(m, L.BatchNorm)]
    try:
        with torch.no_grad():
            model.apply(pcm16_to_float32(pcm), train=True)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for m, (var, mean) in stats.items():
            m.mean.copy_(mean)
            m.var.copy_(var)


def _observe_codes(fn, module, name: str, forced: list | None = None,
                   keep: bool = False):
    """fn() with every int8 quantization of the call through
    ``module.name`` observed (the act_int8 boundary's
    ``efficientnet.quantize_boundary``, the int8 backbone's
    ``quant.quantize_tensor``): (fn(), {"zero", "clipped": shares of codes 0
    and ±127; "codes": each call's codes if `keep`}). With `forced` (the
    codes of another run, in order), each call returns the forced codes in
    place of its own, and the stats also give the share of its own codes
    that differ ("flips") and the largest difference ("step")."""
    orig = getattr(module, name)
    it = iter(forced) if forced is not None else None
    tally = {"zero": 0, "clipped": 0, "n": 0, "flips": 0, "step": 0}
    codes = []

    def observed(*args):
        q = orig(*args)
        qi = q.to(torch.int16)
        tally["zero"] += int((qi == 0).sum())
        tally["clipped"] += int((qi.abs() == 127).sum())
        tally["n"] += q.numel()
        if it is not None:
            f = next(it).to(q.device)
            d = (qi - f.to(torch.int16)).abs()
            tally["flips"] += int((d > 0).sum())
            tally["step"] = max(tally["step"], int(d.max()))
            q = f
        if keep:
            codes.append(q)
        return q

    setattr(module, name, observed)
    try:
        out = fn()
    finally:
        setattr(module, name, orig)
    if it is not None:
        assert next(it, None) is None, "fewer quantizations than forced"
    n = tally["n"]
    return out, {"zero": tally["zero"] / n, "clipped": tally["clipped"] / n,
                 "flips": tally["flips"] / n, "step": tally["step"],
                 "codes": codes}


def _act_int8_step(model, pcm: torch.Tensor, fused: bool, dev, card: str,
                   want_launches: dict) -> None:
    """One `model` int16 step at [BATCH, T] with the int8 boundary on the
    card: its launches and codes; then the first INT8_CPU_ROWS rows on the
    card against the CPU's boundary step on the same weights, segment by
    segment: the CPU runs with the card's codes forced at every boundary,
    so that each block is held to the card's on the same int8 input. Gates:
    the CPU's own codes differ from the card's in at most INT8_FLIPS of the
    positions (a value one bf16 ulp apart on the two devices may fall on
    the other side of a half step, one code step, 8 ulps at |h| ~ 1), and
    the logits meet phase 5's bf16 gate. Printed: the CPU's free-running
    step (its own codes, where a flip propagates through the rest of the
    random-weight network), the gap to the card's step without the
    boundary against JAX's contract, and both steps' times."""
    name = f"{model.spec.model_id}{' fused blocks' if fused else ''}"
    model.fused_blocks = fused
    rows = pcm[:INT8_CPU_ROWS]
    with torch.inference_mode():
        model.act_int8 = True
        (out, full), launches = _counted(lambda: _observe_codes(
            lambda: model.apply_int16(pcm), efficientnet,
            "quantize_boundary"))
        card8, st8 = _observe_codes(lambda: model.apply_int16(rows),
                                    efficientnet, "quantize_boundary",
                                    keep=True)
        model.act_int8 = False
        plain = model.apply_int16(pcm)["logits"]
        cpu = _cpu_copy(model, torch.bfloat16)
        cpu.fused_blocks, cpu.act_int8 = fused, True
        free = cpu.apply_int16(rows.cpu())["logits"]
        want, forced = _observe_codes(
            lambda: cpu.apply_int16(rows.cpu()), efficientnet,
            "quantize_boundary", forced=[c.cpu() for c in st8["codes"]])
        del st8
    lq = out["logits"]
    assert lq.shape == plain.shape and torch.isfinite(lq).all()
    assert launches == want_launches, (name, launches)
    dcpu, ocpu = _agreement(card8["logits"].cpu(), want["logits"])
    dfree, ofree = _agreement(card8["logits"].cpu(), free)
    dq, oq = _boundary_contract(lq, plain)

    def step(on):
        model.act_int8 = on
        return _device_step(model, pcm, fused)

    with torch.inference_mode():
        t_plain, t_q = timed_pair(lambda: step(False), lambda: step(True))
    model.act_int8 = False
    print(f"act_int8 {name} bf16 [{BATCH},{pcm.shape[1]}]: launches "
          f"{launches}; codes {full['zero']:.4f} zero, "
          f"{full['clipped']:.2e} clipped; logits max |l| "
          f"{float(lq.abs().max()):.3f} ({float(plain.abs().max()):.3f} "
          f"without); card vs CPU [{INT8_CPU_ROWS}] block by block (the "
          f"card's codes forced): the CPU's own codes differ at "
          f"{forced['flips']:.3e} of the positions (<= {INT8_FLIPS}), by up "
          f"to {forced['step']} code, logits max post-sigmoid diff "
          f"{dcpu:.3e} (< 0.02), top-10 overlap {ocpu:.4f} (>= 0.9); "
          f"free-running {dfree:.3e}, {ofree:.4f}; vs the card's step "
          f"without the boundary: max post-sigmoid diff {dq:.3e}, least "
          f"top-5 overlap {oq}/5 (JAX's contract < 0.02, >= 4/5: "
          f"{'met' if dq < 0.02 and oq >= 4 else 'not met'}); step "
          f"{np.median(t_q):.4f} ms [{min(t_q):.4f}, {max(t_q):.4f}] against "
          f"{np.median(t_plain):.4f} ms [{min(t_plain):.4f}, "
          f"{max(t_plain):.4f}] without (median [min, max] of {REPS}) "
          f"[{card}]")
    assert forced["flips"] <= INT8_FLIPS, f"act_int8 {name}: code flips"
    assert dcpu < 0.02 and ocpu >= 0.9, f"act_int8 {name}: card vs CPU"


def _ptq_backbone(v24, pcm: torch.Tensor, dev, card: str) -> None:
    """The int8 PTQ backbone of v2.4: calibrated on field-level batches
    (float32, on the card), quantized, and run on the mel kernel's
    float32 features. Gates: every int8 conv's int32 sums on the card equal
    the CPU's on the same int8 input (the first INT8_EXACT_ROWS rows); and,
    with the card's codes forced at every requantization of the CPU's run
    (as for the boundary), the CPU's own codes differ in at most INT8_FLIPS
    of the positions (a float32 epilogue value one ulp apart on a half
    step) and the logits are the card's within INT8_LOGIT_GAP. Printed: the
    CPU's free-running logits, int8 against the bf16 and float32 backbones
    on the same mel with bf16 against float32 as the yardstick, and the int8
    and bf16 steps' times."""
    mel_of = lambda x: melspec_fused(                       # noqa: E731
        x, v24.mel, out_dtype=torch.float32)[..., None]
    with torch.inference_mode():
        cal = [mel_of(torch.from_numpy(pcm_batch(
            (INT8_CAL[1], CLIP), SEED + 20 + i)).to(dev))
            for i in range(INT8_CAL[0])]
    t0 = time.monotonic()
    scales = quant.calibrate_efficientnet(v24.backbone, cal)
    q = quant.quantize_efficientnet(v24.backbone, scales)
    q_cpu = copy.deepcopy(q)
    q.to(dev)
    t_quant = time.monotonic() - t0

    # the int32 sums, card against CPU, on the int8 input each conv got
    seen = []
    acc_i8 = quant._acc_i8

    def record(x_q, layer):
        acc = acc_i8(x_q, layer)
        seen.append((x_q, acc))
        return acc

    rows = INT8_CPU_ROWS
    with torch.inference_mode():
        mel = mel_of(pcm)
        quant._acc_i8 = record
        try:
            q(mel[:INT8_EXACT_ROWS])
        finally:
            quant._acc_i8 = acc_i8
        layers = quant.int8_layers(q_cpu)
        assert len(seen) == len(layers)
        n_values = 0
        for (x_q, acc), layer in zip(seen, layers):
            want = acc_i8(x_q.cpu(), layer)
            assert acc.dtype == torch.int32 and torch.equal(acc.cpu(), want), \
                "int8 backbone: int32 sums, card vs CPU"
            n_values += want.numel()
        del seen
        out, launches = _counted(lambda: q(mel_of(pcm)))
        lq = out["logits"]
        assert lq.shape == (BATCH, 6522) and torch.isfinite(lq).all()
        assert launches == {"melspec_fused": 1, "expand_dw_pool": 0,
                            "scale_project": 0}, launches
        card8, st8 = _observe_codes(lambda: q(mel[:rows]), quant,
                                    "quantize_tensor", keep=True)
        want, forced = _observe_codes(
            lambda: q_cpu(mel[:rows].cpu()), quant, "quantize_tensor",
            forced=[c.cpu() for c in st8["codes"]])
        del st8
        free = q_cpu(mel[:rows].cpu())["logits"]
        ref16 = v24.backbone(mel.to(torch.bfloat16))["logits"]
        m32 = BirdNETv24(compute_dtype=torch.float32)
        m32.load_state_dict(v24.state_dict())
        ref32 = m32.to(dev).eval().backbone(mel)["logits"]
        del m32
    scale = max(1.0, float(want["logits"].abs().max()))
    gap = float((card8["logits"].cpu() - want["logits"]).abs().max())
    free_gap = float((card8["logits"].cpu() - free).abs().max())

    def versus(a, b) -> str:
        k = 5
        ia = torch.topk(a, k).indices.cpu().numpy()
        ib = torch.topk(b, k).indices.cpu().numpy()
        overlap = np.mean([len(set(x) & set(y)) / k for x, y in zip(ia, ib)])
        dconf = float((torch.sigmoid(a) - torch.sigmoid(b)).abs().max())
        corr = np.corrcoef(a.cpu().numpy().ravel(),
                           b.cpu().numpy().ravel())[0, 1]
        return (f"top-{k} overlap {overlap:.4f}, max post-sigmoid gap "
                f"{dconf:.3e}, logit correlation {corr:.4f}")

    def bf16_step():
        v24.fused_blocks = False
        return v24.apply_int16(pcm)["logits"]

    with torch.inference_mode():
        t16, t8 = timed_pair(bf16_step, lambda: q(mel_of(pcm))["logits"])
    print(f"int8 PTQ v2.4 backbone [{BATCH},{CLIP}]: calibrated on "
          f"{INT8_CAL[0]} x {INT8_CAL[1]} windows and quantized in "
          f"{t_quant:.2f} s; int32 sums of all {len(layers)} int8 convs "
          f"equal the CPU's on the same int8 input ({n_values} values, "
          f"{INT8_EXACT_ROWS} rows); launches {launches}; card vs CPU [{rows}]"
          f" with the card's codes forced: the CPU's own codes differ at "
          f"{forced['flips']:.3e} of the positions (<= {INT8_FLIPS}), by up "
          f"to {forced['step']} code, max |dlogit| {gap:.3e} (<= "
          f"{INT8_LOGIT_GAP} x {scale:.2f}); free-running {free_gap:.3e}; "
          f"codes {forced['zero']:.4f} zero, {forced['clipped']:.2e} "
          f"clipped. Printed, not gated at full depth: int8 vs bf16 backbone "
          f"on the same mel: {versus(lq, ref16)}; int8 vs float32: "
          f"{versus(lq, ref32)}; bf16 vs float32: {versus(ref16, ref32)}. "
          f"Step (mel kernel + backbone) int8 {np.median(t8):.4f} ms "
          f"[{min(t8):.4f}, {max(t8):.4f}] against bf16 unfused "
          f"{np.median(t16):.4f} ms [{min(t16):.4f}, {max(t16):.4f}] (median "
          f"[min, max] of {REPS}) [{card}]")
    assert forced["flips"] <= INT8_FLIPS, "int8 backbone: code flips"
    assert gap <= INT8_LOGIT_GAP * scale, "int8 backbone: card vs CPU"


def _dense_heads(dev, card: str) -> None:
    """``apply_dense_int8`` at 1280 → 6522 and 1280 → 14795, B = 256, held
    to JAX's gate against the float32 head (post-sigmoid < 0.02, top-10
    overlap >= 9 each row), timed against the bf16 ``Dense``."""
    rng = np.random.default_rng(11)
    for cout in (6522, 14795):
        dense = L.Dense(1280, cout)
        dense.load_state_dict({
            "w": torch.from_numpy((rng.standard_normal((cout, 1280))
                                   * 0.03).astype(np.float32)),
            "b": torch.from_numpy((rng.standard_normal(cout)
                                   * 0.01).astype(np.float32))})
        q = {k: v.to(dev) for k, v in quant.quantize_dense_head(dense).items()}
        dense.to(dev)
        emb = torch.from_numpy(np.abs(rng.standard_normal(
            (BATCH, 1280))).astype(np.float32)).to(dev)
        with torch.inference_mode():
            got = quant.apply_dense_int8(q, emb)
            with full_float32():
                ref = dense(emb, torch.float32)
            t16, t8 = median_ms_pair(lambda: dense(emb, torch.bfloat16),
                                     lambda: quant.apply_dense_int8(q, emb))
        dconf = float((sigmoid_confidence(got, 1.0)
                       - sigmoid_confidence(ref, 1.0)).abs().max())
        ig = torch.topk(got, 10).indices.cpu().numpy()
        ir = torch.topk(ref, 10).indices.cpu().numpy()
        least = min(len(set(a) & set(b)) for a, b in zip(ig, ir))
        print(f"int8 head 1280 -> {cout} [{BATCH}]: max post-sigmoid diff "
              f"{dconf:.3e} (< 0.02), least top-10 overlap {least}/10 (>= "
              f"9); apply_dense_int8 {t8:.4f} ms against the bf16 Dense "
              f"{t16:.4f} ms (medians of {REPS}, per call) [{card}]")
        assert dconf < 0.02 and least >= 9, f"int8 head {cout}"


def _topk_gap(ref_conf: torch.Tensor, v1, i1, v2, i2) -> tuple[float, int]:
    """(largest relative gap of the values, number of index positions that
    differ and are not ties) between two classifiers' top-k; a position is a
    tie where the species the second names has the first's value there in
    `ref_conf`, within 2e-4."""
    rel = float((np.abs(v2 - v1) / np.maximum(np.abs(v1), 1e-6)).max())
    conf = ref_conf.cpu().numpy()
    rows, cols = np.nonzero(i1 != i2)
    tie = np.abs(conf[rows, i2[rows, cols]] - v1[rows, cols]) <= (
        2e-4 * np.abs(v1[rows, cols]) + 1e-6)
    return rel, int((~tie).sum())


def phase_int8(dev: torch.device, card: str) -> None:
    """Phase 13: the act_int8 steps of v2.4 (unfused) and v3.0 (fused
    blocks), the int8 PTQ backbone of v2.4, the int8 heads, and the mesh
    (``phase_mesh``). The two models' BN statistics come from a field-level
    batch (``_bn_from_batch``)."""
    t0 = time.monotonic()
    v24 = BirdNETv24().init(torch.Generator().manual_seed(SEED)).to(
        dev).eval()
    _bn_from_batch(v24, torch.from_numpy(pcm_batch(
        (INT8_CAL[1], CLIP), SEED + 30)).to(dev))
    pcm = torch.from_numpy(pcm_batch((BATCH, CLIP), SEED + 13)).to(dev)
    _act_int8_step(v24, pcm, False, dev, card,
                   {"melspec_fused": 1, "expand_dw_pool": 0,
                    "scale_project": 0})
    v3 = BirdNETv3().init(torch.Generator().manual_seed(SEED)).to(dev).eval()
    _bn_from_batch(v3, torch.from_numpy(pcm_batch(
        (INT8_CAL[1], CLIP32), SEED + 31, rate=32000)).to(dev))
    pcm32 = torch.from_numpy(pcm_batch((BATCH, CLIP32), SEED + 14,
                                       rate=32000)).to(dev)
    _act_int8_step(v3, pcm32, True, dev, card,
                   {"melspec_fused": 1, "expand_dw_pool": V3_FUSED,
                    "scale_project": V3_FUSED})
    del v3, pcm32
    _ptq_backbone(v24, pcm, dev, card)
    _dense_heads(dev, card)
    phase_mesh(v24, pcm, dev, card)
    print(f"phase 13 (int8, meshes) {time.monotonic() - t0:.1f} s [{card}]")


def phase_mesh(v24, pcm: torch.Tensor, dev: torch.device, card: str) -> None:
    """``ShardedClassifier`` on ``make_mesh()`` (every visible card: 1x1
    here), equal to ``TorchClassifier``; on meshes that list the card 2, 2
    and 4 times, on a ragged batch of 255: in float32 (TF32 off) indices
    equal up to ties and values within 2e-4 relative; in bf16 the same
    printed, since a split batch or head changes the shapes cuDNN and
    cuBLAS see, so their order of summation, and in bf16 a value one ulp
    apart may round to the other bf16 neighbour; each timed beside
    ``TorchClassifier``; the int16 step's host dispatch against its device
    time, single and 2x2; then a
    ``TorchModelBatcher`` serving the bf16 2x2 mesh's classifier through
    ``DeviceLoop`` (``phase_loop``: every window's top-10 checked, the mel
    kernel launched once a batch per data row)."""
    x = pcm16_to_float32(pcm[:BATCH - 1])
    m32 = BirdNETv24(compute_dtype=torch.float32)
    m32.load_state_dict(v24.state_dict())
    m32.to(dev).eval()
    for model in (v24, m32):
        dt = str(model.compute_dtype).removeprefix("torch.")
        gated = model is m32
        with torch.inference_mode():
            ref_conf = sigmoid_confidence(model.apply(x)["logits"], 1.0)
        single = TorchClassifier(model, dev)
        v1, i1 = single.predict_topk(x)
        t = [event_ms(lambda: single.predict_topk(x)) for _ in range(REPS)]
        print(f"mesh baseline {dt}: TorchClassifier.predict_topk "
              f"[{BATCH - 1},{CLIP}] {np.median(t):.4f} ms [{min(t):.4f}, "
              f"{max(t):.4f}] (median [min, max] of {REPS}) [{card}]")
        mesh = make_mesh()
        v2, i2 = ShardedClassifier(model, mesh=mesh).predict_topk(x)
        if mesh.size == 1:
            np.testing.assert_array_equal(i2, i1)
            np.testing.assert_array_equal(v2, v1)
        print(f"mesh make_mesh() {mesh.shape} {dt}: top-10 of "
              f"[{BATCH - 1},{CLIP}] {'equal to' if mesh.size == 1 else 'vs'}"
              f" TorchClassifier's, gap {_topk_gap(ref_conf, v1, i1, v2, i2)}"
              f" [{card}]")
        for d, m in MESH_SPLITS:
            mesh = make_mesh(d * m, d, m, devices=[dev] * (d * m))
            sharded = ShardedClassifier(model, mesh=mesh)
            v2, i2 = sharded.predict_topk(x)
            rel, swaps = _topk_gap(ref_conf, v1, i1, v2, i2)
            t = [event_ms(lambda: sharded.predict_topk(x))
                 for _ in range(REPS)]
            print(f"mesh {d}x{m} of {dev} {dt}: top-10 of [{BATCH - 1},"
                  f"{CLIP}] against TorchClassifier's: largest relative "
                  f"value gap {rel:.3e}, {swaps} index positions differ that "
                  f"are not ties{' (gates: < 2e-4, 0)' if gated else ''}; "
                  f"predict_topk {np.median(t):.4f} ms [{min(t):.4f}, "
                  f"{max(t):.4f}] (median [min, max] of {REPS}) [{card}]")
            if gated:
                assert rel < 2e-4 and swaps == 0, f"mesh {d}x{m}"
    del m32
    # the int16 step's host dispatch against its device time: a data row
    # runs the whole backbone, so a 2-row mesh of one card dispatches twice
    # the kernels of the single step
    mesh = make_mesh(4, 2, 2, devices=[dev] * 4)
    sharded = ShardedClassifier(v24, mesh=mesh)
    with torch.inference_mode():
        for label, fn in (("single", lambda: v24.apply_int16(pcm)),
                          ("2x2", lambda: sharded.model.apply_int16(pcm))):
            fn()
            torch.cuda.synchronize()
            host = []

            def dispatch():
                t1 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t1) * 1e3)

            dev_ms = [event_ms(dispatch) for _ in range(REPS)]
            print(f"mesh step {label} [{BATCH},{CLIP}]: host dispatch "
                  f"{np.median(host):.4f} ms, CUDA events around it "
                  f"{np.median(dev_ms):.4f} ms (medians of {REPS}) [{card}]")
    launches, batches, _ = phase_loop(
        v24, dev, card, MESH_STREAMS, MESH_TICKS, classifier=sharded)
    assert launches["melspec_fused"] == 2 * batches, (launches, batches)


SOAK_STREAMS = 2000          # the survey's north star: >= 2,000 streams
SOAK_SECONDS = 30             # phase 14's plain soak
KS_SECONDS = 45              # phase 15's kitchen-sink leg
SOAK_RING_SECONDS = 27       # run_soak's rings (27 s at 48 kHz, int16)
SOAK_P95_MS = 1500.0         # half the 3 s clip
SOAK_RATE = 0.95             # steady windows/s against those offered
STUB_BATCHES = (64, 256)     # the step's two batch sizes for the stub


def _mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_soak(dev: torch.device, card: str) -> dict:
    """Phase 14: the v2.4 step timed at the stub's two batch sizes (by
    CUDA events around one call, in turns, after three calls of each
    shape; the host's share and the device time by graph replay printed
    beside them), then the full-pipeline soak (``python -m
    birdnet_go_tpu_torch soak``) in a process of its own: 2,000 streams
    of BirdNET v2.4 at full width,
    served unfused at batch 256, in real time, with the realistic action
    mix, into a SQLite file. Its own process keeps ``gc.freeze()`` and the
    rings out of this heap. Gates: the CLI exits 0 (no sample lost, no
    window dropped, no critical job dropped); latency p95 below half the
    clip; steady windows/s at least 0.95 of those offered; calibration set
    a threshold; every approval persisted, and the db file holds as many
    rows; the mel kernel launched once a batch. Returns the soak's
    record."""
    t0 = time.monotonic()
    v24 = BirdNETv24().init(torch.Generator().manual_seed(SEED))
    batcher = TorchModelBatcher(TorchClassifier(v24, dev), max_batch=256)
    xs = {b: torch.from_numpy(pcm_batch((b, CLIP), SEED + 40)).to(dev)
          for b in STUB_BATCHES}
    sens = torch.tensor(1.0, device=dev)     # a graph captures no H2D copy
    for x in xs.values():                    # first calls of a shape tune
        for _ in range(3):
            batcher._step(x, sens, 10, None)
    torch.cuda.synchronize()
    events = {b: [] for b in xs}
    host = {b: [] for b in xs}

    def host_timed(b):
        t1 = time.perf_counter()
        batcher._step(xs[b], sens, 10, None)
        host[b].append((time.perf_counter() - t1) * 1e3)

    for _ in range(2 * REPS):                # the two sizes in turns
        for b in xs:
            events[b].append(event_ms(lambda: host_timed(b)))
    step = {b: float(np.median(t)) for b, t in events.items()}
    for b, x in xs.items():
        dev_ms = graph_ms(lambda: batcher._step(x, sens, 10, None))
        print(f"soak stub: v2.4 unfused int16 step [{b},{CLIP}] by CUDA "
              f"events {step[b]:.4f} ms [{min(events[b]):.4f}, "
              f"{max(events[b]):.4f}] (median [min, max] of {2 * REPS}, "
              f"in turns), host call {np.median(host[b]):.4f} ms, device "
              f"by graph replay {dev_ms:.4f} ms [{card}]")
    lo, hi = STUB_BATCHES
    per_window_us = (step[hi] - step[lo]) / (hi - lo) * 1e3
    base_ms = step[lo] - lo * per_window_us / 1e3
    print(f"soak stub: base_ms={base_ms:.4f} per_window_us="
          f"{per_window_us:.4f} (the line through the event times) "
          f"[{card}]")
    del batcher, v24, xs
    torch.cuda.empty_cache()

    rec = _soak_leg(card, "soak", SOAK_SECONDS)
    print(f"phase 14 (soak) {time.monotonic() - t0:.1f} s [{card}]")
    return rec


def _soak_leg(card: str, name: str, seconds: float, *extra: str) -> dict:
    """``python -m birdnet_go_tpu_torch soak --device cuda`` over
    SOAK_STREAMS streams for `seconds`, with `extra` flags, in a process
    of its own (record, db and log under ``build/<name>_smoke/``), with
    phase 14's prints and gates; returns its record, with the db's rows
    of the soak's detections under ``db_rows`` (and of the kitchen-sink
    migration's copies under ``db_migrated_rows``)."""
    ring_gib = SOAK_STREAMS * SOAK_RING_SECONDS * 48000 * 2 / 2**30
    avail = _mem_available_gib()
    print(f"{name} host: {avail:.1f} GiB available, the rings take "
          f"{ring_gib:.1f} GiB ({SOAK_STREAMS} streams x "
          f"{SOAK_RING_SECONDS} s x 48 kHz x int16)")
    assert avail > 2 * ring_gib, "the host lacks memory for the soak's rings"
    out = REPO / "build" / f"{name}_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    db, rec_path = out / "soak.db", out / "soak.json"
    cmd = [sys.executable, "-m", "birdnet_go_tpu_torch", "soak", "--device",
           "cuda", "--streams", str(SOAK_STREAMS), "--seconds",
           str(seconds), "--db", str(db), "--out", str(rec_path), *extra]
    t1 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=seconds + 300)
    wall = time.monotonic() - t1
    (out / "soak.log").write_text(proc.stderr)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-6000:])
    assert proc.returncode == 0, f"soak exited {proc.returncode}"
    rec = json.loads(rec_path.read_text())["runs"][-1]
    lat, cal = rec["latency_ms"], rec["calibration"]
    thr = cal["threshold_calibration"]
    acts, da = rec["actions"], rec["drop_accounting"]
    with contextlib.closing(sqlite3.connect(str(db))) as conn:
        # the kitchen-sink leg's migration copies legacy rows into the
        # same table, under a source of its own
        rows, migrated = conn.execute(
            "SELECT SUM(source_id != 'import:birdnet-go'),"
            " SUM(source_id = 'import:birdnet-go') FROM detections"
        ).fetchone()
    rows, migrated = rows or 0, migrated or 0
    tick = rec["timeline"][-1]
    print(f"{name}: {rec['streams']} v2.4 streams for {rec['seconds']} s in "
          f"{wall:.1f} s of process (warmup {cal['warmup_s']} s): "
          f"{rec['windows_per_second']} windows/s, steady "
          f"{rec['steady_windows_per_second']} of "
          f"{rec['expected_windows_per_second']} offered, stream "
          f"equivalents sustained {rec['stream_equivalents_sustained']} "
          f"[{cal['card']}]")
    print(f"{name} latency from the window's realtime end (steady, ms): p50 "
          f"{lat['p50']} p95 {lat['p95']} p99 {lat['p99']} max {lat['max']}"
          f" [{card}]")
    print(f"{name} calibration: threshold {thr['threshold']} at sensitivity "
          f"{thr['sensitivity']} after {thr['passes']} passes of 1,024 "
          f"windows (target {thr['target_detection_rate']})")
    print(f"{name} detections: {acts['approved']} approved = "
          f"{acts['approved'] / rec['seconds']:.2f}/s, persisted "
          f"{acts['detections_persisted']}, rows in the db {rows} (and "
          f"{migrated} migrated), clips "
          f"{acts['clips_written']}, mqtt {acts['mqtt_published']}, alerts "
          f"{acts['alerts_evaluated']}")
    print(f"{name} job queue by category: " + ", ".join(
        f"{c} {v['enqueued']}/{v['completed']}/{v['dropped']}"
        for c, v in rec["jobqueue_by_category"].items() if v["enqueued"])
        + " (enqueued/completed/dropped)")
    per_batch = rec["windows_processed"] / cal["batches_dispatched"]
    print(f"{name} drops: {da}; mel kernel launches "
          f"{cal['mel_kernel_launches']} for {cal['batches_dispatched']} "
          f"batches ({per_batch:.1f} windows a batch)")
    print(f"{name} host plane: scheduler_stall_ms_max "
          f"{rec['ring']['scheduler_stall_ms_max']}, tick_busy_ms "
          f"{tick['tick_busy_ms']} over {tick['ticks']} ticks, GC pauses "
          f"over 50 ms {rec['host']['gc_pauses_over_50ms']}, maxrss "
          f"{rec['host']['maxrss_mb']} MB, ring high water "
          f"{rec['ring']['backlog_high_water_pct']}%, grown "
          f"{rec['ring']['grown']}")
    assert da["farm_samples_lost"] == 0 and \
        da["scheduler_windows_dropped"] == 0 and \
        da["jobqueue_dropped_critical"] == 0, da
    assert lat["p95"] < SOAK_P95_MS, lat
    assert rec["steady_windows_per_second"] >= \
        SOAK_RATE * rec["expected_windows_per_second"], rec
    assert thr["threshold"] is not None, thr
    assert acts["detections_persisted"] == acts["approved"] == rows, \
        (acts, rows)
    assert cal["mel_kernel_launches"] == cal["batches_dispatched"] > 0, cal
    rec["db_rows"], rec["db_migrated_rows"] = rows, migrated
    return rec


AUX_SOURCES = 64             # sound levels: 64 sources of 10 s at 48 kHz
AUX_LEVEL_SECONDS = 10.0
AUX_SPECTROGRAMS = (("bird", 48000, 3.0, 400), ("bird", 48000, 3.0, 800),
                    ("bat", 256000, 1.0, 800))
AUX_INDEX_SHARE = 1e-3       # pixels whose colour index may differ by 1
AUX_LEVEL_GAP_DB = 0.05
AUX_HLS_SEGMENTS = 4
KS_HLS = 20                  # the kitchen-sink leg's floors (45 s)
KS_LEVELS = 40
KS_RENDERS = 20


def tone_over_noise(rate: int, seconds: float, seed: int) -> np.ndarray:
    """float32 PCM: a 2.5 kHz tone at -16 dBFS over -40 dBFS noise (and
    a 40 kHz pulse train at a bat rate)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = 0.16 * np.sin(2 * np.pi * 2500 * t) + 0.01 * rng.standard_normal(
        len(t))
    if rate > 96000:
        x += 0.1 * np.sin(2 * np.pi * 40000 * t) * (np.sin(40 * t) > 0.9)
    return x.astype(np.float32)


def png_pixels(path: Path) -> np.ndarray:
    """An 8-bit RGB PNG of filter-0 rows (the port's writer) → [H, W, 3],
    read with zlib alone."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", path
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2), (depth, color)
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all(), "a row with a filter other than 0"
    return rows[:, 1:].reshape(h, w, 3)


class _LevelEngine:
    """A stand-in engine: AUX_SOURCES sources, each a 48 kHz
    ``CaptureBuffer`` holding AUX_LEVEL_SECONDS of a tone over noise that
    ends at `now`."""

    def __init__(self, now: float):
        self._src, self._cb = [], {}
        for i in range(AUX_SOURCES):
            sid = f"src{i}"
            cb = CaptureBuffer(48000, capacity_seconds=12.0)
            x = tone_over_noise(48000, AUX_LEVEL_SECONDS, 100 + i)
            cb.write((x * 32767).astype(np.int16),
                     timestamp=now - AUX_LEVEL_SECONDS)
            self._src.append(SimpleNamespace(source_id=sid))
            self._cb[sid] = cb

    def sources(self):
        return self._src

    def capture_buffer(self, sid):
        return self._cb.get(sid)


def _raw_levels(worker: SoundLevelWorker, now: float) -> list[np.ndarray]:
    """One ``sample_once`` pass at `now`, recording each source's
    unrounded levels (the record rounds them to 0.1 dB)."""
    raw, levels = [], worker._levels

    def record(pcm, rate):
        raw.append(levels(pcm, rate))
        return raw[-1]

    worker._levels = record
    try:
        out = worker.sample_once(now)
    finally:
        del worker._levels
    assert len(out) == AUX_SOURCES and len(raw) == AUX_SOURCES
    return raw


def _mdat(segment: bytes) -> bytes:
    """The payload of a media segment's top-level ``mdat`` box."""
    pos = 0
    while pos + 8 <= len(segment):
        size, kind = struct.unpack(">I4s", segment[pos:pos + 8])
        if kind == b"mdat":
            return segment[pos + 8:pos + size]
        pos += size
    raise AssertionError("no mdat box")


def phase_aux(dev: torch.device, card: str, plain: dict) -> None:
    """Phase 15, the clip and aux planes: whether Pillow imports here;
    spectrograms (bird, 3 s at 48 kHz, widths 400 and 800; bat, 1 s at
    256 kHz, width 800) on the card and on the CPU, their colour index
    within 1 level at no more than 1e-3 of the pixels, the PNG read back
    with zlib equal to the array; ``SoundLevelWorker.sample_once`` over 64
    sources of 10 s on the card and the CPU, the raw levels within
    0.05 dB; a 256 kHz capture exported by ``SaveAudioAction`` as a 48 kHz
    normalised FLAC that decodes to the PCM encoded, and what an ``.opus``
    request writes; four 2 s FLAC HLS segments that decode to the capture;
    then the 2,000-stream soak with ``--kitchen-sink`` in its own process,
    with phase 14's gates and the aux planes' (no aux error, the floors of
    their counters, a live migration with dual-write), beside `plain`,
    phase 14's record."""
    t0 = time.monotonic()
    try:
        pil = importlib.import_module("PIL").__version__
    except ImportError:
        pil = "no"
    print(f"aux: Pillow on this machine: {pil} (the port writes its PNGs "
          f"without it)")
    out = REPO / "build" / "aux_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    for name, rate, seconds, width in AUX_SPECTROGRAMS:
        prof = getattr(FrequencyProfile, name)()
        x = tone_over_noise(rate, seconds, 7)
        got = spectrogram_index(x, rate, width, profile=prof, device=dev)
        ms = [event_ms(lambda: spectrogram_index(x, rate, width,
                                                 profile=prof, device=dev))
              for _ in range(REPS)]
        t1 = time.perf_counter()
        want = spectrogram_index(x, rate, width, profile=prof, device="cpu")
        cpu_ms = (time.perf_counter() - t1) * 1e3
        gap = np.abs(got.astype(int) - want)
        share = float((gap > 0).mean())
        path = out / f"{name}_{width}.png"
        t1 = time.perf_counter()
        generate_png(x, rate, path, width, prof, device=dev)
        png_ms = (time.perf_counter() - t1) * 1e3
        rgb = render_spectrogram(x, rate, width, profile=prof, device=dev)
        assert rgb.shape == (got.shape[0], width, 3), rgb.shape
        assert np.array_equal(png_pixels(path), rgb), path
        print(f"aux spectrogram {name} {seconds:g} s at {rate} Hz, width "
              f"{width}: index {got.shape}, card vs CPU max {gap.max()} "
              f"level at {share:.3e} of the pixels; device part "
              f"{np.median(ms):.4f} ms [{min(ms):.4f}, {max(ms):.4f}] by "
              f"CUDA events (CPU {cpu_ms:.1f} ms), generate_png "
              f"{png_ms:.1f} ms wall, {path.stat().st_size} bytes [{card}]")
        assert gap.max() <= 1 and share <= AUX_INDEX_SHARE, (gap.max(),
                                                             share)

    now = time.time()
    engine = _LevelEngine(now)
    card_worker = SoundLevelWorker(engine, device=dev)
    cpu_worker = SoundLevelWorker(engine, device="cpu")
    card_worker.sample_once(now)                  # cuFFT plans, constants
    times = []
    for _ in range(REPS):
        t1 = time.perf_counter()
        card_levels = _raw_levels(card_worker, now)
        times.append((time.perf_counter() - t1) * 1e3)
    t1 = time.perf_counter()
    cpu_levels = _raw_levels(cpu_worker, now)
    cpu_ms = (time.perf_counter() - t1) * 1e3
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(card_levels, cpu_levels))
    print(f"aux sound levels: {AUX_SOURCES} sources x "
          f"{AUX_LEVEL_SECONDS:g} s at 48 kHz, "
          f"{len(card_levels[0])} bands, card vs CPU max |d| {gap:.3e} dB; "
          f"a pass {np.median(times):.2f} ms [{min(times):.2f}, "
          f"{max(times):.2f}] wall on the card, {cpu_ms:.1f} ms on the CPU "
          f"[{card}]")
    assert gap <= AUX_LEVEL_GAP_DB, gap

    encoded = []
    real_encode = encode.encode_clip

    def spy(pcm, rate, path, fmt=None):
        encoded.append((np.array(pcm), rate))
        return real_encode(pcm, rate, path, fmt)

    cb = CaptureBuffer(256000, capacity_seconds=4.0)
    t_cap = time.time() - 3.0
    cb.write((tone_over_noise(256000, 3.0, 9) * 32767).astype(np.int16),
             timestamp=t_cap)
    encode.encode_clip = spy
    try:
        for clip in ("clip.flac", "request.opus"):
            SaveAudioAction(capture_buffer=cb, start_time=t_cap + 0.5,
                            end_time=t_cap + 2.5, out_path=out / clip,
                            sample_rate=256000, downsample_to=48000,
                            normalization={"enabled": True}).execute()
    finally:
        encode.encode_clip = real_encode
    pcm, rate = decode_flac((out / "clip.flac").read_bytes())
    assert rate == encoded[0][1] == 48000, rate
    assert np.array_equal(pcm, encoded[0][0]), "the FLAC clip is not lossless"
    written = sorted(p.name for p in out.glob("request.*"))
    print(f"aux clip export: 2 s of a 256 kHz capture -> {len(pcm)} "
          f"samples at {rate} Hz, normalised (peak {np.abs(pcm).max()}), "
          f"FLAC decodes bit for bit; an .opus request wrote {written} "
          f"(ffmpeg {'found' if encode.ffmpeg_available() else 'absent'})")

    cb = CaptureBuffer(48000, capacity_seconds=30.0)
    t_hls = time.time() - 20.0
    cb.write((tone_over_noise(48000, 10.0, 11) * 32767).astype(np.int16),
             timestamp=t_hls)
    # FLAC, whose segments decode bit for bit (phase 21 serves AAC)
    session = HlsSession("aux", cb, segment_seconds=2.0, codec="flac")
    for i in range(AUX_HLS_SEGMENTS):
        assert session.tick(t_hls + 2.0 * (i + 1))
        seg = session.segment(i + 1)
        want = cb.read_segment(t_hls + 2.0 * i, t_hls + 2.0 * (i + 1))
        info = streaminfo_block(48000, len(want))
        got, _ = decode_flac(b"fLaC" + bytes([0x80, 0, 0, len(info)]) + info
                             + _mdat(seg))
        assert np.array_equal(got, want), i
    print(f"aux HLS: {AUX_HLS_SEGMENTS} FLAC segments of 2 s "
          f"({len(session.init)} byte init, {len(seg)} byte segments), "
          f"each decodes to the captured PCM; codec {session.codec}")
    print(f"aux phase 15 checks {time.monotonic() - t0:.1f} s [{card}]")

    ks = _soak_leg(card, "kitchen_sink", KS_SECONDS, "--kitchen-sink")
    aux = ks["aux_planes"]
    mig = aux["migration"]
    print(f"kitchen_sink aux planes: hls_segments {aux['hls_segments']}, "
          f"soundlevel_blocks {aux['soundlevel_blocks']}, lufs_blocks "
          f"{aux['lufs_blocks']}, spectrograms_rendered "
          f"{aux['spectrograms_rendered']} (dropped "
          f"{aux['spectrograms_dropped']}), range_rebuilds "
          f"{aux['range_rebuilds']}, aux_errors {aux['aux_errors']}; "
          f"migration {mig['state']} {mig['migrated_records']} of "
          f"{mig['total_records']} ({ks['db_migrated_rows']} rows in the "
          f"db), dual-write {mig['dual_write']}")
    for leg, rec in (("plain", plain), ("kitchen-sink", ks)):
        lat = rec["latency_ms"]
        print(f"soak legs, {leg}: steady {rec['steady_windows_per_second']}"
              f" windows/s of {rec['expected_windows_per_second']}, p50/p95/"
              f"p99 {lat['p50']}/{lat['p95']}/{lat['p99']} ms, tick_busy_ms "
              f"{rec['timeline'][-1]['tick_busy_ms']}, mel launches "
              f"{rec['calibration']['mel_kernel_launches']} [{card}]")
    assert aux["aux_errors"] == 0, aux
    assert aux["hls_segments"] >= KS_HLS, aux
    assert min(aux["soundlevel_blocks"], aux["lufs_blocks"]) >= KS_LEVELS, aux
    assert aux["spectrograms_rendered"] >= KS_RENDERS, aux
    assert aux["spectrograms_dropped"] == 0, aux
    assert mig["state"] == "migrating" and mig["migrated_records"] > 0, mig
    assert mig["dual_write"]["installed"], mig
    print(f"phase 15 (aux planes) {time.monotonic() - t0:.1f} s [{card}]")


APP_TONES = 48               # phase 16: the app's tone sources
APP_FILES = 16               # ... and its sources, each looping a 48 kHz WAV
APP_ALONE_S = 12.0           # v2.4 served alone
APP_BOTH_S = 15.0            # v2.4 and v3.0, after v3.0's runtime load
APP_AFTER_S = 5.0            # v2.4 alone again, after v3.0's unload
APP_RATE = 0.03              # the share of windows a threshold approves
APP_P95_MS = 1500.0          # v2.4's latency p95 over the whole run
APP_V3_WITHIN_S = 15.0       # v3.0's first window served after its load
APP_STOP_S = 15.0            # stop() returns within
APP_RANGE_MARGIN = 1e-5      # card vs CPU: species this near the threshold
APP_LATLON = (60.17, 24.94)  # Helsinki
APP_WARNINGS = ("drain deadline", "job queue full", "exceeds realtime budget")
SERVE_TONES = 8
SERVE_SECONDS = 10.0         # serve's serving, once it answers


def _tone_pcm(freq: float, pulse: float, rate: int, n: int,
              offset: int) -> np.ndarray:
    """int16 PCM as ``ToneSource`` makes it (amplitude 0.3, on/off keyed
    at `pulse` Hz), from sample `offset`."""
    t = (np.arange(n) + offset) / rate
    wave = 0.3 * 32767 * np.sin(2 * np.pi * freq * t)
    if pulse > 0:
        wave = wave * (np.sin(2 * np.pi * pulse * t) > 0)
    return wave.astype(np.int16)


def _app_tones() -> list[tuple[float, float]]:
    """(frequency, pulse rate) of each tone source: 48 frequencies from
    600 Hz to 11 kHz, pulse rates 0 to 7 Hz."""
    return [(float(f), float(k % 8))
            for k, f in enumerate(np.geomspace(600.0, 11000.0, APP_TONES))]


def _calibrate(batcher, labels, included, windows: np.ndarray,
               trigger: float) -> dict:
    """The soak's ``--calibrate-rate`` rule on `windows` (int16 [n, T],
    the sources' signals), for the processor, which approves every
    included species of a window's top-10 at or above the threshold: the
    threshold passes APP_RATE · n such pairs. While it lies above the
    dynamic thresholds' `trigger` the sigmoid sensitivity is cut tenfold
    (random weights saturate the sigmoid, and a threshold above the
    trigger would make every approval lower its species' threshold, as
    the soak cuts it above 0.998). Returns the threshold, the sensitivity
    and the share of windows whose best included confidence reaches the
    trigger."""
    ok = np.array([included is None or labels[i].scientific in included
                   for i in range(len(labels))])
    x = torch.from_numpy(windows).to(batcher.device)
    sens = batcher.sensitivity
    for _ in range(6):
        vals, idx, _ = batcher._step(x, sens, batcher.top_k, None)
        conf = np.where(ok[idx.cpu().numpy()], vals.cpu().numpy(), 0.0)
        pairs = np.sort(conf.ravel())[::-1]
        thr = float(pairs[int(APP_RATE * len(conf))])
        if thr < trigger:
            break
        sens *= 0.1
    return {"threshold": float(np.clip(thr, 0.05, 0.999)),
            "sensitivity": float(sens),
            "windows": len(conf),
            "above_trigger": float((conf.max(axis=1) >= trigger).mean())}


def _app_wavs(out: Path) -> list[np.ndarray]:
    """The file sources' 10 s 48 kHz WAVs under `out`, one a source, each
    a tone of its own (1.5 to 9 kHz) at -26 dBFS over -40 dBFS noise (one
    WAV for all would make the same detections at the same instants, and
    their clips one file); returns their PCM."""
    rng = np.random.default_rng(SEED + 160)
    t = np.arange(10 * 48000) / 48000
    pcm = []
    for k, f in enumerate(np.linspace(1500.0, 9000.0, APP_FILES)):
        x = 0.05 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(
            len(t))
        pcm.append(np.clip(x * 32767, -32768, 32767).astype(np.int16))
        write_pcm16(out / f"loop{k}.wav", pcm[-1][:, None], 48000)
    return pcm


def _cal_windows(rate: int, clip: int, wavs: list[np.ndarray],
                 tones: list[tuple[float, float]] | None = None
                 ) -> np.ndarray:
    """Four windows of each source's signal at `rate`, 1.5 s apart: the
    tones (phase 16's 48 by default) and the WAVs (resampled by index
    where `rate` is not 48 kHz)."""
    rows = []
    for k in range(4):
        off = int(1.5 * rate * k)
        rows += [_tone_pcm(f, p, rate, clip, off)
                 for f, p in (tones or _app_tones())]
        pos = (np.arange(clip) + off) * 48000 // rate
        rows += [w[pos % len(w)] for w in wavs]
    return np.stack(rows)


class _StackSampler:
    """Where a thread spends its time: every `period` s, the thread's
    innermost frame and its innermost frame inside the repository, each
    counted by ``file:function``."""

    def __init__(self, thread_id: int, period: float = 0.01):
        import threading

        self.tid, self.period = thread_id, period
        self.inner: dict[str, int] = {}
        self.repo: dict[str, int] = {}
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stack-sampler")
        self._thread.start()

    def _run(self) -> None:
        root = str(REPO)
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self.tid)
            if frame is None:
                continue
            self.samples += 1
            key = f"{Path(frame.f_code.co_filename).name}:" \
                f"{frame.f_code.co_name}"
            self.inner[key] = self.inner.get(key, 0) + 1
            while frame is not None and not frame.f_code.co_filename \
                    .startswith(root):
                frame = frame.f_back
            if frame is not None:
                key = f"{Path(frame.f_code.co_filename).name}:" \
                    f"{frame.f_code.co_name}:{frame.f_lineno}"
                self.repo[key] = self.repo.get(key, 0) + 1

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()

        def top(d):
            return sorted(d.items(), key=lambda kv: -kv[1])[:12]

        return {"samples": self.samples, "innermost": top(self.inner),
                "in_repo": top(self.repo)}


def _thread_cpu_s() -> dict[str, float]:
    """CPU seconds of this process's threads so far, by thread name with
    its digits dropped (``src-tone12`` counts as ``src-tone``), from
    /proc/self/task."""
    import threading

    names = {th.native_id: th.name for th in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out: dict[str, float] = {}
    for task in Path("/proc/self/task").iterdir():
        try:
            fields = (task / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        name = re.sub(r"\d+", "", names.get(int(task.name), "(native)"))
        out[name] = out.get(name, 0.0) + (int(fields[11]) + int(fields[12])
                                          ) / tick
    return {k: round(v, 2) for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def _pct(ms: list[float]) -> dict:
    a = np.asarray(ms)
    return {q: round(float(np.percentile(a, p)), 1) for q, p in
            (("p50", 50), ("p95", 95), ("p99", 99))} | {
        "max": round(float(a.max()), 1)}


def app_leg(record_path: Path) -> None:
    """Phase 16's app, in a process of its own (``python3 chip_smoke.py
    --app-leg <record.json>``): the ``Application`` on the card at full
    width (v2.4 and, loaded and unloaded at runtime, v3.0, seeded
    weights), 48 tone and 16 file sources (``_app_wavs``), the range
    filter at a fixed place, Deep Detection level 2, dynamic thresholds,
    FLAC export, a SQLite file. The thresholds are calibrated first, as
    the soak's ``--calibrate-rate`` does. Counting wrappers are put on
    from the outside: ``_on_window_result`` (each window's end to its
    hand-off), the engine's window provider, the processor's approvals,
    the batchers' warm-ups, launches and harvests (timed), a stack
    sampler on the tick thread, and a logging handler for every ERROR
    record and each warning that means a loss. Writes its record to
    `record_path`; ``phase_app`` gates it."""
    import logging
    import threading

    from birdnet_go_tpu_torch.app import Application
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
    from birdnet_go_tpu_torch.inference.loader import load_geomodel
    from birdnet_go_tpu_torch.models.geomodel import birdnet_week

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    losses: list[str] = []

    class _Losses(logging.Handler):
        def emit(self, r: logging.LogRecord) -> None:
            msg = r.getMessage()
            if r.levelno >= logging.ERROR or any(w in msg
                                                 for w in APP_WARNINGS):
                losses.append(f"{r.levelname} {r.name}: {msg[:300]}")

    logging.getLogger().addHandler(_Losses())
    out = record_path.parent
    wavs = _app_wavs(out)

    s = Settings()
    s.models = [ModelSettings(model_id="BirdNET_V2.4"),
                ModelSettings(model_id="BirdNET_V3.0", enabled=False)]
    s.database.path = str(out / "app.db")
    s.export.path = str(out / "clips")
    s.export.format = "flac"
    # a clip ends 1.5 s after its window, so the final flush's clips are
    # written within stop()'s drain
    s.export.clip_length_seconds = 6.0
    s.export.pre_capture_seconds = 1.5
    # every approval is saved: the per-species action gate would drop a
    # species' repeats within 15 s, and approved = rows counts saves
    s.realtime.interval_seconds = 0.0
    s.realtime.max_batch = 256
    s.location.latitude, s.location.longitude = APP_LATLON
    s.range_filter.enabled = True
    s.deep_detection.level = 2
    s.dynamic_threshold.enabled = True
    s.webserver.enabled = False
    s.imageprovider.enabled = False
    s.realtime.sources = [
        {"type": "tone", "id": f"tone{k}", "freq": f, "pulse": p}
        for k, (f, p) in enumerate(_app_tones())] + [
        {"type": "file", "id": f"file{k}", "path": str(out / f"loop{k}.wav")}
        for k in range(APP_FILES)]

    warmups = []
    real_warmup = TorchModelBatcher.warmup

    def warmup(self):
        warmups.append(self.spec.model_id)
        return real_warmup(self)

    TorchModelBatcher.warmup = warmup
    step_ms: dict[str, list[tuple[float, float]]] = {}
    for name in ("_launch", "_collect"):
        real = getattr(TorchModelBatcher, name)

        def timed(self, *a, real=real, name=name):
            t_ = time.perf_counter()
            out = real(self, *a)
            step_ms.setdefault(f"{self.spec.model_id} {name}", []).append(
                (time.time(), (time.perf_counter() - t_) * 1e3))
            return out

        setattr(TorchModelBatcher, name, timed)
    t0 = time.monotonic()
    app = Application(s)
    served: dict[str, list[tuple[float, float]]] = {}
    handoff = app._on_window_result

    def on_window(model_id, w, vals, idx):
        served.setdefault(model_id, []).append((w.end_time, time.time()))
        handoff(model_id, w, vals, idx)

    app._on_window_result = on_window
    app.setup()
    setup_s = time.monotonic() - t0
    produced: dict[str, int] = {}
    collect = app.device_loop._providers[0]

    def counted():
        items = collect()
        for it in items:
            produced[it[0]] = produced.get(it[0], 0) + 1
        return items

    app.device_loop._providers[0] = counted
    approved, approved_at = [], []
    on_approved = app.processor.on_approved
    app.processor.on_approved = lambda d, item: (
        approved.append(d.model_id), approved_at.append(time.time()),
        on_approved(d, item))[2]

    # thresholds, as the soak's --calibrate-rate sets them
    inc = app.processor.included_species
    labels = app.labels["BirdNET_V2.4"]
    b24 = app.device_loop.batchers["BirdNET_V2.4"]
    trigger = s.dynamic_threshold.trigger
    cal = {"BirdNET_V2.4": _calibrate(b24, labels, inc,
                                      _cal_windows(48000, CLIP, wavs),
                                      trigger)}
    v3 = BirdNETv3().init(torch.Generator().manual_seed(0))   # load_model's
    b3 = TorchModelBatcher(TorchClassifier(v3, "cuda"), max_batch=256)
    cal["BirdNET_V3.0"] = _calibrate(b3, labels, inc,
                                     _cal_windows(32000, CLIP32, wavs),
                                     trigger)
    del b3, v3
    torch.cuda.empty_cache()
    for ms in s.models:
        ms.threshold = cal[ms.model_id]["threshold"]
        ms.sensitivity = cal[ms.model_id]["sensitivity"]
    app._reload_model_settings()

    # the range filter on the card against the CPU, same Geomodel
    week = birdnet_week(datetime.date.today())
    card_sc = app._range_filter.predict(*APP_LATLON, week)
    cpu_sc = TorchRangeFilter(load_geomodel(num_species=len(labels)),
                              "cpu").predict(*APP_LATLON, week)
    thr = s.range_filter.threshold
    differ = np.nonzero((card_sc >= thr) != (cpu_sc >= thr))[0]
    near = int(np.sum(np.abs(cpu_sc - thr) <= APP_RANGE_MARGIN))
    range_rec = {
        "included_card": int(np.sum(card_sc >= thr)),
        "included_cpu": int(np.sum(cpu_sc >= thr)),
        "differ": int(len(differ)),
        "differ_beyond_margin": int(np.sum(
            np.abs(cpu_sc[differ] - thr) > APP_RANGE_MARGIN)),
        "within_margin": near,
        "max_abs_gap": float(np.abs(card_sc - cpu_sc).max()),
        "included_set_consistent":
            app.processor.included_species
            == app._compute_included_species()}

    for k in KERNELS:
        k.launches = 0
    warmups.clear()
    t1 = time.monotonic()
    app.start(warmup=True)
    start_s = time.monotonic() - t1
    sampler = _StackSampler(app.device_loop._thread.ident)
    t_start = time.time()
    time.sleep(APP_ALONE_S)
    app.device_loop.stall_ms_max = 0.0
    busy_before = app.device_loop.tick_busy_ms_max
    app.device_loop.tick_busy_ms_max = 0.0
    t_load = time.time()
    assert app.load_model_runtime("BirdNET_V3.0")
    t_loaded = time.time()
    load = {"wall_s": round(t_loaded - t_load, 3),
            "tick_stall_ms_max": round(app.device_loop.stall_ms_max, 1),
            "tick_busy_ms_max": round(app.device_loop.tick_busy_ms_max, 1),
            "v24_latency_ms_max": round(max(
                [(h - e) * 1e3 for e, h in served["BirdNET_V2.4"]
                 if t_load <= h <= t_loaded + 0.5] or [0.0]), 1)}
    app.device_loop.tick_busy_ms_max = max(busy_before,
                                           app.device_loop.tick_busy_ms_max)
    time.sleep(APP_BOTH_S)
    batchers = dict(app.device_loop.batchers)
    assert app.unload_model_runtime("BirdNET_V3.0")
    t_unloaded = time.time()
    time.sleep(APP_AFTER_S)
    health = [(r.name, r.healthy, r.detail) for r in app.health.run_all()]
    loop = app.device_loop
    host = {"tick_busy_ms": round(loop.tick_busy_ms, 2),
            "tick_busy_ms_max": round(loop.tick_busy_ms_max, 1),
            "ticks": loop.ticks}
    tick_thread = sampler.stop()
    calls = {k: {"n": len(v), "total_ms": round(sum(x[1] for x in v), 1),
                 "max_ms": round(max(x[1] for x in v), 1),
                 "max_at_s": round(max(v, key=lambda x: x[1])[0] - t_start,
                                   1)}
             for k, v in step_ms.items()}
    cpu = _thread_cpu_s()
    t_end = time.time()
    timeline = []
    for a in np.arange(t_start, t_end, 5.0):
        lat = [(h - e) * 1e3 for e, h in served["BirdNET_V2.4"]
               if a <= h < a + 5.0]
        timeline.append({"t": round(float(a - t_start), 1),
                         "windows": len(lat),
                         **(_pct(lat) if lat else {}),
                         "approved": int(sum(a <= x < a + 5.0
                                             for x in approved_at))})
    t2 = time.monotonic()
    app.stop()
    stop_s = time.monotonic() - t2
    launches = {k.__name__: k.launches for k in KERNELS}
    left = [th.name for th in threading.enumerate()
            if th is not threading.main_thread() and th.is_alive()
            and not th.daemon]
    jq = app.jobqueue.stats
    from birdnet_go_tpu_torch.analysis.jobqueue import (
        CATEGORY_PRIORITY,
        PRIORITY_CRITICAL,
    )

    critical_dropped = sum(c["dropped"] for cat, c in jq.by_category.items()
                           if CATEGORY_PRIORITY.get(cat) == PRIORITY_CRITICAL)
    with contextlib.closing(sqlite3.connect(s.database.path)) as conn:
        rows = conn.execute("SELECT model_id, clip_name FROM detections"
                            ).fetchall()
    clips_dir = Path(s.export.path)
    clips = sorted({c for _, c in rows if c})
    decoded, missing, pngs = 0, [], 0
    for c in clips:
        f = clips_dir / c
        if not f.is_file():
            missing.append(c)
            continue
        pcm, rate = decode_flac(f.read_bytes())
        assert rate == 48000 and len(pcm) > 0, (c, rate, len(pcm))
        decoded += 1
        pngs += f.with_suffix(".png").is_file()
    rec = {
        "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0],
        "setup_s": round(setup_s, 2), "start_s": round(start_s, 2),
        "stop_s": round(stop_s, 2),
        "calibration": cal,
        "range_filter": range_rec,
        "produced": produced,
        "served": {m: len(v) for m, v in served.items()},
        "latency_ms": {m: _pct([(h - e) * 1e3 for e, h in v])
                       for m, v in served.items()},
        "v3_first_after_load_s": round(min(
            h for _, h in served.get("BirdNET_V3.0", [(0, 1e18)]))
            - t_loaded, 3),
        "v3_after_unload": sum(h > t_unloaded for _, h in
                               served.get("BirdNET_V3.0", [])),
        "batchers": {m: dataclasses.asdict(b.stats)
                     for m, b in batchers.items()},
        "windows_dropped": loop.windows_dropped,
        "launches": launches, "warmups": list(warmups),
        "load": load, "host": host, "tick_thread": tick_thread,
        "thread_cpu_s": cpu, "timeline": timeline, "calls": calls,
        "approved": len(approved),
        "approved_by_model": {m: approved.count(m) for m in set(approved)},
        "rows": len(rows), "clips": len(clips), "clips_decoded": decoded,
        "clips_missing": missing[:10], "pngs": pngs,
        "prerender": {"rendered": app.prerenderer.rendered,
                      "dropped": app.prerenderer.dropped},
        "jobqueue": {"enqueued": jq.enqueued, "completed": jq.completed,
                     "failed": jq.failed, "retried": jq.retried,
                     "dropped": jq.dropped,
                     "dropped_critical": critical_dropped},
        "health": health, "threads_left": left,
        "losses": len(losses), "loss_lines": losses[:10],
    }
    record_path.write_text(json.dumps(rec, indent=1))


def _probe_pair() -> tuple[str, str]:
    """``probe_backend`` as it is, and with the card hidden from its child
    (``CUDA_VISIBLE_DEVICES=""``), at once: (the card's name, the second
    probe's error)."""
    from birdnet_go_tpu_torch.utils.backendprobe import (
        BackendUnavailable,
        probe_backend,
    )

    def hidden() -> str:
        try:
            name = probe_backend(timeout_s=120.0, env={
                **os.environ, "CUDA_VISIBLE_DEVICES": ""})
        except BackendUnavailable as e:
            return str(e)
        raise AssertionError(f"the probe without a card returned {name!r}")

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        seen = pool.submit(probe_backend, 120.0)
        refused = pool.submit(hidden)
        return seen.result(), refused.result()


def _serve_leg(card: str, out: Path) -> None:
    """``python -m birdnet_go_tpu_torch serve --config app.json`` as users
    start it (the default device and threshold, the probe on, the API on):
    8 tone sources, a db and an export path in a JSON config, the API on
    127.0.0.1 at a port the OS picks; ``/api/v2/health`` and
    ``/api/v2/system/info`` fetched while it serves, then SIGTERM after
    SERVE_SECONDS of serving. Gates: exit 0, the probe's and serving
    lines, health 200, ``system/info`` naming the card, rows in the db or
    windows in the pipeline-stats log, no traceback."""
    import urllib.request

    cfg = {"database": {"path": str(out / "serve.db")},
           "webserver": {"host": "127.0.0.1", "port": 0},
           "imageprovider": {"providers": ["avicommons"]},
           "export": {"path": str(out / "serve_clips"),
                      "clip_length_seconds": 6.0,
                      "pre_capture_seconds": 1.5},
           "realtime": {"sources": [
               {"type": "tone", "id": f"tone{k}", "freq": f, "pulse": p}
               for k, (f, p) in enumerate(_app_tones()[::6])]}}
    assert len(cfg["realtime"]["sources"]) == SERVE_TONES
    cfg_path = out / "app.json"
    cfg_path.write_text(json.dumps(cfg))
    stdout, stderr = out / "serve.out", out / "serve.log"
    t0 = time.monotonic()
    with open(stdout, "w") as so, open(stderr, "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-m", "birdnet_go_tpu_torch", "serve",
             "--config", str(cfg_path)], stdout=so, stderr=se, cwd=REPO)
        try:
            deadline = time.monotonic() + 300
            while "serving on http" not in stdout.read_text():
                assert proc.poll() is None, \
                    f"serve exited {proc.returncode}:\n" \
                    f"{stderr.read_text()[-4000:]}"
                assert time.monotonic() < deadline, "serve did not start"
                time.sleep(0.2)
            up_s = time.monotonic() - t0
            url = re.search(r"http://[\d.]+:\d+",
                            stdout.read_text()).group(0)
            api = {}
            for route in ("health", "system/info"):
                with urllib.request.urlopen(f"{url}/api/v2/{route}",
                                            timeout=60) as r:
                    api[route] = (r.status, json.loads(r.read()))
            time.sleep(SERVE_SECONDS)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text, log = stdout.read_text(), stderr.read_text()
    with contextlib.closing(sqlite3.connect(cfg["database"]["path"])) as c:
        rows = c.execute("SELECT COUNT(*) FROM detections").fetchone()[0]
    stats = [ln for ln in log.splitlines() if "pipeline: " in ln]
    print(f"app serve: `serve --config app.json` ({SERVE_TONES} tone "
          f"sources) up in {up_s:.1f} s, SIGTERM after {SERVE_SECONDS:.0f} "
          f"s of serving, exit {rc}; {rows} rows in the db"
          + (f", pipeline stats: {stats[-1].split('pipeline: ')[1]}"
             if stats else "") + f" [{card}]")
    print(f"app serve API at {url}: health {api['health'][0]} "
          f"{api['health'][1]['status']}, system/info devices "
          f"{api['system/info'][1]['devices']} [{card}]")
    for line in text.splitlines():
        print(f"app serve stdout: {line}")
    if rc != 0 or "Traceback" in text + log:
        print(log[-6000:])
    assert rc == 0, f"serve exited {rc}"
    assert "backend probe: " in text and f"serving on {url} on cuda" in text
    assert api["health"][0] == api["system/info"][0] == 200, api
    assert any(torch.cuda.get_device_name(0) in d
               for d in api["system/info"][1]["devices"]), api
    assert rows > 0 or stats, "serve served no window that shows"
    assert "Traceback" not in text + log


def phase_app(card: str) -> None:
    """Phase 16, the realtime app and ``serve``: the bounded probe (it
    names the card, and raises with the card hidden from its child); then
    ``app_leg`` in a process of its own (record and log under
    ``build/app_smoke/``), gated here: every window the engine made was
    served (none dropped, no overrun), v2.4's latency p95 below
    APP_P95_MS across v3.0's runtime load, v3.0 served within
    APP_V3_WITHIN_S of its load and not after its unload, the mel kernel
    once a batch over both batchers (and once per warm-up; the MBConv
    kernels never, serving is unfused), approvals = rows, every clip a
    FLAC that decodes with its PNG, every health check ok, the range
    filter's card set the CPU's but for species within APP_RANGE_MARGIN
    of the threshold, no critical job dropped, stop() within APP_STOP_S
    with no thread of the app left, and no error logged; then ``serve``
    as users start it (``_serve_leg``)."""
    t0 = time.monotonic()
    name, refused = _probe_pair()
    print(f"app probe: probe_backend() -> {name!r}; with "
          f"CUDA_VISIBLE_DEVICES='' it raised: {refused} [{card}]")
    assert name == torch.cuda.get_device_name(0)
    assert "--device cpu" in refused
    out = REPO / "build" / "app_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    rec_path = out / "app.json"
    t1 = time.monotonic()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           "--app-leg", str(rec_path)], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    wall = time.monotonic() - t1
    (out / "app.log").write_text(proc.stderr)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-6000:])
    assert proc.returncode == 0, f"the app leg exited {proc.returncode}"
    rec = json.loads(rec_path.read_text())
    lat, b, load = rec["latency_ms"], rec["batchers"], rec["load"]
    batches = sum(v["batches_dispatched"] for v in b.values())
    print(f"app: {APP_TONES} tone + {APP_FILES} file sources, v2.4 "
          f"{APP_ALONE_S:.0f} s alone, + v3.0 {APP_BOTH_S:.0f} s, "
          f"{APP_AFTER_S:.0f} s after its unload; process {wall:.1f} s "
          f"(setup {rec['setup_s']} s, start with warm-up {rec['start_s']} "
          f"s, stop {rec['stop_s']} s) [{rec['card']}]")
    print(f"app calibration (the soak's rule at {APP_RATE}): "
          f"{rec['calibration']}")
    for m, v in b.items():
        print(f"app {m}: produced {rec['produced'].get(m, 0)}, served "
              f"{rec['served'].get(m, 0)} windows in "
              f"{v['batches_dispatched']} batches, overruns {v['overruns']},"
              f" latency from the window's end (ms) {lat.get(m)} [{card}]")
    print(f"app runtime load of v3.0: {load['wall_s']} s on the caller's "
          f"thread; v2.4 tick stall max {load['tick_stall_ms_max']} ms, tick "
          f"busy max {load['tick_busy_ms_max']} ms, v2.4 latency max "
          f"{load['v24_latency_ms_max']} ms meanwhile; v3.0's first window "
          f"{rec['v3_first_after_load_s']} s after the load returned, "
          f"{rec['v3_after_unload']} after the unload [{card}]")
    print(f"app kernels: launches {rec['launches']} for {batches} batches "
          f"and warm-ups {rec['warmups']}")
    print(f"app detections: approved {rec['approved']} "
          f"({rec['approved_by_model']}; "
          f"{rec['approved'] / max(1, sum(rec['served'].values())):.4f} of "
          f"the windows served), rows {rec['rows']}, clips "
          f"{rec['clips']} (decoded {rec['clips_decoded']}), PNGs "
          f"{rec['pngs']}, prerender {rec['prerender']}, job queue "
          f"{rec['jobqueue']}")
    print(f"app range filter card vs CPU: {rec['range_filter']}")
    print(f"app tick thread, stack samples every 10 ms: "
          f"{rec['tick_thread']}")
    print(f"app CPU seconds by thread: {rec['thread_cpu_s']}")
    print(f"app batcher calls: {rec['calls']}")
    for s in rec["timeline"]:
        print(f"app timeline: {s}")
    print(f"app host plane: {rec['host']}; health "
          f"{[(n, ok) for n, ok, _ in rec['health']]}; threads left "
          f"{rec['threads_left']}; errors logged {rec['losses']} "
          f"{rec['loss_lines']}")
    for m, v in b.items():
        assert rec["produced"].get(m, 0) == rec["served"].get(m, 0) > 0, m
        assert v["overruns"] == 0, (m, v)
    assert rec["windows_dropped"] == 0
    assert lat["BirdNET_V2.4"]["p95"] < APP_P95_MS, lat
    assert 0 <= rec["v3_first_after_load_s"] <= APP_V3_WITHIN_S, rec
    assert rec["v3_after_unload"] == 0
    assert rec["launches"]["melspec_fused"] == batches + len(rec["warmups"])
    assert sorted(rec["warmups"]) == ["BirdNET_V2.4", "BirdNET_V3.0"]
    assert rec["launches"]["expand_dw_pool"] == 0
    assert rec["launches"]["scale_project"] == 0
    assert rec["approved"] == rec["rows"] > 0, rec
    assert rec["clips"] == rec["clips_decoded"] == rec["pngs"] > 0, rec
    assert not rec["clips_missing"], rec["clips_missing"]
    assert all(ok for _, ok, _ in rec["health"]), rec["health"]
    rf = rec["range_filter"]
    assert rf["differ_beyond_margin"] == 0 and rf["included_set_consistent"]
    assert rec["jobqueue"]["dropped_critical"] == 0, rec["jobqueue"]
    assert rec["jobqueue"]["failed"] == 0, rec["jobqueue"]
    assert rec["prerender"]["dropped"] == 0
    assert rec["stop_s"] <= APP_STOP_S and not rec["threads_left"], rec
    assert rec["losses"] == 0, rec["loss_lines"]
    _serve_leg(card, out)
    print(f"phase 16 (app) {time.monotonic() - t0:.1f} s [{card}]")


CRASH_STREAMS = 2000         # phase 17: the soak's north-star size
CRASH_KILL_ROWS = 200        # rows committed before the SIGKILL
CRASH_RESTART_S = 10.0       # the restart leg, in the recovered database
CRASH_P95_MS = 1500.0        # the restart leg's latency p95, half the clip


def _cli_run(argv: list[str], timeout: float = 120.0
             ) -> subprocess.CompletedProcess:
    """``python -m birdnet_go_tpu_torch <argv>`` in a process of its own."""
    return subprocess.run([sys.executable, "-m", "birdnet_go_tpu_torch",
                           *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def phase_crash(card: str) -> None:
    """Phase 17, crash recovery: ``python -m
    birdnet_go_tpu_torch.scheduler.crashleg --device cuda`` in a process of
    its own over CRASH_STREAMS streams (record, tree and logs under
    ``build/crash_smoke/``): a durable soak on the card SIGKILLed once
    CRASH_KILL_ROWS rows and a threshold have landed, ``recover_startup``
    twice, then a CRASH_RESTART_S restart leg on the card in the recovered
    database. Gates: the record's ``pass``; the kill by SIGKILL after the
    rows and a threshold, and no process of the victim's left; the
    ledger's integrity ``ok``, no duplicate detection, a threshold
    restored and a species resynced; recovery idempotent; the restart
    leg restoring at its start at least the thresholds persisted before
    the kill, with the database's levels; the restart
    leg's ``after == before + persisted`` with rows persisted, no sample
    lost, no critical job dropped, latency p95 below CRASH_P95_MS and the
    mel kernel launched once a batch. Then the operator's commands on the tree the leg left:
    ``recover --ignore-recency`` exits 0 with nothing left to heal, ``db
    doctor`` reports it healthy, and ``support``'s ``system.json`` names
    the card."""
    t0 = time.monotonic()
    out = REPO / "build" / "crash_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    tree, rec_path = out / "tree", out / "crash.json"
    proc = subprocess.run(
        [sys.executable, "-m", "birdnet_go_tpu_torch.scheduler.crashleg",
         "--device", "cuda", "--streams", str(CRASH_STREAMS),
         "--kill-min-rows", str(CRASH_KILL_ROWS), "--restart-seconds",
         str(CRASH_RESTART_S), "--workdir", str(tree), "--out",
         str(rec_path)], capture_output=True, text=True, timeout=600,
        cwd=REPO)
    leg_s = time.monotonic() - t0
    (out / "crash.log").write_text(proc.stderr)
    if proc.returncode != 0:
        print(proc.stderr[-6000:])
        victim = tree / "victim.log"
        if victim.exists():
            print(victim.read_text(errors="replace")[-4000:])
    assert rec_path.exists(), f"the crash leg exited {proc.returncode}"
    rec = json.loads(rec_path.read_text())["runs"][-1]
    v, led, r = rec["victim"], rec["recovery_ledger"], rec["restart"]
    cal = r["threshold_calibration"] or {}
    print(f"crash victim: `soak --device {rec['device']} --durable` of "
          f"{rec['streams']} "
          f"streams SIGKILLed at {v['killed_at_s']} s (rc {v['returncode']})"
          f" after {v['rows_committed_before_kill']} rows and "
          f"{v['thresholds_before_kill']} thresholds; {v['clips_on_disk_at_kill']}"
          f" clips on disk, WAL {v['wal_left_behind_bytes']} bytes left; "
          f"calibrated threshold {v['calibrated_threshold']} against the "
          f"dynamic trigger {rec['trigger']}; victim's group alive after the "
          f"kill: {v['group_alive_after_kill']} [{rec['card']}]")
    for line in (tree / "victim.log").read_text(
            errors="replace").splitlines():
        if "calibrat" in line:
            print(f"crash victim log: {line.split(' ', 2)[-1]}")
    print(f"crash recovery ({rec['recovery_seconds']} s, twice): {led}; "
          f"idempotent {rec['recovery_idempotent']}")
    print(f"crash restart: card memory before it (torch.cuda.mem_get_info) "
          f"{r['card_memory_free_gib']} GiB free of "
          f"{r['card_memory_total_gib']} GiB; {r['seconds']} s: rows "
          f"{r['detections_before']} + {r['detections_persisted']} persisted "
          f"= {r['detections_after']} ({r['exact_count_equation_holds']}), "
          f"{r['approved']} approved, duplicates "
          f"{r['duplicate_detections']}, integrity {r['integrity']}, "
          f"thresholds restored at its start {r['thresholds_restored']} "
          f"(>= {v['thresholds_before_kill']} before the kill: "
          f"{r['thresholds_restored_ge_before_kill']}; levels equal to the "
          f"database's rows: {r['restored_levels_match_db']})")
    print(f"crash restart calibration: threshold {cal.get('threshold')} at "
          f"sensitivity {cal.get('sensitivity')}, trigger "
          f"{cal.get('trigger')}, dynamic floor {cal.get('dynamic_floor')}")
    print(f"crash restart latency from the window's realtime end (ms): "
          f"{r['latency_ms']}; drops {r['drop_accounting']}; mel kernel "
          f"launches {r['mel_kernel_launches']} for "
          f"{r['batches_dispatched']} batches [{card}]")
    assert rec["pass"], rec
    assert v["signal"] == "SIGKILL" and v["returncode"] == -signal.SIGKILL
    assert v["rows_committed_before_kill"] >= CRASH_KILL_ROWS, v
    assert v["thresholds_before_kill"] >= 1, v
    assert not v["group_alive_after_kill"], v
    assert led["integrity"] == "ok" and led["duplicate_detections"] == 0
    assert led["thresholds_restored"] >= 1 and led["species_resynced"] >= 1
    assert rec["recovery_idempotent"]
    assert r["thresholds_restored"] >= v["thresholds_before_kill"], r
    assert r["restored_levels_match_db"], r
    assert r["exact_count_equation_holds"] and r["detections_persisted"] > 0
    assert r["drop_accounting"]["farm_samples_lost"] == 0, r
    assert r["drop_accounting"]["jobqueue_dropped_critical"] == 0, r
    assert r["latency_ms"]["p95"] < CRASH_P95_MS, r["latency_ms"]
    assert r["mel_kernel_launches"] == r["batches_dispatched"] > 0, r

    # the operator's path on the tree the leg left
    db, clips = str(tree / "birds.db"), str(tree / "clips")
    t1 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        support = pool.submit(_cli_run, ["support", "--output", str(out)])
        recov = _cli_run(["recover", "--db", db, "--clips-dir", clips,
                          "--ignore-recency"])
        doctor = _cli_run(["db", "doctor", "--db", db])
        support = support.result()
    ops_s = time.monotonic() - t1
    for name, p in (("recover", recov), ("db doctor", doctor),
                    ("support", support)):
        if p.returncode != 0:
            print(f"{name} exited {p.returncode}:\n{p.stderr[-3000:]}")
    assert recov.returncode == doctor.returncode == support.returncode == 0
    ledger, report = json.loads(recov.stdout), json.loads(doctor.stdout)
    (bundle,) = out.glob("support-bundle-*.tar.gz")
    with tarfile.open(bundle) as tar:
        sysinfo = json.loads(tar.extractfile("system.json").read())
    print(f"crash operator: recover --ignore-recency {ledger['clips']}, "
          f"{ledger['detections']} rows; db doctor healthy "
          f"{report['healthy']} ({report['detections']} rows, issues "
          f"{report['issues']}); support system.json devices "
          f"{sysinfo['devices']} (torch {sysinfo['torch']}, CUDA "
          f"{sysinfo['cuda']}); {ops_s:.1f} s")
    assert ledger["integrity"] == "ok"
    assert ledger["clips"]["orphan_files_swept"] == 0
    assert ledger["clips"]["dangling_refs_cleared"] == 0
    assert report["healthy"], report
    assert card.split(",")[0].strip() in sysinfo["devices"], sysinfo
    print(f"phase 17 (crash) {time.monotonic() - t0:.1f} s (the leg's "
          f"process {leg_s:.1f} s) [{card}]")


API_TONES = 16               # phase 18: the API leg's tone sources
API_FILES = 4                # ... and its file sources (phase 16's WAVs)
API_SECONDS = 30.0           # the leg's serving, its walks included
API_WALKS = 2                # walks of diag/api_walk.py
API_UNLOAD_AFTER_S = 10.0    # a walk unloads v3.0 this long after its load
API_P95_MS = 1500.0          # v2.4's latency p95 with the API serving
API_STOP_S = 15.0            # stop() returns within, SSE clients connected
API_PASSWORD = "chip-smoke"
API_HEAT_RES = 90            # the heatmap's resolution: 90 x 180 points
API_HEAT_WEEK = 20
API_HEAT_BLOCK = 6           # heatmaps back to back, a block a mode:
API_HEAT_MODES = ("step", "own", "own", "step")
API_ZERO_TAIL_S = 0.60       # an HLS segment's zeros where audio was due
API_HEAT_TOL = 1e-5          # card vs CPU per species score (phase 9's
                             # gate), summed over the species of a point


def _segment_samples(segment: bytes) -> int:
    """The samples of an fMP4 media segment: the sum of its ``trun``
    sample durations (flags 0x301: data offset, then a duration and a
    size a sample)."""
    p = segment.index(b"trun")
    n = struct.unpack(">I", segment[p + 8:p + 12])[0]
    return sum(struct.unpack(">I", segment[p + 16 + 8 * i:p + 20 + 8 * i])[0]
               for i in range(n))


def _split_by_spans(served: list[tuple[float, float]], spans: list
                    ) -> tuple[list[float], list[float]]:
    """v2.4's latencies (ms) of the windows harvested inside any of
    `spans` (wall-clock intervals), and of the others."""
    inside, outside = [], []
    for end, at in served:
        hit = any(a <= at <= b for a, b in spans)
        (inside if hit else outside).append((at - end) * 1e3)
    return inside, outside


def _in_flight_max(served: list[tuple[float, float]],
                   span: tuple[float, float]) -> float:
    """v2.4's largest latency (ms) of the windows in flight during
    `span` (a wall-clock interval: a runtime load): those that ended
    before it ended and were served after it began, so that one a tick
    held back behind the load's warm-up counts."""
    a, b = span
    return round(max([(h - e) * 1e3 for e, h in served if e <= b and h >= a]
                     or [0.0]), 1)


def _zero_tail(pcm: np.ndarray) -> int:
    """How many samples an HLS segment ends with that its session read as
    zeros: ``read_segment`` fills what the source has not delivered yet,
    which a tone source held up (the engine's gate, the GIL) owes until
    its next push, where it pushes all it owes at once."""
    return len(pcm) - len(np.trim_zeros(pcm, "b"))


def api_leg(record_path: Path) -> None:
    """Phase 18's API leg, in a process of its own (``python3
    chip_smoke.py --api-leg <record.json>``): the ``Application`` on the
    card at full width (v2.4 at batch 256, unfused, seeded weights; v3.0
    loaded and unloaded at runtime over HTTP), API_TONES tone and
    API_FILES file sources, FLAC clips, the range filter, sound levels, a
    SQLite file; its API on ``127.0.0.1`` at a port the OS picks, with a
    password and no local bypass, so that the login, the session cookie,
    CSRF and the security middleware are on every request. Thresholds are
    calibrated as phase 16's. While it serves API_SECONDS, a client holds
    ``detections/stream`` and another ``soundlevels/stream``, and a
    logged-in client walks ``diag/api_walk.py`` API_WALKS times (the first
    walk decodes its spectrogram's clip in the app's codec workers, the
    app's own way, the last on the handler's thread, as JAX does: after
    that walk's HLS segment, whose zero tail then counts what the port's
    own way and the loads held tone0 back, not JAX's decode), then
    requests blocks of API_HEAT_BLOCK heatmaps back to back, in the turns
    of API_HEAT_MODES: the range filter's way (its own stream, the scores
    copied into pinned memory) and JAX's (the served step's stream, a
    pageable copy). The v2.4 windows harvested during each request and each block
    give the served step's latency beside it. Then, the app stopped, the
    leg checks the HLS segments, renders the heatmap's grid on the CPU and
    the spectrogram's clip on the card and the CPU. Writes its record to `record_path`;
    ``phase_api`` gates it."""
    import logging
    import threading

    from birdnet_go_tpu_torch.app import Application
    from birdnet_go_tpu_torch.audio.encode import load_clip_audio
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
    from birdnet_go_tpu_torch.diag.api_walk import (
        Client,
        SseReader,
        route_times,
        walk,
    )

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    losses: list[str] = []

    class _Losses(logging.Handler):
        def emit(self, r: logging.LogRecord) -> None:
            msg = r.getMessage()
            if r.levelno >= logging.ERROR or any(w in msg
                                                 for w in APP_WARNINGS):
                losses.append(f"{r.levelname} {r.name}: {msg[:300]}")

    logging.getLogger().addHandler(_Losses())
    out = record_path.parent
    wavs = _app_wavs(out)[:API_FILES]
    tones = _app_tones()[::APP_TONES // API_TONES]
    assert len(tones) == API_TONES

    s = Settings()
    s.models = [ModelSettings(model_id="BirdNET_V2.4"),
                ModelSettings(model_id="BirdNET_V3.0", enabled=False)]
    s.data_dir = str(out)
    s.database.path = str(out / "api.db")
    s.export.path = str(out / "clips")
    s.export.format = "flac"
    s.export.clip_length_seconds = 6.0
    s.export.pre_capture_seconds = 1.5
    s.realtime.interval_seconds = 0.0     # every approval saved and sent
    s.realtime.max_batch = 256
    s.location.latitude, s.location.longitude = APP_LATLON
    s.range_filter.enabled = True
    ws = s.webserver
    ws.enabled, ws.host, ws.port = True, "127.0.0.1", 0
    ws.password, ws.allow_local_bypass = API_PASSWORD, False
    ws.token_file = str(out / "tokens.json")
    s.imageprovider.providers = ["avicommons"]   # nothing leaves the host
    s.realtime.sources = [
        {"type": "tone", "id": f"tone{k}", "freq": f, "pulse": p}
        for k, (f, p) in enumerate(tones)] + [
        {"type": "file", "id": f"file{k}", "path": str(out / f"loop{k}.wav")}
        for k in range(API_FILES)]

    # the HLS sessions mux FLAC, whose segments are held to the PCM they
    # encode bit for bit (phase 21 serves AAC where the machine offers it)
    from birdnet_go_tpu_torch.audio import aacenc
    aacenc.available = lambda: False
    warmups, warm_spans, added = [], [], []
    _timed_warmups(warmups, warm_spans)
    app = Application(s)
    served: dict[str, list[tuple[float, float]]] = {}
    handoff = app._on_window_result

    def on_window(model_id, w, vals, idx):
        served.setdefault(model_id, []).append((w.end_time, time.time()))
        handoff(model_id, w, vals, idx)

    app._on_window_result = on_window
    t0 = time.monotonic()
    app.setup()
    setup_s = time.monotonic() - t0
    real_add = app.device_loop.add_batcher

    def add_batcher(b):
        added.append(b)
        return real_add(b)

    app.device_loop.add_batcher = add_batcher
    added += list(app.device_loop.batchers.values())
    approved = []
    on_approved = app.processor.on_approved
    app.processor.on_approved = lambda d, item: (
        approved.append(d.model_id), on_approved(d, item))[1]

    inc = app.processor.included_species
    labels = app.labels["BirdNET_V2.4"]
    b24 = app.device_loop.batchers["BirdNET_V2.4"]
    trigger = s.dynamic_threshold.trigger
    cal = {"BirdNET_V2.4": _calibrate(
        b24, labels, inc, _cal_windows(48000, CLIP, wavs, tones), trigger)}
    v3 = BirdNETv3().init(torch.Generator().manual_seed(0))   # load_model's
    b3 = TorchModelBatcher(TorchClassifier(v3, "cuda"), max_batch=256)
    cal["BirdNET_V3.0"] = _calibrate(
        b3, labels, inc, _cal_windows(32000, CLIP32, wavs, tones), trigger)
    del b3, v3
    torch.cuda.empty_cache()
    for ms in s.models:
        ms.threshold = cal[ms.model_id]["threshold"]
        ms.sensitivity = cal[ms.model_id]["sensitivity"]
    app._reload_model_settings()
    returns = _ingest_returns(app.engine)
    closings, gcs, holds = _watch_gate(app.engine)

    for k in KERNELS:
        k.launches = 0
    warmups.clear()
    warm_spans.clear()
    t1 = time.monotonic()
    app.start(warmup=True)
    start_s = time.monotonic() - t1
    client = Client(app.api.port, API_PASSWORD)
    client.login()
    readers = [SseReader(client, "/api/v2/detections/stream"),
               SseReader(client, "/api/v2/soundlevels/stream")]
    for r in readers:
        r.start()
    t_start = time.time()
    clips = Path(s.export.path)
    row, deadline = None, time.monotonic() + 20
    while row is None and time.monotonic() < deadline:
        row = next((r for r in app.datastore.recent_detections(50)
                    if r["model_id"] == "BirdNET_V2.4" and r["clip_name"]
                    and (clips / r["clip_name"]).is_file()
                    and (clips / r["clip_name"]).with_suffix(".png")
                    .is_file()), None)
        time.sleep(0.25)
    assert row is not None, "no detection with a clip and its PNG in 20 s"
    rf = app._range_filter
    records, hls = [], []
    heat_url = (f"/api/v2/range/heatmap?resolution={API_HEAT_RES}"
                f"&week={API_HEAT_WEEK}")
    # what each HLS segment's FLAC frames encode, to hold its decode to
    encoded: list[np.ndarray] = []
    real_frames = hlsmux.encode_flac_frames

    def recorded_frames(pcm, rate, **kw):
        encoded.append(np.array(pcm))
        return real_frames(pcm, rate, **kw)

    hlsmux.encode_flac_frames = recorded_frames
    for i in range(API_WALKS):
        # the last walk decodes the clip of its spectrogram on the
        # handler's thread, as JAX does (after its HLS segment: the decode
        # holds the GIL, and every source waits meanwhile); the others in
        # the codec workers
        jax_decode = i == API_WALKS - 1
        if jax_decode:
            app.clip_encoder.decode = load_clip_audio
        recs, bodies = walk(
            client, detection_id=row["id"], clip=row["clip_name"],
            source="tone0", unload_after_s=API_UNLOAD_AFTER_S,
            heatmap_resolution=API_HEAT_RES, heatmap_week=API_HEAT_WEEK,
            range_point=APP_LATLON,
            range_threshold=s.range_filter.threshold,
            png_path=(clips / row["clip_name"]).with_suffix(".png"))
        if jax_decode:
            del app.clip_encoder.decode
        for r in recs:
            r["walk"] = i
        records += recs
        # decoded after stop(): the Python FLAC decoder holds the GIL
        hls.append((bodies["hls_segment"], bodies["hls_init"]))
    last = bodies
    # the heatmap's effect on the served step: blocks of API_HEAT_BLOCK
    # back-to-back heatmaps in turns, the range filter's way ("own": its
    # own stream, the scores into pinned memory) and JAX's ("step": the
    # served step's stream, a pageable copy back)

    def on_step(coords):
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(coords, np.float32),
                                device=rf.device)
            return rf.geomodel(x).cpu().numpy()

    blocks = []
    for mode in API_HEAT_MODES:
        if mode == "step":
            rf._scores = on_step
        t_a = time.time()
        for _ in range(API_HEAT_BLOCK):
            st, _, _, _ = client.call("GET", heat_url)
            assert st == 200, st
        blocks.append((mode, t_a, time.time()))
        rf.__dict__.pop("_scores", None)
    time.sleep(max(0.0, t_start + API_SECONDS - time.time()))
    t_end = time.time()
    # how far each tone's capture buffer ends behind the wall clock (a
    # tone pushes 0.1 s ahead; what a stall withheld it pushes at once)
    behind = {t["id"]: round(t_end - app.engine.capture_buffer(t["id"])
                             .window()[1], 3)
              for t in s.realtime.sources if t["type"] == "tone"}
    connected = [not r.ended.is_set() for r in readers]
    t2 = time.monotonic()
    app.stop()
    stop_s = time.monotonic() - t2
    for r in readers:
        r.ended.wait(10)
        r.close()
    hlsmux.encode_flac_frames = real_frames
    for k, (seg, init) in enumerate(hls):
        # the HLS segment: its FLAC frames decode to the PCM they encode
        info = streaminfo_block(48000, _segment_samples(seg))
        pcm, rate = decode_flac(b"fLaC" + bytes([0x80, 0, 0, len(info)])
                                + info + _mdat(seg))
        hls[k] = {"samples": len(pcm), "rate": rate,
                  "lossless": any(np.array_equal(pcm, e) for e in encoded),
                  "zero_tail": _zero_tail(pcm), "init_bytes": len(init),
                  "segment_bytes": len(seg)}
    launches = {k.__name__: k.launches for k in KERNELS}
    left = [th.name for th in threading.enumerate()
            if th is not threading.main_thread() and th.is_alive()
            and not th.daemon]
    with contextlib.closing(sqlite3.connect(s.database.path)) as conn:
        rows = conn.execute("SELECT COUNT(*) FROM detections").fetchone()[0]

    # the heatmap against the app's Geomodel copied to the CPU, same grid
    values = np.asarray(json.loads(last["heatmap"])["values"], np.float64)
    lats = np.linspace(-85, 85, API_HEAT_RES)
    lons = np.linspace(-180, 180, 2 * API_HEAT_RES)
    grid = np.stack(np.meshgrid(lats, lons, indexing="ij"), axis=-1)
    coords = np.concatenate([grid.reshape(-1, 2),
                             np.full((grid.shape[0] * grid.shape[1], 1),
                                     float(API_HEAT_WEEK))], axis=1)
    cpu_rf = TorchRangeFilter(copy.deepcopy(rf.geomodel).cpu(), "cpu")
    t3 = time.perf_counter()
    cpu_sum = cpu_rf.predict_batch(coords).sum(axis=1).reshape(values.shape)
    cpu_heat_s = time.perf_counter() - t3
    # the spectrogram: the PNG served, the card's render of its clip, and
    # the CPU's colour index against the card's
    png = out / "served.png"
    png.write_bytes(last["spectrogram"])
    samples, rate = load_clip_audio(clips / row["clip_name"])
    rgb = render_spectrogram(samples, rate, 800, device="cuda")
    gap = np.abs(spectrogram_index(samples, rate, 800, device="cuda")
                 .astype(int) - spectrogram_index(samples, rate, 800,
                                                  device="cpu"))
    info = json.loads(last["system_info"])
    v24 = served.get("BirdNET_V2.4", [])
    during, busy = {}, []
    for mode in dict.fromkeys(API_HEAT_MODES):
        spans = [(a, b) for m, a, b in blocks if m == mode]
        busy += spans
        lat_in = _split_by_spans(v24, spans)[0]
        during[mode] = _pct(lat_in or [0.0]) | {
            "windows": len(lat_in), "heatmaps": API_HEAT_BLOCK * len(spans),
            "wall_ms": round(sum(b - a for a, b in spans) * 1e3
                             / (API_HEAT_BLOCK * len(spans)), 1)}
    outside = _split_by_spans(v24, busy + [(r["t0"], r["t1"])
                                           for r in records])[1]
    loads = [(r["t0"], r["t1"]) for r in records
             if r["route"] == "POST models/load/{id}"]
    stalls = _stalls(returns, loads, busy + [(r["t0"], r["t1"])
                                             for r in records],
                     t_start + LIVE_SETTLE_S)
    by_route: dict[str, float] = {}
    for r in records:
        key = f"{r['route']} (walk {r['walk']})"
        lat_in = _split_by_spans(v24, [(r["t0"], r["t1"])])[0]
        by_route[key] = round(max(lat_in or [0.0]), 1)
    rec = {
        "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0],
        "setup_s": round(setup_s, 2), "start_s": round(start_s, 2),
        "stop_s": round(stop_s, 2), "served_s": round(t_end - t_start, 1),
        "calibration": cal,
        "statuses": [(r["route"], r["status"], r["want"]) for r in records],
        "route_ms": route_times(records),
        "v24_latency_during_heatmaps": during,
        "v24_latency_outside_requests": _pct(outside or [0.0]),
        "v24_latency_max_during_route": by_route,
        "heatmap": {"shape": list(values.shape),
                    "finite": bool(np.isfinite(values).all()),
                    "sum": float(values.sum()),
                    "cpu_sum": float(cpu_sum.sum()),
                    "max_abs_gap": float(np.abs(values - cpu_sum).max()),
                    "species": len(labels), "cpu_s": round(cpu_heat_s, 2)},
        "spectrogram": {"png_equals_card_render": bool(np.array_equal(
                            png_pixels(png), rgb)),
                        "index_gap_max": int(gap.max()),
                        "index_gap_share": float((gap > 0).mean()),
                        "detection": row["id"], "clip": row["clip_name"]},
        "clip_range_ok": last["clip_range"]
        == (clips / row["clip_name"]).read_bytes()[:4096],
        "hls": hls,
        "capture_behind_s": {"tone0": behind["tone0"],
                             "max": max(behind.values())},
        "system_info_devices": info["devices"],
        "range_test": json.loads(last["range_test"]),
        "sse": {"detection": len(readers[0].named("detection")),
                "soundlevel": len(readers[1].named("soundlevel")),
                "connected_at_stop": connected,
                "status": [r.status for r in readers]},
        "approved": len(approved),
        "approved_by_model": {m: approved.count(m) for m in set(approved)},
        "rows": rows,
        "latency_ms": {m: _pct([(h - e) * 1e3 for e, h in v])
                       for m, v in served.items()},
        "batches": sum(b.stats.batches_dispatched for b in added),
        "batchers": [b.spec.model_id for b in added],
        "windows_dropped": app.device_loop.windows_dropped,
        "launches": launches, "warmups": list(warmups),
        "stalls": stalls, "tick_ms": s.realtime.tick_ms,
        "v24_max_during_loads_ms": [_in_flight_max(v24, span)
                                    for span in loads],
        "gate": _gate_record(
            closings, gcs, holds, warm_spans, returns, loads,
            busy + [(r["t0"], r["t1"]) for r in records], t_start,
            {f"{r['route']} (walk {r['walk']})": [(r["t0"], r["t1"])]
             for r in records} | {f"heatmaps {m}": [
                 (a, b) for x, a, b in blocks if x == m]
                 for m in API_HEAT_MODES}, watch="tone0"),
        "threads_left": left, "losses": len(losses),
        "loss_lines": losses[:10],
    }
    record_path.write_text(json.dumps(rec, indent=1))


def phase_api(card: str) -> None:
    """Phase 18, the API on the card: ``api_leg`` in a process of its own
    (record and log under ``build/api_smoke/``), gated here: every request
    of both walks answers the status ``diag/api_walk.py`` holds it to
    (the statuses ``tests/test_torch_api.py`` gets from the port on the
    CPU); ``system/info`` names the card; the heatmap (90 x 180 points,
    v2.4's 6,522 species) is finite and within API_HEAT_TOL a score of the
    app's Geomodel copied to the CPU; the served PNG decodes and is the card's
    render, whose colour index is the CPU's within 1 level at no more
    than AUX_INDEX_SHARE of the pixels (phase 15's tolerance); each HLS
    segment's 2 s decode to the PCM its session encoded, bit for bit (the
    zeros it read where the source had not delivered yet are printed:
    ``_zero_tail``); the clip's
    Range is the file's first bytes; SSE detection events = approvals =
    rows; no window dropped and v2.4's latency p95 below API_P95_MS; the
    mel kernel once a batch and once a warm-up, v3.0's loads over HTTP
    included, the MBConv kernels never; ``stop()`` within API_STOP_S with
    both SSE clients still connected; nothing logged at ERROR. Prints
    each route's p50/p95 time and the heatmap's wall time on either
    stream."""
    t0 = time.monotonic()
    out = REPO / "build" / "api_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    rec_path = out / "api.json"
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           "--api-leg", str(rec_path)], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    wall = time.monotonic() - t0
    (out / "api.log").write_text(proc.stderr)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-6000:])
    assert proc.returncode == 0, f"the API leg exited {proc.returncode}"
    _api_gates(json.loads(rec_path.read_text()), wall,
               torch.cuda.get_device_name(0))
    print(f"phase 18 (API) {time.monotonic() - t0:.1f} s [{card}]")


def _api_gates(rec: dict, wall: float, kind: str) -> None:
    """Phase 18's prints and gates on the API leg's record; `kind` is the
    card's name."""
    lat, heat, spec = rec["latency_ms"], rec["heatmap"], rec["spectrogram"]
    print(f"api: {API_TONES} tone + {API_FILES} file sources, v2.4 at batch "
          f"256 with the API on 127.0.0.1 (password, no local bypass), "
          f"{rec['served_s']} s served, {API_WALKS} walks; process "
          f"{wall:.1f} s (setup {rec['setup_s']} s, start {rec['start_s']} "
          f"s, stop {rec['stop_s']} s) [{rec['card']}]")
    for route, t in rec["route_ms"].items():
        print(f"api route {route}: n {t['n']}, p50 {t['p50']} ms, p95 "
              f"{t['p95']} ms, max {t['max']} ms [{rec['card']}]")
    where = {"step": "the served step's stream, copied back pageable",
             "own": "their own stream, copied into pinned memory"}
    for mode, d in rec["v24_latency_during_heatmaps"].items():
        print(f"api heatmaps {API_HEAT_RES} x {2 * API_HEAT_RES} on "
              f"{where[mode]}: {d['heatmaps']} back to back, "
              f"{d['wall_ms']} ms "
              f"wall each; v2.4 latency (ms) of the {d['windows']} windows "
              f"harvested meanwhile p50 {d['p50']}, p95 {d['p95']}, max "
              f"{d['max']} [{rec['card']}]")
    print(f"api v2.4 latency (ms) outside every request: "
          f"{rec['v24_latency_outside_requests']}; its largest during each "
          f"request: {rec['v24_latency_max_during_route']} [{rec['card']}]")
    print(f"api heatmap vs the CPU: {heat}; range test "
          f"{rec['range_test']}; system/info devices "
          f"{rec['system_info_devices']}")
    print(f"api spectrogram: {spec}; clip Range {rec['clip_range_ok']}; "
          f"HLS {rec['hls']}; the tones' capture buffers end behind the "
          f"wall clock at the leg's end by (s) {rec['capture_behind_s']}")
    print(f"api SSE: {rec['sse']}; approved {rec['approved']} "
          f"({rec['approved_by_model']}), rows {rec['rows']}; latency "
          f"{lat} [{rec['card']}]")
    print(f"api kernels: launches {rec['launches']} for {rec['batches']} "
          f"batches ({rec['batchers']}) and warm-ups {rec['warmups']}; "
          f"calibration {rec['calibration']}; windows dropped "
          f"{rec['windows_dropped']}; threads left {rec['threads_left']}; "
          f"errors logged {rec['losses']} {rec['loss_lines']}")
    bad = [r for r in rec["statuses"] if r[1] != r[2]]
    assert not bad and len(rec["statuses"]) >= 2 * 22, bad
    assert kind in " ".join(rec["system_info_devices"]), \
        rec["system_info_devices"]
    assert heat["finite"] and heat["shape"] == [API_HEAT_RES,
                                                2 * API_HEAT_RES], heat
    assert heat["max_abs_gap"] <= API_HEAT_TOL * heat["species"], heat
    assert abs(heat["sum"] - heat["cpu_sum"]) <= API_HEAT_TOL * \
        heat["species"] * API_HEAT_RES * 2 * API_HEAT_RES, heat
    assert spec["png_equals_card_render"], spec
    assert spec["index_gap_max"] <= 1, spec
    assert spec["index_gap_share"] <= AUX_INDEX_SHARE, spec
    assert all(h["lossless"] and h["rate"] == 48000
               and h["samples"] == 2 * 48000 for h in rec["hls"]), rec["hls"]
    # a source held up stays behind the wall clock and its segments end
    # in zeros: no more than API_ZERO_TAIL_S, the most measured before a
    # warm-up stopped holding the sources
    assert all(h["zero_tail"] <= API_ZERO_TAIL_S * 48000
               for h in rec["hls"]), rec["hls"]
    _stall_gate(rec, "api")
    assert rec["clip_range_ok"]
    sse = rec["sse"]
    assert sse["status"] == [200, 200] and all(sse["connected_at_stop"])
    assert sse["detection"] == rec["approved"] == rec["rows"] > 0, rec
    assert sse["soundlevel"] >= 1, sse
    assert rec["windows_dropped"] == 0
    assert lat["BirdNET_V2.4"]["p95"] < API_P95_MS, lat
    assert sorted(rec["warmups"]) == ["BirdNET_V2.4"] + ["BirdNET_V3.0"] * \
        API_WALKS, rec["warmups"]
    assert rec["launches"]["melspec_fused"] == rec["batches"] + len(
        rec["warmups"]), rec
    assert rec["launches"]["expand_dw_pool"] == 0
    assert rec["launches"]["scale_project"] == 0
    assert rec["stop_s"] <= API_STOP_S and not rec["threads_left"], rec
    assert rec["losses"] == 0, rec["loss_lines"]


LIVE_SESSIONS = 2000         # phase 19, leg 1: RTSP sessions into the soak
LIVE_IN_FLIGHT_S = 0.25      # leg 2: on their way, a source (from wall time)
LIVE_SOAK_IN_FLIGHT_S = 0.05  # leg 1: one packet a session (counters read
                              # at one instant)
LIVE_RATES = ((48000, 24), (44100, 8))   # leg 2: (rate, rtsp sources)
LIVE_WAVES = 8               # each load server's waveforms
LIVE_CAL_S = 8.2             # captured a waveform to calibrate on
LIVE_SECONDS = 30.0          # leg 2's serving
LIVE_LOAD_AT = 10.0          # v3.0 loaded over HTTP this far in
LIVE_UNLOAD_AT = 20.0        # ... and unloaded
LIVE_SETTLE_S = 2.0          # ingest stalls counted from this far in
LIVE_P95_MS = 1500.0
LIVE_STOP_S = 15.0
LIVE_PASSWORD = "chip-smoke"


def _ingest_returns(engine) -> dict[str, list[tuple[float, int]]]:
    """Wrap `engine.ingest` so that every return is recorded, per
    source: (the wall clock, the samples ingested). Sources call it from
    their own threads, so a gap between two returns is how long that
    source's audio waited (at the engine's gate, for the GIL, in its
    socket)."""
    returns: dict[str, list[tuple[float, int]]] = {}
    real = engine.ingest

    def ingest(source_id, pcm, timestamp=None):
        real(source_id, pcm, timestamp)
        returns.setdefault(source_id, []).append((time.time(), len(pcm)))

    engine.ingest = ingest
    return returns


def _hits(a: float, b: float, spans: list) -> bool:
    return any(a < y and b > x for x, y in spans)


def _stalls(returns: dict, during: list, busy: list, t_from: float
            ) -> dict[str, tuple[float, float]]:
    """Per source, the largest gap (ms) between two returns of its
    ``engine.ingest`` that overlaps a span of `during` (wall-clock
    intervals: the runtime loads), and the largest that overlaps no span
    of `busy` (every request); gaps that end before `t_from` are left
    out (the sources' connects)."""
    out = {}
    for sid, ts in returns.items():
        d = o = 0.0
        for (a, _), (b, _) in zip(ts, ts[1:]):
            if b < t_from:
                continue
            if _hits(a, b, during):
                d = max(d, (b - a) * 1e3)
            elif not _hits(a, b, busy):
                o = max(o, (b - a) * 1e3)
        out[sid] = (round(d, 1), round(o, 1))
    return out


def _watch_gate(engine) -> tuple[list, list, list]:
    """Record every closing of `engine`'s ``SourceGate`` and every
    warm-up's hold of it (``warming``) as (thread ident, wall start, wall
    end), each from inside it (a closing once it is closed, until before
    it opens: its wait for a running warm-up holds no source), and every
    garbage collection as (wall start, wall end).
    The device loop and every batcher, one loaded at runtime too, call
    ``closed()`` and ``warming()`` on the engine's one gate, so an
    attribute of that instance sees them all."""
    closings, gcs, holds, started = [], [], [], []
    real, real_warming = engine.gate.closed, engine.gate.warming

    def inside(real_cm, spans):
        @contextlib.contextmanager
        def cm():
            with real_cm():
                a = time.time()
                try:
                    yield
                finally:
                    spans.append((threading.get_ident(), a, time.time()))
        return cm

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.time())
        elif started:
            gcs.append((started.pop(), time.time()))

    engine.gate.closed = inside(real, closings)
    engine.gate.warming = inside(real_warming, holds)
    gc.callbacks.append(on_gc)
    return closings, gcs, holds


def _timed_warmups(warmups: list, spans: list) -> None:
    """Wrap ``TorchModelBatcher.warmup``: each warm-up's model id goes to
    `warmups` and its (thread ident, wall start, wall end) to `spans`."""
    real = TorchModelBatcher.warmup

    def warmup(self):
        warmups.append(self.spec.model_id)
        a = time.time()
        try:
            return real(self)
        finally:
            spans.append((threading.get_ident(), a, time.time()))

    TorchModelBatcher.warmup = warmup


def _union(spans: list) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_ms(a: float, b: float, merged: list) -> float:
    return round(sum(max(0.0, min(b, y) - max(a, x))
                     for x, y in merged) * 1e3, 1)


def _gate_record(closings: list, gcs: list, holds: list,
                 warm_spans: list, returns: dict, during: list, busy: list,
                 t_start: float, named: dict | None = None,
                 watch: str | None = None) -> dict:
    """What held the sources: the gate's closings, from any thread, that
    meet a warm-up's hold of the gate (each from inside it, as
    ``_watch_gate`` records them; none since the hold's repair, before
    which a tick closed the gate beside a warm-up and traded the GIL with
    it), the longest time the gate stayed closed during the runtime
    loads and outside every request, the warm-ups' and the longest
    garbage collection's times, and, for the largest ingest stall during
    the loads, the largest outside every request and the largest of all
    (over all sources, from LIVE_SETTLE_S on, as ``_stalls`` counts),
    how much of it the gate was closed and a collection ran, and the
    spans of `named` (name → wall-clock spans: the requests) it
    overlaps; the same for the largest stall of source `watch`."""
    t_from = t_start + LIVE_SETTLE_S
    shut = _union([(a, b) for _, a, b in closings])
    collected = _union(gcs)
    overlapping = [c for c in closings
                   if _hits(c[1], c[2], [(a, b) for _, a, b in holds])]
    worst: dict[str, tuple[float, float, float, str]] = {}
    for sid, ts in returns.items():
        for (a, _), (b, _) in zip(ts, ts[1:]):
            if b < t_from:
                continue
            key = ("during" if _hits(a, b, during) else
                   None if _hits(a, b, busy) else "outside")
            for k in (key, "any", "watched" if sid == watch else None):
                if k and b - a > worst.get(k, (0.0,))[0]:
                    worst[k] = (b - a, a, b, sid)

    def longest(keep) -> float:
        return round(max([(b - a) * 1e3 for a, b in shut if keep(a, b)]
                         or [0.0]), 1)

    return {
        "closings": len(closings), "warmup_holds": len(holds),
        "closings_overlapping_warmup": len(overlapping),
        "longest_closed_during_ms": longest(
            lambda a, b: _hits(a, b, during)),
        "longest_closed_outside_ms": longest(
            lambda a, b: b >= t_from and not _hits(a, b, busy)),
        "warmup_ms": [round((b - a) * 1e3, 1) for _, a, b in warm_spans],
        "gc_max_ms": round(max([(b - a) * 1e3 for a, b in gcs] or [0.0]),
                           1),
        "largest_stalls": {k: {"ms": round(dt * 1e3, 1), "source": sid,
                               "at_s": round(a - t_start, 2),
                               "gate_closed_ms": _overlap_ms(a, b, shut),
                               "gc_ms": _overlap_ms(a, b, collected),
                               "overlaps": sorted(
                                   n for n, sp in (named or {}).items()
                                   if _hits(a, b, sp))}
                           for k, (dt, a, b, sid) in worst.items()},
    }


def _stall_gate(rec: dict, what: str) -> None:
    """The largest ingest stall during a runtime load is at most the
    largest outside every request plus one tick; and no closing of the
    gate, from any thread, met a warm-up's hold (``_gate_record``). The
    first compares stalls that the GIL, the scheduler and the sockets
    make as well as the gate; the second sees a closing beside a warm-up
    itself. Prints v2.4's largest latency during each load (a tick now
    waits for a warm-up)."""
    stalls, tick_ms, g = rec["stalls"], rec["tick_ms"], rec["gate"]
    during = max(d for d, _ in stalls.values())
    outside = max(o for _, o in stalls.values())
    print(f"{what} ingest stalls: the largest during the runtime load "
          f"{during} ms, outside every request {outside} ms (gate: "
          f"+ one tick, {tick_ms:.0f} ms); the engine's gate: {g} "
          f"[{rec['card']}]")
    print(f"{what} v2.4 latency: the largest of the windows in flight "
          f"during each runtime load "
          f"{rec['v24_max_during_loads_ms']} ms (warm-ups "
          f"{g['warmup_ms']} ms) [{rec['card']}]")
    assert during > 0 and outside > 0, stalls
    assert during <= outside + tick_ms, stalls
    assert g["closings"] > 0 and g["warmup_holds"] > 0, g
    assert g["closings_overlapping_warmup"] == 0, g


def _capture_windows(servers: dict) -> dict[str, np.ndarray]:
    """Windows of every waveform the load servers (rate → server) send,
    as the app's engine makes them: LIVE_WAVES sessions a server (which
    the server hands its waveforms in turn) through the port's
    ``RtspSource`` into an ``AudioEngine`` with v2.4's and v3.0's taps,
    LIVE_CAL_S of each; returns model id → its windows, int16 [n, T]."""
    from birdnet_go_tpu_torch.audio.engine import AudioEngine
    from birdnet_go_tpu_torch.audio.rtsp import RtspSource
    from birdnet_go_tpu_torch.models.registry import MODEL_REGISTRY

    eng = AudioEngine([MODEL_REGISTRY["BirdNET_V2.4"],
                       MODEL_REGISTRY["BirdNET_V3.0"]])
    returns = _ingest_returns(eng)
    srcs = [(rate, RtspSource(eng, f"rtsp://127.0.0.1:{srv.port}/cal{k}",
                              source_id=f"cal{rate}-{k}"))
            for rate, srv in servers.items() for k in range(LIVE_WAVES)]
    for _, src in srcs:
        src.start()
    deadline = time.monotonic() + 30
    while not all(sum(n for _, n in returns.get(x.source.source_id, []))
                  >= LIVE_CAL_S * rate for rate, x in srcs):
        assert time.monotonic() < deadline, "calibration capture stalled"
        time.sleep(0.1)
    windows = eng.collect_ready()
    for _, src in srcs:
        src.stop()
    return {m: np.stack([w for mid, w, *_ in windows if mid == m])
            for m in ("BirdNET_V2.4", "BirdNET_V3.0")}


def live_leg(record_path: Path) -> None:
    """Phase 19's app leg, in a process of its own (``python3
    chip_smoke.py --live-leg <record.json>``): two of the port's
    ``RtspLoadServer``s (L16, 50 ms packets) at 48 and 44.1 kHz, and the
    ``Application`` on the card at full width with LIVE_RATES' rtsp
    sources (``client: native``: the port's ``RtspSource``, as where
    ffmpeg is missing), so the 44.1 kHz ones resample through the
    engine's taps; v2.4 at batch 256 for LIVE_SECONDS, v3.0 loaded over
    HTTP at LIVE_LOAD_AT and unloaded at LIVE_UNLOAD_AT; the API on
    127.0.0.1 behind a password, FLAC clips, the range filter, SQLite.
    Thresholds are calibrated as phase 16's, on the windows an engine
    makes of every waveform each server sends, captured first by the
    port's ``RtspSource`` (``_capture_windows``). Records each source's ingest returns (``_stalls``),
    the samples it ingested against those its server sent, and what
    phase 16 records. Writes the record to `record_path`; ``phase_live``
    gates it."""
    import logging
    import threading

    from birdnet_go_tpu_torch.app import Application
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
    from birdnet_go_tpu_torch.diag.api_walk import Client
    from birdnet_go_tpu_torch.native.lib import RtspLoadServer

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    losses: list[str] = []

    class _Losses(logging.Handler):
        def emit(self, r: logging.LogRecord) -> None:
            msg = r.getMessage()
            if r.levelno >= logging.ERROR or any(w in msg
                                                 for w in APP_WARNINGS):
                losses.append(f"{r.levelname} {r.name}: {msg[:300]}")

    logging.getLogger().addHandler(_Losses())
    out = record_path.parent
    servers = {rate: RtspLoadServer(rate=rate, n_waveforms=LIVE_WAVES,
                                    seed=SEED + 190 + k, pkt_ms=50)
               for k, (rate, _) in enumerate(LIVE_RATES)}
    for srv in servers.values():
        srv.start()
    t0 = time.monotonic()
    cal_windows = _capture_windows(servers)
    capture_s = time.monotonic() - t0

    s = Settings()
    s.models = [ModelSettings(model_id="BirdNET_V2.4"),
                ModelSettings(model_id="BirdNET_V3.0", enabled=False)]
    s.data_dir = str(out)
    s.database.path = str(out / "live.db")
    s.export.path = str(out / "clips")
    s.export.format = "flac"
    s.export.clip_length_seconds = 6.0
    s.export.pre_capture_seconds = 1.5
    s.realtime.interval_seconds = 0.0
    s.realtime.max_batch = 256
    s.location.latitude, s.location.longitude = APP_LATLON
    s.range_filter.enabled = True
    ws = s.webserver
    ws.enabled, ws.host, ws.port = True, "127.0.0.1", 0
    ws.password, ws.allow_local_bypass = LIVE_PASSWORD, False
    ws.token_file = str(out / "tokens.json")
    s.imageprovider.providers = ["avicommons"]
    rate_of = {}
    s.realtime.sources = []
    for rate, n in LIVE_RATES:
        for k in range(n):
            sid = f"cam{rate // 100}-{k}"
            rate_of[sid] = rate
            s.realtime.sources.append({
                "type": "rtsp", "id": sid, "client": "native",
                "url": f"rtsp://127.0.0.1:{servers[rate].port}/cam{k}"})

    warmups, warm_spans, added = [], [], []
    _timed_warmups(warmups, warm_spans)
    app = Application(s)
    served: dict[str, list[tuple[float, float]]] = {}
    handoff = app._on_window_result

    def on_window(model_id, w, vals, idx):
        served.setdefault(model_id, []).append((w.end_time, time.time()))
        handoff(model_id, w, vals, idx)

    app._on_window_result = on_window
    t1 = time.monotonic()
    app.setup()
    setup_s = time.monotonic() - t1
    kinds = sorted({type(x).__name__ for x in app._sources})
    real_add = app.device_loop.add_batcher

    def add_batcher(b):
        added.append(b)
        return real_add(b)

    app.device_loop.add_batcher = add_batcher
    added += list(app.device_loop.batchers.values())
    approved = []
    on_approved = app.processor.on_approved
    app.processor.on_approved = lambda d, item: (
        approved.append(d.model_id), on_approved(d, item))[1]
    inc = app.processor.included_species
    labels = app.labels["BirdNET_V2.4"]
    b24 = app.device_loop.batchers["BirdNET_V2.4"]
    trigger = s.dynamic_threshold.trigger
    cal = {"BirdNET_V2.4": _calibrate(
        b24, labels, inc, cal_windows["BirdNET_V2.4"], trigger)}
    v3 = BirdNETv3().init(torch.Generator().manual_seed(0))   # load_model's
    b3 = TorchModelBatcher(TorchClassifier(v3, "cuda"), max_batch=256)
    cal["BirdNET_V3.0"] = _calibrate(
        b3, labels, inc, cal_windows["BirdNET_V3.0"], trigger)
    del b3, v3
    torch.cuda.empty_cache()
    for ms in s.models:
        ms.threshold = cal[ms.model_id]["threshold"]
        ms.sensitivity = cal[ms.model_id]["sensitivity"]
    app._reload_model_settings()
    returns = _ingest_returns(app.engine)
    closings, gcs, holds = _watch_gate(app.engine)
    # the calibration's sessions are over: count what is sent from here
    sent0 = {rate: srv.stats()["samples_sent"]
             for rate, srv in servers.items()}

    for k in KERNELS:
        k.launches = 0
    warmups.clear()
    warm_spans.clear()
    t2 = time.monotonic()
    app.start(warmup=True)
    start_s = time.monotonic() - t2
    t_start = time.time()
    client = Client(app.api.port, LIVE_PASSWORD)
    client.login()
    calls = []
    for at, verb in ((LIVE_LOAD_AT, "load"), (LIVE_UNLOAD_AT, "unload")):
        time.sleep(max(0.0, t_start + at - time.time()))
        a = time.time()
        st, _, body, ms = client.call(
            "POST", f"/api/v2/models/{verb}/BirdNET_V3.0")
        calls.append({"verb": verb, "status": st, "ms": round(ms, 1),
                      "t0": a, "t1": time.time(),
                      "body": body[:200].decode(errors="replace")})
    time.sleep(max(0.0, t_start + LIVE_SECONDS - time.time()))
    st_health, _, health_body, _ = client.call("GET", "/api/v2/health")
    t_stop = time.time()
    server_stats = {rate: srv.stats() for rate, srv in servers.items()}
    for rate, st in server_stats.items():
        st["samples_sent"] -= sent0[rate]
    ingested = {sid: sum(n for _, n in ts) for sid, ts in returns.items()}
    first = {sid: ts[0][0] for sid, ts in returns.items() if ts}
    restarts = {x.source.source_id: x.restarts for x in app._sources}
    health = [(r.name, r.healthy, r.detail) for r in app.health.run_all()]
    t3 = time.monotonic()
    app.stop()
    stop_s = time.monotonic() - t3
    for srv in servers.values():
        srv.stop()
        srv.close()
    launches = {k.__name__: k.launches for k in KERNELS}
    left = [th.name for th in threading.enumerate()
            if th is not threading.main_thread() and th.is_alive()
            and not th.daemon]
    with contextlib.closing(sqlite3.connect(s.database.path)) as conn:
        rows = conn.execute("SELECT COUNT(*) FROM detections").fetchone()[0]
    load = [(c["t0"], c["t1"]) for c in calls if c["verb"] == "load"]
    busy = [(c["t0"], c["t1"]) for c in calls]
    samples = {sid: {"rate": rate_of[sid], "ingested": ingested.get(sid, 0),
                     "expected": round(rate_of[sid] * (t_stop - first[sid]))
                     if sid in first else None}
               for sid in rate_of}
    rec = {
        "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0],
        "capture_s": round(capture_s, 2), "setup_s": round(setup_s, 2),
        "start_s": round(start_s, 2), "stop_s": round(stop_s, 2),
        "served_s": round(t_stop - t_start, 1), "source_kinds": kinds,
        "calibration": cal, "calls": calls,
        "tick_ms": s.realtime.tick_ms,
        "stalls": _stalls(returns, load, busy, t_start + LIVE_SETTLE_S),
        "v24_max_during_loads_ms": [
            _in_flight_max(served.get("BirdNET_V2.4", []), span)
            for span in load],
        "gate": _gate_record(closings, gcs, holds, warm_spans, returns,
                             load, busy,
                             t_start),
        "samples": samples,
        "servers": {str(r): v for r, v in server_stats.items()},
        "sessions": {str(r): n for r, n in LIVE_RATES},
        "restarts": restarts,
        "health_http": [st_health, json.loads(health_body or b"{}")
                        .get("status")],
        "health": health,
        "approved": len(approved),
        "approved_by_model": {m: approved.count(m) for m in set(approved)},
        "rows": rows,
        "processor": dataclasses.asdict(app.processor.stats),
        "latency_ms": {m: _pct([(h - e) * 1e3 for e, h in v])
                       for m, v in served.items()},
        "served": {m: len(v) for m, v in served.items()},
        "batches": sum(b.stats.batches_dispatched for b in added),
        "overruns": {b.spec.model_id: b.stats.overruns for b in added},
        "batchers": [b.spec.model_id for b in added],
        "windows_dropped": app.device_loop.windows_dropped,
        "launches": launches, "warmups": list(warmups),
        "threads_left": left, "losses": len(losses),
        "loss_lines": losses[:10],
    }
    record_path.write_text(json.dumps(rec, indent=1))


def _live_soak(card: str) -> None:
    """Phase 19's first leg: ``soak --device cuda --ingest rtsp`` over
    LIVE_SESSIONS sessions with phase 14's prints and gates
    (``_soak_leg``), then the sessions': all connected at the end, none
    restarted, nothing dropped by the server, and every sample sent
    received but what is still in flight (LIVE_SOAK_IN_FLIGHT_S, one
    50 ms packet a session: the soak reads the server's counters and the
    demux's at one instant)."""
    rec = _soak_leg(card, "rtsp_soak", SOAK_SECONDS, "--ingest", "rtsp")
    ing = rec["ingest"]
    print(f"rtsp soak ingest: {ing} [{card}]")
    assert rec["streams"] == LIVE_SESSIONS, rec["streams"]
    assert ing["type"] == "rtsp" and ing["connected_at_end"] == \
        LIVE_SESSIONS, ing
    assert ing["session_restarts"] == 0, ing
    assert ing["samples_dropped_by_server"] == 0, ing
    assert ing["samples_received"] >= ing["samples_sent"] - \
        LIVE_SOAK_IN_FLIGHT_S * 48000 * LIVE_SESSIONS, ing


def phase_live(card: str) -> None:
    """Phase 19, live sources: what the machine offers them (the ALSA
    shim and its devices, ``ffmpeg`` and ``ffprobe``; no leg runs on
    them), then the RTSP soak (``_live_soak``), then ``live_leg`` in a
    process of its own (record and log under ``build/live_smoke/``),
    gated here: the app built ``RtspSource``s; every window served (none
    dropped, no overrun); v2.4's p95 below LIVE_P95_MS across v3.0's
    runtime load; the largest ingest stall during that load within one
    tick of the largest outside every request, and no gate closing beside
    a warm-up (``_stall_gate``); nothing
    dropped by the servers, no source restarted, each source's samples
    ingested at least those its server sent it less LIVE_IN_FLIGHT_S
    (from its first ingest to the end), and every server's sum;
    approvals = rows; the mel kernel once a batch and a warm-up (v3.0's
    load over HTTP included), the MBConv kernels never; health ok over
    HTTP and every check; ``stop()`` within LIVE_STOP_S with the sources
    connected; nothing logged at ERROR."""
    import resource

    t0 = time.monotonic()
    print(f"live: bn_alsa_available() {native.alsa_available()}, ALSA "
          f"capture devices {native.alsa_list_devices()}, ffmpeg "
          f"{shutil.which('ffmpeg')}, ffprobe {shutil.which('ffprobe')}, "
          f"open files {resource.getrlimit(resource.RLIMIT_NOFILE)}")
    _live_soak(card)
    out = REPO / "build" / "live_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    rec_path = out / "live.json"
    t1 = time.monotonic()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           "--live-leg", str(rec_path)], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    wall = time.monotonic() - t1
    (out / "live.log").write_text(proc.stderr)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-6000:])
    assert proc.returncode == 0, f"the live leg exited {proc.returncode}"
    _live_gates(json.loads(rec_path.read_text()), wall)
    print(f"phase 19 (live sources) {time.monotonic() - t0:.1f} s [{card}]")


def _live_gates(rec: dict, wall: float) -> None:
    """Phase 19's prints and gates on the live leg's record."""
    lat, sam = rec["latency_ms"], rec["samples"]
    print(f"live app: {dict(rec['sessions'])} rtsp sources by rate "
          f"({rec['source_kinds']}), v2.4 at batch 256 for "
          f"{rec['served_s']} s, v3.0 over HTTP {rec['calls']}; process "
          f"{wall:.1f} s (capture {rec['capture_s']} s, setup "
          f"{rec['setup_s']} s, start {rec['start_s']} s, stop "
          f"{rec['stop_s']} s) [{rec['card']}]")
    print(f"live latency (ms): {lat}; served {rec['served']}; batches "
          f"{rec['batches']} ({rec['batchers']}), overruns "
          f"{rec['overruns']}, windows dropped {rec['windows_dropped']} "
          f"[{rec['card']}]")
    print(f"live kernels: launches {rec['launches']}, warm-ups "
          f"{rec['warmups']}; calibration {rec['calibration']}")
    print(f"live servers: {rec['servers']}; restarts "
          f"{sum(rec['restarts'].values())}; health {rec['health_http']} "
          f"{[(n, ok) for n, ok, _ in rec['health']]}; approved "
          f"{rec['approved']} ({rec['approved_by_model']}), rows "
          f"{rec['rows']}; processor {rec['processor']}; threads left "
          f"{rec['threads_left']}; errors logged {rec['losses']} "
          f"{rec['loss_lines']}")
    short = {sid: v["expected"] - v["ingested"] for sid, v in sam.items()}
    print(f"live samples: the most a source ingested short of its "
          f"server's pace {max(short.values())} (of "
          f"{LIVE_IN_FLIGHT_S} s in flight); stalls (during the load, "
          f"outside every request, ms) {rec['stalls']}")
    assert rec["source_kinds"] == ["RtspSource"], rec["source_kinds"]
    assert [c["status"] for c in rec["calls"]] == [200, 200], rec["calls"]
    _stall_gate(rec, "live")
    assert rec["windows_dropped"] == 0
    assert not any(rec["overruns"].values()), rec["overruns"]
    assert lat["BirdNET_V2.4"]["p95"] < LIVE_P95_MS, lat
    assert rec["served"].get("BirdNET_V3.0", 0) > 0, rec["served"]
    for rate, n in rec["sessions"].items():
        srv = rec["servers"][rate]
        assert srv["samples_dropped"] == 0 and srv["playing"] >= n, srv
        got = sum(v["ingested"] for v in sam.values()
                  if str(v["rate"]) == rate)
        assert got >= srv["samples_sent"] - LIVE_IN_FLIGHT_S * int(rate) \
            * n, (rate, got, srv)
    for sid, v in sam.items():
        assert v["expected"] is not None, sid
        assert v["ingested"] >= v["expected"] - LIVE_IN_FLIGHT_S * \
            v["rate"], (sid, v)
    assert not any(rec["restarts"].values()), rec["restarts"]
    assert rec["approved"] == rec["rows"] > 0, rec
    assert sorted(rec["warmups"]) == ["BirdNET_V2.4", "BirdNET_V3.0"]
    assert rec["launches"]["melspec_fused"] == rec["batches"] + len(
        rec["warmups"]), rec
    assert rec["launches"]["expand_dw_pool"] == 0
    assert rec["launches"]["scale_project"] == 0
    assert rec["health_http"] == [200, "healthy"], rec["health_http"]
    assert all(ok for _, ok, _ in rec["health"]), rec["health"]
    assert rec["stop_s"] <= LIVE_STOP_S and not rec["threads_left"], rec
    assert rec["losses"] == 0, rec["loss_lines"]


INT_TONES = 16               # phase 20: the app's tone sources
INT_FILES = 4                # ... and its file sources (phase 16's WAVs)
INT_MYSQL_S = 20.0           # leg 1: served on MySQL, every integration on
INT_BACKUP_S = 15.0          # leg 2: served on SQLite, a backup requested
INT_BACKUP_AT_S = 8.0        # ... this far into leg 2
INT_HOP_S = 1.5              # v2.4's window hop at the default overlap
INT_P95_MS = 1500.0
INT_STOP_S = 15.0
INT_PASSWORD = "chip-smoke"
INT_PASSPHRASE = "chip-smoke-backup"
INT_SERVICES_S = 60.0        # the fake services listen within
INT_DOMAIN = "localhost"     # the ACME certificate's name (leg 2 serves it)
INT_PINGS = 30               # GET ping, timed, in each leg (HTTP; HTTPS)
INT_HANDSHAKES = 20          # TLS handshakes timed in leg 2
INT_REAP_S = 5.0             # a terminal's shell is gone within


def _integrations_app(out: Path, ports: dict, mysql: bool):
    """Phase 20's app, set up, not started: v2.4 at batch 256, unfused,
    INT_TONES tone and INT_FILES file sources, FLAC clips, the range
    filter, sound levels, the API on 127.0.0.1 behind a password; MQTT
    (retained, Home Assistant discovery), BirdWeather, yr.no weather and
    eBird against the fake services of `ports` (``diag/fake_services``);
    the datastore MySQL (`mysql`) over HTTP, or SQLite with encrypted
    backups to a local directory over HTTPS (``tls_mode: acme`` on the
    certificate leg 1 cached) with the OIDC, GitHub and Cloudflare
    logins. Returns (app, settings, wavs, tones)."""
    from birdnet_go_tpu_torch.app import Application
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
    from birdnet_go_tpu_torch.diag.fake_services import urls
    from birdnet_go_tpu_torch.integrations import ebird, weather

    wavs = _app_wavs(out)[:INT_FILES]
    tones = _app_tones()[::APP_TONES // INT_TONES]
    to = urls(ports)
    weather.YrNoProvider.BASE = to["yrno"]
    ebird.API_BASE = to["ebird"]
    s = Settings()
    s.models = [ModelSettings(model_id="BirdNET_V2.4")]
    s.data_dir = str(out)
    s.export.path = str(out / "clips")
    s.export.format = "flac"
    s.export.clip_length_seconds = 6.0
    s.export.pre_capture_seconds = 1.5
    s.realtime.interval_seconds = 0.0     # every approval saved and sent
    s.realtime.max_batch = 256
    s.location.latitude, s.location.longitude = APP_LATLON
    s.range_filter.enabled = True
    s.soundlevel.enabled = True
    ws = s.webserver
    ws.enabled, ws.host, ws.port = True, "127.0.0.1", 0
    ws.password, ws.allow_local_bypass = INT_PASSWORD, False
    ws.token_file = str(out / "tokens.json")
    ws.tls_dir = str(out / "tls")
    if not mysql:
        # leg 2: HTTPS on the certificate leg 1 obtained (tls_dir/acme),
        # the OIDC, GitHub and Cloudflare logins; a port chosen now, for
        # the redirect URIs the logins build from base_url
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ws.port = sock.getsockname()[1]
        ws.base_url = f"https://{INT_DOMAIN}:{ws.port}"
        ws.tls_enabled, ws.tls_mode = True, "acme"
        ws.acme_domain, ws.acme_directory = INT_DOMAIN, to["acme_directory"]
        ws.oidc_issuer = to["oidc_issuer"]
        ws.oidc_client_id = ports["oidc_client_id"]
        ws.oidc_client_secret = ports["oidc_client_secret"]
        ws.oidc_allowed = ["@" + ports["oidc_email"].split("@")[1]]
        ws.github_client_id = "chip-smoke-github"
        ws.github_client_secret = "chip-smoke-github-secret"
        ws.cloudflare_bypass_enabled = True
        ws.cloudflare_team_domain = to["cloudflare_team"]
    s.imageprovider.providers = ["avicommons"]   # nothing leaves the host
    s.mqtt.enabled, s.mqtt.host, s.mqtt.port = True, "127.0.0.1", \
        ports["mqtt"]
    s.mqtt.topic, s.mqtt.retain, s.mqtt.ha_discovery = ports["topic"], \
        True, True
    s.birdweather.enabled = True
    s.birdweather.station_token = ports["station_token"]
    s.weather.provider = "yrno"
    s.ebird.enabled, s.ebird.api_token = True, ports["ebird_token"]
    if mysql:
        d = s.database
        d.type, d.host, d.port, d.name = "mysql", "127.0.0.1", \
            ports["mysql"], ""
        d.user, d.password = ports["mysql_user"], ports["mysql_password"]
    else:
        s.database.path = str(out / "leg2.db")
        s.backup.enabled, s.backup.passphrase = True, INT_PASSPHRASE
        s.backup.target_dir = str(out / "backups")
    s.realtime.sources = [
        {"type": "tone", "id": f"tone{k}", "freq": f, "pulse": p}
        for k, (f, p) in enumerate(tones)] + [
        {"type": "file", "id": f"file{k}", "path": str(out / f"loop{k}.wav")}
        for k in range(INT_FILES)]
    app = Application(s)
    return app, s, wavs, tones


def _integrations_serve(out: Path, ports: dict, mysql: bool,
                        seconds: float, cal: dict | None) -> tuple[dict,
                                                                   dict]:
    """One leg of phase 20: the app of ``_integrations_app`` calibrated
    (as phase 16's, unless `cal` is given), started, its integrations
    walked over HTTP once (``diag/api_walk.integrations_walk``; on SQLite
    at INT_BACKUP_AT_S, whose backup run is the leg's backup), a client
    held on the detection SSE stream, `seconds` served, stopped. Counting
    wrappers: each window's hand-off, the windows the engine offers, each
    approval with its wall clock and the datastore id it got, the event
    tracker's passes by action (``EventType``'s values), the warm-ups and
    the kernels' launches.
    Each approval is recorded with the datastore id it got and the wall
    clock of its approval, of its insert's start and end, and of its MQTT
    publish. Returns the leg's record and the calibration."""
    import threading

    from birdnet_go_tpu_torch.diag.api_walk import (
        V2,
        Client,
        SseReader,
        handshake_ms,
        integrations_walk,
        logins_walk,
        route_times,
        shell_children,
        terminal_session,
        wait_reaped,
    )
    from birdnet_go_tpu_torch.diag.fake_services import urls
    from birdnet_go_tpu_torch.utils.httpclient import UrllibSession

    t_begin = time.time()
    warmups, warm_spans = [], []
    _timed_warmups(warmups, warm_spans)
    t0 = time.monotonic()
    app, s, wavs, tones = _integrations_app(out, ports, mysql)
    served: dict[str, list[tuple[float, float]]] = {}
    handoff = app._on_window_result

    def on_window(model_id, w, vals, idx):
        served.setdefault(model_id, []).append((w.end_time, time.time()))
        handoff(model_id, w, vals, idx)

    app._on_window_result = on_window
    app.setup()
    setup_s = time.monotonic() - t0
    # the client exists once setup has built it; nothing posts before start
    app.birdweather.config.base_url = urls(ports)["birdweather"]
    produced: dict[str, int] = {}
    collect = app.device_loop._providers[0]

    def counted():
        items = collect()
        for it in items:
            produced[it[0]] = produced.get(it[0], 0) + 1
        return items

    app.device_loop._providers[0] = counted
    approved_at: dict[int, float] = {}
    approvals: list[tuple[int | None, float]] = []
    on_approved = app.processor.on_approved

    def approve(d, item):
        approved_at[id(d)] = time.time()
        return on_approved(d, item)

    app.processor.on_approved = approve
    insert = app.datastore.insert_detection

    def inserted(d, *a, **kw):
        t_a = time.time()
        det_id = insert(d, *a, **kw)
        approvals.append((det_id, approved_at.get(id(d)), t_a, time.time()))
        return det_id

    app.datastore.insert_detection = inserted
    published: dict[int, float] = {}
    publish = app.mqtt.publish

    def published_at(topic, payload, *a, **kw):
        ok = publish(topic, payload, *a, **kw)
        if isinstance(payload, dict) and "id" in payload:
            published[payload["id"]] = time.time()
        return ok

    app.mqtt.publish = published_at
    passes: dict[str, int] = {}
    track = app.event_tracker.track

    def tracked(event, common, sci, *a, **kw):
        ok = track(event, common, sci, *a, **kw)
        if ok:
            passes[event] = passes.get(event, 0) + 1
        return ok

    app.event_tracker.track = tracked
    if cal is None:
        cal = _calibrate(app.device_loop.batchers["BirdNET_V2.4"],
                         app.labels["BirdNET_V2.4"],
                         app.processor.included_species,
                         _cal_windows(48000, CLIP, wavs, tones),
                         s.dynamic_threshold.trigger)
    s.models[0].threshold = cal["threshold"]
    s.models[0].sensitivity = cal["sensitivity"]
    app._reload_model_settings()

    for k in KERNELS:
        k.launches = 0
    warmups.clear()
    t1 = time.monotonic()
    app.start(warmup=True)
    start_s = time.monotonic() - t1
    t_start = time.time()
    mqtt_up = app.mqtt.wait_connected(10)
    acme, tls = {}, {}
    if mysql:
        client = Client(app.api.port, INT_PASSWORD)
        acme = _acme_order(s, ports, app.api.port)
    else:
        # a client that trusts the fakes' CA alone, and checks the name
        tls_ctx = ssl.create_default_context(cafile=ports["ca"])
        client = Client(app.api.port, INT_PASSWORD, host=INT_DOMAIN,
                        ssl_context=tls_ctx)
        tls = {"served_is_acme": _served_certificate(client) == _pem_der(
                   Path(s.webserver.tls_dir) / "acme" / f"{INT_DOMAIN}.crt"),
               "plain_http_refused": _plain_http_refused(app.api.port),
               "handshake_ms": handshake_ms(client, INT_HANDSHAKES)}
    client.login()
    pings = [client.call("GET", f"{V2}/ping")[3] for _ in range(INT_PINGS)]
    sse = SseReader(client, "/api/v2/detections/stream")
    sse.start()
    backup = {}
    if not mysql:
        time.sleep(max(0.0, t_start + INT_BACKUP_AT_S - time.time()))
        with contextlib.closing(sqlite3.connect(s.database.path)) as conn:
            backup["rows_before"] = conn.execute(
                "SELECT COUNT(*) FROM detections").fetchone()[0]
    records, bodies = integrations_walk(client, backup=not mysql)
    if not mysql:
        run = next(r for r in records
                   if r["route"] == "POST system/database/backup")
        name = json.loads(bodies["system/database/backup"])["backup"]
        archive = Path(s.backup.target_dir) / name
        backup.update(name=name, path=str(archive),
                      bytes=archive.stat().st_size,
                      wall_ms=round(run["ms"], 1), t0=run["t0"],
                      t1=run["t1"])
    logins, found, span, open_ws = [], {}, None, None
    if not mysql:
        def cf_mint() -> str:            # over HTTPS, trusting SSL_CERT_FILE
            return UrllibSession(timeout=10).post(
                f"https://{urls(ports)['cloudflare_team']}/mint",
                json={}).json()["token"]

        span = (time.time(), None)
        logins, found = logins_walk(
            client, cf_mint=cf_mint,
            github_authorize="https://github.com/login/oauth/authorize")
        span = (span[0], time.time())
        # a terminal left open across stop()
        shells = shell_children()
        found["at_stop"], open_ws = terminal_session(client, rounds=1,
                                                     leave_open=True)
    time.sleep(max(0.0, t_start + seconds - time.time()))
    t_end = time.time()
    cpu = _thread_cpu_s()
    api_stop, api_stop_s = app.api.stop, []

    def timed_api_stop():
        t = time.monotonic()
        api_stop()
        api_stop_s.append(round(time.monotonic() - t, 2))

    app.api.stop = timed_api_stop
    t2 = time.monotonic()
    app.stop()
    stop_s = time.monotonic() - t2
    t_stopped = time.time()
    if open_ws is not None:
        found["at_stop"]["close_code"] = _close_code_of(open_ws)
        found["at_stop"]["left"] = wait_reaped(shells, INT_REAP_S)
    sse.ended.wait(10)
    sse.close()
    launches = {k.__name__: k.launches for k in KERNELS}
    left = [th.name for th in threading.enumerate()
            if th is not threading.main_thread() and th.is_alive()
            and not th.daemon]
    v24 = served.get("BirdNET_V2.4", [])
    if backup:
        # the windows due within one hop (1.5 s) of its start: those its
        # hold of the GIL could serve late (every source's windows fall
        # due at the same instants, 1.5 s apart, so a 0.1 s request may
        # see none in flight)
        during = [(h - e) * 1e3 for e, h in v24
                  if backup["t0"] <= e <= backup["t0"] + INT_HOP_S]
        backup["v24_latency_ms_max_during"] = round(max(during or [0.0]), 1)
        backup["windows_during"] = len(during)
    walk_ms = [(h - e) * 1e3 for e, h in v24
               if span is not None and span[0] <= e <= span[1]]
    rec = {
        "database": "mysql" if mysql else "sqlite",
        "setup_s": round(setup_s, 2), "start_s": round(start_s, 2),
        "stop_s": round(stop_s, 2), "api_stop_s": api_stop_s,
        "served_s": round(t_end - t_start, 1),
        "t_begin": t_begin, "t_start": t_start, "t_end": t_end,
        "t_stopped": t_stopped,
        "mqtt_connected": mqtt_up,
        "produced": produced,
        "served": {m: len(v) for m, v in served.items()},
        "latency_ms": {m: _pct([(h - e) * 1e3 for e, h in v])
                       for m, v in served.items()},
        "batches": sum(b.stats.batches_dispatched
                       for b in app.device_loop.batchers.values()),
        "overruns": sum(b.stats.overruns
                        for b in app.device_loop.batchers.values()),
        "windows_dropped": app.device_loop.windows_dropped,
        "launches": launches, "warmups": list(warmups),
        "approvals": approvals, "mqtt_published": published,
        "passes": passes,
        "sse_detections": len(sse.named("detection")),
        "sse_status": sse.status,
        "statuses": [(r["route"], r["status"], r["want"]) for r in records],
        "route_ms": route_times(records),
        "backup": backup,
        "acme": acme, "tls": tls, "ping_ms": pings,
        "logins": [(r["route"], r["status"], r["want"]) for r in logins],
        "logins_ms": {r["route"]: round(r["ms"], 1) for r in logins},
        "found": found,
        "walk_latency_ms": _pct(walk_ms) if walk_ms else None,
        "soundlevel_interval_s": s.soundlevel.interval_seconds,
        "thread_cpu_s": {k: v for k, v in cpu.items()
                         if k in ("mqtt", "jobq-", "soundlevel",
                                  "weather", "api-server")},
        "jobqueue": {"enqueued": app.jobqueue.stats.enqueued,
                     "failed": app.jobqueue.stats.failed,
                     "dropped": app.jobqueue.stats.dropped},
        "birdweather": {"failures": app.birdweather.failures},
        "threads_left": left,
    }
    return rec, cal


def _acme_order(s, ports: dict, port: int) -> dict:
    """Leg 1's ACME order while it serves: the fake directory told that
    INT_DOMAIN resolves to this app, then ``AutoTlsManager.ensure`` with
    ``GLOBAL_RESPONDER``, which the app's own challenge route answers
    from. The wall time and the certificate cached under
    ``tls_dir/acme``."""
    import urllib.request

    from birdnet_go_tpu_torch.diag.fake_services import urls
    from birdnet_go_tpu_torch.utils.acme import (
        GLOBAL_RESPONDER,
        AutoTlsManager,
    )

    urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{ports['acme']}/dns", method="POST",
        data=json.dumps({"domain": INT_DOMAIN,
                         "address": f"127.0.0.1:{port}"}).encode()),
        timeout=10).close()
    t0 = time.time()
    mgr = AutoTlsManager(s.webserver.tls_dir, INT_DOMAIN,
                         directory_url=urls(ports)["acme_directory"])
    cert, _ = mgr.ensure(GLOBAL_RESPONDER)
    t1 = time.time()
    return {"wall_ms": round((t1 - t0) * 1e3, 1), "cert": str(cert),
            "days": round(mgr.days_remaining(), 2), "t0": t0, "t1": t1}


def _served_certificate(client) -> bytes:
    """The DER certificate the server presents to `client`'s context."""
    with socket.create_connection((client.host, client.port),
                                  timeout=30) as sock:
        with client.ssl_context.wrap_socket(
                sock, server_hostname=client.host) as tls:
            return tls.getpeercert(binary_form=True)


def _pem_der(path: Path) -> bytes:
    """The first certificate of a PEM chain, DER."""
    text = path.read_text()
    end = "-----END CERTIFICATE-----"
    return ssl.PEM_cert_to_DER_cert(text[:text.index(end) + len(end)])


def _plain_http_refused(port: int) -> bool:
    """Whether a plain HTTP request to the TLS port fails."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", "/api/v2/ping")
        c.getresponse().read()
        return False
    except (OSError, http.client.HTTPException):
        return True
    finally:
        c.close()


def _close_code_of(ws) -> int | None:
    """The code of the close frame a socket left open receives, or None."""
    try:
        op, data = ws.recv_message(INT_STOP_S)
        while op != 0x8:
            op, data = ws.recv_message(INT_STOP_S)
        return struct.unpack("!H", data[:2])[0] if len(data) >= 2 else None
    except (OSError, ConnectionError, TimeoutError):
        return None
    finally:
        ws.sock.close()


def integrations_leg(record_path: Path, services_path: Path) -> None:
    """Phase 20's legs, in a process of their own (``python3 chip_smoke.py
    --integrations-leg <record.json> <services.json>``), the fake services
    in another (``phase_integrations`` starts them): leg 1 serves
    INT_MYSQL_S on MySQL with every integration on, leg 2 INT_BACKUP_S on
    SQLite with backups (``_integrations_serve``). A logging handler
    counts every ERROR record. Writes both legs' records to
    `record_path`; ``phase_integrations`` gates them."""
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    losses: list[str] = []

    class _Losses(logging.Handler):
        def emit(self, r: logging.LogRecord) -> None:
            msg = r.getMessage()
            if r.levelno >= logging.ERROR or any(w in msg
                                                 for w in APP_WARNINGS):
                losses.append(f"{r.levelname} {r.name}: {msg[:300]}")

    logging.getLogger().addHandler(_Losses())
    ports = json.loads(services_path.read_text())
    out = record_path.parent
    leg1, cal = _integrations_serve(out, ports, True, INT_MYSQL_S, None)
    leg2, _ = _integrations_serve(out, ports, False, INT_BACKUP_S, cal)
    import importlib.metadata

    record_path.write_text(json.dumps({
        "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0],
        "calibration": cal, "legs": [leg1, leg2],
        "cryptography": importlib.metadata.version("cryptography"),
        "losses": len(losses), "loss_lines": losses[:10]}, indent=1))


def phase_integrations(card: str) -> None:
    """Phase 20, the integrations on the card: the fake services
    (``python -m birdnet_go_tpu_torch.diag.fake_services``: the MQTT
    broker and its recording subscriber, MySQL with caching_sha2 and RSA
    full auth on the first connect, loopback BirdWeather, yr.no and eBird)
    in a process of their own, ``integrations_leg`` in another (record,
    logs and the services' database under ``build/integrations_smoke/``),
    gated here (``_integrations_gates``)."""
    import importlib.util

    t0 = time.monotonic()
    assert importlib.util.find_spec("cryptography") is not None, \
        "phase 20 needs cryptography (MySQL's RSA full auth, backups)"
    out = REPO / "build" / "integrations_smoke"
    shutil.rmtree(out, ignore_errors=True)
    (out / "services").mkdir(parents=True)
    svc_log = open(out / "services.log", "w")
    services = subprocess.Popen(
        [sys.executable, "-m", "birdnet_go_tpu_torch.diag.fake_services",
         "--out", str(out / "services")],
        stdout=svc_log, stderr=subprocess.STDOUT, cwd=REPO)
    try:
        ports_path = out / "services" / "services.json"
        deadline = time.monotonic() + INT_SERVICES_S
        while not ports_path.exists():
            assert services.poll() is None, "the fake services exited"
            assert time.monotonic() < deadline, "the fake services are late"
            time.sleep(0.1)
        rec_path = out / "integrations.json"
        t1 = time.monotonic()
        # the leg trusts the fakes' CA through its environment
        ca = json.loads(ports_path.read_text())["ca"]
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                               "--integrations-leg", str(rec_path),
                               str(ports_path)], capture_output=True,
                              text=True, timeout=600, cwd=REPO,
                              env={**os.environ, "SSL_CERT_FILE": ca})
        wall = time.monotonic() - t1
        (out / "integrations.log").write_text(proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            print(proc.stderr[-6000:])
        assert proc.returncode == 0, \
            f"the integrations leg exited {proc.returncode}"
    finally:
        services.terminate()
        services.wait(30)
        svc_log.close()
    assert services.returncode == 0, services.returncode
    got = json.loads((out / "services" / "services_record.json").read_text())
    with contextlib.closing(sqlite3.connect(out / "services" / "mysql.db")
                            ) as conn:
        mysql_rows = {t: conn.execute(f"SELECT COUNT(*) FROM {t}")
                      .fetchone()[0] for t in ("detections",
                                               "hourly_weather")}
    api = REPO / "build" / "api_smoke" / "api.json"
    phase18 = json.loads(api.read_text())["latency_ms"]["BirdNET_V2.4"] \
        if api.exists() else None
    _integrations_gates(json.loads(rec_path.read_text()),
                        json.loads(ports_path.read_text()), got, mysql_rows,
                        wall, phase18)
    print(f"phase 20 (integrations) {time.monotonic() - t0:.1f} s [{card}]")


def _integrations_gates(rec: dict, ports: dict, got: dict,
                        mysql_rows: dict, wall: float,
                        phase18: dict | None) -> None:
    """Phase 20's prints and gates: the leg's record `rec`, the fake
    services' `ports` (``services.json``), what they received (`got`) and
    the rows in their MySQL file. Each leg:
    every window the engine offered served, none dropped, no overrun,
    v2.4's p95 below INT_P95_MS, the mel kernel once a batch and a
    warm-up (the MBConv kernels never), every walked route answering the
    status ``tests/test_torch_api.py`` gets from the port on the CPU,
    ``stop()`` within INT_STOP_S. Leg 1 (MySQL): approvals = rows in the
    server's file = MQTT detection messages = SSE events (each = the event
    tracker's passes of its action), BirdWeather's detection POSTs = the
    tracker's BIRDWEATHER_SUBMIT passes, the Home Assistant configs
    retained, at least one sound-level message an interval, an hourly
    weather row. Leg 2 (SQLite): the backup archive verifies with the
    passphrase, its database holding at least the rows committed before
    the request. Nothing logged at ERROR in either. Prints each leg's
    v2.4 p50/p95/max (beside phase 18's), a row's approval-to-commit and
    an approval's MQTT delivery times (p50, p95), the backup's wall time,
    bytes and the largest window latency during it, and the thread CPU of
    the MQTT and job-queue threads."""
    from birdnet_go_tpu_torch.integrations.mqtt import ha_discovery_payloads
    from birdnet_go_tpu_torch.utils.backup import verify_archive

    card = rec["card"]
    leg1, leg2 = rec["legs"]
    topic = ports["topic"]
    print(f"integrations: {INT_TONES} tone + {INT_FILES} file sources, v2.4 "
          f"at batch 256 with its API; leg 1 MySQL {leg1['served_s']} s "
          f"(setup {leg1['setup_s']} s, start {leg1['start_s']} s, stop "
          f"{leg1['stop_s']} s), leg 2 SQLite + backup {leg2['served_s']} s "
          f"(stop {leg2['stop_s']} s); process {wall:.1f} s [{card}]")
    for leg in (leg1, leg2):
        lat = leg["latency_ms"]["BirdNET_V2.4"]
        print(f"integrations leg {leg['database']}: v2.4 latency (ms) p50 "
              f"{lat['p50']}, p95 {lat['p95']}, max {lat['max']} (phase 18: "
              f"{phase18}); served {leg['served']} of {leg['produced']}; "
              f"batches {leg['batches']}, launches {leg['launches']}, "
              f"warm-ups {leg['warmups']}; approvals "
              f"{len(leg['approvals'])}, passes {leg['passes']}, SSE "
              f"{leg['sse_detections']}; thread CPU s {leg['thread_cpu_s']}; "
              f"job queue {leg['jobqueue']} [{card}]")
        for route, t in leg["route_ms"].items():
            print(f"integrations {leg['database']} route {route}: "
                  f"{t['p50']} ms [{card}]")
    t_split = leg2["t_begin"]          # leg 2 sends nothing before it
    received = [(t, json.loads(p) if p.startswith("{") else p, at)
                for t, p, at in got["mqtt"]["received"]]
    det1 = [(p, at) for t, p, at in received
            if t == f"{topic}/detections" and at <= t_split]
    levels1 = [at for t, _, at in received
               if t == f"{topic}/soundlevels" and at <= t_split]
    approved1 = {i: at for i, at, _, _ in leg1["approvals"]}
    committed = dict(got["mysql"]["committed"])
    commit_ms = [(committed[i] - at) * 1e3 for i, at in approved1.items()
                 if i in committed and at is not None]
    mqtt_ms = [(at - approved1[p["id"]]) * 1e3 for p, at in det1
               if p["id"] in approved1 and approved1[p["id"]] is not None]
    # where an approval's time to the subscriber goes: waiting for a job
    # queue worker, the whole insert (its ~15 statements), from the
    # insert's end to the publish (SSE first), the broker to the
    # subscriber
    pub = {int(k): v for k, v in leg1["mqtt_published"].items()}
    got_at = {p["id"]: at for p, at in det1}
    parts = {"queue_wait": [(a - at) * 1e3 for _, at, a, _ in
                            leg1["approvals"]],
             "insert": [(b - a) * 1e3 for _, _, a, b in leg1["approvals"]],
             "to_publish": [(pub[i] - b) * 1e3 for i, _, _, b in
                            leg1["approvals"] if i in pub],
             "broker": [(got_at[i] - pub[i]) * 1e3 for i in pub
                        if i in got_at]}
    bw = [r for r in got["http"]["birdweather"]
          if r["method"] == "POST" and r["path"].endswith("/detections")]
    bw1 = [r for r in bw if r["t"] <= t_split]
    print(f"integrations MySQL: rows {mysql_rows}, RSA full auths "
          f"{got['mysql']['full_auths']}, statements "
          f"{got['mysql']['statements']}; approval to commit (ms) "
          f"{_pct(commit_ms or [0.0])}; MQTT approval to the subscriber's "
          f"receipt (ms) {_pct(mqtt_ms or [0.0])}; MQTT detections "
          f"{len(det1)}, sound levels {len(levels1)} (interval "
          f"{leg1['soundlevel_interval_s']} s), retained "
          f"{sorted(got['mqtt']['retained'])}; BirdWeather POSTs {len(bw1)} "
          f"(leg 2 {len(bw) - len(bw1)}), yr.no requests "
          f"{len(got['http']['yrno'])}, eBird {len(got['http']['ebird'])} "
          f"[{card}]")
    each = [(round(at - leg1["t_start"], 2), round((a - at) * 1e3, 1),
             round((b - a) * 1e3, 1)) for _, at, a, b in leg1["approvals"]]
    print("integrations MQTT delivery by part (ms): " + "; ".join(
        f"{k} {_pct(v or [0.0])}" for k, v in parts.items())
        + f"; each approval (s into leg 1, queue wait ms, insert ms): "
        f"{each} [{card}]")
    b = leg2["backup"]
    report = verify_archive(Path(b["path"]).read_bytes(), INT_PASSPHRASE)
    print(f"integrations backup: {b['name']}, {b['bytes']} bytes, wall "
          f"{b['wall_ms']} ms, v2.4 latency max of the "
          f"{b['windows_during']} windows due within {INT_HOP_S} s of its "
          f"start {b['v24_latency_ms_max_during']} ms; verified "
          f"{report['database']} (rows before the request "
          f"{b['rows_before']}) [{card}]")
    print(f"integrations calibration {rec['calibration']}; errors logged "
          f"{rec['losses']} {rec['loss_lines']}")
    _logins_report(rec, got, phase18)
    for leg in (leg1, leg2):
        m = "BirdNET_V2.4"
        assert leg["produced"].get(m, 0) == leg["served"].get(m, 0) > 0, leg
        assert leg["windows_dropped"] == 0 and leg["overruns"] == 0, leg
        assert leg["latency_ms"][m]["p95"] < INT_P95_MS, leg["latency_ms"]
        assert leg["warmups"] == [m], leg["warmups"]
        assert leg["launches"]["melspec_fused"] == leg["batches"] + 1, leg
        assert leg["launches"]["expand_dw_pool"] == 0
        assert leg["launches"]["scale_project"] == 0
        bad = [r for r in leg["statuses"] if r[1] != r[2]]
        assert not bad and len(leg["statuses"]) == 12, leg["statuses"]
        assert leg["stop_s"] <= INT_STOP_S and not leg["threads_left"], leg
        assert leg["mqtt_connected"] and leg["sse_status"] == 200, leg
        assert leg["jobqueue"]["failed"] == 0, leg["jobqueue"]
    _logins_gates(leg1, leg2, got)
    passes = leg1["passes"]
    n = len(leg1["approvals"])
    assert n > 0 and all(i is not None and at is not None
                         for i, at, _, _ in leg1["approvals"]), \
        leg1["approvals"]
    assert n == mysql_rows["detections"] == len(committed), \
        (n, mysql_rows, len(committed))
    assert passes.get("mqtt_publish") == n == len(det1), (passes, len(det1))
    assert passes.get("sse_broadcast") == n == leg1["sse_detections"], \
        (passes, leg1["sse_detections"])
    assert passes.get("birdweather_submit") == len(bw1) > 0, \
        (passes, len(bw1))
    assert leg1["birdweather"]["failures"] == 0, leg1["birdweather"]
    retained = got["mqtt"]["retained"]
    assert all(json.loads(retained.get(t, "null")) == json.loads(json.dumps(
        cfg)) for t, cfg in ha_discovery_payloads(topic).items()), retained
    every = leg1["soundlevel_interval_s"]
    assert len(levels1) >= int(leg1["served_s"] // every) - 1 > 0, \
        (len(levels1), every)
    assert mysql_rows["hourly_weather"] >= 1, mysql_rows
    assert got["mysql"]["full_auths"] >= 1, got["mysql"]
    assert len(commit_ms) == n and len(mqtt_ms) == n, \
        (len(commit_ms), len(mqtt_ms), n)
    assert report["encrypted"] and report["files"]["database.sql"][
        "sha256_ok"], report
    assert report["database"]["tables"]["detections"] >= \
        b["rows_before"], (report["database"], b)
    assert rec["losses"] == 0, rec["loss_lines"]


def _logins_report(rec: dict, got: dict, phase18: dict | None) -> None:
    """Phase 20's prints of HTTPS, ACME, the logins and the terminal."""
    card = rec["card"]
    leg1, leg2 = rec["legs"]
    tls, found = leg2["tls"], leg2["found"]
    hs = _pct(tls["handshake_ms"])
    print(f"integrations TLS: handshake (ms) p50 {hs['p50']}, p95 "
          f"{hs['p95']} ({INT_HANDSHAKES} handshakes); GET ping (ms) over "
          f"HTTP p50 {_pct(leg1['ping_ms'])['p50']}, p95 "
          f"{_pct(leg1['ping_ms'])['p95']}, over HTTPS p50 "
          f"{_pct(leg2['ping_ms'])['p50']}, p95 "
          f"{_pct(leg2['ping_ms'])['p95']} ({INT_PINGS} each, a connection "
          f"a request); cryptography {rec['cryptography']} [{card}]")
    print(f"integrations ACME: order for {INT_DOMAIN} {leg1['acme']['wall_ms']}"
          f" ms (validated through the app: "
          f"{[v['status'] for v in got['acme']['validations']]}), "
          f"{leg1['acme']['days']} days; orders in all "
          f"{len(got['acme']['orders'])}; leg 2 served it "
          f"{tls['served_is_acme']}, plain HTTP refused "
          f"{tls['plain_http_refused']} [{card}]")
    term, stop = found["terminal"], found["at_stop"]
    print(f"integrations logins: OIDC login {found['oidc']['ms']} ms "
          f"(statuses {found['oidc']['statuses']}, authenticated "
          f"{found['oidc']['authenticated']}); walk {leg2['logins']}; "
          f"route ms {leg2['logins_ms']} [{card}]")
    print(f"integrations terminal: echo round trips (ms) "
          f"{term.get('echo_ms')}, resized {term.get('resized')}, close "
          f"{term.get('close_code')}, shells left {term.get('left')}; open "
          f"across stop(): close {stop.get('close_code')}, shells left "
          f"{stop.get('left')}, stop {leg2['stop_s']} s (the API's "
          f"{leg2['api_stop_s']} s; leg 1 {leg1['stop_s']} s, the API's "
          f"{leg1['api_stop_s']} s) [{card}]")
    print(f"integrations v2.4 latency during leg 2's walk (ms) "
          f"{leg2['walk_latency_ms']} (phase 18: {phase18}) [{card}]")


def _logins_gates(leg1: dict, leg2: dict, got: dict) -> None:
    """Phase 20's gates of HTTPS, ACME, the logins and the terminal (see
    the module's docstring)."""
    validations = got["acme"]["validations"]
    assert len(got["acme"]["orders"]) == 1, got["acme"]
    assert [v["status"] for v in validations] == ["valid"], validations
    assert Path(leg1["acme"]["cert"]).is_file() and \
        leg1["acme"]["days"] > 80, leg1["acme"]
    tls, found = leg2["tls"], leg2["found"]
    assert tls["served_is_acme"] and tls["plain_http_refused"], tls
    bad = [r for r in leg2["logins"] if r[1] != r[2]]
    assert not bad and len(leg2["logins"]) == 13, leg2["logins"]
    assert found["oidc"]["authenticated"], found["oidc"]
    assert got["oidc"]["codes_traded"] == 1, got["oidc"]
    assert found["github_redirect"], found
    assert found["github_wrong_state"] == {
        "error": "unknown or expired state"}, found
    assert found["Cloudflare forged"] == '{"error": "unauthorized"}', found
    assert found["tls_download_pem"], found
    term, stop = found["terminal"], found["at_stop"]
    assert term["status"] == 101 and term["resized"], term
    assert len(term["echo_ms"]) == 5 and term["close_code"] == 1000, term
    assert term["left"] == [], term
    assert found["terminal_cross_origin"] == {
        "error": "cross-origin terminal access denied"}, found
    assert stop["status"] == 101 and stop["close_code"] == 1001, stop
    assert stop["left"] == [], stop


CODEC_TONES = 16             # phase 21: the app's tone sources
CODEC_SECONDS = 30.0         # served
CODEC_CLIP_S = 6.0           # a clip, and the round trips' signal, at 48 kHz
CODEC_PI_ROWS = 10000        # BirdDB.txt: about a week of a busy station
CODEC_GO_NOTES = 2000        # the legacy BirdNET-Go database's notes
CODEC_LIVE_S = 2.0           # audio/live?format=opus read this long
CODEC_LIVE_TOL_S = 0.5       # ... its granule's advance within this of it
CODEC_OPUS_SNR_DB = 25.0     # tests/test_native_codecs.py's threshold
CODEC_AAC_CORR = 0.99        # tests/test_aac.py's threshold
CODEC_HLS_WAIT_S = 10.0      # an HLS segment appears within
CODEC_P95_MS = 1500.0
CODEC_STOP_S = 15.0
CODEC_PASSWORD = "chip-smoke"
# export.format: the first of these the machine offers, else flac
CODEC_FORMATS = ("opus", "aac", "mp3")
CODEC_SUFFIX = {"opus": ".opus", "aac": ".m4a", "mp3": ".mp3",
                "flac": ".flac"}


def _codecs_offered() -> dict:
    """What the machine offers the codecs: ``ctypes.util.find_library``
    of each codec library, libavcodec's version, and whether the port's
    codec library (built here from ``csrc/codecs.cpp``) has each codec."""
    import ctypes.util

    from birdnet_go_tpu_torch.audio import aacenc, opusogg

    v = native.avcodec_version()
    return {"find_library": {n: ctypes.util.find_library(n)
                             for n in ("opus", "mp3lame", "avcodec")},
            "avcodec_version": f"{v >> 16}.{(v >> 8) & 0xFF}.{v & 0xFF}"
            if v else None,
            "opus": opusogg.opus_available(), "mp3": opusogg.mp3_available(),
            "aac": aacenc.available()}


def _codec_signal(seconds: float, seed: int) -> np.ndarray:
    """int16 at 48 kHz: a 1 kHz tone at 0.4 of full scale over noise at
    0.005."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(48000 * seconds)) / 48000
    x = 0.4 * np.sin(2 * np.pi * 1000 * t) + 0.005 * rng.standard_normal(
        len(t))
    return (x * 32767).astype(np.int16)


def _aligned_corr(decoded: np.ndarray, original: np.ndarray,
                  search: int = 4096) -> float:
    """``tests/test_aac.py``'s: the correlation after the best shift."""
    d = decoded.astype(np.float64)
    o = original.astype(np.float64)
    n = min(len(o), len(d) - search)
    best = max(range(0, search, 32),
               key=lambda k: float(np.dot(d[k:k + n], o[:n])))
    return float(np.corrcoef(d[best:best + n], o[:n])[0, 1])


def _opus_file(blob: bytes) -> dict:
    """An Ogg Opus file or stream read back: its pages' CRCs verified
    (``parse_ogg_pages`` raises otherwise), the pre-skip, the last
    granule less the pre-skip, and the decoded PCM."""
    from birdnet_go_tpu_torch.audio import opusogg

    pages = opusogg.parse_ogg_pages(blob)
    head = pages[0]["packets"][0]
    assert head[:8] == b"OpusHead", head[:8]
    preskip = struct.unpack("<H", head[10:12])[0]
    packets = [p for pg in pages[2:] for p in pg["packets"]]
    return {"pages": len(pages), "preskip": preskip,
            "samples": pages[-1]["granule"] - preskip,
            "first_granule": pages[2]["granule"] if len(pages) > 2 else None,
            "pcm": opusogg.decode_opus_packets(packets, 48000)}


def _mp3_samples(data: bytes) -> int:
    """The samples of an MPEG-1 Layer III stream at 48, 44.1 or 32 kHz:
    1,152 a frame, counted by walking the frame headers (an ID3 tag
    first is skipped)."""
    rates = {0: 44100, 1: 48000, 2: 32000}
    kbps = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320)
    off = 10 + int.from_bytes(data[6:10], "big") if data[:3] == b"ID3" \
        else 0
    frames = 0
    while off + 4 <= len(data):
        h = int.from_bytes(data[off:off + 4], "big")
        assert h >> 21 == 0x7FF and (h >> 17) & 0xF == 0xD, \
            f"no MPEG-1 Layer III frame sync at {off}"
        size = 144 * kbps[(h >> 12) & 0xF] * 1000 // rates[(h >> 10) & 3] \
            + ((h >> 9) & 1)
        off += size
        frames += 1
    return frames * 1152


def _codec_round_trips(offered: dict, out: Path, card: str) -> dict:
    """Phase 21's gates outside the app, for each codec the machine
    offers: a CODEC_CLIP_S tone over noise at 48 kHz encoded through the
    port and decoded through it. Opus: the file's Ogg CRCs verify, its
    granule less the pre-skip is the clip's length, the SNR after the
    pre-skip above CODEC_OPUS_SNR_DB. AAC: an ``.m4a`` from
    ``encode_clip`` loads through ``load_clip_audio`` at the clip's
    length plus less than one 1,024-sample frame (the encoder's 1,024
    priming trimmed by its edit list), correlation above CODEC_AAC_CORR.
    MP3: every frame header synced, its frames' samples the clip's
    length plus at most five frames (the encoder's delay and padding).
    Returns each codec's encode ms for the clip."""
    from birdnet_go_tpu_torch.audio import opusogg
    from birdnet_go_tpu_torch.audio.encode import encode_clip, load_clip_audio

    pcm = _codec_signal(CODEC_CLIP_S, SEED + 210)
    n = len(pcm)
    enc_ms = {}
    if offered["opus"]:
        t = time.perf_counter()
        path = opusogg.encode_ogg_opus(pcm, 48000, out / "round.opus")
        enc_ms["opus"] = round((time.perf_counter() - t) * 1e3, 2)
        f = _opus_file(path.read_bytes())
        d = f["pcm"][f["preskip"]:].astype(np.float64)
        m = min(len(d), n)
        r = pcm[:m].astype(np.float64)
        snr = 10 * np.log10((r ** 2).sum() / ((r - d[:m]) ** 2).sum())
        print(f"codecs opus: {n} samples -> {path.stat().st_size} bytes in "
              f"{f['pages']} pages (CRCs verified), granule - pre-skip "
              f"{f['samples']}, SNR {snr:.2f} dB (gate > "
              f"{CODEC_OPUS_SNR_DB}); encode {enc_ms['opus']} ms [{card}]")
        assert f["samples"] == n, f["samples"]
        assert snr > CODEC_OPUS_SNR_DB, snr
    if offered["aac"]:
        t = time.perf_counter()
        path = encode_clip(pcm, 48000, out / "round.m4a", fmt="aac")
        enc_ms["aac"] = round((time.perf_counter() - t) * 1e3, 2)
        samples, rate = load_clip_audio(path)
        got = (samples * 32768).astype(np.int16)
        corr = _aligned_corr(got, pcm)
        print(f"codecs aac: {n} samples -> {path.name} {path.stat().st_size}"
              f" bytes, loads {len(samples)} samples at {rate} Hz (gate "
              f"[{n}, {n + 1024})), correlation {corr:.5f} (gate > "
              f"{CODEC_AAC_CORR}); encode {enc_ms['aac']} ms [{card}]")
        assert path.suffix == ".m4a" and rate == 48000
        assert n <= len(samples) < n + 1024, len(samples)
        assert corr > CODEC_AAC_CORR, corr
    if offered["mp3"]:
        t = time.perf_counter()
        path = opusogg.encode_mp3(pcm, 48000, out / "round.mp3")
        enc_ms["mp3"] = round((time.perf_counter() - t) * 1e3, 2)
        got = _mp3_samples(path.read_bytes())
        print(f"codecs mp3: {n} samples -> {path.stat().st_size} bytes, "
              f"frames of {got} samples (gate [{n}, {n + 5 * 1152}]); "
              f"encode {enc_ms['mp3']} ms [{card}]")
        assert n <= got <= n + 5 * 1152, got
    if not any(offered[c] for c in CODEC_FORMATS):
        print(f"codecs: the machine offers no lossy codec: no round trip "
              f"[{card}]")
    return enc_ms


def _esds_asc(init: bytes) -> bytes:
    """The AudioSpecificConfig in an init segment's ``esds``."""
    from birdnet_go_tpu_torch.audio.aacenc import _desc_len

    esds = init[init.index(b"esds") + 8:]
    i = 0
    while i < len(esds):
        tag = esds[i]
        ln, j = _desc_len(esds, i + 1)
        if tag == 0x03:
            i = j + 3
        elif tag == 0x04:
            i = j + 13
        elif tag == 0x05:
            return esds[j:j + ln]
        else:
            i = j + ln
    raise AssertionError("no DecoderSpecificInfo in the esds")


def _live_audio(client, source: str, seconds: float) -> dict:
    """``GET audio/live/{source}?format=opus`` read for `seconds`: the
    content type, and the audio received: an Ogg Opus stream's whole
    pages read back (``_opus_file``: CRCs, pre-skip, the granule's
    advance, the decoded samples), or, where the machine has no libopus,
    the WAV stream JAX serves there (its header, and the samples after
    it)."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", client.port, timeout=10)
    try:
        c.request("GET", f"/api/v2/audio/live/{source}?format=opus",
                  headers={"Cookie": client.cookie})
        r = c.getresponse()
        kind, data = r.getheader("Content-Type"), b""
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end:
            chunk = r.read1(65536)
            if not chunk:
                break
            data += chunk
    finally:
        c.close()
    rec = {"status": r.status, "content_type": kind}
    if kind != "audio/ogg":
        channels, rate = struct.unpack("<HI", data[22:28])
        bits = struct.unpack("<H", data[34:36])[0]
        return rec | {"riff": data[:4] == b"RIFF" and data[8:12] == b"WAVE",
                      "rate": rate, "channels": channels, "bits": bits,
                      "samples": (len(data) - 44) // 2}
    off = 0                          # the pages received whole
    while off + 27 <= len(data):
        nseg = data[off + 26]
        end = off + 27 + nseg + sum(data[off + 27:off + 27 + nseg])
        if end > len(data):
            break
        off = end
    f = _opus_file(data[:off])
    return rec | {"bytes": off, "pages": f["pages"],
                  "preskip": f["preskip"], "samples": f["samples"],
                  "decoded": len(f["pcm"])}


def _hls_aac(client, source: str) -> dict:
    """An HLS session on `source` over the API: start, the playlist
    polled until a segment is listed (CODEC_HLS_WAIT_S), the init
    segment and that segment, a heartbeat, stop. Where the init carries
    ``mp4a``, the segment's access units (split by its ``trun`` sizes)
    decoded through the port with the init's AudioSpecificConfig."""
    from birdnet_go_tpu_torch.audio import aacenc

    base = f"/api/v2/audio/hls/{source}"
    st = [client.call("POST", f"{base}/start")[0]]
    deadline, segs = time.monotonic() + CODEC_HLS_WAIT_S, []
    while not segs and time.monotonic() < deadline:
        _, _, b, _ = client.call("GET", f"{base}/playlist.m3u8")
        segs = [ln for ln in b.decode().splitlines()
                if ln.endswith(".m4s")]
        time.sleep(0.25)
    assert segs, f"no HLS segment in {CODEC_HLS_WAIT_S} s"
    s_init, _, init, _ = client.call("GET", f"{base}/init.mp4")
    s_seg, _, seg, _ = client.call("GET", f"{base}/{segs[-1]}")
    st += [s_init, s_seg, client.call("POST", f"{base}/heartbeat")[0],
           client.call("POST", f"{base}/stop")[0]]
    rec = {"statuses": st, "codec": "aac" if b"mp4a" in init else "flac",
           "init_bytes": len(init), "segment_bytes": len(seg),
           "samples": _segment_samples(seg)}
    if rec["codec"] == "aac":
        p = seg.index(b"trun")
        n = struct.unpack(">I", seg[p + 8:p + 12])[0]
        sizes = [struct.unpack(">I", seg[p + 20 + 8 * i:p + 24 + 8 * i])[0]
                 for i in range(n)]
        payload, packets, off = _mdat(seg), [], 0
        for size in sizes:
            packets.append(payload[off:off + size])
            off += size
        pcm = aacenc.decode_aac(packets, _esds_asc(init), 48000)
        rec.update(packets=n, decoded=len(pcm), asc=_esds_asc(init).hex(),
                   rms=float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))))
    return rec


def _clip_length(path: Path) -> int:
    """The samples a clip decodes to: an Opus clip's granule less its
    pre-skip (its packets decoded), an ``.m4a`` through
    ``load_clip_audio``, an MP3's frames, a FLAC's."""
    from birdnet_go_tpu_torch.audio.encode import load_clip_audio

    if path.suffix == ".opus":
        f = _opus_file(path.read_bytes())
        assert len(f["pcm"]) >= f["samples"], (path, f["samples"])
        return f["samples"]
    if path.suffix == ".mp3":
        return _mp3_samples(path.read_bytes())
    if path.suffix == ".flac":
        return len(decode_flac(path.read_bytes())[0])
    return len(load_clip_audio(path)[0])


def codecs_leg(record_path: Path) -> None:
    """Phase 21's app leg, in a process of its own (``python3
    chip_smoke.py --codecs-leg <record.json>``): the ``Application`` on
    the card with its API behind a password, CODEC_TONES tone sources,
    v2.4 unfused at batch 256, clips in the first lossy format the
    machine offers (CODEC_FORMATS; ``flac`` where it offers none), serving
    CODEC_SECONDS. Meanwhile over HTTP: ``imports/birdnet-pi`` of a
    CODEC_PI_ROWS-row ``BirdDB.txt`` polled through ``imports/jobs/{id}``
    until completed, the same log again, ``imports/birdnet-go`` of a
    CODEC_GO_NOTES-note database (``diag/import_data.py``, seeded);
    ``audio/live/tone0?format=opus`` for CODEC_LIVE_S; an HLS session.
    Writes its record to `record_path`; ``phase_codecs_imports`` gates
    it."""
    import logging
    import threading

    from birdnet_go_tpu_torch.app import Application
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
    from birdnet_go_tpu_torch.diag.api_walk import Client
    from birdnet_go_tpu_torch.diag.import_data import (
        write_birdnet_go_db,
        write_birdnet_pi_log,
    )

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    losses: list[str] = []

    class _Losses(logging.Handler):
        def emit(self, r: logging.LogRecord) -> None:
            msg = r.getMessage()
            if r.levelno >= logging.ERROR or any(w in msg
                                                 for w in APP_WARNINGS):
                losses.append(f"{r.levelname} {r.name}: {msg[:300]}")

    logging.getLogger().addHandler(_Losses())
    out = record_path.parent
    offered = _codecs_offered()
    fmt = next((c for c in CODEC_FORMATS if offered[c]), "flac")
    pi_log, go_db = out / "BirdDB.txt", out / "birdnet.db"
    made_pi = write_birdnet_pi_log(pi_log, CODEC_PI_ROWS, seed=SEED + 211)
    made_go = write_birdnet_go_db(go_db, CODEC_GO_NOTES, seed=SEED + 212)
    tones = _app_tones()[::APP_TONES // CODEC_TONES]
    s = Settings()
    s.models = [ModelSettings(model_id="BirdNET_V2.4")]
    s.data_dir = str(out)
    s.database.path = str(out / "codecs.db")
    s.export.path = str(out / "clips")
    s.export.format = fmt
    s.export.clip_length_seconds = CODEC_CLIP_S
    s.export.pre_capture_seconds = 1.5
    s.realtime.interval_seconds = 0.0     # every approval saved and sent
    s.realtime.max_batch = 256
    s.location.latitude, s.location.longitude = APP_LATLON
    ws = s.webserver
    ws.enabled, ws.host, ws.port = True, "127.0.0.1", 0
    ws.password, ws.allow_local_bypass = CODEC_PASSWORD, False
    ws.token_file = str(out / "tokens.json")
    s.imageprovider.providers = ["avicommons"]   # nothing leaves the host
    s.realtime.sources = [
        {"type": "tone", "id": f"tone{k}", "freq": f, "pulse": p}
        for k, (f, p) in enumerate(tones)]
    warmups, warm_spans = [], []
    _timed_warmups(warmups, warm_spans)
    app = Application(s)
    served: dict[str, list[tuple[float, float]]] = {}
    handoff = app._on_window_result

    def on_window(model_id, w, vals, idx):
        served.setdefault(model_id, []).append((w.end_time, time.time()))
        handoff(model_id, w, vals, idx)

    app._on_window_result = on_window
    t0 = time.monotonic()
    app.setup()
    setup_s = time.monotonic() - t0
    produced: dict[str, int] = {}
    collect = app.device_loop._providers[0]

    def counted():
        items = collect()
        for it in items:
            produced[it[0]] = produced.get(it[0], 0) + 1
        return items

    app.device_loop._providers[0] = counted
    cal = _calibrate(app.device_loop.batchers["BirdNET_V2.4"],
                     app.labels["BirdNET_V2.4"],
                     app.processor.included_species,
                     _cal_windows(48000, CLIP, [], tones),
                     s.dynamic_threshold.trigger)
    s.models[0].threshold = cal["threshold"]
    s.models[0].sensitivity = cal["sensitivity"]
    app._reload_model_settings()

    for k in KERNELS:
        k.launches = 0
    warmups.clear()
    t1 = time.monotonic()
    app.start(warmup=True)
    start_s = time.monotonic() - t1
    t_start = time.time()
    client = Client(app.api.port, CODEC_PASSWORD)
    client.login()
    imports, spans = [], []
    for _ in range(2):
        a = time.time()
        st, _, b, _ = client.call("POST", "/api/v2/imports/birdnet-pi",
                                  {"path": str(pi_log)})
        assert st == 202, (st, b[:300])
        path = f"/api/v2/imports/jobs/{json.loads(b)['job']['id']}"
        job = {"status": "pending"}
        while job["status"] in ("pending", "running"):
            time.sleep(0.1)
            st, _, b, _ = client.call("GET", path)
            assert st == 200, (st, b[:300])
            job = json.loads(b)
        spans.append((a, time.time()))
        imports.append(job)
    a = time.time()
    st, _, b, ms = client.call("POST", "/api/v2/imports/birdnet-go",
                               {"path": str(go_db)})
    spans.append((a, time.time()))
    go = {"status": st, "ms": round(ms, 1)} | json.loads(b)
    live = _live_audio(client, "tone0", CODEC_LIVE_S)
    hls = _hls_aac(client, "tone0")
    time.sleep(max(0.0, t_start + CODEC_SECONDS - time.time()))
    t_end = time.time()
    t2 = time.monotonic()
    app.stop()
    stop_s = time.monotonic() - t2
    launches = {k.__name__: k.launches for k in KERNELS}
    left = [th.name for th in threading.enumerate()
            if th is not threading.main_thread() and th.is_alive()
            and not th.daemon]
    with contextlib.closing(sqlite3.connect(s.database.path)) as conn:
        def one(sql, *args):
            return conn.execute(sql, args).fetchone()[0]

        of = "FROM detections WHERE source_id = ?"
        db = {"pi_rows": one(f"SELECT COUNT(*) {of}", "birdnet-pi-import"),
              "go_rows": one(f"SELECT COUNT(*) {of}", "import:birdnet-go"),
              "go_results": one(f"SELECT COUNT(*) FROM results WHERE "
                                f"detection_id IN (SELECT id {of})",
                                "import:birdnet-go"),
              "go_reviews": one(f"SELECT COUNT(*) FROM reviews WHERE "
                                f"detection_id IN (SELECT id {of})",
                                "import:birdnet-go"),
              "go_comments": one(f"SELECT COUNT(*) FROM comments WHERE "
                                 f"detection_id IN (SELECT id {of})",
                                 "import:birdnet-go"),
              "go_locks": one(f"SELECT COUNT(*) {of} AND locked = 1",
                              "import:birdnet-go")}
        clips = [r[0] for r in conn.execute(
            "SELECT clip_name FROM detections WHERE source_id LIKE 'tone%'")]
    # a row holds no clip where its span was not captured before stop()
    # (phase 16 counts those rows the same way)
    clip_dir = Path(s.export.path)
    lengths = {name: _clip_length(clip_dir / name)
               if (clip_dir / name).is_file() else None
               for name in clips if name}
    v24 = served.get("BirdNET_V2.4", [])
    during, outside = _split_by_spans(v24, spans)
    rec = {
        "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0],
        "offered": offered, "format": fmt,
        "setup_s": round(setup_s, 2), "start_s": round(start_s, 2),
        "stop_s": round(stop_s, 2), "served_s": round(t_end - t_start, 1),
        "calibration": cal, "made_pi": made_pi, "made_go": made_go,
        "imports": imports, "go": go, "db": db,
        "import_spans_s": [round(b - a, 2) for a, b in spans],
        "clips": lengths, "rows_without_clip": clips.count(""),
        "live": live, "hls": hls,
        "produced": produced,
        "served": {m: len(v) for m, v in served.items()},
        "latency_ms": {m: _pct([(h - e) * 1e3 for e, h in v])
                       for m, v in served.items()},
        "v24_during_imports": _pct(during or [0.0]) | {"n": len(during)},
        "v24_outside_imports": _pct(outside or [0.0]) | {
            "n": len(outside)},
        "batches": sum(b.stats.batches_dispatched
                       for b in app.device_loop.batchers.values()),
        "overruns": sum(b.stats.overruns
                        for b in app.device_loop.batchers.values()),
        "windows_dropped": app.device_loop.windows_dropped,
        "launches": launches, "warmups": list(warmups),
        "threads_left": left, "losses": len(losses),
        "loss_lines": losses[:10],
    }
    record_path.write_text(json.dumps(rec, indent=1))


def phase_codecs_imports(card: str) -> None:
    """Phase 21, the importers and the native codecs: what the machine
    offers (``_codecs_offered``), the round trips of the codecs it offers
    (``_codec_round_trips``), then ``codecs_leg`` in a process of its own
    (record and log under ``build/codecs_smoke/``), gated here
    (``_codecs_gates``)."""
    t0 = time.monotonic()
    out = REPO / "build" / "codecs_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    offered = _codecs_offered()
    print(f"codecs offered: find_library {offered['find_library']}, "
          f"avcodec_version {offered['avcodec_version']}; the port's codec "
          f"library: opus_available() {offered['opus']}, mp3_available() "
          f"{offered['mp3']}, aacenc.available() {offered['aac']} [{card}]")
    enc_ms = _codec_round_trips(offered, out, card)
    rec_path = out / "codecs.json"
    t1 = time.monotonic()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           "--codecs-leg", str(rec_path)],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    wall = time.monotonic() - t1
    (out / "codecs.log").write_text(proc.stderr)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-6000:])
    assert proc.returncode == 0, f"the codecs leg exited {proc.returncode}"
    _codecs_gates(json.loads(rec_path.read_text()), enc_ms, wall)
    print(f"phase 21 (codecs, imports) {time.monotonic() - t0:.1f} s "
          f"[{card}]")


def _codecs_gates(rec: dict, enc_ms: dict, wall: float) -> None:
    """Phase 21's prints and gates on the leg's record: every window the
    engine offered served, none dropped, no overrun; v2.4's p95 below
    CODEC_P95_MS; the mel kernel once a batch and once the warm-up (the
    MBConv kernels never); the first import imported every row, the second
    skipped every row, the BirdNET-Go import took every note, and the
    database holds the generated rows, results, reviews, comments and
    locks; every approval's clip exists in the chosen format and decodes
    to CODEC_CLIP_S at 48 kHz (an ``.m4a`` less than a frame more, an MP3
    at most five frames more); the live Opus pages verify and their
    granule advances CODEC_LIVE_S x 48,000 within CODEC_LIVE_TOL_S (where
    the machine has no libopus: JAX's WAV stream there, 48 kHz mono 16-bit,
    as many samples); the
    HLS session answers, and muxes AAC that decodes where AAC is offered;
    ``stop()`` within CODEC_STOP_S; nothing logged at ERROR. Prints the
    import rows/s, v2.4's p50/p95/max during the imports and outside
    them, and each codec's encode ms a clip."""
    card, fmt = rec["card"], rec["format"]
    lat = rec["latency_ms"]["BirdNET_V2.4"]
    pi1, pi2 = rec["imports"]
    go, db = rec["go"], rec["db"]
    rate = round(pi1["imported"] / max(pi1["finished_at"]
                                       - pi1["started_at"], 1e-9), 1)
    why = ("no lossy codec offered" if fmt == "flac"
           else "the first lossy codec offered")
    print(f"codecs app: {CODEC_TONES} tone sources, v2.4 at batch 256 with "
          f"its API, clips as {fmt} ({why}), {rec['served_s']} s served; "
          f"process {wall:.1f} s (setup "
          f"{rec['setup_s']} s, start {rec['start_s']} s, stop "
          f"{rec['stop_s']} s) [{card}]")
    go_rate = round(go["imported"] / max(go["ms"], 1e-9) * 1e3, 1)
    print(f"codecs imports: BirdNET-Pi {pi1['scanned']} rows, imported "
          f"{pi1['imported']} at {rate} rows/s, again skipped "
          f"{pi2['skipped']}; BirdNET-Go {go} ({go_rate} notes/s); "
          f"database {db}; spans {rec['import_spans_s']} s [{card}]")
    print(f"codecs v2.4 latency (ms): during the imports "
          f"{rec['v24_during_imports']}, outside them "
          f"{rec['v24_outside_imports']}, all {lat} [{card}]")
    print(f"codecs encode ms a {CODEC_CLIP_S:g} s clip: {enc_ms}; live "
          f"?format=opus {rec['live']}; HLS {rec['hls']} [{card}]")
    print(f"codecs clips: {len(rec['clips'])} approvals' clips (rows "
          f"without one {rec['rows_without_clip']}), decoded lengths "
          f"{sorted(set(rec['clips'].values()), key=str)}; served "
          f"{rec['served']} of {rec['produced']}; batches {rec['batches']}, "
          f"launches {rec['launches']}, warm-ups {rec['warmups']}; "
          f"calibration {rec['calibration']}; threads left "
          f"{rec['threads_left']}; errors logged {rec['losses']} "
          f"{rec['loss_lines']} [{card}]")
    m = "BirdNET_V2.4"
    assert rec["produced"].get(m, 0) == rec["served"].get(m, 0) > 0, rec
    assert rec["windows_dropped"] == 0 and rec["overruns"] == 0, rec
    assert lat["p95"] < CODEC_P95_MS, lat
    assert rec["warmups"] == [m], rec["warmups"]
    assert rec["launches"]["melspec_fused"] == rec["batches"] + 1, rec
    assert rec["launches"]["expand_dw_pool"] == 0
    assert rec["launches"]["scale_project"] == 0
    rows, made = CODEC_PI_ROWS, rec["made_go"]
    assert pi1["status"] == "completed" and pi1["imported"] == rows \
        and pi1["errors"] == 0, pi1
    assert pi2["status"] == "completed" and pi2["skipped"] == rows \
        and pi2["imported"] == 0, pi2
    assert go["status"] == 200 and go["imported"] == made["notes"] \
        and go["errors"] == 0, go
    assert db == {"pi_rows": rows, "go_rows": made["notes"],
                  "go_results": made["results"],
                  "go_reviews": made["reviews"],
                  "go_comments": made["comments"],
                  "go_locks": made["locks"]}, (db, made)
    want = int(CODEC_CLIP_S * 48000)
    slack = {"aac": 1023, "mp3": 5 * 1152}.get(fmt, 0)
    assert rec["clips"], "no approval saved a clip"
    for name, n in rec["clips"].items():
        assert name.endswith(CODEC_SUFFIX[fmt]), name
        assert n is not None and want <= n <= want + slack, (name, n)
    live = rec["live"]
    assert live["status"] == 200, live
    assert abs(live["samples"] - CODEC_LIVE_S * 48000) <= \
        CODEC_LIVE_TOL_S * 48000, live
    if rec["offered"]["opus"]:
        assert live["content_type"] == "audio/ogg", live
        assert live["decoded"] >= live["samples"], live
    else:                            # JAX's WAV where libopus is missing
        assert live["content_type"] == "audio/wav" and live["riff"], live
        assert (live["rate"], live["channels"], live["bits"]) == \
            (48000, 1, 16), live
    hls = rec["hls"]
    assert hls["statuses"] == [200] * 5, hls
    assert hls["codec"] == ("aac" if rec["offered"]["aac"] else "flac"), hls
    if hls["codec"] == "aac":
        assert hls["decoded"] == hls["packets"] * 1024 == hls["samples"], hls
        assert hls["rms"] > 0, hls
    assert rec["stop_s"] <= CODEC_STOP_S and not rec["threads_left"], rec
    assert rec["losses"] == 0, rec["loss_lines"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if sys.argv[1:2] == ["--app-leg"]:       # phase 16's own process
        app_leg(Path(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--api-leg"]:       # phase 18's own process
        api_leg(Path(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--live-leg"]:      # phase 19's own process
        live_leg(Path(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--integrations-leg"]:   # phase 20's own process
        integrations_leg(Path(sys.argv[2]), Path(sys.argv[3]))
        return
    if sys.argv[1:2] == ["--codecs-leg"]:    # phase 21's own process
        codecs_leg(Path(sys.argv[2]))
        return
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
    phase_int8(dev, card)
    plain = phase_soak(dev, card)
    phase_aux(dev, card, plain)
    phase_app(card)
    phase_crash(card)
    phase_api(card)
    phase_live(card)
    phase_integrations(card)
    phase_codecs_imports(card)
    print(f"total {time.monotonic() - t0:.1f} s of phases, "
          f"{time.monotonic() - T_START:.1f} s since the imports")
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
