"""Spectrogram PNG rendering from the shared device STFT.

Reference: internal/spectrogram — generates detection-clip PNGs via SoX
(FFT-friendly heights, generator.go:111-123) with FFmpeg showspectrumpic
fallback, frequency profiles (bird 24 kHz resample → 0-12 kHz axis; bat
fixed 256 kHz → 0-128 kHz axis, frequency_profile.go:1-30), a PreRenderer
background worker queue (prerenderer.go:45-590), and
semaphore+singleflight concurrency.

The port's copy of ``birdnet_go_tpu/analysis/spectrogram.py``.
Everything up to the image's uint8 colour index runs on `device`, the
card unless the caller asks for another (``spectrogram_index``): the bird
profile's resample (``ops/resample.polyphase_resample``: cuDNN's
``conv1d`` with TF32 off), framing, ``_spectrum`` with
``use_matmul_fft=False`` (``torch.fft.rfft``: cuFFT), 10·log10, the
image's maximum, the clip to the dynamic range and the scaling to 0..255,
truncated to uint8 as numpy's ``astype`` truncates; only the [bins, F]
index is copied to the host. The JAX function takes the steps after its
FFT in float32 numpy.

The card's machine has no Pillow, so the rest is numpy and the standard
library: the colour map, PIL's BILINEAR resize reproduced in fixed point
(``_resize_width``) and a PNG writer (``write_png``: 8-bit RGB, filter 0,
zlib). ``render_spectrogram`` returns the [height, width, 3] uint8 array
where the JAX function returns a PIL Image. ``tests/test_torch_aux.py``
holds the index to the JAX function's and the image and PNG to PIL's.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import queue
import struct
import threading
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from birdnet_go_tpu_torch.ops.melspec import MelConfig, _spectrum, frame_signal
from birdnet_go_tpu_torch.ops.resample import (
    ResampleConfig,
    polyphase_resample,
)
from birdnet_go_tpu_torch.ops.streams import aux_device, on_stream, side_stream

log = logging.getLogger("birdnet_tpu.spectrogram")

# Reference size presets (ARCHITECTURE.md:2480-2485)
SIZES = {"sm": 400, "md": 800, "lg": 1000, "xl": 1200}


@dataclasses.dataclass(frozen=True)
class FrequencyProfile:
    """Bird: resample to 24 kHz (0-12 kHz axis). Bat: raw 256 kHz fixed
    0-128 kHz axis (frequency_profile.go:13-16)."""

    name: str
    target_rate: int | None          # resample before STFT (None = keep)
    fmax_hz: float

    @classmethod
    def bird(cls):
        return cls(name="bird", target_rate=24000, fmax_hz=12000.0)

    @classmethod
    def bat(cls):
        return cls(name="bat", target_rate=None, fmax_hz=128000.0)


# Inferno-like 8-stop colormap (dark → bright), interpolated to 256 RGB.
_STOPS = np.array([
    (0, 0, 4), (40, 11, 84), (101, 21, 110), (159, 42, 99),
    (212, 72, 66), (245, 125, 21), (250, 193, 39), (252, 255, 164)],
    np.float32)


def _colormap() -> np.ndarray:
    xs = np.linspace(0, len(_STOPS) - 1, 256)
    lo = np.floor(xs).astype(int)
    hi = np.minimum(lo + 1, len(_STOPS) - 1)
    t = (xs - lo)[:, None]
    return ((1 - t) * _STOPS[lo] + t * _STOPS[hi]).astype(np.uint8)


_CMAP = _colormap()


def spectrogram_index(samples: np.ndarray, sample_rate: int,
                      width: int = 800, height: int = 0,
                      profile: FrequencyProfile | None = None,
                      dyn_range_db: float = 80.0,
                      device: torch.device | str = "cuda") -> np.ndarray:
    """float32 PCM → the image's colour index, uint8 [height, F] with low
    frequencies at the bottom, computed on `device`.

    Heights are FFT-friendly: n_fft = 2·(height−1) when height is given,
    otherwise height = n_fft//2 + 1 with n_fft=512 (generator.go:111-123
    picks FFT-friendly heights the same way).
    """
    dev = aux_device(device, "render_spectrogram")
    profile = profile or FrequencyProfile.bird()
    rate = sample_rate
    x = torch.from_numpy(np.asarray(samples, np.float32)).to(dev)
    if profile.target_rate and sample_rate != profile.target_rate:
        x = polyphase_resample(x, ResampleConfig(sample_rate,
                                                 profile.target_rate))
        rate = profile.target_rate

    if height and height > 16:
        n_fft = 2 * (height - 1)
        n_fft = 1 << int(np.ceil(np.log2(n_fft)))  # radix-friendly
    else:
        n_fft = 512

    hop = max(1, (x.shape[-1] - n_fft) // max(width - 1, 1))
    cfg = MelConfig(sample_rate=rate, n_fft=n_fft, hop=hop,
                    window="hann", use_matmul_fft=False, mag_scale="linear")
    if x.shape[-1] < n_fft:
        x = F.pad(x, (0, n_fft - x.shape[-1]))
    power = _spectrum(frame_signal(x, cfg), cfg)     # [F, bins]

    db = 10.0 * torch.log10(power.T + 1e-12)          # [bins, F]
    top = db.max()
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    floor = top - dyn_range_db
    db = torch.clamp(db, floor, top)
    norm = (db - floor) / dyn_range_db
    idx = (norm * 255).to(torch.uint8).flip(0)        # low freq at bottom
    return idx.cpu().numpy()


# PIL's fixed point for 8-bit resampling (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for its BILINEAR filter over the whole
    row, then ``normalize_coeffs_8bpc``: each output pixel's first input
    pixel [out] and its integer weights [out, ksize], in float64 as
    Resample.c computes them (a triangle of support 1 widened by the
    reduction factor, each pixel's weights normalized to sum 1, then
    rounded to 22-bit fixed point)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            w.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for v in w:                     # in order, as the C loop sums
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(0.5 + k * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _resize_width(rgb: np.ndarray, width: int) -> np.ndarray:
    """[H, W, 3] uint8 → [H, width, 3] as PIL's ``resize((width, H),
    BILINEAR)``, which runs only its horizontal pass when the height
    matches: each channel a fixed-point sum rounded by half an ulp, shifted
    down and clipped to 0..255."""
    first, kk = _bilinear_coeffs(rgb.shape[1], width)
    cols = np.minimum(first[:, None] + np.arange(kk.shape[1]),
                      rgb.shape[1] - 1)           # weights past xmax are 0
    acc = (rgb[:, cols, :].astype(np.int64)
           * kk[None, :, :, None]).sum(axis=2)
    acc += 1 << (_PRECISION_BITS - 1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def render_spectrogram(samples: np.ndarray, sample_rate: int,
                       width: int = 800, height: int = 0,
                       profile: FrequencyProfile | None = None,
                       dyn_range_db: float = 80.0,
                       device: torch.device | str = "cuda") -> np.ndarray:
    """float32 PCM → RGB image, uint8 [height, width, 3] (linear
    frequency, SoX-style; see ``spectrogram_index``)."""
    img_idx = spectrogram_index(samples, sample_rate, width, height,
                                profile, dyn_range_db, device)
    rgb = _CMAP[img_idx]
    if rgb.shape[1] != width:      # the height is the index's by design
        rgb = _resize_width(rgb, width)
    return rgb


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 → an 8-bit RGB PNG: one IDAT, every scanline
    filter 0 (none), zlib level 6."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def generate_png(samples: np.ndarray, sample_rate: int, out_path: str | Path,
                 width: int = 800, profile: FrequencyProfile | None = None,
                 device: torch.device | str = "cuda") -> Path:
    """Render + atomic write (temp file + rename, as the reference does)."""
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    rgb = render_spectrogram(samples, sample_rate, width=width,
                             profile=profile, device=device)
    tmp = out.with_suffix(out.suffix + ".tmp")
    write_png(tmp, rgb)
    tmp.rename(out)
    return out


class PreRenderer:
    """Background spectrogram worker pool with singleflight dedup.

    Reference: spectrogram/prerenderer.go — renders from in-memory PCM
    right after a detection is saved so the UI never waits; duplicate
    requests for the same output coalesce. Renders run on `device`, the
    card unless the caller asks for another, each worker on a CUDA stream
    of its own there.
    """

    def __init__(self, workers: int = 2,
                 device: torch.device | str = "cuda"):
        self.device = aux_device(device, "PreRenderer")
        self._queue: queue.Queue = queue.Queue(maxsize=256)
        self._inflight: set[str] = set()
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._workers = workers
        self.rendered = 0
        self.dropped = 0

    def queue_depth(self) -> int:
        """Pending render jobs (the /spectrogram/:id/status probe)."""
        return self._queue.qsize()

    def start(self) -> None:
        if self._threads:
            return
        for i in range(self._workers):
            t = threading.Thread(target=self._run, name=f"prerender-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def submit(self, samples: np.ndarray, sample_rate: int,
               out_path: str | Path, width: int = 800,
               profile: FrequencyProfile | None = None) -> bool:
        key = str(out_path)
        with self._lock:
            if key in self._inflight:         # singleflight
                return True
            self._inflight.add(key)
        try:
            self._queue.put_nowait((samples, sample_rate, out_path, width,
                                    profile))
        except queue.Full:
            with self._lock:
                self._inflight.discard(key)
            self.dropped += 1
            return False
        return True

    def _run(self) -> None:
        with on_stream(side_stream(self.device)):
            while True:
                item = self._queue.get()
                if item is None:
                    return
                samples, rate, out_path, width, profile = item
                try:
                    generate_png(samples, rate, out_path, width, profile,
                                 self.device)
                    self.rendered += 1
                except Exception:
                    log.exception("prerender failed for %s", out_path)
                finally:
                    with self._lock:
                        self._inflight.discard(str(out_path))
