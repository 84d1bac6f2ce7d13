"""Mel-spectrogram front end in plain PyTorch (port of
``birdnet_go_tpu/ops/melspec.py``).

This is the XLA path of the JAX package: framing, a two-stage matmul real
DFT (Cooley–Tukey split n_fft = A×B) and a mel projection through a
filterbank whose rows are permuted into the DFT's (r, j) output layout. It
runs in float32 at full precision, as the JAX path pins
``Precision.HIGHEST``: float32 matmuls on a CUDA card stay out of TF32
while ``torch.backends.cuda.matmul.allow_tf32`` is False, its default.

The numpy constant builders and ``MelConfig`` are copies: the originals
cannot be imported without JAX, because ``birdnet_go_tpu/ops/__init__.py``
imports it. ``tests/test_torch_melspec.py`` holds the copies equal to the
originals array for array.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Static mel front-end configuration (hashable).

    Defaults correspond to the BirdNET v2.4 family contract: 48 kHz, 3 s
    windows.
    """

    sample_rate: int = 48000
    n_fft: int = 2048
    hop: int = 512
    n_mels: int = 96
    fmin: float = 0.0
    fmax: float = 15000.0
    window: str = "hann"           # "hann" | "hamming" | "rect"
    log_offset: float = 1e-6
    power: float = 2.0             # 2.0 = power spectrogram, 1.0 = magnitude
    use_matmul_fft: bool = True    # two-stage matmul DFT vs torch.fft.rfft
    mag_scale: str = "log"         # "log" | "db" | "linear" | "nonlinear"

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.n_fft:
            return 0
        return (num_samples - self.n_fft) // self.hop + 1


def _window_fn(cfg: MelConfig) -> np.ndarray:
    n = cfg.n_fft
    if cfg.window == "hann":
        return np.hanning(n).astype(np.float32)
    if cfg.window == "hamming":
        return np.hamming(n).astype(np.float32)
    if cfg.window == "rect":
        return np.ones((n,), np.float32)
    raise ValueError(f"unknown window {cfg.window!r}")


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def _mel_filterbank_np(sample_rate: int, n_fft: int, n_mels: int,
                       fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank, [n_bins, n_mels], float32 (HTK-style)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return fb


def _choose_radix(n: int) -> tuple[int, int]:
    """Pick A×B = n with A,B as close as possible (minimizes A+B)."""
    best = (1, n)
    a = int(math.isqrt(n))
    while a > 1:
        if n % a == 0:
            best = (a, n // a)
            break
        a -= 1
    return best


@functools.lru_cache(maxsize=16)
def _rdft_matmul_consts(n_fft: int, a_sz: int | None = None):
    """DFT constants: stage-1 [A,A] (re, im), stage-2 [A,B,J] (re, im),
    the (r, j) → bin map, and A, B, J.

    For x[a·B + b], X[r + A·j] = Σ_b W_N^{(r+A·j)·b} · Σ_a x[a·B+b]·W_A^{r·a}.
    `a_sz` overrides the FLOP-minimal radix split.
    """
    if a_sz is not None:
        if n_fft % a_sz:
            raise ValueError(f"{a_sz} does not divide n_fft={n_fft}")
        b_sz = n_fft // a_sz
    else:
        a_sz, b_sz = _choose_radix(n_fft)
    k_out = n_fft // 2 + 1
    j_sz = (k_out - 1) // a_sz + 1          # bins per residue group (padded)
    aa = np.arange(a_sz)
    w_a = np.exp(-2j * np.pi * np.outer(aa, aa) / a_sz)     # [A, A]
    r = np.arange(a_sz)[:, None, None]
    b = np.arange(b_sz)[None, :, None]
    j = np.arange(j_sz)[None, None, :]
    k = r + a_sz * j                                         # [A, 1, J]
    tw = np.exp(-2j * np.pi * (k * b) / n_fft)               # [A, B, J]
    # bin_of[r, j] = r + A*j, or -1 where it exceeds the spectrum
    bin_of = (np.arange(a_sz)[:, None] + a_sz * np.arange(j_sz)[None, :])
    valid = bin_of < k_out
    bin_of = np.where(valid, bin_of, -1)
    return (
        w_a.real.astype(np.float32), w_a.imag.astype(np.float32),
        tw.real.astype(np.float32), tw.imag.astype(np.float32),
        bin_of.astype(np.int64), a_sz, b_sz, j_sz,
    )


@functools.lru_cache(maxsize=32)
def _mel_filterbank_permuted_np(sample_rate: int, n_fft: int, n_mels: int,
                                fmin: float, fmax: float,
                                a_sz: int | None = None) -> np.ndarray:
    """Mel filterbank with rows permuted into the (r, j) DFT output layout:
    fb_perm[r·J + j, m] = fb[r + A·j, m], 0 for padded positions."""
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, fmin, fmax)
    *_, bin_of, a_sz, b_sz, j_sz = _rdft_matmul_consts(n_fft, a_sz)
    out = np.zeros((a_sz * j_sz, n_mels), np.float32)
    rr, jj = np.nonzero(bin_of >= 0)
    out[rr * j_sz + jj] = fb[bin_of[rr, jj]]
    return out


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def frame_signal(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[..., T] → [..., F, n_fft] overlapped frames (a strided view)."""
    t = x.shape[-1]
    if cfg.num_frames(t) <= 0:
        raise ValueError(
            f"signal of {t} samples shorter than n_fft={cfg.n_fft}")
    return x.unfold(-1, cfg.n_fft, cfg.hop)


def _rdft_power_permuted(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """frames [..., F, n_fft] → power spectrum [..., F, A, J] (r, j layout)."""
    war, wai, twr, twi, _, a_sz, b_sz, _ = _rdft_matmul_consts(n_fft)
    dev = frames.device
    war, wai, twr, twi = (_const(c, dev).to(frames.dtype)
                          for c in (war, wai, twr, twi))
    x = frames.reshape(*frames.shape[:-1], a_sz, b_sz)   # x[a, b]
    # stage 1: DFT over 'a' for each b → s[r, b] complex
    sr = torch.einsum("...ab,ar->...rb", x, war)
    si = torch.einsum("...ab,ar->...rb", x, wai)
    # stage 2: per-residue matmul over b → X[r, j] complex
    re = (torch.einsum("...rb,rbj->...rj", sr, twr)
          - torch.einsum("...rb,rbj->...rj", si, twi))
    im = (torch.einsum("...rb,rbj->...rj", sr, twi)
          + torch.einsum("...rb,rbj->...rj", si, twr))
    return re * re + im * im


def _rdft_power_matmul(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """frames [..., F, n_fft] → power spectrum [..., F, n_fft//2+1] in
    natural bin order."""
    *_, bin_of, a_sz, b_sz, j_sz = _rdft_matmul_consts(n_fft)
    p = _rdft_power_permuted(frames, n_fft)
    flat = p.reshape(*p.shape[:-2], a_sz * j_sz)
    k_out = n_fft // 2 + 1
    pos_of_k = np.zeros((k_out,), np.int64)
    rr, jj = np.nonzero(bin_of >= 0)
    pos_of_k[bin_of[rr, jj]] = rr * j_sz + jj
    return flat[..., _const(pos_of_k, frames.device)]


@functools.lru_cache(maxsize=16)
def _window_on(cfg: MelConfig, device: torch.device) -> torch.Tensor:
    """``_window_fn(cfg)`` uploaded to `device` once (an ordinary tensor,
    also when the first caller runs in inference mode)."""
    with torch.inference_mode(False):
        return _const(_window_fn(cfg), device)


def _spectrum(frames: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Windowed frames → power (or magnitude) spectrum [..., F, n_bins]."""
    fw = frames * _window_on(cfg, frames.device)
    if cfg.use_matmul_fft:
        power = _rdft_power_matmul(fw, cfg.n_fft)
    else:
        spec = torch.fft.rfft(fw, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
    if cfg.power == 2.0:
        return power
    return torch.sqrt(torch.clamp(power, min=0.0)) ** cfg.power


def scale_mag(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Apply cfg.mag_scale to mel energies."""
    if cfg.mag_scale == "log":
        return torch.log(mel + cfg.log_offset)
    if cfg.mag_scale == "db":
        return 10.0 * torch.log10(mel + cfg.log_offset)
    if cfg.mag_scale == "nonlinear":
        # BirdNET-style compression x^(1/1.3)
        return torch.pow(torch.clamp(mel, min=0.0), 1.0 / 1.3)
    return mel


def melspec(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """PCM float32 [..., T] → mel spectrogram [..., F, n_mels] (float32).

    A float64 signal is computed in float64, with the same float32
    constants: the reference the CUDA kernel is held to on the card."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    frames = frame_signal(x.to(dtype), cfg)
    if cfg.use_matmul_fft and cfg.power == 2.0:
        # permuted-layout matmul DFT + permuted filterbank
        win = _const(_window_fn(cfg), x.device).to(dtype)
        p = _rdft_power_permuted(frames * win, cfg.n_fft)
        p = p.reshape(*p.shape[:-2], -1)
        fb = _mel_filterbank_permuted_np(
            cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    else:
        p = _spectrum(frames, cfg)
        fb = _mel_filterbank_np(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                cfg.fmin, cfg.fmax)
    mel = torch.matmul(p, _const(fb, x.device).to(dtype))
    return scale_mag(mel, cfg)
