"""Fused mel spectrogram: the Hopper CUDA kernel, its wrapper and its plain
version (port of ``birdnet_go_tpu/ops/pallas_melspec.py``).

``melspec_fused`` launches ``csrc/melspec.cu`` for a tensor on a CUDA card
and takes ``melspec_fused_plain`` for a tensor on the CPU; on a CUDA tensor
it launches the kernel or raises. On the card the kernel is held to its
plain version computed in float64, not to the TPU kernel's bf16-class
output. The constants come from ``kernel_consts``, a port of the packed (v4)
branch of ``_kernel_consts``; ``group_consts`` lays them out by residue
group for the kernel's tensor-core products, and ``tf32_split`` splits them
into the (hi, lo) pairs of its 3xTF32 arithmetic. ``melspec_fused_work``
counts a call's operations and bytes for its bound.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from birdnet_go_tpu_torch.ops import _build
from birdnet_go_tpu_torch.ops.melspec import (
    MelConfig,
    _mel_filterbank_permuted_np,
    _rdft_matmul_consts,
    _window_fn,
    melspec,
)
from birdnet_go_tpu_torch.ops.pcm import pcm16_to_float32

_A = 16                       # radix: B = n_fft // 16 must equal 128
_LANE = 128
_MAG_MODES = {"linear": 0, "log": 1, "db": 2, "nonlinear": 3}
_MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=8)
def kernel_consts(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                  fmax: float):
    """Packed two-stage DFT constants: (wpk, twa, twb, fb2, j2).

    wpk is the packed real [16, 16] DFT-over-a matrix (rows re S[0..8],
    im S[1..7]). twa/twb [16, 128, 2·j2] are the per-residue stage-2
    twiddle pairs with the conjugate-symmetry signs baked in; fb2
    [16, j2, n_mels] is the permuted filterbank trimmed to its support.
    """
    war, wai, twr, twi, _, a_sz, b_sz, j_sz = _rdft_matmul_consts(n_fft, _A)
    if a_sz != _A or b_sz != _LANE:
        raise ValueError(f"n_fft={n_fft} does not split as 16 x 128")
    half = a_sz // 2

    # permuted filterbank [A*j_sz, m] → the j support actually used
    fbp = _mel_filterbank_permuted_np(sample_rate, n_fft, n_mels, fmin,
                                      fmax, _A).reshape(a_sz, j_sz, n_mels)
    used = np.nonzero(fbp.any(axis=(0, 2)))[0]
    j_need = int(used[-1]) + 1 if len(used) else 1
    # J2: filterbank support rounded up to a multiple of 8, capped at j_sz
    j2 = min(-(-j_need // 8) * 8, -(-j_sz // 8) * 8)
    js = min(j2, j_sz)

    fb2 = np.zeros((a_sz, j2, n_mels), np.float32)
    fb2[:, :js, :] = fbp[:, :js, :]

    # stage 1: the A-point DFT input is real, so S[A-r] = conj(S[r]); only
    # re(S[0..8]) and im(S[1..7]) are independent
    wpk = np.zeros((a_sz, a_sz), np.float32)
    wpk[:half + 1, :] = war[:half + 1, :]
    wpk[half + 1:, :] = wai[1:half, :]

    # stage 2 per residue r, against packed rows p1 (re) and p2 (im):
    #   r <= 8:  re = sr_r·twr − si_r·twi,  im = sr_r·twi + si_r·twr
    #   r >  8:  sr_r = sr_{A−r}, si_r = −si_{A−r} → B slab negated.
    twa = np.zeros((a_sz, b_sz, 2 * j2), np.float32)
    twb = np.zeros((a_sz, b_sz, 2 * j2), np.float32)
    for r in range(a_sz):
        twa[r, :, :js] = twr[r, :, :js]
        twa[r, :, j2:j2 + js] = twi[r, :, :js]
        if r % half:                       # r = 0, 8 have im(S) = 0
            sign = 1.0 if r < half else -1.0
            twb[r, :, :js] = -sign * twi[r, :, :js]
            twb[r, :, j2:j2 + js] = sign * twr[r, :, :js]
    return wpk, twa, twb, fb2, j2


def residue_groups() -> list[tuple[int, int]]:
    """The residue pairs the kernel walks, one per packed-row pair (g, 8 +
    g): (0, 8), whose rows are re S[0] and re S[8], then the conjugate
    pairs (g, 16 - g) for g = 1..7, whose rows are re S[g] and im S[g]."""
    return [(0, _A // 2)] + [(g, _A - g) for g in range(1, _A // 2)]


def group_consts(twa: np.ndarray, twb: np.ndarray, fb2: np.ndarray):
    """The kernel's per-group operands: (bg [8, 256, 4·j2], fbg [8, 2·j2,
    n_mels rounded up to 8]).

    Group g's stage-2 product is A [frames, 256] times bg[g]; its columns
    are residue h's (re j, im j) at h·2·j2. For g = 1..7, A interleaves the
    packed rows g and 8 + g by b (k = 2·b + row), so that every run of 16
    k-terms holds both rows' terms of 8 samples, which cancel there. Group
    0 is block-diagonal, A = [row 0 | row 8]: residue 0 reads only row 0
    and residue 8 only row 8. fbg[g] stacks the two residues' filterbank
    rows, zero-padded to a multiple of 8 mel bands.
    """
    a_sz, b_sz, w2 = twa.shape
    j2, n_mels = fb2.shape[1:]
    nm8 = -(-n_mels // 8) * 8
    groups = residue_groups()
    bg = np.zeros((len(groups), 2 * b_sz, 2 * w2), np.float32)
    fbg = np.zeros((len(groups), 2 * j2, nm8), np.float32)
    for g, pair in enumerate(groups):
        for h, r in enumerate(pair):
            cols = slice(h * w2, (h + 1) * w2)
            if g == 0:
                bg[g, h * b_sz:(h + 1) * b_sz, cols] = twa[r]
            else:
                bg[g, 0::2, cols] = twa[r]
                bg[g, 1::2, cols] = twb[r]
            fbg[g, h * j2:(h + 1) * j2, :n_mels] = fb2[r]
    return bg, fbg


def tf32_split(x: np.ndarray) -> np.ndarray:
    """float32 x → [..., 2] (hi, lo) with hi = tf32(x), lo = tf32(x - hi),
    rounding as ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero,
    10-bit mantissa): the kernel's 3xTF32 operands."""
    def tf32(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)

    hi = tf32(x)
    return np.stack([hi, tf32(x - hi)], axis=-1)


@functools.lru_cache(maxsize=8)
def _device_consts(cfg: MelConfig, device: torch.device):
    """(window, wpk, bg2, fbg2) as contiguous float32 tensors on `device`,
    and j2; bg2 and fbg2 are group_consts' arrays split by ``tf32_split``.
    Built once per (config, device)."""
    wpk, twa, twb, fb2, j2 = kernel_consts(cfg.sample_rate, cfg.n_fft,
                                           cfg.n_mels, cfg.fmin, cfg.fmax)
    arrays = (_window_fn(cfg), wpk,
              *map(tf32_split, group_consts(twa, twb, fb2)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays), j2


def check_config(cfg: MelConfig) -> None:
    """Raise ValueError for a config the kernel does not take (the same
    conditions as the TPU kernel)."""
    if cfg.power != 2.0:
        raise ValueError("fused kernel supports power spectrogram only")
    if cfg.hop % _LANE or cfg.n_fft % _LANE or cfg.n_fft // _A != _LANE:
        raise ValueError(
            f"fused kernel needs hop%128==0 and n_fft==2048 "
            f"(got hop={cfg.hop}, n_fft={cfg.n_fft})")
    if cfg.mag_scale not in _MAG_MODES:
        raise ValueError(f"unknown mag_scale {cfg.mag_scale!r}")


def melspec_fused_work(batch: int, t_len: int, cfg: MelConfig,
                       out_dtype: torch.dtype = torch.float32
                       ) -> tuple[dict[str, float], float]:
    """The kernel's work at [batch, t_len] (see ``ops/roofline.py``).

    Per frame, in float32 multiply-adds: stage 1, 128 · 16 · 16, on CUDA
    cores ("f32"); stage 2, 16 · J2 · 128 · 4 (re and im against the two
    packed rows), and the mel projection, 16 · J2 · n_mels, on the tensor
    cores in 3xTF32, three TF32 products per float32 multiply-add ("tf32").
    Bytes: the int16 PCM, the constants (window, wpk, both twiddle slabs,
    fb2) and the mel rows, each once.
    """
    j2 = kernel_consts(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                       cfg.fmax)[-1]
    frames = batch * cfg.num_frames(t_len)
    stage1 = _LANE * _A * _A
    mma = _A * j2 * _LANE * 4 + _A * j2 * cfg.n_mels
    consts = (cfg.n_fft + _A * _A + 2 * _A * _LANE * 2 * j2
              + _A * j2 * cfg.n_mels)
    item = 2 if out_dtype == torch.bfloat16 else 4
    nbytes = 2 * batch * t_len + 4 * consts + item * frames * cfg.n_mels
    return ({"f32": 2.0 * stage1 * frames, "tf32": 3 * 2.0 * mma * frames},
            float(nbytes))


def melspec_fused_plain(pcm_i16: torch.Tensor, cfg: MelConfig,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """The kernel's plain version: int16 → float32 → plain ``melspec``."""
    return melspec(pcm16_to_float32(pcm_i16), cfg).to(out_dtype)


def melspec_fused(pcm_i16: torch.Tensor, cfg: MelConfig,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int16 PCM [B, T] → mel [B, F, n_mels] (cfg.mag_scale applied).

    `out_dtype` is float32 or bfloat16 (the CNN's input dtype). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel on
    the current stream, and each launch adds one to
    ``melspec_fused.launches``.
    """
    check_config(cfg)
    if pcm_i16.device.type == "cpu":
        return melspec_fused_plain(pcm_i16, cfg, out_dtype)
    if pcm_i16.device.type != "cuda":
        raise ValueError(
            f"melspec_fused: unsupported device {pcm_i16.device}")
    if pcm_i16.dtype != torch.int16:
        raise ValueError(
            f"melspec_fused: needs int16 PCM, got {pcm_i16.dtype}")
    if pcm_i16.ndim != 2:
        raise ValueError(
            f"melspec_fused: needs [B, T], got {tuple(pcm_i16.shape)}")
    if not pcm_i16.is_contiguous():
        raise ValueError("melspec_fused: PCM must be contiguous")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"melspec_fused: unsupported out_dtype {out_dtype}")
    b, t = pcm_i16.shape
    n_frames = cfg.num_frames(t)
    if n_frames <= 0:
        raise ValueError(
            f"signal of {t} samples shorter than n_fft={cfg.n_fft}")
    if not 0 < b <= _MAX_GRID_Y:
        raise ValueError(
            f"melspec_fused: batch {b} outside [1, {_MAX_GRID_Y}]")

    # the launcher refuses more mel bands than its warps' accumulators hold
    lib = _build.load()
    (win, wpk, bg2, fbg2), j2 = _device_consts(cfg, pcm_i16.device)
    out = torch.empty((b, n_frames, cfg.n_mels), dtype=out_dtype,
                      device=pcm_i16.device)
    with torch.cuda.device(pcm_i16.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.melspec_fused_launch(
            pcm_i16.data_ptr(), b, t, cfg.hop, n_frames, win.data_ptr(),
            wpk.data_ptr(), bg2.data_ptr(), fbg2.data_ptr(), j2, cfg.n_mels,
            _MAG_MODES[cfg.mag_scale], cfg.log_offset, out.data_ptr(),
            int(out_dtype == torch.bfloat16), stream)
    _build.check(lib, err, "melspec_fused")
    melspec_fused.launches += 1
    return out


melspec_fused.launches = 0
