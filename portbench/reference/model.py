"""Mel front end + EfficientNet backbone + sigmoid, range mask and top-10,
in plain float32 PyTorch with TF32 off.

The model is the one a configuration file describes:

- mel: frames of ``n_fft`` samples every ``hop`` (no centring), a symmetric
  Hann window, the power spectrum of the real DFT, an HTK triangular mel
  filterbank of ``n_mels`` bands from ``fmin`` to ``fmax`` over the
  ``n_fft // 2 + 1`` bins, then ``mel ** (1 / 1.3)`` ("nonlinear").
- backbone (arXiv:1905.11946): a 3x3 stride-2 stem, MBConv blocks (1x1
  expansion, depthwise k x k, squeeze-excite on the block's input width
  times ``se_ratio``, 1x1 projection, residual where shape allows), a 1x1
  head to ``embedding_dim``, global average pooling and a dense classifier.
  Convolutions pad as TensorFlow's "SAME"; batch norm is folded from its
  statistics with eps 1e-3; the activation is swish.

``precision`` names the controls, the reference put in the program's place
one step below the precision that the configuration states. ``"int8"`` and
``"fp8"`` round every convolution's and every dense layer's two operands to
int8 codes or to float8 e4m3, each tensor scaled by its largest magnitude,
before the float32 product: one step below the bfloat16 the backbone serves
in. ``"tf32"`` and ``"bf16"`` compute the mel front end's transform and
filterbank as products of operands rounded to TF32 (10 stored mantissa
bits) or bfloat16: below the float32 that the front end states.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3


@contextlib.contextmanager
def exact_float32():
    """float32 products stay float32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` as an operand of a product in `precision` sees it. int8 and fp8:
    scaled by the tensor's largest magnitude to the type's range (±127,
    ±448), rounded to the nearest code, scaled back (the per-tensor
    symmetric scaling such products use). tf32 and bf16: the float32
    mantissa rounded to 10 or 7 stored bits."""
    if precision == "int8":
        scale = x.abs().amax().clamp(min=1e-30) / 127.0
        return torch.round(x / scale).clamp(-127, 127) * scale
    if precision == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    if precision == "tf32":
        bits = x.to(torch.float32).contiguous().view(torch.int32)
        bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
        return bits.view(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


# -- mel front end ------------------------------------------------------------

def hann(n: int) -> np.ndarray:
    """Symmetric Hann window of n points."""
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """HTK triangular filterbank [n_fft // 2 + 1, n_mels] (float64)."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    edges = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    lo, ctr, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (bins[:, None] - lo) / np.maximum(ctr - lo, 1e-9)
    down = (hi - bins[:, None]) / np.maximum(hi - ctr, 1e-9)
    return np.maximum(0.0, np.minimum(up, down))


def mel_features(pcm: torch.Tensor, mel: dict,
                 precision: str = "float32") -> torch.Tensor:
    """float32 PCM [B, T] in [-1, 1) → mel [B, frames, n_mels] float32.
    float32: the transform by ``torch.fft.rfft``; "tf32" or "bf16" (the
    front end's controls): the transform as a product with the DFT's cosine
    and sine matrices, and the filterbank's product, each of operands
    rounded to that precision and summed in float32."""
    n_fft, hop = mel["n_fft"], mel["hop"]
    frames = pcm.to(torch.float32).unfold(-1, n_fft, hop)
    win = torch.tensor(hann(n_fft), dtype=torch.float32, device=pcm.device)
    fb = torch.tensor(mel_filterbank(mel["sample_rate"], n_fft,
                                     mel["n_mels"], mel["fmin"], mel["fmax"]),
                      dtype=torch.float32, device=pcm.device)
    with exact_float32():
        if precision == "float32":
            spec = torch.fft.rfft(frames * win, dim=-1)
            power = spec.real.square() + spec.imag.square()
            m = power @ fb
        else:
            n = torch.arange(n_fft, dtype=torch.float64, device=pcm.device)
            ang = (2.0 * math.pi / n_fft) * torch.outer(n, n[:n_fft // 2 + 1])
            x = _round(frames * win, precision)
            re = x @ _round(torch.cos(ang).to(torch.float32), precision)
            im = x @ _round(torch.sin(ang).to(torch.float32), precision)
            power = _round(re.square() + im.square(), precision)
            m = power @ _round(fb, precision)
    if mel["mag_scale"] != "nonlinear":
        raise ValueError(f"mag_scale {mel['mag_scale']!r} not described")
    return m.clamp(min=0.0).pow(1.0 / 1.3)


# -- backbone -------------------------------------------------------------------

def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv(x, w, stride, groups, precision):
    k = w.shape[-1]
    return F.conv2d(_round(_same_pad(x, k, stride), precision),
                    _round(w, precision), stride=stride, groups=groups)


def _bn(x, p, name):
    k = p[f"{name}.scale"] / torch.sqrt(p[f"{name}.var"] + BN_EPS)
    b = p[f"{name}.bias"] - p[f"{name}.mean"] * k
    return x * k[:, None, None] + b[:, None, None]


def _dense(x, p, name, precision):
    y = _round(x, precision) @ _round(p[f"{name}.w"], precision).T
    return y + p[f"{name}.b"]


def block_layout(net: dict) -> list[dict]:
    """One entry per MBConv block: cin, cout, cmid, k, stride, squeeze
    width, residual."""
    out, cin = [], net["stem_channels"]
    for expand, cout, k, stride, repeats in net["blocks"]:
        for r in range(repeats):
            s = stride if r == 0 else 1
            out.append({"cin": cin, "cout": cout, "cmid": cin * expand,
                        "expand": expand, "k": k, "stride": s,
                        "squeeze": max(1, int(cin * net["se_ratio"])),
                        "residual": s == 1 and cin == cout})
            cin = cout
    return out


def stem(mel: torch.Tensor, p: dict, precision: str = "float32",
         bn=None) -> torch.Tensor:
    """mel [B, frames, n_mels] → the stem's output [B, C, H, W]."""
    bn = bn or (lambda x, name: _bn(x, p, name))
    with exact_float32():
        h = mel[:, None].to(torch.float32)        # [B, 1, frames, mels]
        return F.silu(bn(_conv(h, p["stem_conv.w"], 2, 1, precision),
                         "stem_bn"))


def block(x: torch.Tensor, p: dict, i: int, b: dict,
          precision: str = "float32", bn=None) -> torch.Tensor:
    """MBConv block `i` (`b`: its entry of ``block_layout``) on `x`."""
    bn = bn or (lambda h, name: _bn(h, p, name))
    q = f"blocks.{i}"
    with exact_float32():
        h = x.to(torch.float32)
        if b["expand"] != 1:
            h = F.silu(bn(_conv(h, p[f"{q}.expand_conv.w"], 1, 1,
                                precision), f"{q}.expand_bn"))
        h = F.silu(bn(_conv(h, p[f"{q}.dw.w"], b["stride"], b["cmid"],
                            precision), f"{q}.dw_bn"))
        s = h.mean(dim=(2, 3))
        s = F.silu(_dense(s, p, f"{q}.se.reduce", precision))
        s = torch.sigmoid(_dense(s, p, f"{q}.se.expand", precision))
        h = h * s[:, :, None, None]
        h = bn(_conv(h, p[f"{q}.project_conv.w"], 1, 1, precision),
               f"{q}.project_bn")
        if b["residual"]:
            h = h + x.to(torch.float32)
        return h


def head(x: torch.Tensor, p: dict, precision: str = "float32",
         bn=None) -> torch.Tensor:
    """The last block's output → logits [B, num_classes] float32."""
    bn = bn or (lambda h, name: _bn(h, p, name))
    with exact_float32():
        h = F.silu(bn(_conv(x.to(torch.float32), p["head_conv.w"], 1, 1,
                            precision), "head_bn"))
        return _dense(h.mean(dim=(2, 3)), p, "classifier", precision)


def backbone(mel: torch.Tensor, p: dict, net: dict,
             precision: str = "float32", bn_hook=None) -> torch.Tensor:
    """mel [B, frames, n_mels] → logits [B, num_classes] float32. `p` maps
    the benchmark's parameter names to float32 tensors. `bn_hook(name, x)`,
    where given, sees each batch norm's input before it is applied (the
    weight maker sets the statistics from it)."""
    def bn(x, name):
        if bn_hook is not None:
            bn_hook(name, x)
        return _bn(x, p, name)

    h = stem(mel, p, precision, bn)
    for i, b in enumerate(block_layout(net)):
        h = block(h, p, i, b, precision, bn)
    return head(h, p, precision, bn)


def confidences(pcm: torch.Tensor, p: dict, cfg: dict,
                mask: torch.Tensor | None, sensitivity: float = 1.0,
                precision: str = "float32") -> torch.Tensor:
    """float32 PCM [B, clip] → masked confidences [B, num_classes]:
    sigmoid(sensitivity · logit) times the range mask. The mel front end
    stays float32 for the backbone's controls (int8, fp8)."""
    mel_prec = precision if precision in ("tf32", "bf16") else "float32"
    net_prec = "float32" if precision in ("tf32", "bf16") else precision
    logits = backbone(mel_features(pcm, cfg["mel"], mel_prec), p,
                      cfg["net"], net_prec)
    conf = torch.sigmoid(sensitivity * logits)
    return conf * mask if mask is not None else conf


# -- resampling -------------------------------------------------------------------

def resample(x: torch.Tensor, in_rate: int, out_rate: int,
             taps_per_phase: int = 24, beta: float = 8.6,
             cutoff_scale: float = 0.97) -> torch.Tensor:
    """Rational resampling of a 1-D float32 signal by L/M (the rates over
    their gcd): upsample by L with zeros, low-pass with a Kaiser-windowed
    sinc of 2 · taps_per_phase · max(L, M) + 1 taps, cutoff cutoff_scale /
    max(L, M) of the upsampled rate and passband gain L, keep every M-th
    sample. Output j is centred on input j · M / L; the signal is zero
    outside its span; the output has floor(T · L / M) samples.

    Written as y[j] = Σ_n x[n] · h[j·M − n·L + c], c = (taps − 1) / 2,
    evaluated for each output phase j mod L over the inputs it reaches."""
    g = math.gcd(in_rate, out_rate)
    up, down = out_rate // g, in_rate // g
    if up == down == 1:
        return x
    n_taps = 2 * taps_per_phase * max(up, down) + 1
    cutoff = cutoff_scale / max(up, down)
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = np.sinc(n * cutoff) * cutoff * np.kaiser(n_taps, beta)
    h = h * up / h.sum()
    c = (n_taps - 1) // 2
    t = x.shape[-1]
    out_len = t * up // down
    y = torch.zeros(out_len, dtype=torch.float32, device=x.device)
    # output j = q·up + r reads inputs n with 0 <= j·M − n·L + c < taps:
    # n = floor((j·M + c) / L) − s for s = 0 .. S−1
    span = n_taps // up + 2
    for r in range(up):
        j = torch.arange(r, out_len, up, device=x.device)
        if len(j) == 0:
            continue
        base = (j * down + c) // up
        s = torch.arange(span, device=x.device)
        idx = base[:, None] - s[None, :]                  # [Q, S]
        tap = j[:, None] * down - idx * up + c
        ok = (tap >= 0) & (tap < n_taps) & (idx >= 0) & (idx < t)
        hv = torch.tensor(h, dtype=torch.float64, device=x.device)
        w = torch.where(ok, hv[tap.clamp(0, n_taps - 1)],
                        torch.zeros((), dtype=torch.float64,
                                    device=x.device))
        xv = x.to(torch.float64)[idx.clamp(0, t - 1)]
        y[r::up] = (w * xv).sum(dim=1).to(torch.float32)
    return y
