"""Fused stride-1 MBConv: the Hopper CUDA kernels, their wrappers and their
plain versions (port of ``birdnet_go_tpu/ops/pallas_mbconv.py``).

Two kernels per block, as in the JAX module:

  kernel A  x[S, C] ─ expand 1×1 ─ BN·swish ─ depthwise k×k ─ BN·swish
            → y[S, Cm] + the float32 channel sum (SE squeeze input)
  (SE mid: two small dense layers on [B, Cm], plain torch)
  kernel B  y[S, Cm] ─ ×SE scale ─ project 1×1 ─ BN ─ (+residual)
            → out[S, C']

``expand_dw_pool`` and ``scale_project`` take their plain versions for a
tensor on the CPU; on a CUDA tensor they launch ``csrc/mbconv.cu`` or raise,
and each launch adds one to the wrapper's ``launches``. With bf16 matrix
operands the kernels read their weights rounded to bf16 and laid out in
tensor-core fragment order (``pack_fragments``): the glue packs them once
per block, a direct call packs them on the call. Both check the
layout on every device: activations are contiguous [B, S, C], which is the
memory of an NCHW tensor in ``torch.channels_last``. Nothing is copied to
make them so.

The plain versions compute what the Pallas kernels compute, which is not
what ``layers.MBConv`` computes: everything between the two matrix products
stays float32, matrix operands are rounded to `dot_dtype` and multiplied
with a float32 accumulator, only y and out are rounded to their dtypes, and
the pool is the float32 sum taken before y is rounded.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from birdnet_go_tpu_torch.ops import _build

if TYPE_CHECKING:
    from birdnet_go_tpu_torch.models.layers import BatchNorm, MBConv

_DTYPES = (torch.float32, torch.bfloat16)
_KERNELS = (3, 5)


def fold_bn(bn: BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as y = x·k + b: float32 row vectors [1, C]."""
    k = bn.scale * torch.rsqrt(bn.var + bn.eps)
    b = bn.bias - bn.mean * k
    return k[None, :].float(), b[None, :].float()


def fused_block_ok(stride: int, h: int, w: int, train: bool) -> bool:
    """Gate, as the JAX module's: stride-1 inference blocks with H·W >= 64
    (the tail stages stay on the unfused path)."""
    return stride == 1 and not train and h * w >= 64


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """A matrix operand w [K, N] rounded to bf16 and laid out as the B
    fragments of ``mma.sync.m16n8k16`` (bf16): [⌈K/16⌉, ⌈N/8⌉, 32 lanes, 4]
    bf16, zero-padded past K and N. Lane 4·g + t of k16 step s and 8-column
    tile j holds w[16·s + 2·t + e % 2 + 8·(e // 2), 8·j + g] as its element
    e, so each lane loads its two 32-bit registers as 8 bytes."""
    k, n = w.shape
    ks, nt = -(-k // 16), -(-n // 8)
    wp = torch.zeros((ks * 16, nt * 8), dtype=torch.bfloat16, device=w.device)
    wp[:k, :n] = w.to(torch.bfloat16)
    # k = 16·s + 8·hi + 2·t + lo, n = 8·j + g → [s, j, g, t, hi, lo]
    v = wp.view(ks, 2, 4, 2, nt, 8).permute(0, 4, 5, 2, 1, 3)
    return v.reshape(ks, nt, 32, 4).contiguous()


def _rounded(t: torch.Tensor, dot_dtype: torch.dtype) -> torch.Tensor:
    """A matrix operand rounded to `dot_dtype`, held in float32."""
    return t.to(dot_dtype).float()


def _swish(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(v)


def expand_dw_pool_plain(x, wexp, kexp, bexp, dwk, kdw, bdw, *,
                         height: int, width: int, kernel: int,
                         out_dtype=torch.bfloat16, dot_dtype=torch.bfloat16):
    """Kernel A's plain version: (y [B, S, Cm] out_dtype, pool [B, Cm]
    float32)."""
    b = x.shape[0]
    cm = dwk.shape[1]
    if wexp is not None:
        h = _rounded(x, dot_dtype) @ _rounded(wexp, dot_dtype)
        h = _swish(h * kexp + bexp)
    else:
        h = x.float()
    # SAME depthwise, stride 1: the taps in (dy, dx) order over zero padding
    r = kernel // 2
    hp = F.pad(h.reshape(b, height, width, cm), (0, 0, r, r, r, r))
    acc = torch.zeros((b, height, width, cm), dtype=torch.float32,
                      device=x.device)
    for t in range(kernel * kernel):
        dy, dx = divmod(t, kernel)
        acc = acc + hp[:, dy:dy + height, dx:dx + width] * dwk[t]
    acc = _swish(acc * kdw + bdw).reshape(b, height * width, cm)
    return acc.to(out_dtype), acc.sum(dim=1)


def scale_project_plain(y, se, wproj, kpr, bpr, res, *,
                        out_dtype=torch.bfloat16, dot_dtype=torch.bfloat16):
    """Kernel B's plain version: out [B, S, C'] in out_dtype."""
    z = y.float() * se[:, None, :]
    o = _rounded(z, dot_dtype) @ _rounded(wproj, dot_dtype)
    o = o * kpr + bpr
    if res is not None:
        o = o + res.float()
    return o.to(out_dtype)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _dot_type(dot_dtype: torch.dtype) -> str:
    return "bf16" if dot_dtype == torch.bfloat16 else "f32"


def expand_dw_pool_work(batch: int, height: int, width: int, c: int, cm: int,
                        kernel: int, *, x_dtype=torch.bfloat16,
                        out_dtype=torch.bfloat16, dot_dtype=torch.bfloat16,
                        expand: bool = True
                        ) -> tuple[dict[str, float], float]:
    """Kernel A's work (see ``ops/roofline.py``): the expand product in
    `dot_dtype` (none without an expand), the depthwise taps in float32;
    x, the constants, y and the float32 pool each moved once."""
    s = batch * height * width
    flops = {"f32": 2.0 * s * cm * kernel * kernel}
    if expand:
        flops[_dot_type(dot_dtype)] = flops.get(_dot_type(dot_dtype), 0.0) \
            + 2.0 * s * c * cm
    consts = (c * cm if expand else 0) + kernel * kernel * cm + 4 * cm
    nbytes = (s * c * _itemsize(x_dtype) + s * cm * _itemsize(out_dtype)
              + 4 * batch * cm + 4 * consts)
    return flops, float(nbytes)


def scale_project_work(batch: int, s: int, cm: int, c2: int, *,
                       residual: bool, y_dtype=torch.bfloat16,
                       out_dtype=torch.bfloat16, dot_dtype=torch.bfloat16
                       ) -> tuple[dict[str, float], float]:
    """Kernel B's work (see ``ops/roofline.py``): the project product in
    `dot_dtype`; y, the SE scale, the constants, the residual and out each
    moved once."""
    rows = batch * s
    flops = {_dot_type(dot_dtype): 2.0 * rows * cm * c2}
    item = _itemsize(out_dtype)
    nbytes = (rows * cm * _itemsize(y_dtype) + 4 * batch * cm
              + 4 * (cm * c2 + 2 * c2) + rows * c2 * item
              + (rows * c2 * _itemsize(y_dtype) if residual else 0))
    return flops, float(nbytes)


def _check_act(name: str, what: str, t: torch.Tensor):
    if t.ndim != 3 or not t.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be a contiguous [B, S, C] tensor "
            f"(channels_last activations), got shape {tuple(t.shape)} and "
            f"strides {t.stride()}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: {what} has dtype {t.dtype}, not float32 "
                         f"or bfloat16")


def _check_const(name: str, what: str, t: torch.Tensor, shape: tuple,
                 device: torch.device):
    if (tuple(t.shape) != shape or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != device):
        raise ValueError(
            f"{name}: {what} must be a contiguous float32 {shape} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_dtypes(name: str, out_dtype, dot_dtype):
    if out_dtype not in _DTYPES or dot_dtype not in _DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype} and dot_dtype "
                         f"{dot_dtype} must be float32 or bfloat16")


def _device_of(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _check_frags(name: str, frags: torch.Tensor, w: torch.Tensor):
    shape = (-(-w.shape[0] // 16), -(-w.shape[1] // 8), 32, 4)
    if (tuple(frags.shape) != shape or frags.dtype != torch.bfloat16
            or not frags.is_contiguous() or frags.device != w.device):
        raise ValueError(f"{name}: packed weights must be pack_fragments' "
                         f"bf16 {shape} on {w.device}, got {frags.dtype} "
                         f"{tuple(frags.shape)} on {frags.device}")


def expand_dw_pool(x, wexp, kexp, bexp, dwk, kdw, bdw, *,
                   height: int, width: int, kernel: int,
                   out_dtype=torch.bfloat16, dot_dtype=torch.bfloat16,
                   wexp_frags=None):
    """Kernel A. x [B, S, C] → (y [B, S, Cm], pool [B, Cm] float32).

    wexp [C, Cm] or None (expand-less blocks, Cm == C); dwk [k·k, Cm]
    tap-major depthwise weights, in (dy, dx) order; kexp/bexp/kdw/bdw
    folded BN [1, Cm]; all float32. `wexp_frags` is
    ``pack_fragments(wexp)``, packed here when not given.
    """
    name = "expand_dw_pool"
    _check_act(name, "x", x)
    _check_dtypes(name, out_dtype, dot_dtype)
    b, s, c = x.shape
    cm = dwk.shape[1] if dwk.ndim == 2 else -1
    if s != height * width or kernel not in _KERNELS:
        raise ValueError(f"{name}: S={s} with {height}x{width}, k={kernel} "
                         f"not taken (k must be 3 or 5)")
    if wexp is None and cm != c:
        raise ValueError(f"{name}: an expand-less block needs Cm == C")
    for what, t, shape in (("wexp", wexp, (c, cm)), ("kexp", kexp, (1, cm)),
                           ("bexp", bexp, (1, cm)),
                           ("dwk", dwk, (kernel * kernel, cm)),
                           ("kdw", kdw, (1, cm)), ("bdw", bdw, (1, cm))):
        if t is not None:
            _check_const(name, what, t, shape, x.device)
    if not _device_of(name, x):
        return expand_dw_pool_plain(
            x, wexp, kexp, bexp, dwk, kdw, bdw, height=height, width=width,
            kernel=kernel, out_dtype=out_dtype, dot_dtype=dot_dtype)

    w = wexp
    if wexp is not None and dot_dtype == torch.bfloat16:
        w = pack_fragments(wexp) if wexp_frags is None else wexp_frags
        _check_frags(name, w, wexp)
    lib = _build.load()
    y = torch.empty((b, s, cm), dtype=out_dtype, device=x.device)
    pool = torch.empty((b, cm), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        # the launcher's band choice, which sizes the per-band pool scratch
        rows = lib.expand_dw_pool_band_rows(b, height, cm, int(w is not None))
        if rows < 1:
            raise RuntimeError(f"{name}: the device's SM count cannot be "
                               f"read")
        n_bands = -(-height // rows)
        part = (torch.empty((b, n_bands, cm), dtype=torch.float32,
                            device=x.device) if n_bands > 1 else pool)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.expand_dw_pool_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            None if w is None else w.data_ptr(), kexp.data_ptr(),
            bexp.data_ptr(), dwk.data_ptr(), kdw.data_ptr(), bdw.data_ptr(),
            y.data_ptr(), int(out_dtype == torch.bfloat16), pool.data_ptr(),
            part.data_ptr(), b, height, width, c, cm, kernel, rows,
            int(dot_dtype == torch.bfloat16), stream)
    # the launcher refuses a width its shared memory cannot hold, or a batch
    # beyond the grid
    _build.check(lib, err, f"{name} [{b}, {height}x{width}, {c}] -> Cm {cm}")
    expand_dw_pool.launches += 1
    return y, pool


expand_dw_pool.launches = 0


def scale_project(y, se, wproj, kpr, bpr, res, *,
                  out_dtype=torch.bfloat16, dot_dtype=torch.bfloat16,
                  wproj_frags=None):
    """Kernel B. y [B, S, Cm] × se [B, Cm] → project → BN → (+res).

    wproj [Cm, C'], kpr/bpr [1, C'], se float32; res is the block input
    [B, S, C'] for identity-residual blocks, or None. `wproj_frags` is
    ``pack_fragments(wproj)``, packed here when not given.
    """
    name = "scale_project"
    _check_act(name, "y", y)
    _check_dtypes(name, out_dtype, dot_dtype)
    b, s, cm = y.shape
    c2 = wproj.shape[1] if wproj.ndim == 2 else -1
    for what, t, shape in (("se", se, (b, cm)), ("wproj", wproj, (cm, c2)),
                           ("kpr", kpr, (1, c2)), ("bpr", bpr, (1, c2))):
        _check_const(name, what, t, shape, y.device)
    if res is not None:
        _check_act(name, "res", res)
        if tuple(res.shape) != (b, s, c2) or res.device != y.device:
            raise ValueError(f"{name}: res {tuple(res.shape)} on "
                             f"{res.device} does not match out {(b, s, c2)}")
    if not _device_of(name, y):
        return scale_project_plain(y, se, wproj, kpr, bpr, res,
                                   out_dtype=out_dtype, dot_dtype=dot_dtype)

    w = wproj
    if dot_dtype == torch.bfloat16:
        w = pack_fragments(wproj) if wproj_frags is None else wproj_frags
        _check_frags(name, w, wproj)
    lib = _build.load()
    out = torch.empty((b, s, c2), dtype=out_dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scale_project_launch(
            y.data_ptr(), int(y.dtype == torch.bfloat16), se.data_ptr(),
            w.data_ptr(), kpr.data_ptr(), bpr.data_ptr(),
            None if res is None else res.data_ptr(),
            int(res is not None and res.dtype == torch.bfloat16),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, s, cm, c2,
            int(dot_dtype == torch.bfloat16), stream)
    _build.check(lib, err, f"{name} [{b}, {s}, {cm}] -> C' {c2}")
    scale_project.launches += 1
    return out


scale_project.launches = 0


def _fold_consts(block: MBConv, kernel: int) -> tuple:
    """The block's constant operands in the kernels' layouts: (wexp, kexp,
    bexp, dwk, kdw, bdw, wproj, kpr, bpr), all float32, then wexp and wproj
    packed for bf16 operands (``pack_fragments``; None without an
    expand)."""
    cm = block.dw.w.shape[0]
    # (Cm, 1, k, k) → tap-major [k·k, Cm]
    dwk = block.dw.w.reshape(cm, kernel * kernel).t().contiguous()
    kdw, bdw = fold_bn(block.dw_bn)
    if block.expand_conv is not None:
        wexp = block.expand_conv.w[:, :, 0, 0].t().contiguous()    # [C, Cm]
        kexp, bexp = fold_bn(block.expand_bn)
    else:
        # no expand stage: the kernel skips the matmul and its BN
        wexp, kexp, bexp = None, torch.ones_like(kdw), torch.zeros_like(bdw)
    wproj = block.project_conv.w[:, :, 0, 0].t().contiguous()      # [Cm, C']
    kpr, bpr = fold_bn(block.project_bn)
    wexp_frags = None if wexp is None else pack_fragments(wexp)
    return (wexp, kexp, bexp, dwk, kdw, bdw, wproj, kpr, bpr, wexp_frags,
            pack_fragments(wproj))


def _block_consts(block: MBConv, kernel: int) -> tuple:
    """`_fold_consts`, folded once and kept on the block.

    The key is the address and version of every parameter they come from,
    so they are folded again after a move to another device or an
    in-place write (``load_state_dict``), and at no other call. They are
    made outside inference mode, so a later call outside it may use them.
    Parameters made in inference mode keep no version: they are folded on
    every call.
    """
    params = [p for m in (block.expand_conv, block.expand_bn, block.dw,
                          block.dw_bn, block.project_conv, block.project_bn)
              if m is not None for p in m.parameters()]
    if any(p.is_inference() for p in params):
        return _fold_consts(block, kernel)
    key = (kernel, tuple((p.data_ptr(), p._version) for p in params))
    cached = getattr(block, "_fused_consts", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.inference_mode(False), torch.no_grad():
        consts = _fold_consts(block, kernel)
    block._fused_consts = (key, consts)
    return consts


def mbconv_fused(block: MBConv, x: torch.Tensor, *, kernel: int,
                 compute_dtype=torch.bfloat16, dot_dtype=torch.bfloat16
                 ) -> torch.Tensor:
    """Drop-in for ``block(x)`` on a stride-1 inference block, through the
    two kernels. x and the result are NCHW [B, C, H, W] in channels_last
    memory, so [B, H·W, C] is a view of each.

    `dot_dtype` stays bfloat16 for a float32 model, as in the JAX package,
    whose backbone never passes it.
    """
    bsz, cin, height, width = x.shape
    s = height * width
    xf = x.permute(0, 2, 3, 1).view(bsz, s, cin)
    (wexp, kexp, bexp, dwk, kdw, bdw, wproj, kpr, bpr, wexp_frags,
     wproj_frags) = _block_consts(block, kernel)
    cm, cout = wproj.shape

    y, pool = expand_dw_pool(
        xf, wexp, kexp, bexp, dwk, kdw, bdw, height=height, width=width,
        kernel=kernel, out_dtype=compute_dtype, dot_dtype=dot_dtype,
        wexp_frags=wexp_frags)

    # SE mid on the mean of the float32 pool, as the JAX glue
    if block.se is not None:
        pooled = (pool / float(s)).to(compute_dtype)
        mid = F.silu(block.se.reduce(pooled, compute_dtype))
        sev = torch.sigmoid(block.se.expand(mid, compute_dtype)).float()
    else:
        sev = torch.ones((bsz, cm), dtype=torch.float32, device=x.device)

    res = xf if cin == cout else None
    out = scale_project(y, sev, wproj, kpr, bpr, res,
                        out_dtype=compute_dtype, dot_dtype=dot_dtype,
                        wproj_frags=wproj_frags)
    return out.view(bsz, height, width, cout).permute(0, 3, 1, 2)
