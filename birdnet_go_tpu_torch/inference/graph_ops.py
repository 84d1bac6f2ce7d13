"""What the port's two graph executors (``tflite_import``, ``onnx_import``)
share: the values of one run, numpy dtypes as torch dtypes, and the ops
whose torch form differs from the JAX one (TF-SAME padding, slices with
negative steps, gathers, mirror padding, pools that divide by the count of
valid inputs, resizing)."""

from __future__ import annotations

import functools
from typing import Any, Callable, Hashable

import numpy as np
import torch
import torch.nn.functional as F


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype; float64 is float32, as in JAX
    without x64."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return torch.float32
    return torch.from_numpy(np.empty(0, dtype)).dtype


def device_array(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device` (a copy; float64 → float32)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)


class Values:
    """The tensors of one graph run, by key (a TFLite tensor index or an
    ONNX value name): what the ops produced, else the graph's constants as
    device buffers. An op may produce a host (numpy) value, as a shape or a
    range; it goes to the device when an op reads it as a tensor, and
    `host` reads it where it lies."""

    def __init__(self, device: torch.device,
                 buffer: Callable[[Hashable], torch.Tensor | None],
                 const: Callable[[Hashable], np.ndarray | None],
                 undefined: Callable[[Hashable], str]):
        self.device = device
        self.env: dict[Hashable, Any] = {}
        self._buffer = buffer
        self._const = const
        self._undefined = undefined

    def __call__(self, key: Hashable) -> torch.Tensor:
        v = self.env.get(key)
        if v is None:
            v = self._buffer(key)
            if v is None:
                raise KeyError(self._undefined(key))
        elif isinstance(v, np.ndarray):
            v = self.env[key] = device_array(v, self.device)
        return v

    def host(self, key: Hashable) -> np.ndarray:
        """The value as host numpy: a graph constant or a host value as it
        is, a device tensor copied back."""
        c = self._const(key)
        if c is not None:
            return np.asarray(c)
        v = self.env.get(key)
        if isinstance(v, np.ndarray):
            return v
        return self(key).cpu().numpy()


def same_pads(size: int, k: int, stride: int, dilation: int = 1
              ) -> tuple[int, int]:
    """TF/XLA SAME padding of one dimension: (low, high), the odd one on
    the high side."""
    eff = (k - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def pad(x: torch.Tensor, pads: list[tuple[int, int]],
        value: float = 0.0) -> torch.Tensor:
    """``F.pad`` of the last ``len(pads)`` dimensions by (low, high) each,
    first to last; x itself where every pad is 0."""
    flat = [int(p) for lo, hi in reversed(pads) for p in (lo, hi)]
    return F.pad(x, flat, value=value) if any(flat) else x


def slice_axes(x: torch.Tensor, slices: dict[int, slice | int]
               ) -> torch.Tensor:
    """``x[...]`` with a slice or an index on some dimensions, as numpy
    takes it: a slice with a negative step reads a flipped view, which
    torch's indexing does not take."""
    idx: list[slice | int] = [slice(None)] * x.ndim
    flips = []
    for d, s in slices.items():
        if not isinstance(s, slice):
            idx[d] = s
            continue
        n = x.shape[d]
        start, stop, step = s.indices(n)
        if step > 0:
            idx[d] = slice(start, stop, step)
            continue
        count = len(range(start, stop, step))
        flips.append(d)
        first = n - 1 - start
        idx[d] = (slice(first, first + (count - 1) * -step + 1, -step)
                  if count else slice(0, 0))
    if flips:
        x = x.flip(flips)
    return x[tuple(idx)]


def take(x: torch.Tensor, indices: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take(x, indices, axis)``: negative indices count from the
    end."""
    axis %= x.ndim
    idx = indices.to(torch.long)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def mirror_pad(x: torch.Tensor, pads: list[tuple[int, int]],
               symmetric: bool) -> torch.Tensor:
    """``np.pad`` in "reflect" (the border sample not repeated) or
    "symmetric" mode, over any dimensions."""
    off = 0 if symmetric else 1
    for d, (lo, hi) in enumerate(pads):
        parts = []
        if lo:
            parts.append(x.narrow(d, off, lo).flip(d))
        parts.append(x)
        if hi:
            parts.append(x.narrow(d, x.shape[d] - hi - off, hi).flip(d))
        if len(parts) > 1:
            x = torch.cat(parts, d)
    return x


def pool(x: torch.Tensor, kind: str, kernel: tuple[int, ...],
         strides: tuple[int, ...], pads: list[tuple[int, int]]
         ) -> torch.Tensor:
    """Max or average pool of x [N, C, *spatial] (1 to 3 spatial dims)
    with explicit (low, high) pads: a max pool pads with -inf, an average
    pool divides each window's sum by its count of valid inputs, as
    ``reduce_window`` over the padded input does in the JAX importers."""
    one_d = len(kernel) == 1
    if one_d:
        x = x.unsqueeze(-2)
        kernel, strides, pads = (1,) + kernel, (1,) + strides, [(0, 0)] + pads
    three_d = len(kernel) == 3
    if kind == "max":
        fn = F.max_pool3d if three_d else F.max_pool2d
        y = fn(pad(x, pads, float("-inf")), kernel, strides)
    else:
        fn = F.avg_pool3d if three_d else F.avg_pool2d
        total = fn(pad(x, pads), kernel, strides, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        count = fn(pad(ones, pads), kernel, strides, divisor_override=1)
        y = total / count
    return y.squeeze(-2) if one_d else y


def reduce(kind: str, x: torch.Tensor, axes: tuple[int, ...],
            keep: bool) -> torch.Tensor:
    """jnp's sum, max, min, mean or prod over `axes` (none: x
    unchanged)."""
    if not axes:
        return x
    if kind == "sum":
        return torch.sum(x, dim=axes, keepdim=keep)
    if kind == "max":
        return torch.amax(x, dim=axes, keepdim=keep)
    if kind == "min":
        return torch.amin(x, dim=axes, keepdim=keep)
    if kind == "mean":
        if not x.is_floating_point():
            x = x.to(torch.float32)
        return torch.mean(x, dim=axes, keepdim=keep)
    for a in sorted(axes, reverse=True):           # prod
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


def _linear_weights(m: int, n: int) -> np.ndarray:
    """``jax.image``'s weight matrix [m, n] that resizes an axis of `m`
    samples to `n` linearly: the triangle kernel at half-pixel centres,
    widened by the shrink factor when the axis shrinks (JAX's antialias,
    in any number of dimensions), each output column normalised, columns
    whose centre falls outside the input zero. Built in float64."""
    inv = m / n if n else 1.0
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(n, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(m, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0.0)


@functools.lru_cache(maxsize=256)
def _resize_operand(m: int, n: int, linear: bool, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """What ``resize`` applies to an axis of `m` samples resized to `n`,
    on `device`: the linear weights [m, n] in `dtype`, or the nearest
    indices [n] (JAX's float32 half-pixel offsets). Built on the host once
    for each shape, so a served graph's steps copy nothing to the card."""
    if linear:
        w = torch.from_numpy(_linear_weights(m, n))
        return w.to(device=device, dtype=dtype)
    at = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                  * np.float32(m) / np.float32(n)).astype(np.int64)
    return torch.from_numpy(at).to(device)


def resize(x: torch.Tensor, shape, linear: bool) -> torch.Tensor:
    """``jax.image.resize`` of x to `shape`, every axis whose size
    changes, batch and channel axes included: nearest at half-pixel
    centres, or linear through JAX's scale-and-translate weights
    (``_linear_weights``), one product per axis, which antialiases a
    shrink in 1-D and 3-D as in 2-D (where ``F.interpolate`` antialiases
    only bilinear and bicubic). Each axis's operand comes from
    ``_resize_operand``'s cache."""
    shape = [int(s) for s in shape]
    if len(shape) != x.dim():
        raise ValueError(f"resize to {shape}: {x.dim()} axes in "
                         f"{tuple(x.shape)}")
    axes = [d for d, (m, n) in enumerate(zip(x.shape, shape)) if m != n]
    if linear and not x.is_floating_point():
        x = x.to(torch.float32)
    for d in axes:
        op = _resize_operand(x.shape[d], shape[d], linear, x.device,
                             x.dtype if linear else torch.int64)
        x = (torch.tensordot(x, op, dims=([d], [0])).movedim(-1, d)
             if linear else x.index_select(d, op))
    return x
