"""Full float32 for cuDNN convolutions and cuBLAS products.

PyTorch lets cuDNN run float32 convolutions on TF32 by default, and a
caller may allow it for matrix products too
(``torch.backends.cuda.matmul.allow_tf32``). The JAX package computes the
graphs and filters the port mirrors in float32 (``Precision.HIGHEST``), so
the ops that must agree with it to float32 rounding run inside
``full_float32()``.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# both flags are process-wide: one holder at a time turns them off and
# restores them, so that no thread's restore lands while another's
# convolution or product is still being dispatched
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and cuBLAS products without TF32 for the body's
    dispatches; holds `_TF32_LOCK` from the flags' change to their
    restore."""
    with _TF32_LOCK:
        conv = torch.backends.cudnn.allow_tf32
        mm = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = conv
            torch.backends.cuda.matmul.allow_tf32 = mm
