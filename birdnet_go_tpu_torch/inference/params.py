"""Parameter bridge: the JAX package's parameter pytree → the port's state.

The tree must already hold numpy arrays (``jax.tree.map(np.asarray, p)``
on the JAX side); this module never imports JAX. Layouts:
conv HWIO → OIHW, depthwise (k, k, 1, C) → (C, 1, k, k) (the same
transpose), dense [in, out] → [out, in], BN vectors as they are.
``quant_from_jax`` carries the JAX package's int8 tree
(``ops/quant.py::quantize_efficientnet``) the same way, int8 codes kept
int8.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from birdnet_go_tpu_torch.models.efficientnet import EfficientNet
from birdnet_go_tpu_torch.ops.quant import QuantizedEfficientNet


def _flatten(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:                      # HWIO → OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:                      # [in, out] → [out, in]
        return a.T
    return a


def params_from_jax(tree: Any) -> dict[str, torch.Tensor]:
    """Nested dicts/lists of numpy arrays → a float32 state dict whose keys
    are the pytree paths joined by dots (``blocks.3.dw.w``)."""
    # a copy: the arrays of a JAX tree are read-only, and torch warns
    return {k: torch.from_numpy(np.array(_to_torch_layout(v),
                                         dtype=np.float32, order="C"))
            for k, v in _flatten(tree)}


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX parameter pytree into `module`; every key must match."""
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module


def quant_from_jax(qtree: Any, template: EfficientNet
                   ) -> QuantizedEfficientNet:
    """The JAX package's quantized tree (numpy leaves: ``w_q`` int8 HWIO,
    ``w_scale``, ``bias``, ``act_scales``, the float32 stem, SE and
    classifier) → the port's ``QuantizedEfficientNet`` on the CPU.
    `template` gives the block structure (strides are not in the tree);
    every key must match."""
    tree = dict(qtree)
    scales = {k: float(np.float32(v))
              for k, v in tree.pop("act_scales").items()}
    state = {k: torch.from_numpy(np.array(
                 _to_torch_layout(v),
                 dtype=np.int8 if v.dtype == np.int8 else np.float32,
                 order="C"))
             for k, v in _flatten(tree)}
    q = QuantizedEfficientNet(template, scales)
    q.load_state_dict(state, strict=True)
    return q
