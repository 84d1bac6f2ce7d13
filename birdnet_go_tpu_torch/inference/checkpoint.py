"""Parameter persistence in the port's own format (the counterpart of
``birdnet_go_tpu/inference/checkpoint.py``, which writes orbax).

A checkpoint is a directory holding ``params.npz``: one float32 array per
entry of the module's state dict, under its name (``backbone.blocks.3.dw.w``)
and in the port's layout (conv OIHW, dense [out, in]). It is written with
``np.savez`` and read with ``allow_pickle=False``: no pickle either way.
Orbax's OCDBT layout needs orbax and tensorstore, which the card's machine
lacks.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch
from torch import nn

PARAMS_FILE = "params.npz"


def has_params(path: str | Path) -> bool:
    """True when `path` is a checkpoint directory of this format."""
    return (Path(path) / PARAMS_FILE).is_file()


def save_params(module: nn.Module, path: str | Path) -> Path:
    """Write `module`'s state to ``<path>/params.npz``; whatever the
    directory held before is replaced, as orbax's ``force=True`` does."""
    path = Path(path)
    if path.is_dir():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    arrays = {k: v.detach().to("cpu", torch.float32).numpy()
              for k, v in module.state_dict().items()}
    np.savez(path / PARAMS_FILE, **arrays)
    return path / PARAMS_FILE


def read_params(path: str | Path) -> dict[str, torch.Tensor]:
    """The state dict stored under `path`, float32 on the CPU."""
    with np.load(Path(path) / PARAMS_FILE, allow_pickle=False) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def load_params(path: str | Path, like: nn.Module) -> nn.Module:
    """Load the checkpoint under `path` into `like`, strictly: every key
    and shape must match. Returns `like`."""
    like.load_state_dict(read_params(path), strict=True)
    return like
