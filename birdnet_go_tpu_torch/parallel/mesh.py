"""Mesh construction and parameter sharding rules (port of
``birdnet_go_tpu/parallel/mesh.py``).

A ``Mesh`` is a [data, model] array of ``torch.device``. A device may
appear more than once: torch has no virtual devices, so the CPU tests and a
one-card host build meshes that list one device several times.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch



class Mesh:
    """A ("data", "model") grid of torch devices."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be 2-D, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def _visible() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, data_axis: int | None = None,
              model_axis: int | None = None,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A ("data", "model") mesh over the first `n_devices` of `devices`
    (default: every visible card, ``cuda:0`` to ``cuda:{count - 1}``).

    Default split, as JAX's: the model axis is 2 when the count is even,
    else 1 (heads are small; most capacity goes to the stream axis).
    Raises ValueError for more devices than there are, or a split that
    does not cover them."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _visible())
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} visible")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("requested a mesh, only 0 devices visible")
    if model_axis is None:
        model_axis = 2 if n % 2 == 0 and n >= 2 else 1
    if data_axis is None:
        data_axis = n // model_axis
    if data_axis * model_axis != n:
        raise ValueError(f"mesh {data_axis}x{model_axis} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data_axis, model_axis))


def _is_head(name: str) -> bool:
    """The classifier head: a name containing "classifier", or the bat
    family's regional ``head.w`` / ``head.b``."""
    return "classifier" in name or name.split(".")[-2:-1] == ["head"]


def _spec_for_param(name: str, t: torch.Tensor) -> tuple:
    """A tensor's placement, as JAX's PartitionSpec: the mesh axis of each
    of its dims, () for replicated. Head tensors are split over the species
    axis, dim 0 of the port's [out, in] weight (JAX splits dim 1 of [in,
    out]) and the bias's only dim; everything else is replicated: at these
    sizes replication beats the traffic sharding would add."""
    if _is_head(name):
        if t.ndim == 2:
            return ("model", None)
        if t.ndim == 1:
            return ("model",)
    return ()


def param_pspec_tree(state: Mapping[str, torch.Tensor]) -> dict[str, tuple]:
    """{state-dict name: spec}: head → split over "model", rest
    replicated."""
    return {k: _spec_for_param(k, v) for k, v in state.items()}


def shard_params(state: Mapping[str, torch.Tensor], mesh: Mesh
                 ) -> dict[str, np.ndarray]:
    """Place each tensor of a state dict on the mesh by its spec: {name:
    [data, model] array of the tensor each device holds}. A split tensor's
    piece j (``tensor_split`` over dim 0) lies on the devices of model
    column j; a device listed more than once holds one copy of each piece."""
    specs = param_pspec_tree(state)
    d, m = mesh.devices.shape
    out = {}
    for name, t in state.items():
        split = bool(specs[name])
        pieces = t.detach().tensor_split(m) if split else [t.detach()]
        placed: dict[tuple[int, torch.device], torch.Tensor] = {}
        grid = np.empty((d, m), dtype=object)
        for r in range(d):
            for j in range(m):
                dev = mesh.devices[r, j]
                key = (j if split else 0, dev)
                if key not in placed:
                    placed[key] = pieces[key[0]].to(dev)
                grid[r, j] = placed[key]
        out[name] = grid
    return out
