"""Mesh-sharded serving (port of ``birdnet_go_tpu/parallel/serving.py``).

One process drives the mesh. A batch is padded to a multiple of the data
axis and scattered over it: data row r runs the backbone once, on its first
device, and sends the head's input to each device of its row, which
computes its slice of the species axis; the logits are gathered on the
mesh's first device. Copies between devices are ``non_blocking``; kernels
on different cards overlap because each launch returns at once.

``ShardedClassifier`` looks like ``TorchClassifier`` (``model``, ``device``,
``predict_topk``, ``set_range_mask``), and its ``model`` has ``spec``,
``num_species``, ``apply`` and ``apply_int16``, so ``TorchModelBatcher``
serves it unchanged, as the JAX ``ModelBatcher`` serves the JAX
``ShardedClassifier``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from birdnet_go_tpu_torch.models import layers as L
from birdnet_go_tpu_torch.ops.pcm import pcm16_to_float32
from birdnet_go_tpu_torch.ops.postprocess import (
    sigmoid_confidence,
    top_k_results,
)
from birdnet_go_tpu_torch.parallel.mesh import (
    Mesh,
    _is_head,
    make_mesh,
    shard_params,
)


class _HeadInput(nn.Module):
    """Stands in for a head in a replica: returns the head's input, so
    the replica's "logits" are what the head would have read."""

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        return x


def _served_head(model: nn.Module) -> str | None:
    """The name of the dense layer that produces the served logits: the
    bat family's regional ``head``, else the backbone's ``classifier``;
    None for a model without one (an imported graph)."""
    for name in ("head", "backbone.classifier"):
        try:
            if isinstance(model.get_submodule(name), L.Dense):
                return name
        except AttributeError:
            pass
    return None


class ShardedModel:
    """`model` over a mesh: one replica of everything but the head on each
    distinct device of the data axis, the head split over the model
    axis. The replicas are copies made here, so serving options such as
    ``act_int8`` are set on `model` before it is wrapped, as the JAX app
    applies them before it builds its ``ShardedClassifier``."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.spec = model.spec
        self.num_species = model.num_species
        self.head_name = _served_head(model)
        # every head of the model stays out of the replicas (the bat
        # family's unused backbone classifier too): each would compute its
        # whole species axis there
        trunk = copy.deepcopy(model).eval()
        heads = [n for n, m in trunk.named_modules()
                 if isinstance(m, L.Dense) and _is_head(f"{n}.w")]
        for name in heads:
            parent, _, leaf = name.rpartition(".")
            setattr(trunk.get_submodule(parent) if parent else trunk, leaf,
                    _HeadInput())
        self.replicas = {}
        for dev in mesh.devices[:, 0]:
            if dev not in self.replicas:
                self.replicas[dev] = copy.deepcopy(trunk).to(dev)
        self.head_shards = None
        self.heads = None
        if self.head_name is not None:
            self.compute_dtype = model.compute_dtype
            head = model.get_submodule(self.head_name)
            self.head_shards = shard_params(
                {f"{self.head_name}.{k}": v
                 for k, v in head.state_dict().items()}, mesh)
            w = self.head_shards[f"{self.head_name}.w"]
            b = self.head_shards.get(f"{self.head_name}.b")
            self.heads = np.empty(w.shape, dtype=object)
            for r, j in np.ndindex(w.shape):
                self.heads[r, j] = self._dense(w[r, j],
                                               None if b is None else b[r, j])

    @staticmethod
    def _dense(w: torch.Tensor, b: torch.Tensor | None) -> L.Dense:
        d = L.Dense(w.shape[1], w.shape[0], bias=b is not None)
        d.w = nn.Parameter(w, requires_grad=False)
        if b is not None:
            d.b = nn.Parameter(b, requires_grad=False)
        return d

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0, 0]

    def _run(self, x: torch.Tensor, int16: bool) -> dict[str, torch.Tensor]:
        b = x.shape[0]
        d, m = self.mesh.devices.shape
        rem = (-b) % d
        if rem:
            x = torch.cat([x, x.new_zeros((rem, *x.shape[1:]))])
        first = self.device
        logits, embs = [], []
        for r, xr in enumerate(x.chunk(d)):
            dev = self.mesh.devices[r, 0]
            rep = self.replicas[dev]
            xr = xr.to(dev, non_blocking=True)
            if int16 and hasattr(rep, "apply_int16"):
                out = rep.apply_int16(xr)
            else:
                # an imported graph takes the float32 PCM, as in the
                # batcher's step
                out = rep.apply(pcm16_to_float32(xr) if int16 else xr)
            h = out["logits"]
            if self.heads is None:
                parts = [h.to(first, non_blocking=True)]
            else:
                parts = []
                for j in range(m):
                    dj = self.mesh.devices[r, j]
                    y = self.heads[r, j](h.to(dj, non_blocking=True),
                                         self.compute_dtype)
                    parts.append(y.to(first, non_blocking=True))
            logits.append(torch.cat(parts, dim=1))
            embs.append(out["embedding"].to(first, non_blocking=True))
        return {"logits": torch.cat(logits)[:b].to(torch.float32),
                "embedding": torch.cat(embs)[:b]}

    def apply(self, pcm: torch.Tensor) -> dict[str, torch.Tensor]:
        """float32 PCM [B, T] → {"logits", "embedding"} on the first
        device."""
        return self._run(pcm, int16=False)

    def apply_int16(self, pcm_i16: torch.Tensor) -> dict[str, torch.Tensor]:
        """int16 PCM [B, T] step: each replica's own int16 path (the mel
        kernel on a card)."""
        return self._run(pcm_i16, int16=True)


class ShardedClassifier:
    """Drop-in for ``TorchClassifier`` with a mesh-sharded model: the mesh
    from ``make_mesh()`` (every visible card) unless one is given."""

    def __init__(self, model: nn.Module, mesh: Mesh | None = None,
                 range_mask: np.ndarray | None = None):
        self.mesh = mesh or make_mesh()
        self.model = ShardedModel(model, self.mesh)
        self.device = self.model.device
        self.model_id = model.spec.model_id
        self.num_species = model.num_species
        self.set_range_mask(range_mask)

    def set_range_mask(self, mask: np.ndarray | None) -> None:
        self._range_mask = (torch.as_tensor(np.asarray(mask, np.float32),
                                            device=self.device)
                            if mask is not None else None)

    def predict_topk(self, pcm: np.ndarray | torch.Tensor,
                     sensitivity: float = 1.0,
                     k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """float32 PCM [B, clip_samples] → (confidences [B, k], indices
        [B, k] int32); a ragged batch is padded to a multiple of the data
        axis and the padding dropped."""
        k = min(k, self.num_species)
        with torch.inference_mode():
            x = torch.as_tensor(pcm, dtype=torch.float32, device=self.device)
            conf = sigmoid_confidence(self.model.apply(x)["logits"],
                                      sensitivity)
            if self._range_mask is not None:
                conf = conf * self._range_mask
            vals, idx = top_k_results(conf, k)
            return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()
