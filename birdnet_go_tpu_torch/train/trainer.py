"""Training step for classifier models, multi-label sigmoid objective (port
of ``birdnet_go_tpu/train/trainer.py``).

Bioacoustic classifiers are multi-label (overlapping vocalizations), trained
with per-species sigmoid binary cross-entropy. The optimizer is AdamW with
``optax.adamw``'s defaults, over one group that holds every parameter of the
module, BN statistics included: they are leaves of the JAX parameter tree,
so optax updates and decays them too. A module holds its own parameters,
so the state is the module, its optimizer and the step count, and a step
updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

# optax.adamw's defaults; torch's own weight decay default (1e-2) differs
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def multilabel_loss(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy over [B, S] logits/labels."""
    return F.binary_cross_entropy_with_logits(logits, labels)


def init_train_state(module: nn.Module, learning_rate: float = 1e-3
                     ) -> TrainState:
    """Every parameter of `module` made trainable, under one AdamW."""
    module.requires_grad_(True)
    optimizer = torch.optim.AdamW(
        list(module.parameters()), lr=learning_rate, betas=BETAS, eps=EPS,
        weight_decay=WEIGHT_DECAY)
    return TrainState(module, optimizer)


def make_train_step(apply_fn: Callable, train: bool = True) -> Callable:
    """Build train_step(state, pcm, labels) -> (state, metrics).

    `apply_fn(pcm, train)` must return {"logits": [B, S], ...}. Metrics
    are scalar tensors on the step's device: the loss, the global norm of
    every parameter's gradient and the mean sigmoid confidence.
    """

    def train_step(state: TrainState, pcm: torch.Tensor,
                   labels: torch.Tensor):
        logits = apply_fn(pcm, train)["logits"]
        loss = multilabel_loss(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        for p in params:
            # BN statistics are unused with batch statistics: optax sees a
            # zero gradient and still decays them, AdamW would skip them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        state.optimizer.step()
        state.step += 1
        logits = logits.detach()
        return state, {"loss": loss.detach(), "grad_norm": grad_norm,
                       "mean_confidence": torch.sigmoid(logits).mean()}

    return train_step


def make_eval_step(apply_fn: Callable) -> Callable:
    """eval_step(pcm, labels) -> {"accuracy", "loss"}: top-1 accuracy (the
    first maximum of each row) and the mean multilabel loss over a
    batch, with BN on its stored statistics."""

    def eval_step(pcm: torch.Tensor, labels: torch.Tensor):
        with torch.no_grad():
            out = apply_fn(pcm, False)
            logits = out["logits"] if isinstance(out, dict) else out
            top1 = logits.argmax(-1) == labels.argmax(-1)
            return {"accuracy": top1.float().mean(),
                    "loss": multilabel_loss(logits, labels)}

    return eval_step


def evaluate(eval_step: Callable, dataset, batch_size: int = 64,
             device: torch.device | str = "cpu") -> dict[str, float]:
    """Run eval_step over every full batch of a WindowDataset."""
    accs, losses, n = [], [], 0
    for pcm, labels in dataset.batches(batch_size, epochs=1):
        m = eval_step(torch.from_numpy(pcm).to(device),
                      torch.from_numpy(labels).to(device))
        accs.append(float(m["accuracy"]) * len(pcm))
        losses.append(float(m["loss"]) * len(pcm))
        n += len(pcm)
    if n == 0:
        return {"accuracy": float("nan"), "loss": float("nan"), "n": 0}
    return {"accuracy": sum(accs) / n, "loss": sum(losses) / n, "n": n}
