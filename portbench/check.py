"""The comparison that decides ``correct``: the program's top-10 of each
sampled window against the plain reference's confidences of the same
window.

- ``conf_p75``: the 75th percentile over the windows of each window's
  mean gap, over its ten ranks, between a confidence the program served
  and the reference's confidence of the same species in the same window.
- ``rank_gap_p75``: the 75th percentile over the windows of the widest
  amount by which the species the program put at a rank j scores, in the
  reference, below the reference's own j-th best. Where two species
  nearly tie, either order reads near 0.

The widest, the mean and the 50th and 90th percentiles of each are
printed beside them and not compared: with seeded random weights the
network carries a bfloat16 rounding from block to block and grows it
(0.4% after the stem, 15% of the embedding after sixteen blocks, on the
CPU at full width), so the worst windows of a run land in that tail and
swing from seed to seed, close to what a lower precision reads there
(``PERF.md`` gives the readings). The 75th percentile leaves that tail out
and still fails a fault that reaches a quarter of the windows (every
other answer left out: ``tests/test_portbench_control.py``).

Both are in confidence units (sigmoid of the logit, times the range
mask). A lower precision in one stage, which this tail can hide, is read
stage by stage (``stages.py``). The limits live in each cell's file, set
from the program's and the controls' readings (``PERF.md``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref


def reference_confidences(pcm: np.ndarray | torch.Tensor, params: dict,
                          cfg: dict, mask, device: torch.device,
                          precision: str = "float32", block: int = 64,
                          sensitivity: float = 1.0) -> np.ndarray:
    """Confidences [N, S] of float32 PCM rows [N, clip], in blocks."""
    out = []
    with torch.no_grad():
        for i in range(0, len(pcm), block):
            x = torch.as_tensor(np.asarray(pcm[i:i + block], np.float32)
                                if not torch.is_tensor(pcm)
                                else pcm[i:i + block]).to(device)
            out.append(ref.confidences(x, params, cfg, mask, sensitivity,
                                       precision=precision).cpu().numpy())
    return (np.concatenate(out) if out
            else np.zeros((0, cfg["net"]["num_classes"]), np.float32))


def compare(vals: np.ndarray, idx: np.ndarray, conf: np.ndarray
            ) -> dict[str, float]:
    """`vals`, `idx` [N, k]: what was served; `conf` [N, S]: the
    reference's confidences of the same windows."""
    if len(vals) == 0:
        return dict.fromkeys(("conf_err", "rank_gap", "conf_mae",
                              "rank_gap_mean", "conf_p50", "conf_p75",
                              "conf_p90", "rank_gap_p50", "rank_gap_p75",
                              "rank_gap_p90"), float("inf"))
    k = vals.shape[1]
    picked = np.take_along_axis(conf, idx.astype(np.int64), axis=1)
    best = -np.sort(-conf, axis=1)[:, :k]
    err = np.abs(vals - picked)
    gap = np.maximum(best - picked, 0.0).max(axis=1)
    return {"conf_err": float(err.max()), "rank_gap": float(gap.max()),
            "conf_mae": float(err.mean()), "rank_gap_mean": float(gap.mean()),
            **{f"conf_p{q}": float(np.percentile(err.mean(axis=1), q))
               for q in (50, 75, 90)},
            **{f"rank_gap_p{q}": float(np.percentile(gap, q))
               for q in (50, 75, 90)}}


def served_topk(conf: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(values, indices) of the k best confidences, as a step serves them;
    the control's answers."""
    idx = np.argsort(-conf, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(conf, idx, axis=1), idx
