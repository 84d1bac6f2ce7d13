"""Small settings for CPU runs of the cells: a two-stage float32 net beside
the published mel front ends, a few streams, batches of 16. In float32 the
program agrees with the reference to rounding, so the limits sit far below
what the int8 control and a broken step read."""

from __future__ import annotations

import torch

TINY_NET = {"blocks": [[1, 8, 3, 1, 1], [6, 16, 3, 2, 1]],
            "stem_channels": 8, "embedding_dim": 32, "num_classes": 64,
            "se_ratio": 0.25, "compute_dtype": "float32",
            "dense_dtype": "float32"}
TINY_LIMITS = {"conf_p75": 1e-3, "rank_gap_p75": 1e-3, "mel_err": 1e-3,
               "net_err": 1e-3, "min_compared": 8, "min_stage_rows": 4}
SEED = 2 ** 31 + 12345            # larger than 32 signed bits hold


def params_for(cell: str) -> dict:
    if cell.endswith("offline"):
        return {"recordings": 2, "recording_seconds": 30,
                "sample_windows": 8, "stage_every": 1, "stage_rows": 4}
    live = "live" in cell
    return {"streams": 64 if live else 16, "timescale": 1.0 if live else 4.0,
            "max_batch": 16, "calibration_windows": 64,
            "preroll_seconds": 0.5, "sample_every": 1,
            "sample_max": 32, "range_share": 0.5, "stage_every": 1,
            "drain_seconds": 0.5}


def run_tiny(cell: str, trace: bool = False, seconds: float = 3.0,
             root=None, control: bool = False, seed: int = SEED):
    from portbench import run

    return run.run_cell(cell, seed, seconds, trace,
                        device=torch.device("cpu"), root=root,
                        cfg_override={"net": TINY_NET},
                        params_override=params_for(cell),
                        limits_override=TINY_LIMITS, control=control)
