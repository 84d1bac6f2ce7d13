"""The comparison fails what it must: each control (the reference in the
program's place with int8 or float8 operands in the backbone, with a TF32
or bfloat16 mel front end), and the timed path broken underneath a run
(half of a batch's answers left out, every other one; an answer altered
where it is produced). At a small size on the CPU; the controls' readings
at the cells' own size are in ``PERF.md``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests.tiny import TINY_LIMITS, run_tiny

# what each control has to fail, at the least
FAILS = {"int8": ("conf_p75", "rank_gap_p75", "net_err"),
         "fp8": ("net_err",), "tf32": ("mel_err",), "bf16": ("mel_err",)}


@pytest.mark.parametrize("cell", ["v24_backlog", "v24_offline"])
def test_control_reads_far_above_the_program(cell):
    result, checks, rec = run_tiny(cell, control=True)
    prog = dict((n, v) for n, v, _ in checks)
    assert result["correct"] is True, checks
    assert rec["stage_rows"] >= TINY_LIMITS["min_stage_rows"]
    for prec, names in FAILS.items():
        for name in names:
            got = result["control"][prec][name]
            assert got > TINY_LIMITS[name] > prog[name], (prec, name, got)
            assert got >= 3 * prog[name]


def _half_left_out(collect):
    def broken(self, handle, meta):
        vals, idx, cv = collect(self, handle, meta)
        vals[1::2] = 0.0                  # every other answer left out
        idx[1::2] = 0
        return vals, idx, cv
    broken.method = "_collect"
    return broken


def _answer_altered(step):
    def broken(self, pcm, *a, **k):
        vals, idx, cv = step(self, pcm, *a, **k)
        idx = idx.clone()
        idx[:, 0] = (idx[:, 0] + 1) % self.model.num_species
        return vals, idx, cv
    broken.method = "_step"
    return broken


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered],
                         ids=["half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", ["v24_backlog", "v24_live"])
def test_broken_served_step_is_not_correct(cell, fault, monkeypatch):
    from birdnet_go_tpu_torch.scheduler.loop import TorchModelBatcher

    name = fault(lambda *a: None).method
    monkeypatch.setattr(TorchModelBatcher, name,
                        fault(getattr(TorchModelBatcher, name)))
    result, checks, _ = run_tiny(cell)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_broken_offline_step_is_not_correct(fault, monkeypatch):
    from birdnet_go_tpu_torch.inference.backend import TorchClassifier

    predict = TorchClassifier.predict_topk

    def broken(self, pcm, *a, **k):
        vals, idx = predict(self, pcm, *a, **k)
        vals, idx = np.array(vals), np.array(idx)
        if fault == "half_left_out":
            vals[1::2] = 0.0
            idx[1::2] = 0
        else:
            idx[:, 0] = (idx[:, 0] + 1) % self.num_species
        return vals, idx

    monkeypatch.setattr(TorchClassifier, "predict_topk", broken)
    result, checks, _ = run_tiny("v24_offline")
    assert result["correct"] is False, checks


@pytest.mark.cuda
def test_backlog_cell_on_the_card(card):
    from portbench import run

    result, checks, _ = run.run_cell("v24_backlog", 2 ** 31 + 7, 5.0, False,
                                     control=True)
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "gpu"
    lim = dict((n, l) for n, _, l in checks)
    for prec, names in FAILS.items():
        assert any(result["control"][prec][n] > lim[n] for n in names), prec
    assert torch.cuda.is_available()
