"""A small CPU rehearsal of each cell prints one contract line."""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from portbench import harness
from portbench.tests.tiny import run_tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_one_contract_line(cell, trace):
    result, checks, rec = run_tiny(cell, trace=trace)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
            io.StringIO()):
        harness.emit(result, checks)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True, checks
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"     # never under "gpu"
    bench = harness.manifest()
    group = bench["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
