"""BENCHMARK.json against the contract's shape, and every file the harness
finds by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness, run
from portbench.tests.tiny import run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"] if "workloads" in m else []) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.load_json(harness.workload_file(cell))
    assert wl["config"] == entry["config"] and wl["traffic"] == entry[
        "traffic"]
    assert harness.config_file(entry["config"]).is_file()
    assert harness.traffic_module(wl["kind"]).run
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert len(e2e) >= 2
    assert any(cell in m.get("workloads", [cell])
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_found_by_name(metric):
    mod = harness.load_module(harness.metric_file(metric), metric)
    assert mod.read({"spans": {}, "trace": {}, "cfg": {}}) is None


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_ports_family_at_full_width(config):
    from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
    from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24

    from portbench import program

    cfg = harness.load_json(harness.config_file(config))
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    assert entry["reduced"] == cfg["reduced"] == []
    port = {"BirdNET_V2.4": BirdNETv24, "BirdNET_V3.0": BirdNETv3}[
        cfg["family"]]()
    assert program.mel_config(cfg["mel"]) == port.mel
    assert program.net_config(cfg["net"]) == port.net
    assert port.spec.clip_samples == cfg["clip_samples"]
    assert port.spec.sample_rate == cfg["sample_rate"]


def test_added_files_are_picked_up_without_editing_others(tmp_path):
    """A cell, a configuration and a per-layer metric added as new files
    and new manifest entries run in a copy of the benchmark."""
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.load_json(harness.config_file("birdnet_v24"))
    (tmp_path / "portbench/configs/v24_copy.json").write_text(
        json.dumps(cfg))
    wl = harness.load_json(harness.workload_file("v24_backlog"))
    wl.update(config="v24_copy", traffic="backlog_small")
    (tmp_path / "portbench/workloads/v24_small.json").write_text(
        json.dumps(wl))
    (tmp_path / "portbench/metrics/windows_done.small.py").write_text(
        "def read(rec):\n    return rec.get('windows_done')\n")
    bench["configs"].append({"name": "v24_copy", "source": "x",
                             "file": "portbench/configs/v24_copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "v24_small", "config": "v24_copy",
                               "traffic": "backlog_small", "chips": 1,
                               "why": "a small copy"})
    bench["end_to_end"][0]["workloads"].append("v24_small")
    bench["per_layer"].append({"name": "windows_done.small", "unit": "n",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "host loop",
                               "moves": "windows_per_s",
                               "workloads": ["v24_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _, _ = run_tiny("v24_small", trace=True, root=tmp_path)
    assert result["metrics"]["windows_done.small"]["value"] > 0
    result, _, _ = run_tiny("v24_small", root=tmp_path)
    assert set(result["metrics"]) == {"windows_per_s", "setup_s"}


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.run_cell("no_such_cell", 1, 1.0, False)
