"""The port's command line and loader against the JAX package's, on the
CPU.

``python -m birdnet_go_tpu_torch analyze`` on the full-width default model
(``--device cpu``); ``analyze`` and ``rangefilter`` of both CLIs on the
same weights (a tiny float32 model and the Geomodel, JAX ``init`` weights
carried over), whose tables and species rows must agree; the refusal to
run on the CPU without ``--device cpu`` where there is no card; the
loader, which serves .tflite and .onnx artifacts (given or installed) as
the JAX loader does, seeded weights where there are none, and raises where
the JAX loader would read an orbax checkpoint; ``TorchModelBatcher``
serving an imported model; ``verify-artifact`` against the JAX command;
``train --tiny`` against the JAX command on the same initial weights, and
on its own; and the model gallery (``ModelManager`` and ``model
list|install|remove``) against the JAX package's.
"""

import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import birdnet_go_tpu.inference.loader as jloader
from birdnet_go_tpu.analysis import raven as jraven
from birdnet_go_tpu.cli import main as jcli
from birdnet_go_tpu_torch.audio.wav import write_wav
from birdnet_go_tpu_torch.cli import main as tcli
from birdnet_go_tpu_torch.inference import loader as tloader
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models.bsg import BSGFinland
from birdnet_go_tpu_torch.models.geomodel import Geomodel, GeomodelConfig

from tests.test_torch_offline import _tiny_pair

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SUMMARY = re.compile(r"^(.+): (\d+)s audio, (\d+) windows, (\d+) detections "
                     r"in \d+\.\d\ds \(\d+x realtime\)$")


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _wav(path, seconds, rate, seed):
    rng = np.random.default_rng(seed)
    write_wav(path, (rng.standard_normal(int(seconds * rate)) * 0.1
                     ).astype(np.float32), rate)
    return path


# -- analyze -------------------------------------------------------------------

def test_analyze_default_model_on_cpu(tmp_path, capsys):
    """The full-width BirdNET v2.4 on seeded weights: a 44.1 kHz file is
    resampled and cut into 3 windows (the last padded), in 2 batches."""
    wav = _wav(tmp_path / "dawn chorus.wav", 7.0, 44100, 1)
    out = tmp_path / "out"
    rc = tcli.main(["analyze", str(wav), "--device", "cpu", "--batch-size",
                    "2", "--threshold", "0", "--rtype", "both", "--output",
                    str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    m = SUMMARY.match(lines[0])
    assert m and m.groups() == ("dawn chorus.wav", "7", "3", "3"), lines
    table = out / "dawn chorus.wav.txt"
    csv = out / "dawn chorus.csv"
    assert lines[1:] == [f"Output written to {table}",
                         f"Output written to {csv}"]
    rows = table.read_text(encoding="utf-8").splitlines()
    assert rows[0] == jraven._HEADER and len(rows) == 4
    assert [r.split("\t")[:6] for r in rows[1:]] == [
        [str(i + 1), "Spectrogram 1", "1", "dawn chorus.wav", f"{b:.1f}",
         f"{b + 3:.1f}"] for i, b in enumerate((0.0, 3.0, 6.0))]
    for r in rows[1:]:
        species_code, common, conf = r.split("\t")[8:]
        assert species_code and common and 0.0 <= float(conf) <= 1.0
    crows = csv.read_text(encoding="utf-8").splitlines()
    assert crows[0] == jraven.format_csv([]).strip() and len(crows) == 4


@pytest.fixture
def carried(monkeypatch):
    """Both CLIs load one tiny float32 v2.4 and Geomodels of the same
    weights (the JAX ``init``'s, carried into the port)."""
    jc, tc = _tiny_pair("v24")
    jgeo = jloader.load_geomodel

    def port_geomodel(num_species=6522, seed=7):
        g, params = jgeo(num_species=num_species, seed=seed)
        return load_jax_params(Geomodel(GeomodelConfig(num_species)),
                               _np_tree(params))

    monkeypatch.setattr(jloader, "load_model",
                        lambda *a, **k: (jc.model, jc.params))
    monkeypatch.setattr(tcli, "load_model", lambda *a, **k: tc.model)
    monkeypatch.setattr(tcli, "load_geomodel", port_geomodel)
    return tc


def test_analyze_tables_match_jax_cli(carried, tmp_path, capsys):
    d = tmp_path / "in"
    d.mkdir()
    _wav(d / "a.wav", 7.5, 32000, 2)
    _wav(d / "b.wav", 4.0, 48000, 3)
    (d / "notes.txt").write_text("not audio")
    common = ["--threshold", "0.1", "--all-results", "--overlap", "1.5",
              "--batch-size", "3", "--rtype", "both", "--latitude", "60.17",
              "--longitude", "24.94"]
    assert jcli.main(["analyze", str(d), "--output", str(tmp_path / "j"),
                      "--no-backend-probe", *common]) == 0
    jout = capsys.readouterr().out.splitlines()
    assert tcli.main(["analyze", str(d), "--output", str(tmp_path / "t"),
                      "--device", "cpu", *common]) == 0
    tout = capsys.readouterr().out.splitlines()
    # the same lines, but for the elapsed time
    strip = re.compile(r" in \d+\.\d\ds \(\d+x realtime\)")
    assert [strip.sub("", ln).replace(str(tmp_path / "t"), "OUT")
            for ln in tout] == \
        [strip.sub("", ln).replace(str(tmp_path / "j"), "OUT")
         for ln in jout]
    assert len(tout) == 6
    for name in ("a.wav.txt", "a.csv", "b.wav.txt", "b.csv"):
        t = (tmp_path / "t" / name).read_text(encoding="utf-8").splitlines()
        j = (tmp_path / "j" / name).read_text(encoding="utf-8").splitlines()
        assert len(t) == len(j) > 1 and t[0] == j[0]
        sep = "\t" if name.endswith(".txt") else ","
        for tr, jr in zip(t[1:], j[1:]):
            tf, jf = tr.split(sep), jr.split(sep)
            assert tf[:-1] == jf[:-1]
            assert abs(float(tf[-1]) - float(jf[-1])) <= 1e-4


# -- rangefilter ---------------------------------------------------------------

def _species_rows(lines, csv):
    """{species: score} from the rangefilter's output lines."""
    if csv:
        return {ln.rsplit(",", 1)[0]: float(ln.rsplit(",", 1)[1])
                for ln in lines[1:]}
    rows = [re.match(r"^  (\d\.\d{3})  (.+)$", ln) for ln in lines[2:]]
    return {m.group(2): float(m.group(1)) for m in rows if m}


@pytest.mark.parametrize("csv", [False, True])
def test_rangefilter_matches_jax_cli(carried, capsys, csv):
    args = ["rangefilter", "--latitude", "60.17", "--longitude", "24.94",
            "--week", "23"] + (["--csv"] if csv else [])
    assert jcli.main(args) == 0
    j = capsys.readouterr()
    assert tcli.main(args + ["--device", "cpu"]) == 0
    t = capsys.readouterr()
    tl, jl = t.out.splitlines(), j.out.splitlines()
    assert "random init" in t.err and "random init" in j.err
    if csv:
        assert tl[0] == jl[0] == "scientific_name,common_name,score"
    else:
        assert tl[:2] == jl[:2]
        assert jl[0] == "[random-init geomodel — output is not " \
                        "field-accurate]"
        assert re.match(r"^\d+ species probable at \(60\.17, 24\.94\) "
                        r"week 23:$", tl[1])
        assert tl[-1] == jl[-1] and len(tl) == len(jl) == 53
    trows, jrows = _species_rows(tl, csv), _species_rows(jl, csv)
    assert len(trows) >= 50 and trows.keys() == jrows.keys()
    # scores equal to float32 rounding: at most one step of the printed
    # decimals apart
    step = 1e-4 if csv else 1e-3
    for k, v in jrows.items():
        assert round(abs(trows[k] - v) / step) <= 1, k


def test_rangefilter_needs_a_location(capsys):
    assert tcli.main(["rangefilter", "--device", "cpu"]) == 1
    assert "requires --latitude and --longitude" in capsys.readouterr().err


# -- no card, no --device cpu --------------------------------------------------

@pytest.mark.parametrize("command", [["analyze", "x.wav"], ["benchmark"],
                                     ["rangefilter", "--latitude", "1",
                                      "--longitude", "2"],
                                     ["verify-artifact", "--audit"],
                                     ["train", "dataset"]])
def test_refuses_the_cpu_without_device_cpu(command, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tcli, "load_model", None)      # never reached
    assert tcli.main(command) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_module_entry_point_refuses_without_a_card(tmp_path):
    wav = _wav(tmp_path / "a.wav", 1.0, 48000, 4)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "birdnet_go_tpu_torch",
                          "analyze", str(wav), "--output", str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1 and res.stdout == ""
    assert "--device cpu" in res.stderr
    assert not (tmp_path / "a.wav.txt").exists()


def test_console_script_names_the_port_main():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["birdnet-tpu-torch"] == "birdnet_go_tpu_torch.cli.main:main"
    assert scripts["birdnet-tpu"] == "birdnet_go_tpu.cli.main:main"


def test_benchmark_prints_the_jax_line(monkeypatch, capsys):
    monkeypatch.setattr(tcli, "load_model", lambda *a, **k: BSGFinland(
        compute_dtype=torch.float32).init(torch.Generator().manual_seed(0)))
    assert tcli.main(["benchmark", "--device", "cpu", "--batch-size", "1",
                      "--iters", "2", "--model", "BSG"]) == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert list(rep) == ["model", "batch", "iters", "batch_latency_ms",
                         "windows_per_second", "realtime_streams"]
    assert (rep["model"], rep["batch"], rep["iters"]) == ("BSG", 1, 2)
    assert list(rep["batch_latency_ms"]) == ["mean", "median", "p95"]
    # both rounded to 0.1
    assert rep["realtime_streams"] == pytest.approx(
        rep["windows_per_second"] * 1.5, abs=0.15)


# -- loader --------------------------------------------------------------------

def test_model_home_equals_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("BIRDNET_TPU_MODELS", raising=False)
    assert tloader.model_home() == jloader.model_home()
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path))
    assert tloader.model_home() == jloader.model_home() == tmp_path


def test_load_model_serves_seeded_weights(monkeypatch, tmp_path, caplog):
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path))
    (tmp_path / "BSG").mkdir()                 # empty: nothing installed
    with caplog.at_level(logging.WARNING, "birdnet_tpu.inference"):
        a = tloader.load_model("BSG", seed=3)
    assert "using deterministic random init" in caplog.text
    b = tloader.load_model("BSG", seed=3)
    c = tloader.load_model("BSG", seed=4)
    assert isinstance(a, BSGFinland) and a.num_species == 380
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    with pytest.raises(KeyError, match="unknown model family"):
        tloader.build_model("BirdNET_V9")
    assert sorted(tloader._FAMILIES) == sorted(jloader._FAMILIES)


# -- imported artifacts --------------------------------------------------------

N_ART = 16                                      # the artifacts' species


def _tflite_artifact(path: Path) -> Path:
    """PCM [B, 144000] → dense → 16 logits, a genuine .tflite."""
    from birdnet_go_tpu.inference.tflite_import import Op
    from tests.tflite_builder import ModelBuilder, fully_connected_options

    rng = np.random.default_rng(31)
    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 144000], "pcm")
    w_t = mb.add_tensor([N_ART, 144000], "w", (rng.standard_normal(
        (N_ART, 144000)) * 3e-3).astype(np.float32))
    b_t = mb.add_tensor([N_ART], "b", rng.standard_normal(N_ART).astype(
        np.float32))
    y_t = mb.add_tensor([1, N_ART], "logits")
    mb.add_op(Op.FULLY_CONNECTED, [x_t, w_t, b_t], [y_t],
              lambda b: fully_connected_options(b))
    mb.inputs, mb.outputs = [x_t], [y_t]
    path.write_bytes(mb.finish())
    return path


def _onnx_artifact(path: Path) -> Path:
    """PCM [B, 144000] → Gemm → Relu (the embedding) → Gemm → 16 logits,
    a genuine .onnx with two outputs."""
    from tests import onnx_builder as ob

    rng = np.random.default_rng(32)
    w1 = (rng.standard_normal((144000, 24)) * 3e-3).astype(np.float32)
    w2 = rng.standard_normal((24, N_ART)).astype(np.float32)
    nodes = [ob.node("Gemm", ["pcm", "w1"], ["pre"]),
             ob.node("Relu", ["pre"], ["embedding"]),
             ob.node("Gemm", ["embedding", "w2", "b2"], ["logits"])]
    path.write_bytes(ob.model(nodes, [
        ob.tensor_proto("w1", w1), ob.tensor_proto("w2", w2),
        ob.tensor_proto("b2", rng.standard_normal(N_ART).astype(
            np.float32))], ["pcm"], ["logits", "embedding"]))
    return path


def _artifact(kind: str, path: Path) -> Path:
    return (_tflite_artifact if kind == "tflite" else _onnx_artifact)(
        path.with_suffix(f".{kind}"))


def _field_pcm(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(144000) / 48000.0
    f = rng.uniform(200.0, 12000.0, (n, 1))
    return (0.05 * np.sin(2 * np.pi * f * t) + rng.standard_normal(
        (n, 144000)) * 0.01).astype(np.float32)


@pytest.mark.parametrize("kind, where", [
    ("tflite", "checkpoint"), ("onnx", "checkpoint"),
    ("tflite", "installed"), ("onnx", "installed"), ("both", "installed")])
def test_loader_serves_artifacts_as_jax(kind, where, monkeypatch, tmp_path,
                                        caplog):
    """A .tflite or .onnx, given as the checkpoint or installed as
    ``<home>/<id>/model.tflite|onnx`` (the .tflite first where both are),
    loads as an ``ImportedModel`` equal to the JAX loader's."""
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path))
    ckpt = None
    if where == "checkpoint":
        ckpt = str(_artifact(kind, tmp_path / "model"))
    else:
        home = tmp_path / "BirdNET_V2.4"
        home.mkdir()
        for k in (("tflite", "onnx") if kind == "both" else (kind,)):
            _artifact(k, home / "model")
    with caplog.at_level(logging.INFO, "birdnet_tpu.inference"):
        tm = tloader.load_model("BirdNET_V2.4", checkpoint=ckpt)
    jm, params = jloader.load_model("BirdNET_V2.4", checkpoint=ckpt)
    fmt = "onnx" if kind == "onnx" else "tflite"
    assert f"imported BirdNET_V2.4 from {fmt}" in caplog.text
    assert isinstance(tm, tloader.ImportedModel)
    assert isinstance(tm.graph, tloader.OnnxGraph if fmt == "onnx"
                      else tloader.TFLiteGraph)
    assert tm.num_species == jm.num_species == N_ART
    assert dataclasses.asdict(tm.spec) == dataclasses.asdict(jm.spec)
    pcm = _field_pcm(1, 5)
    got = tm.apply(torch.from_numpy(pcm))
    want = jm.apply(params, pcm)
    assert got.keys() == want.keys() == {"logits", "embedding"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["orbax_checkpoint", "no_artifact_installed",
                                  "geomodel_installed"])
def test_loader_raises_where_jax_would_load_weights(case, monkeypatch,
                                                    tmp_path):
    """Where the JAX loader reads an orbax checkpoint (given, or installed
    without a .tflite/.onnx or the port's params.npz beside it) the port
    raises rather than serve random weights; the CLI does not catch it."""
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path))
    if case == "orbax_checkpoint":
        with pytest.raises(NotImplementedError, match="params.npz"):
            tloader.load_model("BirdNET_V2.4", checkpoint="ckpt/")
        with pytest.raises(NotImplementedError, match="not orbax"):
            tcli.main(["analyze", "x.wav", "--device", "cpu",
                       "--checkpoint", "ckpt/"])
    elif case == "no_artifact_installed":
        (tmp_path / "BirdNET_V2.4").mkdir()
        (tmp_path / "BirdNET_V2.4" / "params").write_bytes(b"x")
        with pytest.raises(NotImplementedError,
                           match="no model.tflite, model.onnx or params.npz "
                                 "there"):
            tloader.load_model("BirdNET_V2.4")
    else:
        assert not tloader.geomodel_weights_installed()
        g = tloader.load_geomodel(num_species=12, seed=7)
        assert isinstance(g, Geomodel) and g.cfg.num_species == 12
        (tmp_path / "Geomodel").mkdir()
        (tmp_path / "Geomodel" / "params").write_bytes(b"x")
        assert tloader.geomodel_weights_installed()
        assert jloader.geomodel_weights_installed()
        with pytest.raises(NotImplementedError,
                           match="installed model .*orbax"):
            tloader.load_geomodel()
        with pytest.raises(NotImplementedError):
            tcli.main(["rangefilter", "--device", "cpu", "--latitude", "1",
                       "--longitude", "2"])


@pytest.mark.parametrize("kind", ["tflite", "onnx"])
def test_batcher_serves_imported_model_as_jax(kind, tmp_path):
    """``TorchModelBatcher`` serves an ``ImportedModel`` (no int16 path:
    the step takes the float32 PCM) with the JAX ``ModelBatcher``'s top-10
    on the same windows."""
    from birdnet_go_tpu.inference.backend import JaxClassifier
    from birdnet_go_tpu.scheduler import loop as jloop
    from birdnet_go_tpu_torch.scheduler import loop as tloop

    path = str(_artifact(kind, tmp_path / "model"))
    jm, params = jloader.load_model("BirdNET_V2.4", checkpoint=path)
    tm = tloader.load_model("BirdNET_V2.4", checkpoint=path)
    assert not hasattr(tm, "apply_int16")
    pcm = (np.clip(_field_pcm(5, 6), -1, 1) * 32767).astype(np.int16)
    served = []
    for b in (jloop.ModelBatcher(JaxClassifier(jm, params), max_batch=4),
              tloop.TorchModelBatcher(TorchClassifier(tm, "cpu"),
                                      max_batch=4)):
        out = []
        b.on_batch = lambda meta, v, i, cv, out=out: out.append(
            ([m.source_id for m in meta], np.asarray(v), np.asarray(i)))
        ids, times = [f"s{k}" for k in range(5)], [float(k) for k in range(5)]
        assert b.offer_block(pcm, ids, times) == 4          # a full batch
        b.dispatch()
        assert b.offer_block(pcm[4:], ids[4:], times[4:]) == 1
        b.dispatch()
        b.harvest_all()
        served.append(out)
    want, got = served
    assert [ids for ids, _, _ in got] == [ids for ids, _, _ in want] == \
        [["s0", "s1", "s2", "s3"], ["s4"]]
    for (_, tv, ti), (_, jv, ji) in zip(got, want):
        assert tv.shape == jv.shape and tv.shape[1] == 10
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
        assert (np.diff(tv, axis=1) <= 0).all()
        np.testing.assert_array_equal(ti, ji)


# -- verify-artifact -------------------------------------------------------------

_VERIFY_KEYS = ("artifact", "sha256", "format", "ops", "inputs", "outputs",
                "fingerprint", "golden", "raven")


def _verify_lines(main, argv, capsys) -> tuple[int, dict, list[str]]:
    rc = main(argv)
    lines = capsys.readouterr().out.splitlines()
    fields = {ln[:12].strip(): ln[12:] for ln in lines
              if ln[:12].strip() in _VERIFY_KEYS}
    return rc, fields, lines


@pytest.mark.parametrize("kind", ["tflite", "onnx"])
def test_verify_artifact_prints_the_jax_lines(kind, tmp_path, capsys):
    """The port's command prints the JAX command's lines: the same
    artifact, digest, format, op inventory, shapes and statuses, then PASS;
    its fingerprint is its own and stable across runs (the second run
    matches the golden the first recorded), exit 0."""
    path = str(_artifact(kind, tmp_path / "model"))
    jrc, jf, jlines = _verify_lines(
        jcli.main, ["verify-artifact", path, "--golden",
                    str(tmp_path / "jgold")], capsys)
    runs = [_verify_lines(tcli.main, ["verify-artifact", path, "--device",
                                      "cpu", "--golden",
                                      str(tmp_path / "tgold")], capsys)
            for _ in range(2)]
    assert jrc == 0 and jf["golden"] == "recorded"
    for rc, tf, tlines in runs:
        assert rc == 0 and tlines[-1] == jlines[-1] == "PASS"
        assert [ln[:12] for ln in tlines] == [ln[:12] for ln in jlines]
        for key in ("artifact", "sha256", "format", "ops", "inputs",
                    "outputs", "raven"):
            assert tf[key] == jf[key], key
    (_, first, _), (_, second, _) = runs
    assert (first["golden"], second["golden"]) == ("recorded", "match")
    assert first["fingerprint"] == second["fingerprint"]
    assert list((tmp_path / "tgold").iterdir()) == [
        tmp_path / "tgold" / f"{first['sha256']}.json"]


def test_verify_artifact_exit_codes(tmp_path, capsys):
    """A fingerprint that differs from the recorded one fails with exit 1,
    as in the JAX command; ``--audit`` alone prints the JAX audit table."""
    path = str(_artifact("tflite", tmp_path / "model"))
    gold = tmp_path / "gold"
    argv = ["verify-artifact", path, "--device", "cpu", "--golden",
            str(gold)]
    rc, f, _ = _verify_lines(tcli.main, argv, capsys)
    assert rc == 0
    rec = gold / f"{f['sha256']}.json"
    rec.write_text(rec.read_text().replace(f["fingerprint"], "0" * 64))
    rc, f, lines = _verify_lines(tcli.main, argv, capsys)
    assert rc == 1 and f["golden"] == "MISMATCH" and lines[-1] == "FAIL"
    rc, f, _ = _verify_lines(tcli.main, argv[:-2] + ["--no-golden"], capsys)
    assert rc == 0 and f["golden"] == "skipped"
    assert tcli.main(["verify-artifact", "--audit", "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert jcli.main(["verify-artifact", "--audit"]) == 0
    assert tout == capsys.readouterr().out
    (tmp_path / "m.pb").write_bytes(b"x")
    with pytest.raises(ValueError, match="unknown artifact format"):
        tcli.main(["verify-artifact", str(tmp_path / "m.pb"), "--device",
                   "cpu", "--no-golden"])


def test_verify_artifact_wav_leg_writes_the_jax_table(tmp_path, capsys):
    """With ``--wav`` both commands analyze the file through the imported
    model: the same detections, so the same Raven table."""
    path = str(_artifact("onnx", tmp_path / "model"))
    wav = _wav(tmp_path / "field.wav", 9.0, 48000, 7)
    for main, gold, extra in ((jcli.main, "jgold", []),
                              (tcli.main, "tgold", ["--device", "cpu"])):
        rc, f, _ = _verify_lines(main, ["verify-artifact", path, "--wav",
                                        str(wav), "--golden",
                                        str(tmp_path / gold)] + extra,
                                 capsys)
        assert rc == 0 and f["raven"] == "recorded"
    (jt,), (tt,) = ((tmp_path / g).glob("*.raven.txt")
                    for g in ("jgold", "tgold"))
    assert tt.read_text() == jt.read_text()


# -- train ---------------------------------------------------------------------

def _tone_dataset(root: Path, seed: int = 0) -> Path:
    """The JAX CLI test's dataset: two tone classes over a 0.01 noise
    floor, 2 files of 12 s (4 windows) each."""
    rng = np.random.default_rng(seed)
    for cls, freq in (("lowtone", 500.0), ("hightone", 6000.0)):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(2):
            t = np.arange(48000 * 12) / 48000.0
            x = 0.4 * np.sin(2 * np.pi * freq * t) \
                + 0.01 * rng.standard_normal(len(t))
            write_wav(d / f"{i}.wav", x.astype(np.float32), 48000)
    return root


TRAIN_ARGS = ["--epochs", "15", "--batch-size", "4", "--tiny",
              "--learning-rate", "3e-3"]
STEP = re.compile(r"^step (\d+): loss=([\d.]+) grad_norm=([\d.]+)$")
VALIDATION = re.compile(r"^validation: accuracy=([\d.]+) loss=([\d.]+) "
                        r"\(n=(\d+)\)$")


def _train_lines(out: str) -> dict:
    lines = out.splitlines()
    steps = [STEP.match(ln) for ln in lines if ln.startswith("step ")]
    (val,) = [VALIDATION.match(ln) for ln in lines
              if ln.startswith("validation")]
    return {"dataset": lines[0],
            "steps": [(int(m[1]), float(m[2]), float(m[3])) for m in steps],
            "validation": (float(val[1]), float(val[2]), int(val[3])),
            "last": lines[-1]}


def test_train_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """Both ``train --tiny`` commands on one dataset, the port's model
    carrying the JAX command's initial weights (``PRNGKey(0)``): the same
    lines, losses and grad norms within their printed rounding."""
    ds = _tone_dataset(tmp_path / "ds")
    from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
    from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
    from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
    from birdnet_go_tpu.ops.melspec import MelConfig as JMel

    ref = JBirdNETv24(num_species=2, mel=JMel(sample_rate=48000, n_fft=512,
                                              hop=4096, n_mels=32),
                      compute_dtype=jax.numpy.float32)
    ref.net = JNet(blocks=(JBlock(1, 8, 3, 2, 1), JBlock(4, 16, 3, 2, 1)),
                   embedding_dim=32, num_classes=2)
    carried = tcli._tiny_v24(2)
    load_jax_params(carried.backbone,
                    _np_tree(ref.init(jax.random.PRNGKey(0))))
    carried.init = lambda generator=None: carried
    monkeypatch.setattr(tcli, "_tiny_v24", lambda n: carried)

    assert jcli.main(["train", str(ds), "--output", str(tmp_path / "j"),
                      *TRAIN_ARGS]) == 0
    want = _train_lines(capsys.readouterr().out)
    assert tcli.main(["train", str(ds), "--output", str(tmp_path / "t"),
                      "--device", "cpu", *TRAIN_ARGS]) == 0
    got = _train_lines(capsys.readouterr().out)
    assert got["dataset"] == want["dataset"] == (
        "dataset: 14 train / 2 val windows, 2 classes: "
        "['hightone', 'lowtone']")
    assert [s[0] for s in got["steps"]] == [s[0] for s in want["steps"]] \
        == [1, 11, 21, 31, 41]
    for (_, gl, gn), (_, wl, wn) in zip(got["steps"], want["steps"]):
        assert abs(gl - wl) <= 1.5e-4 and abs(gn - wn) <= 1.5e-3
    assert got["validation"][0] == want["validation"][0]
    assert abs(got["validation"][1] - want["validation"][1]) <= 1.5e-4
    assert got["validation"][2] == want["validation"][2] == 2
    for side, d in (("t", got), ("j", want)):
        assert d["last"] == (f"trained 45 steps; checkpoint + labels "
                             f"written to {tmp_path / side}")
    assert (tmp_path / "t" / "labels.json").read_text() == \
        (tmp_path / "j" / "labels.json").read_text()


def test_train_cli_end_to_end(tmp_path, capsys):
    """``test_train_cli_end_to_end`` of the JAX package through the port
    on its own initial weights: the checkpoint it writes separates the
    two tones."""
    rng = np.random.default_rng(0)
    ds = _tone_dataset(tmp_path / "ds")
    out = tmp_path / "ckpt"
    rc = tcli.main(["train", str(ds), "--output", str(out), "--device",
                    "cpu", *TRAIN_ARGS])
    assert rc == 0
    lines = _train_lines(capsys.readouterr().out)
    assert lines["steps"][-1][1] < lines["steps"][0][1]
    assert json.loads((out / "labels.json").read_text()) == \
        ["hightone", "lowtone"]
    assert sorted(p.name for p in out.iterdir()) == ["labels.json",
                                                     "params.npz"]

    from birdnet_go_tpu_torch.inference.checkpoint import load_params

    model = load_params(out, like=tcli._tiny_v24(2))
    t = np.arange(48000 * 3) / 48000.0
    # same distribution as training: tone + the 0.01 noise floor
    noise = 0.01 * rng.standard_normal(len(t))
    low = 0.4 * np.sin(2 * np.pi * 500.0 * t) + noise
    high = 0.4 * np.sin(2 * np.pi * 6000.0 * t) + noise
    with torch.inference_mode():
        logits = model.apply(torch.from_numpy(
            np.stack([low, high]).astype(np.float32)))["logits"].numpy()
    # class order: ["hightone", "lowtone"]
    assert logits[0, 1] > logits[0, 0]      # low tone → "lowtone"
    assert logits[1, 0] > logits[1, 1]      # high tone → "hightone"


# -- model gallery -------------------------------------------------------------

def test_catalog_equals_jax():
    from birdnet_go_tpu.models import catalog as jcatalog
    from birdnet_go_tpu_torch.models import catalog as tcatalog

    assert [dataclasses.asdict(e) for e in tcatalog.catalog_entries()] == \
        [dataclasses.asdict(e) for e in jcatalog.catalog_entries()]
    ids = {e.model_id for e in tcatalog.catalog_entries()}
    assert {"BirdNET_V2.4", "Perch_V2", "BattyBirdNET"} <= ids
    assert tcatalog.get_entry("BirdNET_V2.4").file_name == "model.tflite"
    assert tcatalog.get_entry("nope") is None


def _toy_tflite(path: Path) -> Path:
    """The JAX gallery test's artifact: [1, 8] → dense of ones → 3."""
    from birdnet_go_tpu.inference.tflite_import import Op
    from tests.tflite_builder import ModelBuilder, fully_connected_options

    mb = ModelBuilder()
    x_t = mb.add_tensor([1, 8], "in")
    w_t = mb.add_tensor([3, 8], "w", np.ones((3, 8), np.float32))
    y_t = mb.add_tensor([1, 3], "out")
    mb.add_op(Op.FULLY_CONNECTED, [x_t, w_t, -1], [y_t],
              lambda b: fully_connected_options(b))
    mb.inputs, mb.outputs = [x_t], [y_t]
    path.write_bytes(mb.finish())
    return path


def test_manager_install_from_file_and_loader(tmp_path, monkeypatch):
    from birdnet_go_tpu_torch.models.catalog import ModelManager

    artifact = _toy_tflite(tmp_path / "toy.tflite")
    home = tmp_path / "models"
    mgr = ModelManager(home=home)
    dest = mgr.install_from_file("Toy_X", artifact)
    assert dest == home / "Toy_X" / "model.tflite"
    assert mgr.is_installed("Toy_X")
    inv = mgr.installed()
    assert inv[0]["model_id"] == "Toy_X" and inv[0]["bytes"] > 0
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(home))
    model = tloader.load_model("Toy_X")           # the installed artifact
    assert isinstance(model, tloader.ImportedModel)
    with torch.inference_mode():
        out = model.apply(torch.ones((1, 8)))
    np.testing.assert_allclose(out["logits"].numpy(), [[8.0, 8.0, 8.0]],
                               rtol=1e-5)
    assert mgr.remove("Toy_X")
    assert not mgr.is_installed("Toy_X")
    assert not mgr.remove("Toy_X")


def test_manager_refuses_unpinned_download(tmp_path):
    from birdnet_go_tpu_torch.models.catalog import CatalogEntry, ModelManager

    mgr = ModelManager(home=tmp_path)
    with pytest.raises(ValueError, match="unpinned"):
        mgr.install_from_url(CatalogEntry(
            model_id="X", display_name="X", description="",
            url="http://example/x.onnx", sha256="", file_name="model.onnx"))
    with pytest.raises(ValueError, match="no artifact URL"):
        mgr.install_from_url(CatalogEntry(
            model_id="X", display_name="X", description="", url="",
            sha256="0" * 64, file_name="model.onnx"))
    assert not (tmp_path / "X").exists()


class _Resp:
    def __init__(self, payload):
        self.payload = payload
        self.headers = {"Content-Length": str(len(payload))}

    def raise_for_status(self):
        pass

    def iter_bytes(self, n):
        for i in range(0, len(self.payload), n):
            yield self.payload[i:i + n]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


class _Session:
    """An httpx-like session serving one payload; no network."""

    def __init__(self, payload):
        self.payload = payload
        self.urls = []

    def stream(self, method, url):
        self.urls.append((method, url))
        return _Resp(self.payload)


def test_manager_verifies_sha256(tmp_path):
    import hashlib

    from birdnet_go_tpu_torch.models.catalog import CatalogEntry, ModelManager

    payload = b"fake model bytes"
    good = hashlib.sha256(payload).hexdigest()
    session = _Session(payload)
    mgr = ModelManager(home=tmp_path, session=session)
    seen = []
    entry = CatalogEntry(model_id="Y", display_name="Y", description="",
                         url="http://example/y.onnx", sha256=good,
                         file_name="model.onnx")
    dest = mgr.install_from_url(entry, progress=lambda g, t: seen.append(
        (g, t)))
    assert dest == tmp_path / "Y" / "model.onnx"
    assert dest.read_bytes() == payload
    assert session.urls == [("GET", "http://example/y.onnx")]
    assert seen == [(len(payload), len(payload))]
    assert not list(tmp_path.glob("Y/*.tmp"))
    bad = dict(model_id="Z", display_name="Z", description="",
               url="http://example/z.onnx", sha256="0" * 64,
               file_name="model.onnx")
    with pytest.raises(ValueError, match="sha256 mismatch"):
        mgr.install_from_url(CatalogEntry(**bad))
    assert not (tmp_path / "Z" / "model.onnx").exists()


def test_manager_downloads_through_urllib_without_a_session(tmp_path,
                                                            monkeypatch):
    """Without a session the download goes through ``urllib.request``
    (stubbed here: no test reaches the network), in 1 MiB reads."""
    import hashlib
    import io
    import urllib.request

    from birdnet_go_tpu_torch.models import catalog as tcatalog

    payload = bytes(range(256)) * 5000              # 1.28 MB, two reads
    calls = []

    class _Urlopen(io.BytesIO):
        headers = {"Content-Length": str(len(payload))}

        def __init__(self, req, timeout):
            calls.append((req.full_url, req.get_method(), timeout))
            super().__init__(payload)

    monkeypatch.setattr(urllib.request, "urlopen", _Urlopen)
    entry = tcatalog.CatalogEntry(
        model_id="W", display_name="W", description="",
        url="https://example/w.tflite",
        sha256=hashlib.sha256(payload).hexdigest(), file_name="model.tflite")
    seen = []
    dest = tcatalog.ModelManager(home=tmp_path).install_from_url(
        entry, progress=lambda g, t: seen.append(g))
    assert dest.read_bytes() == payload
    assert calls == [("https://example/w.tflite", "GET", 120.0)]
    assert seen == [1 << 20, len(payload)]


def test_model_install_stages_labels_beside_weights(tmp_path, monkeypatch):
    from birdnet_go_tpu_torch.models.catalog import ModelManager
    from birdnet_go_tpu_torch.taxonomy import labels as labels_mod

    art = tmp_path / "model.tflite"
    art.write_bytes(b"\x00" * 64)
    mgr = ModelManager(home=tmp_path / "home")
    mgr.install_from_file("BirdNET_V2.4", art)
    staged = tmp_path / "home" / "BirdNET_V2.4" / "labels"
    assert len(list(staged.glob("*.txt"))) == 42
    # host with NO data dir at all: only the staged copies resolve
    monkeypatch.delenv("BIRDNET_TPU_DATA", raising=False)
    monkeypatch.setattr(labels_mod, "_DEFAULT_DATA_DIRS", ())
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path / "home"))
    ls = labels_mod.load_labels(model_id="BirdNET_V2.4", locale="de")
    assert len(ls.species) == 6522
    assert "Synthetica" not in ls.species[0].scientific
    assert mgr.install_from_file("Toy_Z", art).parent == \
        tmp_path / "home" / "Toy_Z"
    assert not (tmp_path / "home" / "Toy_Z" / "labels").exists()


_LOG_RECORD = re.compile(r"^\d{4}-\d\d-\d\d ")


def _model_cli(main, argv, home, monkeypatch, capsys):
    """One ``model`` command on `home`: (exit code, stdout, stderr lines
    that are not log records), the home's path written as <home>."""
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(home))
    rc = main(["model", *argv])
    out = capsys.readouterr()
    err = [ln for ln in out.err.splitlines() if not _LOG_RECORD.match(ln)]
    return (rc, out.out.replace(str(home), "<home>"),
            [ln.replace(str(home), "<home>") for ln in err])


def test_model_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """``model list|install|remove`` of both CLIs, each on a model home of
    its own, step by step: the same output lines, errors, exit codes and
    installed files. The port's ``model`` needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    artifact = _toy_tflite(tmp_path / "toy.tflite")
    steps = [["list"], ["install"], ["remove"],
             ["install", "Toy_X", "--from-file", str(artifact)],
             ["list"], ["install", "Nope"], ["install", "BirdNET_V2.4"],
             ["install", "BirdNET_V2.4", "--from-file", str(artifact)],
             ["list"], ["remove", "Toy_X"], ["remove", "Toy_X"],
             ["remove", "BirdNET_V2.4"], ["list"]]
    homes = {"t": tmp_path / "t", "j": tmp_path / "j"}

    def tree(home):
        return sorted(str(p.relative_to(home)) for p in home.rglob("*"))

    for argv in steps:
        got = _model_cli(tcli.main, argv, homes["t"], monkeypatch, capsys)
        want = _model_cli(jcli.main, argv, homes["j"], monkeypatch, capsys)
        assert got == want, argv
        assert tree(homes["t"]) == tree(homes["j"]), argv
    assert want[0] == 0 and want[1].splitlines()[0].split() == [
        "model", "installed", "description"]
