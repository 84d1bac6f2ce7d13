"""The port's full-pipeline soak (``scheduler/soak.py``) and its CLI against
the JAX package's, on the CPU.

Two stub soaks run through both ``run_soak``s with the same explicit stub
latency model: a multi-model leg shaped like ``tests/test_stream_farm.py::
test_multi_model_soak_smoke`` and a durable leg shaped like
``tests/test_crash_durability.py::test_restart_no_double_count``. Their
values are timing-bound and not compared; their records have the same keys,
recursively, and both meet the same invariants. A ``device="cpu"`` leg
serves the tiny float32 v2.4 of ``train --tiny`` in place of the full-width
classifier (``soak_classifier``): its windows reach the datastore and every
batch's top-10 equals the classifier's called directly on the same PCM.
A kitchen-sink leg runs every aux plane beside the stub soak in both
packages: the same record keys, every aux counter but the 45 s range
rebuild above 0, no aux error, and a live dual-write migration. The flags
of both CLIs reach ``run_soak`` alike. The soak legs run 6 s (the
multi-model leg 8 s), sampled every 2 s. A durable ``device="cpu"`` leg
shows the port's durable calibration (the dynamic floor raised to the
calibrated threshold) and the restored thresholds it records, which JAX,
running durable mode on the stub only, does not have.
"""

import argparse
import dataclasses
import json
import sqlite3
import time

import numpy as np
import pytest
import torch

from birdnet_go_tpu.scheduler import soak as jsoak
from birdnet_go_tpu_torch.cli import main as tcli
from birdnet_go_tpu_torch.datastore.sqlite import Datastore
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.ops.pcm import pcm16_to_float32
from birdnet_go_tpu_torch.scheduler import loop as tloop
from birdnet_go_tpu_torch.scheduler import soak as tsoak

SECONDS = 6.0
STUB = dict(stub_base_ms=0.5, stub_per_window_us=5.0, sample_seconds=2.0)


def _keys(x, path=""):
    """The record's key structure: dicts recursively, lists as one leaf
    (the timeline's samples carry optional keys, checked apart)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    return type(x).__name__ if x is None else "leaf"


UNTHROTTLED = ({"note"}, {"p50", "p95", "p99", "max", "window_fraction",
                          "definition"})


def _same_shape(got: dict, want: dict) -> None:
    """Equal key structure; the timeline's samples and the steal-free
    latency, whose keys depend on the host's steal during the run, each
    take one of their known shapes."""
    apart = ("timeline", "latency_unthrottled_ms")
    assert _keys({k: v for k, v in got.items() if k not in apart}) == \
        _keys({k: v for k, v in want.items() if k not in apart})
    for rec in (got, want):
        assert set(rec["latency_unthrottled_ms"]) in UNTHROTTLED
    optional = {"steal_pct", "lat_p50_ms", "burst"}
    for rec in (got, want):
        assert rec["timeline"], "no timeline samples"
    base = set(want["timeline"][0]) - optional
    for s in got["timeline"] + want["timeline"]:
        assert base <= set(s) <= base | optional


def _invariants(rec: dict) -> None:
    da, a = rec["drop_accounting"], rec["actions"]
    assert da["farm_samples_lost"] == 0
    assert da["scheduler_windows_dropped"] == 0
    assert da["jobqueue_dropped_critical"] == 0
    assert a["approved"] > 0
    assert rec["processor"]["detections_persisted"] == a["approved"] == \
        a["detections_persisted"]
    assert a["clip_files_on_disk"] == a["clips_written"]
    assert rec["latency_ms"] and rec["latency_ms"]["p50"] > 0


def test_multi_model_stub_soak_matches_jax(tmp_path):
    """Two families at their native rates, the realistic action mix and a
    burst: both soaks process windows of both models, approve, persist
    every approval and write every clip, with no critical job dropped."""
    recs = {}
    for name, mod in (("jax", jsoak), ("port", tsoak)):
        # 8 s: a Perch window takes 5 s of audio
        recs[name] = mod.run_soak(
            streams=60, seconds=8.0, device="stub",
            models=("BirdNET_V2.4", "Perch_V2"), action_mix="realistic",
            clips_dir=str(tmp_path / name / "clips"), burst_at=2.0,
            burst_seconds=3.0, hit_stride=8, tick_ms=50, **STUB)
    _same_shape(recs["port"], recs["jax"])
    for rec in recs.values():
        _invariants(rec)
        assert rec["models"] == ["BirdNET_V2.4", "Perch_V2"]
        pm = rec["per_model"]
        assert pm["BirdNET_V2.4"]["windows_processed"] > \
            pm["Perch_V2"]["windows_processed"] > 0
        assert rec["burst"] == {"at_seconds": 2.0, "seconds": 3.0,
                                "stride": 1}
    cal = recs["port"]["calibration"]
    assert cal["mode"] == "calibrated stub"
    assert cal["device_batch_latency_model_ms"] == "0.5 + n*5.0/1000"
    assert cal["calibration_source"] == tsoak.STUB_SOURCE


def test_durable_stub_soak_matches_jax(tmp_path):
    """Durable mode: thresholds learnt and persisted, clip names on the
    rows, every persisted detection in the database file, no duplicate."""
    recs = {}
    for name, mod in (("jax", jsoak), ("port", tsoak)):
        db = tmp_path / name / "soak.db"
        rec = mod.run_soak(streams=100, seconds=SECONDS, device="stub",
                           db_path=str(db), clips_dir=str(tmp_path / name),
                           durable=True, persist_interval_s=2.0,
                           hit_stride=4, sim_mqtt_ms=1.0, sim_alert_ms=1.0,
                           **STUB)
        recs[name] = rec
        _invariants(rec)
        assert rec["durable"]["thresholds_persisted"] >= 1
        store = Datastore(str(db))
        try:
            assert store.count_detections() == \
                rec["actions"]["detections_persisted"]
            assert store.count_duplicate_detections() == 0
            assert store.integrity_check() == "ok"
            assert len(store.load_dynamic_thresholds()) == \
                rec["durable"]["thresholds_persisted"]
        finally:
            store.close()
        conn = sqlite3.connect(str(db))
        names = [r[0] for r in conn.execute(
            "SELECT clip_name FROM detections")]
        conn.close()
        assert names and all(n.endswith(".wav") for n in names)
        assert all((tmp_path / name / n).is_file() for n in names)
    # the port also records the thresholds it restored at start (none in
    # a new database) and their levels, which the crash leg checks
    port = recs["port"]["durable"]
    assert (port.pop("thresholds_restored"), port.pop("restored_levels")) \
        == (0, [])
    _same_shape(recs["port"], recs["jax"])


def test_kitchen_sink_stub_soak_matches_jax(tmp_path):
    """``kitchen_sink=True``: HLS, sound levels and LUFS, spectrogram
    pre-rendering, range rebuilds and the dual-write migration run beside
    the stub soak (the port's device work on the CPU). Both records have
    the same keys, ``aux_planes`` included; every aux counter but
    ``range_rebuilds`` (its interval is 45 s) is above 0, no aux plane
    erred, and the migration is copying with dual-write installed, while
    the soak's own invariants hold."""
    recs = {}
    for name, mod in (("jax", jsoak), ("port", tsoak)):
        recs[name] = mod.run_soak(
            streams=40, seconds=SECONDS, device="stub", kitchen_sink=True,
            clips_dir=str(tmp_path / name), hit_stride=4, sim_mqtt_ms=1.0,
            sim_alert_ms=1.0, **STUB)
    _same_shape(recs["port"], recs["jax"])
    for rec in recs.values():
        _invariants(rec)
    aux = recs["port"]["aux_planes"]
    assert aux["aux_errors"] == 0 and aux["spectrograms_dropped"] == 0
    assert aux["range_rebuilds"] == 0
    for key in ("hls_segments", "soundlevel_blocks", "lufs_blocks",
                "spectrograms_rendered"):
        assert aux[key] > 0, (key, aux)
    mig = aux["migration"]
    assert mig["state"] == "migrating" and mig["migrated_records"] > 0
    assert mig["total_records"] == 150_000
    assert mig["dual_write"]["enabled"] and mig["dual_write"]["installed"]


def _tiny_classifier(device):
    """The tiny float32 v2.4 of ``train --tiny`` at the full 6,522-class
    head, one class's bias raised so that every window's top-1 clears the
    default threshold: one detection per stream."""
    model = tcli._tiny_v24(6522).init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.backbone.classifier.b.fill_(-8.0)
        model.backbone.classifier.b[17] = 8.0
    return TorchClassifier(model, device)


def test_cpu_soak_serves_the_classifier(tmp_path, monkeypatch):
    """``device="cpu"``: the port's device leg on the tiny net. Every
    window reaches the processor, the detections reach the datastore, the
    record's calibration entry counts the batches (no mel kernel on the
    CPU), and each batch's top-10 equals ``predict_topk`` on its PCM."""
    monkeypatch.setattr(tsoak, "soak_classifier", _tiny_classifier)
    launched, collected = [], []
    launch, collect = (tloop.TorchModelBatcher._launch,
                       tloop.TorchModelBatcher._collect)

    def spy_launch(self, staged, n):
        launched.append((staged[:n].copy(), self.sensitivity))
        return launch(self, staged, n)

    def spy_collect(self, handle, meta):
        out = collect(self, handle, meta)
        collected.append(out[:2])
        return out

    monkeypatch.setattr(tloop.TorchModelBatcher, "_launch", spy_launch)
    monkeypatch.setattr(tloop.TorchModelBatcher, "_collect", spy_collect)
    db = tmp_path / "soak.db"
    rec = tsoak.run_soak(streams=48, seconds=SECONDS, device="cpu",
                         db_path=str(db), action_mix="db",
                         sample_seconds=2.0)
    assert rec["device"] == "cpu"
    da = rec["drop_accounting"]
    assert da["farm_samples_lost"] == da["scheduler_windows_dropped"] == 0
    assert rec["windows_processed"] > 0
    assert rec["processor"]["windows_submitted"] == rec["windows_processed"]
    cal = rec["calibration"]
    assert cal["mode"] == "device step (cpu)" and cal["card"] is None
    assert cal["mel_kernel_launches"] == 0
    assert cal["batches_dispatched"] == len(launched) == len(collected) > 0
    persisted = rec["actions"]["detections_persisted"]
    assert persisted == rec["actions"]["approved"] > 0
    conn = sqlite3.connect(str(db))
    rows = conn.execute("SELECT scientific_name, COUNT(*) FROM detections"
                        " GROUP BY scientific_name").fetchall()
    conn.close()
    assert sum(n for _, n in rows) == persisted and len(rows) == 1
    clf = _tiny_classifier("cpu")
    for (pcm, sensitivity), (vals, idx) in zip(launched, collected):
        n = len(pcm)
        want_v, want_i = clf.predict_topk(pcm16_to_float32(
            torch.from_numpy(pcm)), sensitivity, 10)
        np.testing.assert_allclose(vals[:n], want_v, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(idx[:n], want_i)
        assert (idx[:n, 0] == 17).all()


def test_rtsp_cpu_soak_serves_four_sessions(tmp_path, monkeypatch):
    """``ingest="rtsp"`` on ``device="cpu"`` (JAX's refuses only its TPU;
    the port also serves the leg on the card): four realtime L16 sessions
    from the load server through the native demux into the tiny net's
    step. All four connected at the end, none restarted, nothing dropped
    by the server or the rings, every sample sent received but 0.25 s a
    session still in flight, every window to the processor."""
    monkeypatch.setattr(tsoak, "soak_classifier", _tiny_classifier)
    rec = tsoak.run_soak(streams=4, seconds=SECONDS, device="cpu",
                         ingest="rtsp", db_path=str(tmp_path / "soak.db"),
                         action_mix="db", sample_seconds=2.0)
    ing = rec["ingest"]
    assert ing["type"] == "rtsp" and ing["connected_at_end"] == 4, ing
    assert ing["session_restarts"] == 0, ing
    assert ing["samples_dropped_by_server"] == 0, ing
    assert ing["samples_received"] >= ing["samples_sent"] - 0.25 * 48000 * 4
    da = rec["drop_accounting"]
    assert da["farm_samples_lost"] == da["scheduler_windows_dropped"] == 0
    assert da["jobqueue_dropped_critical"] == 0
    assert rec["windows_processed"] > 0
    assert rec["processor"]["windows_submitted"] == rec["windows_processed"]
    assert rec["calibration"]["batches_dispatched"] > 0


def test_durable_cpu_soak_floors_at_the_calibrated_threshold(
        tmp_path, monkeypatch):
    """``device="cpu"``, durable, calibrated: the port's durable device
    mode (JAX ran durable mode on the stub only). The calibration raises
    the dynamic floor to the calibrated threshold; a threshold already in
    the database is restored at start with its level and persisted again;
    every approval is persisted."""
    from birdnet_go_tpu_torch.analysis.dynamic_threshold import \
        ThresholdState

    monkeypatch.setattr(tsoak, "soak_classifier", _tiny_classifier)
    db = tmp_path / "soak.db"
    store = Datastore(str(db))
    try:
        store.save_dynamic_thresholds({("BirdNET_V2.4", "Turdus merula"):
                                       ThresholdState(
            level=2, high_conf_count=2, expires_at=time.time() + 3600,
            last_learned_at=time.time())})
    finally:
        store.close()
    # at 8x real time 200 streams offer the calibration's 1,024 windows a
    # pass within a second
    rec = tsoak.run_soak(streams=200, timescale=8.0, seconds=SECONDS,
                         device="cpu", db_path=str(db), durable=True,
                         persist_interval_s=1.0, calibrate_rate=0.015,
                         sample_seconds=2.0)
    thr = rec["calibration"]["threshold_calibration"]
    assert thr["trigger"] == 0.9
    assert thr["threshold"] is not None
    assert thr["dynamic_floor"] == thr["threshold"]
    assert rec["durable"]["persist_interval_s"] == 1.0
    assert rec["durable"]["thresholds_restored"] == 1
    assert rec["durable"]["restored_levels"] == [
        ["BirdNET_V2.4", "Turdus merula", 2]]
    assert rec["drop_accounting"]["jobqueue_dropped_critical"] == 0
    acts = rec["actions"]
    store = Datastore(str(db))
    try:
        assert store.count_detections() == acts["detections_persisted"] \
            == acts["approved"]
        saved = store.load_dynamic_thresholds()
    finally:
        store.close()
    assert len(saved) == rec["durable"]["thresholds_persisted"] >= 1
    assert saved[("BirdNET_V2.4", "Turdus merula")].level == 2


def _captured(monkeypatch, mod):
    """Replace `mod.run_soak` by a recorder returning a clean record."""
    calls = []

    def fake(**kw):
        calls.append(kw)
        lost = kw.get("streams") == 13
        return {"drop_accounting": {
            "farm_samples_lost": 5 if lost else 0,
            "scheduler_windows_dropped": 0,
            "jobqueue_dropped_critical": 0}}

    monkeypatch.setattr(mod, "run_soak", fake)
    return calls


FLAGS = ["--streams", "40", "--seconds", "3", "--max-batch", "64",
         "--models", "BirdNET_V2.4", "--action-mix", "db", "--hit-stride",
         "4", "--burst-at", "1", "--burst-seconds", "2", "--burst-stride",
         "8", "--sim-mqtt-ms", "2", "--sim-alert-ms", "1", "--min-tick-ms",
         "0", "--durable", "--persist-interval", "5", "--calibrate-rate",
         "0.02", "--stall-at", "1", "--stall-seconds", "1",
         "--kitchen-sink"]


@pytest.mark.parametrize("device", ["stub", "cpu"])
def test_soak_cli_flags_reach_run_soak_as_in_jax(device, monkeypatch,
                                                 capsys, tmp_path):
    """``python -m birdnet_go_tpu_torch soak`` and the soak module's own
    ``main`` hand ``run_soak`` JAX's arguments for the stub; the device
    modes tick at 100 ms with the adaptive floor and calibrate at 0.015
    unless told otherwise. The exit code is the soak's check."""
    jcalls = _captured(monkeypatch, jsoak)
    tcalls = _captured(monkeypatch, tsoak)
    out = str(tmp_path / "rec.json")
    assert jsoak.main([*FLAGS, "--device", "stub", "--out", out]) == 0
    assert tcli.main(["soak", *FLAGS, "--device", device, "--out",
                      out]) == 0
    assert tsoak.main([*FLAGS, "--device", device]) == 0
    want = dict(jcalls[0], device=device)
    assert tcalls[0] == tcalls[1] == want
    assert want["tick_ms"] == 100 and want["calibrate_rate"] == 0.02
    assert want["kitchen_sink"] is True
    assert len(json.loads(open(out).read())["runs"]) == 2
    assert tcli.main(["soak", "--device", device]) == 0
    assert tcalls[2]["calibrate_rate"] == (0.015 if device == "cpu"
                                           else None)
    assert tcalls[2]["tick_ms"] == 100 and tcalls[2]["min_tick_ms"] == 15
    assert tcli.main(["soak", "--device", device, "--streams", "13"]) == 1
    parser = argparse.ArgumentParser()
    tsoak.add_arguments(parser)
    assert parser.parse_args([]).device == "cuda"


def test_soak_refuses_what_is_not_ported_or_stub_only():
    with pytest.raises(ValueError, match="single-model"):
        tsoak.run_soak(streams=4, seconds=1.0, device="stub", ingest="rtsp",
                       models=("BirdNET_V2.4", "Perch_V2"))
    with pytest.raises(ValueError, match="single-model"):
        tsoak.run_soak(streams=4, seconds=1.0, device="cpu",
                       models=("BirdNET_V2.4", "Perch_V2"))
    with pytest.raises(ValueError, match="unknown soak device"):
        tsoak.run_soak(streams=4, seconds=1.0, device="tpu")
    with pytest.raises(ValueError, match="unknown ingest"):
        tsoak.run_soak(streams=4, seconds=1.0, device="stub", ingest="x")


def test_stub_batcher_defaults_are_the_cards(monkeypatch):
    """The stub's default latency model is the card's measured step, not
    JAX's TPU figures; the rest of the stub is JAX's."""
    assert (tsoak.STUB_BASE_MS, tsoak.STUB_PER_WINDOW_US) != (8.4, 33.0)
    assert "H100" in tsoak.STUB_SOURCE and " W" in tsoak.STUB_SOURCE
    from birdnet_go_tpu_torch.models.registry import MODEL_REGISTRY

    spec = MODEL_REGISTRY["BirdNET_V2.4"]
    b = tsoak.CalibratedStubBatcher(spec, max_batch=8)
    assert (b.base_ms, b.per_window_us) == (tsoak.STUB_BASE_MS,
                                            tsoak.STUB_PER_WINDOW_US)
    j = jsoak.CalibratedStubBatcher(spec, max_batch=8, base_ms=0.0,
                                    per_window_us=0.0)
    t = tsoak.CalibratedStubBatcher(spec, max_batch=8, base_ms=0.0,
                                    per_window_us=0.0)
    meta = [tloop.PendingWindow(f"farm:{i}", 0.0, 3.0) for i in range(8)]
    for got, want in zip(t._collect(t._launch(t._staged, 8), meta)[:2],
                         j._collect(j._launch(j._staged, 8), meta)[:2]):
        np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
