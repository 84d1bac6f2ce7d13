"""Command line of the PyTorch port: analyze / benchmark / rangefilter /
train / model / verify-artifact (ports of those commands of
``birdnet_go_tpu/cli/main.py``).

    python -m birdnet_go_tpu_torch analyze recording.wav
    python -m birdnet_go_tpu_torch analyze recordings/ --device cpu
    python -m birdnet_go_tpu_torch analyze rec.wav --checkpoint model.tflite
    python -m birdnet_go_tpu_torch train dataset/ --output ckpt/
    python -m birdnet_go_tpu_torch model list
    python -m birdnet_go_tpu_torch verify-artifact model.tflite

Global flags mirror the reference's persistent flags (cmd/root.go:86-106):
threshold, sensitivity, overlap, locale, latitude/longitude. Output lines
and exit codes are the JAX CLI's. Every command that computes runs on the
CUDA card unless ``--device`` names another device; without a card it
stops with an error rather than run on the CPU. ``model`` only moves files.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from birdnet_go_tpu_torch.analysis.offline import (
    OfflineAnalyzer,
    OfflineConfig,
)
from birdnet_go_tpu_torch.analysis.raven import write_csv, write_raven_table
from birdnet_go_tpu_torch.inference.backend import (
    TorchClassifier,
    TorchRangeFilter,
    range_mask,
)
from birdnet_go_tpu_torch.inference.loader import (
    geomodel_weights_installed,
    load_geomodel,
    load_model,
)
from birdnet_go_tpu_torch.inference.checkpoint import save_params
from birdnet_go_tpu_torch.inference.opaudit import audit_table
from birdnet_go_tpu_torch.inference.verify_artifact import verify_artifact
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.catalog import (
    ModelManager,
    catalog_entries,
    get_entry,
)
from birdnet_go_tpu_torch.models.efficientnet import (
    BlockSpec,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.models.geomodel import birdnet_week
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.ops.precision import full_float32
from birdnet_go_tpu_torch.taxonomy.labels import load_labels
from birdnet_go_tpu_torch.train.dataset import load_directory_dataset
from birdnet_go_tpu_torch.train.trainer import (
    evaluate,
    init_train_state,
    make_eval_step,
    make_train_step,
)

_LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="birdnet-tpu-torch",
        description="Bioacoustic analysis (BirdNET-class models) with "
                    "PyTorch on a CUDA card")
    p.add_argument("--debug", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(sp):
        sp.add_argument("--device", type=torch.device, default="cuda",
                        help="torch device to run on (default cuda; "
                             "cpu runs on the CPU)")

    def common_model_flags(sp):
        sp.add_argument("--model", default="BirdNET_V2.4",
                        help="model family id (default BirdNET_V2.4)")
        sp.add_argument("--checkpoint", default=None,
                        help="a .tflite or .onnx model file, or a "
                             "directory holding params.npz (as train "
                             "writes), to serve (default: the installed "
                             "model, else random init; an orbax "
                             "checkpoint raises)")
        sp.add_argument("--sensitivity", type=float, default=1.0,
                        help="sigmoid sensitivity 0.0-1.5 (default 1.0)")
        sp.add_argument("--threshold", type=float, default=0.8,
                        help="confidence threshold (default 0.8)")
        sp.add_argument("--overlap", type=float, default=0.0,
                        help="window overlap seconds on 3 s base (0-2.9)")
        sp.add_argument("--locale", default="en_us")
        sp.add_argument("--data-dir", default=None,
                        help="taxonomy/label data directory")
        sp.add_argument("--latitude", type=float, default=None)
        sp.add_argument("--longitude", type=float, default=None)
        device_flag(sp)

    a = sub.add_parser("analyze", help="offline analysis of WAV file(s)")
    a.add_argument("input", help="WAV file or directory")
    a.add_argument("--output", default="output",
                   help="output directory for Raven tables (default output/)")
    a.add_argument("--batch-size", type=int, default=64)
    a.add_argument("--all-results", action="store_true",
                   help="emit every top-K result above threshold per window")
    a.add_argument("--rtype", choices=["table", "csv", "both"],
                   default="table",
                   help="output format: Raven table (default), CSV, or both")
    common_model_flags(a)

    b = sub.add_parser("benchmark", help="device inference throughput")
    b.add_argument("--batch-size", type=int, default=256)
    b.add_argument("--iters", type=int, default=10)
    common_model_flags(b)

    r = sub.add_parser("rangefilter",
                       help="print included species for a location")
    r.add_argument("--week", type=int, default=-1,
                   help="BirdNET week 1-48, -1 = today")
    r.add_argument("--rf-threshold", type=float, default=0.01)
    r.add_argument("--csv", action="store_true")
    common_model_flags(r)

    t = sub.add_parser("train", help="train a custom classifier")
    t.add_argument("dataset", help="directory-per-species WAV dataset root")
    t.add_argument("--output", default="data/models/Custom",
                   help="checkpoint output dir")
    t.add_argument("--epochs", type=int, default=10)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--learning-rate", type=float, default=1e-3)
    t.add_argument("--tiny", action="store_true",
                   help="tiny backbone (fast smoke runs / tests)")
    t.add_argument("--val-split", type=float, default=0.1,
                   help="stratified validation fraction (0 disables)")
    common_model_flags(t)

    mdl = sub.add_parser("model", help="model gallery: list/install/remove")
    mdl.add_argument("action", choices=["list", "install", "remove"])
    mdl.add_argument("model_id", nargs="?")
    mdl.add_argument("--from-file", default=None,
                     help="install from a local .tflite/.onnx artifact")

    va = sub.add_parser(
        "verify-artifact",
        help="import a .tflite/.onnx artifact, fingerprint its outputs "
             "on a deterministic input, diff a Raven table against the "
             "recorded golden (record-on-first-run), and audit op "
             "coverage — one-command real-weight parity readiness")
    va.add_argument("artifact", nargs="?", default=None,
                    help=".tflite or .onnx file (omit with --audit)")
    va.add_argument("--wav", default=None,
                    help="also analyze this WAV and diff the Raven table")
    va.add_argument("--golden", default="data/golden_artifacts/torch",
                    help="golden dir (fingerprints + Raven fixtures, "
                         "keyed by artifact sha256; the port's own)")
    va.add_argument("--no-golden", action="store_true",
                    help="compute only; skip golden record/compare")
    va.add_argument("--model-id", default="BirdNET_V2.4",
                    help="family registry entry for the analyze leg")
    va.add_argument("--audit", action="store_true",
                    help="print the op-inventory audit (expected family "
                         "ops vs importer tables) and exit")
    device_flag(va)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO,
                        format=_LOG_FORMAT)
    device = getattr(args, "device", None)      # `model` computes nothing
    if device is not None and device.type == "cuda" \
            and not torch.cuda.is_available():
        print(f"error: no CUDA card (torch.cuda.is_available() is false); "
              f"pass --device cpu to run {args.command} on the CPU",
              file=sys.stderr)
        return 1
    return {"analyze": _cmd_analyze, "benchmark": _cmd_benchmark,
            "rangefilter": _cmd_rangefilter, "train": _cmd_train,
            "model": _cmd_model,
            "verify-artifact": _cmd_verify_artifact}[args.command](args)


def _load_classifier(args) -> TorchClassifier:
    return TorchClassifier(load_model(args.model, checkpoint=args.checkpoint),
                           args.device)


def _range_mask_if_located(args, num_species):
    """Build the included-species mask when a location is configured
    (reference: BuildRangeFilter at startup, range_filter.go:100)."""
    if args.latitude is None or args.longitude is None:
        return None
    rf = TorchRangeFilter(load_geomodel(num_species=num_species),
                          args.device)
    week = birdnet_week(datetime.date.today())
    return range_mask(rf, args.latitude, args.longitude, week,
                      threshold=getattr(args, "rf_threshold", 0.01))


def _cmd_analyze(args) -> int:
    clf = _load_classifier(args)
    mask = _range_mask_if_located(args, clf.num_species)
    if mask is not None:
        clf.set_range_mask(mask)
    labels = load_labels(args.data_dir, locale=args.locale,
                         model_id=args.model,
                         expected_count=clf.num_species)
    if len(labels) != clf.num_species:
        print(f"warning: label count {len(labels)} != model outputs "
              f"{clf.num_species}", file=sys.stderr)
    analyzer = OfflineAnalyzer(clf, labels, OfflineConfig(
        threshold=args.threshold, sensitivity=args.sensitivity,
        overlap=args.overlap, batch_size=args.batch_size,
        all_results=args.all_results))

    inp = Path(args.input)
    files = sorted(inp.glob("*.wav")) if inp.is_dir() else [inp]
    if not files:
        print(f"no WAV files under {inp}", file=sys.stderr)
        return 1
    failures = 0
    for f in files:
        try:
            report = analyzer.analyze_file(f)
        except (ValueError, OSError) as e:
            print(f"{f}: {e}", file=sys.stderr)
            failures += 1
            continue
        outs = []
        if args.rtype in ("table", "both"):
            outs.append(write_raven_table(report.detections, f, args.output))
        if args.rtype in ("csv", "both"):
            outs.append(write_csv(report.detections, f, args.output))
        print(f"{f.name}: {report.duration_seconds:.0f}s audio, "
              f"{len(report.windows)} windows, "
              f"{len(report.detections)} detections in "
              f"{report.elapsed_seconds:.2f}s "
              f"({report.realtime_factor:.0f}x realtime)")
        for out in outs:
            print(f"Output written to {out}")
    return 1 if failures else 0


def _cmd_benchmark(args) -> int:
    """Inference latency/throughput stats (reference: cmd/benchmark +
    cmd/perch-benchmark — warmup then mean/median/p95 per batch). Each
    batch goes from host memory to the device and its top-10 back, as in
    the JAX command."""
    clf = _load_classifier(args)
    clip = clf.model.spec.clip_samples
    rng = np.random.default_rng(0)
    pcm = rng.standard_normal((args.batch_size, clip)).astype(np.float32) * .05
    for _ in range(2):
        clf.predict_topk(pcm)                  # warmup
    lat = []
    for i in range(args.iters):
        # perturb so no layer can serve a cached execution
        pcm[0, 0] = np.float32(i) * 1e-6
        t0 = time.perf_counter()
        clf.predict_topk(pcm)
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1000.0
    wps = args.batch_size / np.mean(lat)
    hop = clf.model.spec.buffer_interval_seconds
    print(json.dumps({
        "model": args.model,
        "batch": args.batch_size,
        "iters": args.iters,
        "batch_latency_ms": {
            "mean": round(float(np.mean(lat_ms)), 1),
            "median": round(float(np.median(lat_ms)), 1),
            "p95": round(float(np.percentile(lat_ms, 95)), 1),
        },
        "windows_per_second": round(float(wps), 1),
        "realtime_streams": round(float(wps * hop), 1),
    }))
    return 0


def _cmd_rangefilter(args) -> int:
    if args.latitude is None or args.longitude is None:
        print("rangefilter requires --latitude and --longitude",
              file=sys.stderr)
        return 1
    labels = load_labels(args.data_dir, locale=args.locale)
    g = load_geomodel(num_species=len(labels))
    if not geomodel_weights_installed():
        # in the OUTPUT, not just the log: random-init scores are
        # plausible-looking nonsense
        print("WARNING: no geomodel weights installed — scores below are "
              "deterministic random init, NOT real species occurrence.",
              file=sys.stderr)
        if not args.csv:
            print("[random-init geomodel — output is not field-accurate]")
    rf = TorchRangeFilter(g, args.device)
    week = args.week if args.week > 0 else birdnet_week(datetime.date.today())
    scores = rf.predict(args.latitude, args.longitude, week)
    rows = [(labels[i], float(s)) for i, s in enumerate(scores)
            if s >= args.rf_threshold]
    rows.sort(key=lambda r: -r[1])
    if args.csv:
        print("scientific_name,common_name,score")
        for sp, s in rows:
            print(f"{sp.scientific},{sp.common},{s:.4f}")
    else:
        print(f"{len(rows)} species probable at "
              f"({args.latitude}, {args.longitude}) week {week}:")
        for sp, s in rows[:50]:
            print(f"  {s:.3f}  {sp.common} ({sp.scientific})")
        if len(rows) > 50:
            print(f"  ... and {len(rows) - 50} more (use --csv for all)")
    return 0


def _tiny_v24(n_classes: int) -> BirdNETv24:
    """The float32 v2.4 of ``train --tiny``: a 32-band mel at hop 4096 and
    two narrow MBConv stages."""
    return BirdNETv24(
        num_species=n_classes,
        mel=MelConfig(sample_rate=48000, n_fft=512, hop=4096, n_mels=32),
        compute_dtype=torch.float32,
        net=EfficientNetConfig(
            blocks=(BlockSpec(1, 8, 3, 2, 1), BlockSpec(4, 16, 3, 2, 1)),
            embedding_dim=32, num_classes=n_classes))


def _cmd_train(args) -> int:
    full = load_directory_dataset(args.dataset, device=args.device)
    n_classes = len(full.class_names)
    ds, val = full.split(args.val_split) if args.val_split > 0 \
        else (full, None)
    print(f"dataset: {len(ds)} train / {len(val) if val else 0} val "
          f"windows, {n_classes} classes: {full.class_names}")

    model = (_tiny_v24(n_classes) if args.tiny
             else BirdNETv24(num_species=n_classes))
    model.init(torch.Generator().manual_seed(0)).to(args.device)
    state = init_train_state(model, args.learning_rate)
    # BN in inference mode during training: batch-norm acts as a learnable
    # affine, so the trained params behave identically at inference time
    # (no running-stat updates needed — the standard fine-tuning recipe)
    train_step = make_train_step(model.apply, train=False)
    # a float32 model keeps cuDNN's convolutions off TF32, as JAX's float32
    precision = (full_float32 if model.compute_dtype == torch.float32
                 else contextlib.nullcontext)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(args.device)

    step = 0
    with precision():
        for pcm, labels in ds.batches(args.batch_size, epochs=args.epochs):
            state, metrics = train_step(state, to_dev(pcm), to_dev(labels))
            step += 1
            if step % 10 == 1:
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.3f}")
        if val is not None and len(val):
            m = evaluate(make_eval_step(model.apply), val,
                         batch_size=min(args.batch_size, len(val)),
                         device=args.device)
            print(f"validation: accuracy={m['accuracy']:.3f} "
                  f"loss={m['loss']:.4f} (n={m['n']})")
    out = Path(args.output)
    save_params(model, out)
    (out / "labels.json").write_text(json.dumps(full.class_names))
    print(f"trained {step} steps; checkpoint + labels written to {out}")
    return 0


def _cmd_model(args) -> int:
    mgr = ModelManager()
    if args.action == "list":
        installed = {m["model_id"] for m in mgr.installed()}
        print(f"{'model':<18} {'installed':<10} description")
        for e in catalog_entries():
            mark = "yes" if e.model_id in installed else "-"
            print(f"{e.model_id:<18} {mark:<10} {e.description}")
        return 0
    if not args.model_id:
        print("model id required", file=sys.stderr)
        return 1
    if args.action == "remove":
        ok = mgr.remove(args.model_id)
        print("removed" if ok else "not installed")
        return 0 if ok else 1
    # install
    if args.from_file:
        dest = mgr.install_from_file(args.model_id, args.from_file)
        print(f"installed to {dest}")
        return 0
    entry = get_entry(args.model_id)
    if entry is None:
        print(f"unknown model {args.model_id}", file=sys.stderr)
        return 1
    try:
        dest = mgr.install_from_url(entry)
    except ValueError as e:
        print(f"install failed: {e}", file=sys.stderr)
        return 1
    print(f"installed to {dest}")
    return 0


def _cmd_verify_artifact(args) -> int:
    if args.audit or args.artifact is None:
        print(audit_table())
        if args.artifact is None:
            return 0
    rep = verify_artifact(
        args.artifact, wav=args.wav,
        golden_dir=None if args.no_golden else args.golden,
        model_id=args.model_id, device=args.device)
    print(f"artifact    {rep.artifact}")
    print(f"sha256      {rep.sha256}")
    print(f"format      {rep.format}")
    print(f"ops         {sum(rep.ops.values())} nodes, "
          f"{len(rep.ops)} kinds: "
          + ", ".join(f"{k}×{v}" for k, v in rep.ops.items()))
    print(f"inputs      {rep.input_shapes}")
    print(f"outputs     {rep.output_shapes}")
    print(f"fingerprint {rep.fingerprint}")
    print(f"golden      {rep.golden_status}")
    print(f"raven       {rep.raven_status}")
    for d in rep.details:
        print(f"  · {d}")
    print("PASS" if rep.ok else "FAIL")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
