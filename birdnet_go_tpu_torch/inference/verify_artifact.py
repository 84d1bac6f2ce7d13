"""One-command real-artifact readiness: import → fingerprint → table diff
(port of ``birdnet_go_tpu/inference/verify_artifact.py``).

``python -m birdnet_go_tpu_torch verify-artifact <file>`` turns "the real
weights are reachable" into a parity verdict in one command:

1. import the artifact (.tflite/.onnx) through the port's readers and
   report its op inventory (an unsupported op fails here, named);
2. run the graph on `device` on a DETERMINISTIC seeded input and
   fingerprint the outputs (SHA-256 over round(out, 4) bytes — stable
   across runs, sensitive to any numeric drift beyond 1e-4);
3. with a WAV: run the port's offline analysis and write a Raven
   selection table;
4. compare 2-3 against the recorded golden for this artifact digest
   (record-on-first-run, byte diff after).

The seed, the probe shapes and the fingerprint rule are the JAX module's.
A fingerprint rounded to 1e-4 may differ between the two packages (or
between the card and the CPU) where an output lies near a rounding
boundary, so the port records and compares goldens of its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from birdnet_go_tpu_torch.analysis.offline import OfflineAnalyzer
from birdnet_go_tpu_torch.analysis.raven import format_raven_table
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.inference.loader import ImportedModel
from birdnet_go_tpu_torch.inference.onnx_import import load_onnx
from birdnet_go_tpu_torch.inference.tflite_import import Op, load_tflite
from birdnet_go_tpu_torch.taxonomy.labels import load_labels


@dataclasses.dataclass
class Report:
    artifact: str
    sha256: str
    format: str
    ops: dict[str, int]
    input_shapes: list[tuple]
    output_shapes: list[tuple]
    fingerprint: str
    golden_status: str          # recorded | match | MISMATCH | skipped
    raven_status: str           # recorded | match | MISMATCH | skipped
    details: list[str]

    @property
    def ok(self) -> bool:
        return "MISMATCH" not in (self.golden_status, self.raven_status)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _load(path: Path):
    """(graph, format, op_counts). Import errors propagate — an
    unsupported op IS the audit result."""
    if path.suffix == ".tflite":
        g = load_tflite(str(path))
        counts: dict[str, int] = {}
        for op in g.model.ops:
            name = Op(op.opcode).name if op.opcode in set(Op) \
                else str(op.opcode)
            counts[name] = counts.get(name, 0) + 1
        return g, "tflite", counts
    if path.suffix == ".onnx":
        g = load_onnx(str(path))
        counts = {}
        for node in g.graph.nodes:
            counts[node.op_type] = counts.get(node.op_type, 0) + 1
        return g, "onnx", counts
    raise ValueError(f"unknown artifact format {path.suffix!r} "
                     "(expected .tflite or .onnx)")


def _runtime_input_shapes(g, fmt) -> list[tuple]:
    if fmt == "tflite":
        return [tuple(g.model.tensors[i].shape) for i in g.model.inputs
                if g.model.tensors[i].data is None]
    # onnx: declared value_info shapes when present, else a 48 kHz/3 s
    # PCM row (the family input contract) as the probe fallback
    return [tuple(g.graph.input_shapes.get(n) or (1, 144000))
            for n in g.graph.inputs]


def _seeded_inputs(shapes: list[tuple]) -> list[np.ndarray]:
    rng = np.random.default_rng(20240824)
    out = []
    for shp in shapes:
        concrete = tuple(max(1, int(d)) if d and int(d) > 0 else 1
                         for d in shp) or (1,)
        out.append(rng.standard_normal(concrete).astype(np.float32))
    return out


def verify_artifact(path: str | Path, wav: str | None = None,
                    golden_dir: str | Path | None = None,
                    model_id: str = "BirdNET_V2.4",
                    device: torch.device | str = "cuda") -> Report:
    path = Path(path)
    digest = _sha256(path)
    details: list[str] = []
    g, fmt, op_counts = _load(path)
    g = g.to(device)
    shapes = _runtime_input_shapes(g, fmt)
    inputs = _seeded_inputs(shapes)
    with torch.inference_mode():
        outs = [o.cpu().numpy() for o in g(*inputs)]
    fp = hashlib.sha256()
    for o in outs:
        fp.update(np.round(np.asarray(o, np.float64), 4).tobytes())
    fingerprint = fp.hexdigest()
    details.append(f"outputs: {[o.shape for o in outs]}; "
                   f"first logits: "
                   f"{np.asarray(outs[0]).ravel()[:5].round(4).tolist()}")

    golden_status = raven_status = "skipped"
    gdir = Path(golden_dir) if golden_dir else None
    if gdir is not None:
        gdir.mkdir(parents=True, exist_ok=True)
        gfile = gdir / f"{digest}.json"
        if gfile.exists():
            rec = json.loads(gfile.read_text())
            golden_status = ("match" if rec["fingerprint"] == fingerprint
                             else "MISMATCH")
            if golden_status == "MISMATCH":
                details.append(f"fingerprint {fingerprint} != recorded "
                               f"{rec['fingerprint']}")
        else:
            gfile.write_text(json.dumps(
                {"artifact": path.name, "sha256": digest,
                 "fingerprint": fingerprint,
                 "output_shapes": [list(o.shape) for o in outs]},
                indent=1))
            golden_status = "recorded"

    if wav:
        model = ImportedModel(g, model_id)
        labels = load_labels(model_id=model_id,
                             expected_count=model.num_species or None)
        clf = TorchClassifier(model, device)
        report = OfflineAnalyzer(clf, labels).analyze_file(wav)
        table = format_raven_table(report.detections, Path(wav).name)
        details.append(f"{len(report.detections)} detections from {wav}")
        if gdir is not None:
            rfile = gdir / f"{digest}.raven.txt"
            if rfile.exists():
                raven_status = ("match" if rfile.read_text() == table
                                else "MISMATCH")
                if raven_status == "MISMATCH":
                    old = rfile.read_text().splitlines()
                    new = table.splitlines()
                    diff = [f"-{a} | +{b}" for a, b in zip(old, new)
                            if a != b][:10]
                    details.extend(diff)
            else:
                rfile.write_text(table)
                raven_status = "recorded"
        else:
            raven_status = "computed"

    return Report(artifact=str(path), sha256=digest, format=fmt,
                  ops=dict(sorted(op_counts.items())),
                  input_shapes=shapes,
                  output_shapes=[tuple(o.shape) for o in outs],
                  fingerprint=fingerprint, golden_status=golden_status,
                  raven_status=raven_status, details=details)
