"""Op-inventory audit: published model-family op sets vs importer tables.

A copy of ``birdnet_go_tpu/inference/opaudit.py`` that reads the port's
importer tables.

The real BirdNET/Perch/geomodel weights are not reachable in this
environment (reference embeds them at build time —
the reference's internal/classifier/models_embedded.go:14-22 declares the
embed directives with no binaries in-tree), so full-graph parity cannot
be executed here. What CAN be audited ahead of time is op coverage: each
family's published architecture implies a TFLite/ONNX op inventory; if
every op is in the importer's dispatch table, the day an artifact is
reachable `verify-artifact` is one command away from a parity verdict.

Sources for the expected inventories (no network access — these are the
ops implied by the published architectures, conservatively over-listed):
- BirdNET v2.4 (audio-spectrogram EfficientNet variant with an in-graph
  mel front end — reference model docs; classifier/model.go builds the
  48 kHz/3 s input contract, tflite.go runs the flatbuffer): framing +
  RFFT2D + COMPLEX_ABS mel front end, conv/dwconv/dense backbone with
  fused activations, sigmoid head.
- BirdNET range/geo model (MData v2.4 fp16: sinusoidal week encoding +
  MLP — reference rangefilter docs, models_embedded.go mdata directive).
- Perch v2 (EfficientNet-B1-like backbone, frame-based mel front end —
  Google Bird Vocalization Classifier model card; reference
  model_registry.go perch entry).
- BirdNET v2.4 INT8 / ARM64 variants (same graph + QUANTIZE/DEQUANTIZE,
  per-channel — reference model_catalog.go int8 artifacts).
- BSG Finland v4.4 ONNX (conv/BN/activation CNN exported from torch —
  reference model_registry.go BSG entry; QDQ pairs on the int8 export).
"""

from __future__ import annotations

import dataclasses

# TFLite builtin-op names per family (tflite_import.Op names)
TFLITE_EXPECTED: dict[str, tuple[str, ...]] = {
    "BirdNET_V2.4": (
        # mel front end (in-graph signal path)
        "RESHAPE", "EXPAND_DIMS", "STRIDED_SLICE", "CONCATENATION",
        "MUL", "RFFT2D", "COMPLEX_ABS", "POW", "ADD", "LOG", "CAST",
        "TRANSPOSE", "PAD",
        # backbone + head
        "CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED",
        "AVERAGE_POOL_2D", "MAX_POOL_2D", "MEAN", "RELU", "LOGISTIC",
        "HARD_SWISH", "SUB", "DIV", "SQUEEZE",
    ),
    "BirdNET_V2.4_INT8": (
        "QUANTIZE", "DEQUANTIZE", "CONV_2D", "DEPTHWISE_CONV_2D",
        "FULLY_CONNECTED", "AVERAGE_POOL_2D", "MEAN", "RESHAPE",
        "CONCATENATION", "ADD", "MUL", "LOGISTIC",
    ),
    "BirdNET_GeoModel_V2.4": (
        "FULLY_CONNECTED", "SIN", "COS", "MUL", "ADD", "CONCATENATION",
        "RELU", "LOGISTIC", "DEQUANTIZE",        # fp16 weight dequant
        "RESHAPE", "PACK", "STRIDED_SLICE",
    ),
    "Perch_V2": (
        "RESHAPE", "EXPAND_DIMS", "MUL", "RFFT2D", "COMPLEX_ABS",
        "POW", "ADD", "LOG", "CONV_2D", "DEPTHWISE_CONV_2D",
        "FULLY_CONNECTED", "MEAN", "LOGISTIC", "HARD_SWISH",
        "AVERAGE_POOL_2D", "PAD", "SQUEEZE", "BATCH_MATMUL",
        "RSQRT", "SQUARED_DIFFERENCE", "TRANSPOSE", "CONCATENATION",
    ),
}

# ONNX op types per family
ONNX_EXPECTED: dict[str, tuple[str, ...]] = {
    "BSG_Finland_V4.4": (
        "Conv", "BatchNormalization", "Relu", "Sigmoid", "MaxPool",
        "AveragePool", "GlobalAveragePool", "Gemm", "MatMul", "Add",
        "Mul", "Reshape", "Flatten", "Transpose", "Concat", "Softmax",
        "Dropout", "Identity",
    ),
    "BSG_Finland_V4.4_INT8": (
        "QuantizeLinear", "DequantizeLinear", "Conv", "Gemm", "Relu",
        "MaxPool", "Reshape", "Flatten",
    ),
    # opset-17 exports that keep the mel front end in-graph
    "ONNX_mel_frontend": (
        "STFT", "HannWindow", "MelWeightMatrix", "MatMul", "Pow",
        "Add", "Log", "Transpose", "Unsqueeze",
    ),
}


@dataclasses.dataclass
class AuditRow:
    family: str
    format: str                  # "tflite" | "onnx"
    expected: int
    supported: int
    missing: tuple[str, ...]

    @property
    def ready(self) -> bool:
        return not self.missing


def audit() -> list[AuditRow]:
    """Coverage of each family's expected op inventory by the importer
    dispatch tables. A non-empty `missing` means the family's real
    artifact would fail import today."""
    from birdnet_go_tpu_torch.inference import onnx_import, tflite_import

    tfl_names = {tflite_import.Op(c).name
                 for c in tflite_import.supported_ops()}
    onnx_names = set(onnx_import.supported_ops())
    rows: list[AuditRow] = []
    for fam, ops in TFLITE_EXPECTED.items():
        missing = tuple(o for o in ops if o not in tfl_names)
        rows.append(AuditRow(fam, "tflite", len(ops),
                             len(ops) - len(missing), missing))
    for fam, ops in ONNX_EXPECTED.items():
        missing = tuple(o for o in ops if o not in onnx_names)
        rows.append(AuditRow(fam, "onnx", len(ops),
                             len(ops) - len(missing), missing))
    return rows


def audit_table() -> str:
    """Markdown audit table (embedded in PARITY.md)."""
    lines = ["| Family | Format | Expected ops | Supported | Missing |",
             "|---|---|---|---|---|"]
    for r in audit():
        lines.append(
            f"| {r.family} | {r.format} | {r.expected} | {r.supported} |"
            f" {', '.join(r.missing) if r.missing else '— (ready)'} |")
    return "\n".join(lines)
