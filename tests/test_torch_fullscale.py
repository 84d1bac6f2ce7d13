"""The port's importers on the three full-scale replicas, on the CPU.

The replicas of ``tests/test_fullscale_parity.py`` — the BirdNET v2.4
TFLite graph with its mel front end in the graph (seed 424, two-tone
input), the float16 MData range filter (seed 77) and the Perch v2-scale
ONNX graph (seed 99) — are built once each. The port meets:
- the JAX importer on the same bytes and inputs: rtol 1e-4, atol 1e-5
  (float32 sums in another order through 60-odd convolutions; the JAX
  tests hold their importer to rtol 2e-3, atol 2e-2 against a torch twin,
  and MData to rtol 1e-3, atol 1e-4);
- the goldens under ``tests/golden/``, read and never written, at the JAX
  tests' tolerances (atol 1e-4, rtol 1e-3; MData atol 1e-3).
The replica generators of ``birdnet_go_tpu_torch/diag/replicas.py``,
which the card's smoke runs without the FlatBuffers runtime, write at
batch 1 the models the test builders write: the JAX parser reads equal
ops, shapes and weight bytes from both, and the ONNX bytes are identical.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_go_tpu.inference.onnx_import import load_onnx as jload_onnx
from birdnet_go_tpu.inference.onnx_import import parse_onnx
from birdnet_go_tpu.inference.tflite_import import Op
from birdnet_go_tpu.inference.tflite_import import load_tflite as jload_tflite
from birdnet_go_tpu.inference.tflite_import import parse_tflite
from birdnet_go_tpu_torch.diag import replicas
from birdnet_go_tpu_torch.inference.onnx_import import load_onnx
from birdnet_go_tpu_torch.inference.tflite_import import load_tflite
from tests.onnx_builder import attr_int, attr_ints, model, node, tensor_proto
from tests.test_fullscale_parity import (
    build_mdata_fullscale,
    build_v24_fullscale,
)

GOLDEN = Path(__file__).parent / "golden"
RTOL, ATOL = 1e-4, 1e-5


def _perch_test_builder(rng):
    """``test_fullscale_perch_onnx_parity``'s graph, built as it builds it
    (with ``tests/onnx_builder.py``)."""
    n_sp, emb = 14795, 1280

    def t(name, shape, scale=None):
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        s = scale if scale is not None else np.sqrt(2.0 / max(fan, 1))
        return tensor_proto(name, (rng.standard_normal(shape) * s
                                   ).astype(np.float32))

    chans = [1, 64, 128, 256, 512]
    inits, nodes = [], []
    cur = "mel"
    for i in range(4):
        cin, cout = chans[i], chans[i + 1]
        inits += [t(f"c{i}_w", (cout, cin, 3, 3)),
                  t(f"c{i}_b", (cout,), 0.01),
                  t(f"c{i}_g", (cout,), 0.1), t(f"c{i}_be", (cout,), 0.01),
                  t(f"c{i}_m", (cout,), 0.01)]
        v = np.abs((rng.standard_normal((cout,)) * 0.0).astype(np.float32))
        inits.append(tensor_proto(f"c{i}_v", v + 1.0))
        nodes += [
            node("Conv", [cur, f"c{i}_w", f"c{i}_b"], [f"conv{i}"],
                 [attr_ints("strides", [2, 2]),
                  attr_ints("pads", [1, 1, 1, 1])]),
            node("BatchNormalization",
                 [f"conv{i}", f"c{i}_g", f"c{i}_be", f"c{i}_m",
                  f"c{i}_v"], [f"bn{i}"]),
            node("Relu", [f"bn{i}"], [f"act{i}"]),
        ]
        cur = f"act{i}"
    inits += [t("emb_w", (512, emb), 0.05), t("emb_b", (emb,), 0.01),
              t("head_w", (emb, n_sp), 0.02), t("head_b", (n_sp,), 0.01)]
    nodes += [
        node("GlobalAveragePool", [cur], ["gap"]),
        node("Flatten", ["gap"], ["flat"], [attr_int("axis", 1)]),
        node("Gemm", ["flat", "emb_w", "emb_b"], ["pre_emb"]),
        node("Relu", ["pre_emb"], ["embedding"]),
        node("Gemm", ["embedding", "head_w", "head_b"], ["logits"]),
    ]
    return model(nodes, inits, inputs=["mel"], outputs=["logits"])


@pytest.fixture(scope="module")
def replica_runs():
    """name → (test-builder bytes, port replica bytes, inputs, JAX output,
    port output): each replica built once."""
    runs = {}
    buf, _ = build_v24_fullscale(np.random.default_rng(424))
    mine = replicas.v24_tflite(np.random.default_rng(424))
    x = [replicas.two_tones()[None, :]]
    jg = jload_tflite(buf)
    runs["v24"] = (buf, mine, x, np.asarray(jg.apply(jg.params, *x)[0]),
                   load_tflite(buf)(*x)[0].numpy())
    del jg
    rng = np.random.default_rng(77)
    buf, _ = build_mdata_fullscale(rng)
    mine = replicas.mdata_tflite(np.random.default_rng(77))
    x = [rng.standard_normal((1, 96)).astype(np.float32)]
    jg = jload_tflite(buf)
    runs["mdata"] = (buf, mine, x, np.asarray(jg.apply(jg.params, *x)[0]),
                     load_tflite(buf)(*x)[0].numpy())
    rng = np.random.default_rng(99)
    buf = _perch_test_builder(rng)
    mine = replicas.perch_onnx(np.random.default_rng(99))
    x = [rng.standard_normal(replicas.PERCH_MEL).astype(np.float32)]
    jg = jload_onnx(buf)
    runs["perch"] = (buf, mine, x, np.asarray(jg.jitted()(jg.params, *x)[0]),
                     load_onnx(buf)(*x)[0].numpy())
    return runs


@pytest.mark.parametrize("name", ["v24", "mdata", "perch"])
def test_fullscale_replica_equals_jax_importer(replica_runs, name):
    buf, _, _, want, got = replica_runs[name]
    assert len(buf) > {"v24": 40, "mdata": 5, "perch": 70}[name] * 2**20
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def golden_check(name: str, values: np.ndarray, atol=1e-4, rtol=1e-3):
    """``tests/test_golden_parity.py::_golden_check``'s comparison, read
    only: the golden must exist."""
    want = json.loads((GOLDEN / f"{name}.json").read_text())
    flat = np.asarray(values, np.float64).ravel()
    idx = np.asarray(want["sample_idx"])
    assert want["shape"] == list(np.asarray(values).shape)
    np.testing.assert_allclose(np.linalg.norm(flat), want["norm"], rtol=rtol)
    np.testing.assert_allclose(flat[idx], want["sample"], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name, golden, atol", [
    ("v24", "v24_fullscale_replica_logits", 1e-4),
    ("mdata", "mdata_fullscale_scores", 1e-3),
    ("perch", "perch_fullscale_onnx_logits", 1e-4)])
def test_fullscale_replica_meets_golden(replica_runs, name, golden, atol):
    golden_check(golden, replica_runs[name][4], atol=atol)


@pytest.mark.parametrize("name", ["v24", "mdata", "perch"])
def test_replica_generator_writes_the_test_model(replica_runs, name):
    buf, mine = replica_runs[name][:2]
    if name == "perch":
        assert mine == buf
        a, b = parse_onnx(buf), parse_onnx(mine)
        assert [n.op_type for n in a.nodes] == [n.op_type for n in b.nodes]
        return
    a, b = parse_tflite(buf), parse_tflite(mine)
    assert (a.inputs, a.outputs) == (b.inputs, b.outputs)
    assert len(a.tensors) == len(b.tensors)
    for x, y in zip(a.tensors, b.tensors):
        assert (x.name, x.shape, x.dtype, x.buffer_index) == \
            (y.name, y.shape, y.dtype, y.buffer_index)
        assert (x.data is None) == (y.data is None)
        if x.data is not None:
            assert x.data.dtype == y.data.dtype
            assert x.data.tobytes() == y.data.tobytes()
    # ops, and every option field the importers read, with their defaults
    fields = {Op.CONV_2D: ("b0", "i1", "i1", "b0", "i1", "i1"),
              Op.DEPTHWISE_CONV_2D: ("b0", "i1", "i1", "i1", "b0", "i1",
                                     "i1"),
              Op.FULLY_CONNECTED: ("b0",), Op.MEAN: ("B0",)}
    assert len(a.ops) == len(b.ops)
    for x, y in zip(a.ops, b.ops):
        assert (x.opcode, x.inputs, x.outputs) == \
            (y.opcode, y.inputs, y.outputs)
        for fid, (kind, default) in enumerate(fields.get(x.opcode, ())):
            read = [{"b": t.get_byte, "B": t.get_bool, "i": t.get_int}[kind]
                    (fid, int(default)) for t in (x.options, y.options)]
            assert read[0] == read[1], (x.opcode, fid)


def test_v24_replica_batch_sets_its_constants():
    """At batch 4 the replica's reshapes, slices and tensor shapes carry
    the batch, its weights are those of batch 1, and it runs 4 rows."""
    one = parse_tflite(replicas.v24_tflite(np.random.default_rng(424)))
    buf4 = replicas.v24_tflite(np.random.default_rng(424), batch=4)
    four = parse_tflite(buf4)
    named = {t.name: t for t in four.tensors}
    assert named["pcm"].shape == (4, 144000)
    assert named["rs1"].data.tolist() == [4, 144000, 1, 1]
    assert named["rs2"].data.tolist() == [4 * 278, 1025]
    assert named["sc_e"].data.tolist() == [4, 278, 1, 1025]
    assert named["logits"].shape == (4, 6522)
    for x in one.tensors:
        if x.data is not None and x.data.dtype == np.float32:
            assert x.data.tobytes() == named[x.name].data.tobytes()


def test_v24_replica_float32_and_tf32_against_float64():
    """The v2.4 replica at batch 2 (two tones, noise) on the CPU: float32
    within 1e-6 of the float64 run's largest logit (1.1e-7 measured),
    while the same graph with every weight rounded to TF32's 10-bit
    mantissa is more than 1e-4 off (2.7e-4): the card's gate of 1e-5
    tells a float32 forward from one on TF32 operands."""
    rng = np.random.default_rng(3)
    x = np.stack([replicas.two_tones(), (rng.standard_normal(144000)
                                         * 0.05).astype(np.float32)])
    buf = replicas.v24_tflite(np.random.default_rng(424), batch=2)
    ref = load_tflite(buf).double()(x.astype(np.float64))[0].numpy()
    scale = np.abs(ref).max()
    f32 = load_tflite(buf)(x)[0].numpy()
    g = load_tflite(buf)
    for b in g.buffers():
        if b.is_floating_point():
            bits = b.view(torch.int32)
            b.copy_(((bits + 0x1000) & ~0x1FFF).view(torch.float32))
    tf32 = g(x)[0].numpy()
    assert np.abs(f32 - ref).max() <= 1e-6 * scale
    assert np.abs(tf32 - ref).max() > 1e-4 * scale
