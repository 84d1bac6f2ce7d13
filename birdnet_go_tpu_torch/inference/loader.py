"""Model construction and weight resolution (port of
``birdnet_go_tpu/inference/loader.py``).

Weight order of precedence, as in the JAX loader:
1. an explicit checkpoint: a .tflite flatbuffer or a .onnx proto, imported
   through the port's readers (``tflite_import``, ``onnx_import``) and
   served as an ``ImportedModel``;
2. the installed model dir ``<model_home>/<model_id>``
   ($BIRDNET_TPU_MODELS, default ./data/models): its ``model.tflite``,
   else its ``model.onnx``;
3. deterministic random init (clearly warned: not field-accurate).

The JAX loader also reads orbax checkpoints, given or installed. The port
cannot: orbax's OCDBT layout is not readable without orbax and tensorstore,
which the card's machine does not have. Where the JAX loader would read
one, the port raises ``NotImplementedError`` rather than serve random
weights in its place. A port model holds its own parameters, so the
loaders return the module.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import torch
from torch import nn

from birdnet_go_tpu_torch.inference.onnx_import import OnnxGraph, load_onnx
from birdnet_go_tpu_torch.inference.tflite_import import (
    TFLiteGraph,
    load_tflite,
)
from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.bsg import BSGFinland
from birdnet_go_tpu_torch.models.geomodel import Geomodel, GeomodelConfig
from birdnet_go_tpu_torch.models.perch_v2 import PerchV2
from birdnet_go_tpu_torch.models.registry import MODEL_REGISTRY, ModelSpec

log = logging.getLogger("birdnet_tpu.inference")

_MODELS_ENV = "BIRDNET_TPU_MODELS"
_DEFAULT_MODEL_HOME = "./data/models"

_FAMILIES = {
    "BirdNET_V2.4": BirdNETv24,
    "BirdNET_V3.0": BirdNETv3,
    "Perch_V2": PerchV2,
    "BattyBirdNET": BatClassifier,
    "BSG": BSGFinland,
}


def model_home() -> Path:
    return Path(os.environ.get(_MODELS_ENV, _DEFAULT_MODEL_HOME))


def build_model(model_id: str, **kwargs) -> nn.Module:
    try:
        return _FAMILIES[model_id](**kwargs)
    except KeyError:
        raise KeyError(f"unknown model family {model_id!r}; "
                       f"known: {sorted(_FAMILIES)}") from None


def _installed(model_id: str) -> Path | None:
    path = model_home() / model_id
    return path if path.is_dir() and any(path.iterdir()) else None


class ImportedModel(nn.Module):
    """An imported .tflite/.onnx graph behind the native model interface
    (``spec``, ``num_species``, ``apply``), so that ``TorchClassifier``,
    the offline analyzer and the scheduler treat it as a native model.
    The graph is a submodule: ``.to(device)`` moves its constants once."""

    def __init__(self, graph: TFLiteGraph | OnnxGraph, model_id: str):
        super().__init__()
        self.graph = graph
        base = MODEL_REGISTRY.get(model_id)
        self._probe_species(graph)
        if base is not None:
            self.spec = base
            if self.num_species is None:
                self.num_species = base.num_species
        else:
            # keep num_species a real int even when probing failed —
            # predict_topk does min(k, num_species) and None would crash
            self.num_species = self.num_species or 0
            self.spec = ModelSpec(
                model_id=model_id, display_name=model_id,
                sample_rate=48000, clip_seconds=3.0,
                num_species=self.num_species)

    def _probe_species(self, graph) -> None:
        self.num_species = None
        try:
            if isinstance(graph, TFLiteGraph):
                out = graph.model.tensors[graph.model.outputs[0]]
                if out.shape:
                    self.num_species = int(out.shape[-1])
            else:                               # onnx (shapes not in proto
                # value_info: trace the classifier head's weight instead)
                self.num_species = self._probe_onnx_species(graph.graph)
        except Exception:
            pass

    @staticmethod
    def _probe_onnx_species(g) -> int | None:
        """Walk back from the graph output through shape-preserving ops to
        the final Gemm/MatMul and read the head width off its weight."""
        producers = {o: n for n in g.nodes for o in n.outputs}
        passthrough = {"Softmax", "LogSoftmax", "Sigmoid", "Relu",
                       "Identity", "Reshape", "Flatten", "Squeeze",
                       "Unsqueeze", "Add", "Cast"}
        name = g.outputs[0]
        for _ in range(20):
            n = producers.get(name)
            if n is None:
                return None
            if n.op_type == "Gemm" and len(n.inputs) > 1:
                w = g.initializers.get(n.inputs[1])
                if w is not None:
                    trans_b = int(n.attrs.get("transB", 0) or 0)
                    return int(w.shape[0] if trans_b else w.shape[-1])
                return None
            if n.op_type == "MatMul" and len(n.inputs) > 1:
                w = g.initializers.get(n.inputs[1])
                return int(w.shape[-1]) if w is not None else None
            if n.op_type in passthrough and n.inputs:
                name = n.inputs[0]
                continue
            return None
        return None

    def forward(self, pcm) -> dict[str, torch.Tensor]:
        """The graph on `pcm`: its first output as the logits, its second
        (else the first) as the embedding."""
        outs = self.graph(pcm)
        logits = outs[0]
        emb = outs[1] if len(outs) > 1 else logits
        return {"logits": logits, "embedding": emb}

    apply = forward


def _no_orbax(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the PyTorch port reads .tflite and .onnx artifacts, not "
        f"orbax checkpoints (orbax's OCDBT layout needs orbax and "
        f"tensorstore, which the card's machine lacks); checkpoints come "
        f"with training and inference/checkpoint.py, ROADMAP queue 1 item 4")


def load_model(model_id: str, checkpoint: str | None = None, seed: int = 0,
               **kwargs) -> nn.Module:
    """The model to serve, on the CPU: `checkpoint` may be a .tflite
    flatbuffer or a .onnx proto (an ``ImportedModel``); else the installed
    dir's ``model.tflite`` or ``model.onnx``; else the family with
    deterministic random weights from `seed`.

    Raises ``NotImplementedError`` where the JAX loader would read an
    orbax checkpoint: any other `checkpoint`, or a non-empty
    ``model_home()/<id>`` without such an artifact.
    """
    if checkpoint and str(checkpoint).endswith(".tflite"):
        model = ImportedModel(load_tflite(checkpoint), model_id)
        log.info("imported %s from tflite %s", model_id, checkpoint)
        return model
    if checkpoint and str(checkpoint).endswith(".onnx"):
        model = ImportedModel(load_onnx(checkpoint), model_id)
        log.info("imported %s from onnx %s", model_id, checkpoint)
        return model
    installed = _installed(model_id)
    if not checkpoint and installed is not None:
        # gallery-installed artifacts take precedence: model.tflite/.onnx
        for name in ("model.tflite", "model.onnx"):
            artifact = installed / name
            if artifact.is_file():
                return load_model(model_id, checkpoint=str(artifact),
                                  seed=seed, **kwargs)
    if checkpoint:
        raise _no_orbax(f"checkpoint {checkpoint}")
    if installed is not None:
        raise _no_orbax(f"installed model {installed} (no model.tflite or "
                        f"model.onnx there)")
    model = build_model(model_id, **kwargs)
    log.warning(
        "no weights for %s (no checkpoint given, nothing installed under "
        "%s) — using deterministic random init; detections will NOT be "
        "field-accurate", model_id, model_home())
    return model.init(torch.Generator().manual_seed(seed))


def geomodel_weights_installed() -> bool:
    """True when ``model_home()/Geomodel`` holds trained weights, which the
    JAX loader would serve rather than random init (whose scores are
    plausible-looking nonsense — callers presenting range-filter output to
    a user must surface that)."""
    return _installed("Geomodel") is not None


def load_geomodel(num_species: int = 6522, seed: int = 7) -> Geomodel:
    """The Geomodel with deterministic random weights from `seed`; raises
    ``NotImplementedError`` when ``model_home()/Geomodel`` is non-empty
    (the JAX loader reads an orbax checkpoint there)."""
    installed = _installed("Geomodel")
    if installed is not None:
        raise _no_orbax(f"installed model {installed}")
    log.warning("no geomodel weights — using deterministic random init")
    g = Geomodel(GeomodelConfig(num_species=num_species))
    return g.init(torch.Generator().manual_seed(seed))
