"""Model construction and weight resolution (port of
``birdnet_go_tpu/inference/loader.py``).

Weight order of precedence, as in the JAX loader:
1. an explicit checkpoint: a .tflite flatbuffer or a .onnx proto, imported
   through the port's readers (``tflite_import``, ``onnx_import``) and
   served as an ``ImportedModel``; or a checkpoint directory of the port's
   own format (``params.npz``, ``inference/checkpoint.py``, written by
   ``train``), loaded strictly into the family;
2. the installed model dir ``<model_home>/<model_id>``
   ($BIRDNET_TPU_MODELS, default ./data/models): its ``model.tflite``,
   else its ``model.onnx``, else its ``params.npz``;
3. deterministic random init (clearly warned: not field-accurate).

Where the JAX loader reads orbax, the port reads ``params.npz``: orbax's
OCDBT layout is not readable without orbax and tensorstore, which the
card's machine does not have. A checkpoint or installed dir without any of
these files raises ``NotImplementedError`` rather than serve random weights
in its place. A port model holds its own parameters, so the loaders return
the module.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import torch
from torch import nn

from birdnet_go_tpu_torch.inference.checkpoint import has_params, read_params
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
        f"{what}: the PyTorch port reads .tflite and .onnx artifacts and its "
        f"own checkpoints (a directory holding params.npz, as train "
        f"writes), not orbax checkpoints (orbax's OCDBT layout needs orbax "
        f"and tensorstore, which the card's machine lacks)")


def _from_checkpoint(model_id: str, path: Path, **kwargs) -> nn.Module:
    """The family on the weights under `path`. Its head is as wide as the
    checkpoint's, as the JAX loader, which restores the tree as saved,
    serves logits of the checkpoint's width."""
    state = read_params(path)
    kwargs["num_species"] = state["backbone.classifier.w"].shape[0]
    model = build_model(model_id, **kwargs)
    model.load_state_dict(state, strict=True)
    log.info("loaded %s weights from %s", model_id, path)
    return model


def load_model(model_id: str, checkpoint: str | None = None, seed: int = 0,
               **kwargs) -> nn.Module:
    """The model to serve, on the CPU: `checkpoint` may be a .tflite
    flatbuffer or a .onnx proto (an ``ImportedModel``) or a directory
    holding ``params.npz``; else the installed dir's ``model.tflite``,
    ``model.onnx`` or ``params.npz``; else the family with deterministic
    random weights from `seed`.

    Raises ``NotImplementedError`` where the JAX loader would read an
    orbax checkpoint: any other `checkpoint`, or a non-empty
    ``model_home()/<id>`` without such a file.
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
        if has_params(checkpoint):
            return _from_checkpoint(model_id, Path(checkpoint), **kwargs)
        raise _no_orbax(f"checkpoint {checkpoint}")
    if installed is not None:
        if has_params(installed):
            return _from_checkpoint(model_id, installed, **kwargs)
        raise _no_orbax(f"installed model {installed} (no model.tflite, "
                        f"model.onnx or params.npz there)")
    model = build_model(model_id, **kwargs)
    log.warning(
        "no weights for %s (no checkpoint given, nothing installed under "
        "%s) — using deterministic random init; detections will NOT be "
        "field-accurate", model_id, model_home())
    return model.init(torch.Generator().manual_seed(seed))


def geomodel_weights_installed(checkpoint: str | None = None) -> bool:
    """True when load_geomodel would serve trained weights rather than
    deterministic random init (whose scores are plausible-looking
    nonsense — callers presenting range-filter output to a user must
    surface that)."""
    return bool(checkpoint) or _installed("Geomodel") is not None


def load_geomodel(checkpoint: str | None = None, num_species: int = 6522,
                  seed: int = 7) -> Geomodel:
    """The Geomodel on the weights of `checkpoint` (a directory holding
    ``params.npz``), else of ``model_home()/Geomodel``, else deterministic
    random weights from `seed`. The checkpoint's output width wins over
    `num_species`, as the JAX loader's restored tree does. Raises
    ``NotImplementedError`` for a checkpoint or a non-empty installed dir
    without ``params.npz`` (the JAX loader reads orbax there)."""
    path = Path(checkpoint) if checkpoint else _installed("Geomodel")
    if path is not None:
        if not has_params(path):
            raise _no_orbax(f"checkpoint {checkpoint}" if checkpoint
                            else f"installed model {path}")
        state = read_params(path)
        last = max(int(k.split(".")[1]) for k in state)
        g = Geomodel(GeomodelConfig(
            num_species=state[f"mlp.{last}.w"].shape[0]))
        g.load_state_dict(state, strict=True)
        log.info("loaded geomodel weights from %s", path)
        return g
    log.warning("no geomodel weights — using deterministic random init")
    g = Geomodel(GeomodelConfig(num_species=num_species))
    return g.init(torch.Generator().manual_seed(seed))
