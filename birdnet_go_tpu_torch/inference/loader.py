"""Model construction and weight resolution (the part of
``birdnet_go_tpu/inference/loader.py`` that offline analysis and the CLI
need).

The JAX loader serves, in this order: an explicit checkpoint, the
installed model dir ``<model_home>/<model_id>``, then deterministic random
init. The port cannot read checkpoints or installed artifacts yet (the
importers and the loader are ROADMAP queue 1 item 2), so it serves only
the last: where the JAX loader would load real weights, it raises
``NotImplementedError`` rather than serve random weights in their place.
A port model holds its own parameters, so the loaders return the module.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import torch
from torch import nn

from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.bsg import BSGFinland
from birdnet_go_tpu_torch.models.geomodel import Geomodel, GeomodelConfig
from birdnet_go_tpu_torch.models.perch_v2 import PerchV2

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


def _no_weight_loading(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the PyTorch port cannot load weights yet (checkpoints and "
        f".tflite/.onnx artifacts come with the importers and the loader, "
        f"ROADMAP queue 1 item 2); it serves seeded random weights only")


def load_model(model_id: str, checkpoint: str | None = None, seed: int = 0,
               **kwargs) -> nn.Module:
    """The model family with deterministic random weights from `seed`.

    Raises ``NotImplementedError`` where the JAX loader would serve real
    weights: a `checkpoint` given, or a non-empty ``model_home()/<id>``.
    """
    if checkpoint:
        raise _no_weight_loading(f"checkpoint {checkpoint}")
    installed = _installed(model_id)
    if installed is not None:
        raise _no_weight_loading(f"installed model {installed}")
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
    ``NotImplementedError`` when ``model_home()/Geomodel`` is non-empty."""
    installed = _installed("Geomodel")
    if installed is not None:
        raise _no_weight_loading(f"installed model {installed}")
    log.warning("no geomodel weights — using deterministic random init")
    g = Geomodel(GeomodelConfig(num_species=num_species))
    return g.init(torch.Generator().manual_seed(seed))
