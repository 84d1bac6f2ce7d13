"""Model families as torch modules (BirdNET v2.4 and v3.0, Perch v2, BSG
Finland, BattyBirdNET), the Geomodel range filter and the model
registry."""

from birdnet_go_tpu_torch.models.bat import BatClassifier
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.bsg import BSGFinland
from birdnet_go_tpu_torch.models.geomodel import (
    Geomodel,
    GeomodelConfig,
    birdnet_week,
)
from birdnet_go_tpu_torch.models.perch_v2 import PerchV2
from birdnet_go_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    ModelSpec,
    get_model_spec,
)

__all__ = ["ModelSpec", "MODEL_REGISTRY", "get_model_spec", "BirdNETv24",
           "BirdNETv3", "PerchV2", "BSGFinland", "BatClassifier",
           "Geomodel", "GeomodelConfig", "birdnet_week"]
