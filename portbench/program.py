"""The system under test: the port's model built for a configuration file
and loaded with the benchmark's weights. The traffic generators take the
rest of the served path (loop, farm, processor, analyzer) from the port
directly."""

from __future__ import annotations

import torch

from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    BlockSpec,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.models.registry import get_model_spec
from birdnet_go_tpu_torch.ops.melspec import MelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mel_config(mel: dict) -> MelConfig:
    return MelConfig(sample_rate=mel["sample_rate"], n_fft=mel["n_fft"],
                     hop=mel["hop"], n_mels=mel["n_mels"], fmin=mel["fmin"],
                     fmax=mel["fmax"], mag_scale=mel["mag_scale"])


def net_config(net: dict) -> EfficientNetConfig:
    return EfficientNetConfig(
        blocks=tuple(BlockSpec(*b) for b in net["blocks"]),
        stem_channels=net["stem_channels"],
        embedding_dim=net["embedding_dim"], num_classes=net["num_classes"],
        se_ratio=net["se_ratio"])


def build_model(cfg: dict, params: dict) -> MelCnnModel:
    """The port's mel-CNN for the configuration's family (its registry
    spec), at the file's widths, with `params` loaded (strict)."""
    model = MelCnnModel(cfg["net"]["num_classes"], mel_config(cfg["mel"]),
                        net_config(cfg["net"]),
                        compute_dtype=DTYPES[cfg["net"]["compute_dtype"]])
    model.spec = get_model_spec(cfg["family"])
    model.fused_blocks = bool(cfg["serving"]["fused_blocks"])
    model.act_int8 = bool(cfg["serving"]["act_int8"])
    dev = next(iter(params.values())).device
    model.to(dev)
    model.load_state_dict({f"backbone.{k}": v for k, v in params.items()},
                          strict=True)
    return model


def classifier(model: MelCnnModel, device: torch.device,
               mask) -> TorchClassifier:
    clf = TorchClassifier(model, device)
    if mask is not None:
        clf.set_range_mask(mask.cpu().numpy())
    return clf
