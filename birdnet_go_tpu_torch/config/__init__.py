"""Typed settings tree (a copy of ``birdnet_go_tpu/config/settings.py``):
dataclass defaults, YAML loading, env overrides and validation. The
hot-reload control signals and the API schema are not ported yet."""

from birdnet_go_tpu_torch.config.settings import (
    Settings,
    load_settings,
    default_settings,
)

__all__ = ["Settings", "load_settings", "default_settings"]
