"""Typed settings tree (a copy of ``birdnet_go_tpu/config/settings.py``):
dataclass defaults, YAML loading (JSON where yaml is missing), env
overrides and validation; the hot-reload control signals
(``control.py``) and the config's JSON schema (``schema.py``)."""

from birdnet_go_tpu_torch.config.settings import (
    Settings,
    load_settings,
    default_settings,
)

__all__ = ["Settings", "load_settings", "default_settings"]
