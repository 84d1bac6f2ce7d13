"""The release version, a copy of ``birdnet_go_tpu/version.py``: the API
and the update check report it as the JAX package does."""

__version__ = "0.1.0"
