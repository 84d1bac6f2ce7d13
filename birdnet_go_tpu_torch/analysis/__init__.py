"""Offline file analysis, detection types and Raven output (ports of
``birdnet_go_tpu/analysis/offline.py``, ``results.py`` and ``raven.py``)."""

from birdnet_go_tpu_torch.analysis.results import Detection, WindowResult

__all__ = ["Detection", "WindowResult"]
