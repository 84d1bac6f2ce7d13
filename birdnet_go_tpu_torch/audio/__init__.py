"""Host audio buffers of the port: the overlapped-window ring."""

from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer

__all__ = ["AnalysisBuffer"]
