"""Host audio of the port: the ring buffers, the streaming resampler,
loudness normalisation, the FLAC codec, clip encoding and the HLS muxer."""

from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer, CaptureBuffer

__all__ = ["AnalysisBuffer", "CaptureBuffer"]
