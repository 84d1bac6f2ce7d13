"""Host audio of the port: the ring buffers, the streaming resampler,
loudness normalisation, the FLAC codec, clip encoding, the HLS muxer, and
the realtime engine with its sources (file loop, tone), equalizer,
liveness watchdog and quiet hours."""

from birdnet_go_tpu_torch.audio.buffers import AnalysisBuffer, CaptureBuffer

__all__ = ["AnalysisBuffer", "CaptureBuffer"]
