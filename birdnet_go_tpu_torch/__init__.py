"""birdnet_go_tpu_torch — the realtime mel-CNN device step and offline
analysis in PyTorch.

A port of the JAX package ``birdnet_go_tpu`` to PyTorch and CUDA on an
NVIDIA H100. It covers the per-window device step of the realtime server
for BirdNET v2.4 (EfficientNet-B0), BirdNET v3.0 and Perch v2 (B1): int16
PCM megabatch → fused mel spectrogram (a CUDA kernel for Hopper,
``csrc/melspec.cu``) → EfficientNet backbone, whose stride-1 blocks may run
through the fused MBConv kernels (``csrc/mbconv.cu``) → sigmoid ·
sensitivity, range mask and top-K, driven by the port's own copy of the
host loop (``scheduler.loop.DeviceLoop``, ``audio.AnalysisBuffer``,
``utils.tracing``) through ``scheduler.loop.TorchModelBatcher``. Offline
file analysis (``analysis.offline``: resampling and window slicing on the
card, Raven tables) and the CLI's device commands run as
``python -m birdnet_go_tpu_torch analyze | benchmark | rangefilter |
verify-artifact``. Real weights come as .tflite or .onnx artifacts,
imported as torch modules (``inference.tflite_import``,
``inference.onnx_import``) and served through ``inference.loader``.

It imports torch and numpy, never JAX and nothing of ``birdnet_go_tpu``.
Importing it builds nothing: the kernels are compiled on first launch
(``ops/_build.py``).
"""

__all__ = ["analysis", "audio", "cli", "inference", "models", "ops",
           "scheduler", "taxonomy", "utils"]
