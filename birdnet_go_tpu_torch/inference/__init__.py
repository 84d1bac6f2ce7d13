"""Classifier backend, the JAX parameter bridge, the .tflite/.onnx
importers, ``verify-artifact`` and the model loader."""
