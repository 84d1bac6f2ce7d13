"""Classifier backend, the JAX parameter bridge and the model loader."""
