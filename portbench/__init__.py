"""The PyTorch/CUDA port's benchmark: ``python3 -m portbench.run``."""
