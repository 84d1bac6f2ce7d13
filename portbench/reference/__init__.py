"""The plain reference of the benchmark's models: float32 PyTorch with TF32
off, written from the published description and the configuration files
under ``portbench/configs/``. It imports nothing of the measured program,
and it never reads the program's weights or tables: it takes the weights
the benchmark made (``portbench/weights.py``) and works out its own
filterbank, window, resampling filter and windows."""
