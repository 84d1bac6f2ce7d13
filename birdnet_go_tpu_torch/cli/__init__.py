"""The port's command line (``python -m birdnet_go_tpu_torch``)."""
