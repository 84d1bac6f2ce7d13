"""Custom-classifier training (port of ``birdnet_go_tpu/train``)."""

from birdnet_go_tpu_torch.train.trainer import (
    TrainState,
    make_train_step,
    multilabel_loss,
)

__all__ = ["TrainState", "make_train_step", "multilabel_loss"]
