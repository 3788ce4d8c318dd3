"""The port's train step: loss, optimizer, loop and its CLI
(`python -m dan_tpu_torch.train`)."""
from dan_tpu_torch.train.loop import (
    TrainState,
    create_train_state,
    preprocess_and_match,
    train_step,
)
from dan_tpu_torch.train.loss import detection_loss, smooth_l1
from dan_tpu_torch.train.optim import learning_rate, sgd_update

__all__ = [
    "TrainState",
    "create_train_state",
    "detection_loss",
    "learning_rate",
    "preprocess_and_match",
    "sgd_update",
    "smooth_l1",
    "train_step",
]
