"""Training (counterpart of ``repro.train``): the optimizers, the loss and
train step, gradient compression, the data pipeline and the Trainer."""

from repro_torch.train.optimizer import (
    OptState,
    adamw_init,
    adamw_update,
    lr_schedule,
    make_optimizer,
)
from repro_torch.train.train_step import (
    TrainState,
    init_train_state,
    loss_fn,
    make_train_step,
)

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "make_optimizer",
    "lr_schedule",
    "loss_fn",
    "make_train_step",
    "TrainState",
    "init_train_state",
]
