"""Training: config, state, steps and the plateau schedule.  Port of
``vaeunet_tpu/training`` (``config``, ``state``, ``step``, ``schedule``;
the loop, checkpoints and pretraining are not ported yet)."""

from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.schedule import ReduceLROnPlateau
from vaeunet_tpu_torch.training.state import (
    TrainState,
    build_model,
    create_train_state,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from vaeunet_tpu_torch.training.step import forward_loss, make_eval_step, make_train_step

__all__ = [
    "TrainConfig",
    "ReduceLROnPlateau",
    "TrainState",
    "build_model",
    "create_train_state",
    "get_learning_rate",
    "make_optimizer",
    "set_learning_rate",
    "forward_loss",
    "make_eval_step",
    "make_train_step",
]
