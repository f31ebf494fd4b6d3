"""Training: config, state, steps, the plateau schedule, checkpoints and
the loop.  Port of ``vaeunet_tpu/training`` (``config``, ``state``,
``step``, ``schedule``, ``checkpoint``, ``loop``, and encoder
pretraining, ``pretrain``)."""

from vaeunet_tpu_torch.training.checkpoint import (
    load_config,
    restore_checkpoint,
    save_checkpoint,
)
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.loop import evaluate_model, train_model
from vaeunet_tpu_torch.training.schedule import ReduceLROnPlateau
from vaeunet_tpu_torch.training.state import (
    TrainState,
    build_model,
    create_train_state,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from vaeunet_tpu_torch.training.step import (
    forward_loss,
    make_eval_step,
    make_train_step,
    multi_temp_training_step,
)

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
    "multi_temp_training_step",
    "save_checkpoint",
    "restore_checkpoint",
    "load_config",
    "evaluate_model",
    "train_model",
]
