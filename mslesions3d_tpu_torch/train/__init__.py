"""Training: the train state, the reference's optimizer, the train / eval /
predict steps, checkpoints, metrics logging and the Trainer loop."""

from .checkpoints import CheckpointManager, load_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .loop import Trainer, TrainerConfig
from .state import (
    AdamL2,
    TrainState,
    cosine_annealing_schedule,
    create_train_state,
    eval_view,
    make_optimizer,
    resolve_device,
    use_ieee_float32,
)
from .steps import (
    make_eval_step,
    make_gathered_eval_step,
    make_gathered_train_epoch,
    make_gathered_train_step,
    make_predict_step,
    make_sharded_gathered_train_step,
    make_train_step,
)

__all__ = [
    "AdamL2", "TrainState", "cosine_annealing_schedule", "create_train_state", "eval_view",
    "make_optimizer", "resolve_device", "use_ieee_float32", "make_eval_step",
    "make_gathered_eval_step", "make_gathered_train_epoch", "make_gathered_train_step",
    "make_predict_step", "make_sharded_gathered_train_step", "make_train_step",
    "CheckpointManager", "load_checkpoint", "save_checkpoint", "MetricsLogger", "Trainer",
    "TrainerConfig",
]
