"""Training of the port (misonet_tpu/train): optimizer, state, steps."""

from misonet_tpu_torch.train.state import (
    PlateauScheduler,
    TrainState,
    create_train_state,
    make_optimizer,
)
from misonet_tpu_torch.train.steps import (
    make_enhance_joint_train_step,
    make_enhance_train_step,
    make_separate_eval_step,
    make_separate_train_step,
    make_separate_wave_eval_step,
    make_separate_wave_train_step,
)

__all__ = [
    "PlateauScheduler",
    "TrainState",
    "create_train_state",
    "make_enhance_joint_train_step",
    "make_enhance_train_step",
    "make_optimizer",
    "make_separate_eval_step",
    "make_separate_train_step",
    "make_separate_wave_eval_step",
    "make_separate_wave_train_step",
]
