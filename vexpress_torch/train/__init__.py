from .adam8bit import Adam8bit
from .train_step import (
    AdamW,
    TrainConfig,
    TrainOptimizer,
    TrainState,
    build_train_step,
    make_lr_schedule,
    make_optimizer,
    sample_draws,
    stage_zero_init,
    trainable_mask,
)

__all__ = [
    "Adam8bit",
    "AdamW",
    "TrainConfig",
    "TrainOptimizer",
    "TrainState",
    "build_train_step",
    "make_lr_schedule",
    "make_optimizer",
    "sample_draws",
    "stage_zero_init",
    "trainable_mask",
]
