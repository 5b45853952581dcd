"""Training substrate: optimizer, schedules, data, checkpointing, trainer
(the port of ``repro.train``)."""

from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule, linear_warmup
from .step import TrainStepConfig, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup", "TrainStepConfig",
           "make_train_step", "Trainer", "TrainerConfig"]
