"""Training substrate of the port: optimizers, schedules, the train-step
builder (port of ``repro.train``)."""

from .optim import Optimizer, adafactor, adamw, clip_by_global_norm, warmup_cosine
from .step import TrainState, build_train_step, init_train_state

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "warmup_cosine", "TrainState", "build_train_step",
           "init_train_state"]
