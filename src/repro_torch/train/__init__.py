"""Training utilities of the port: SGD, AdamW, Adafactor and the
learning-rate schedules."""
from .optim import (Optimizer, sgd, adamw, adafactor, global_norm,
                    clip_by_global_norm, cosine_schedule, linear_schedule,
                    constant_schedule)

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_schedule",
           "constant_schedule"]
