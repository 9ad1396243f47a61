"""Training utilities of the port: AdamW and the learning-rate schedules
(the JAX package's ``sgd`` and ``adafactor`` are not ported yet)."""
from .optim import (Optimizer, adamw, global_norm, clip_by_global_norm,
                    cosine_schedule, linear_schedule, constant_schedule)

__all__ = ["Optimizer", "adamw", "global_norm", "clip_by_global_norm",
           "cosine_schedule", "linear_schedule", "constant_schedule"]
