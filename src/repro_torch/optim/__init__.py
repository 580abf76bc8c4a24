"""Optimizers and learning-rate schedules (port of ``repro.optim``;
gradient compression is not ported yet)."""
from .optimizers import Optimizer, adamw, cosine_schedule, global_norm, sgd

__all__ = ["Optimizer", "adamw", "cosine_schedule", "global_norm", "sgd"]
