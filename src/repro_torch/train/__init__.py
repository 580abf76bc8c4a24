"""BWQ-A quantization-aware training (port of ``repro.train``;
checkpointing and restarts are not ported yet)."""
from .loop import Trainer, TrainerConfig
from .state import TrainState
from .step import (build_maintenance_step, build_train_step, freeze_mask,
                   microbatched_value_and_grad, quant_reg_loss, quant_stats)

__all__ = ["Trainer", "TrainerConfig", "TrainState",
           "build_maintenance_step", "build_train_step", "freeze_mask",
           "microbatched_value_and_grad", "quant_reg_loss", "quant_stats"]
