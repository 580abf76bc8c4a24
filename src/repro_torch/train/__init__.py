"""BWQ-A quantization-aware training with checkpoints and restarts (port
of ``repro.train``)."""
from .loop import Trainer, TrainerConfig, run_with_restarts
from .state import TrainState
from .step import (build_maintenance_step, build_train_step, freeze_mask,
                   microbatched_value_and_grad, quant_reg_loss, quant_stats)

__all__ = ["Trainer", "TrainerConfig", "TrainState", "run_with_restarts",
           "build_maintenance_step", "build_train_step", "freeze_mask",
           "microbatched_value_and_grad", "quant_reg_loss", "quant_stats"]
