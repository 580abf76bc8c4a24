"""Optimizers, learning-rate schedules and error-feedback int8 gradient
compression (port of ``repro.optim``)."""
from .grad_compress import (compress_decompress, compressed_all_reduce,
                            compressed_sum, init_error_state)
from .optimizers import Optimizer, adamw, cosine_schedule, global_norm, sgd

__all__ = ["Optimizer", "adamw", "compress_decompress",
           "compressed_all_reduce", "compressed_sum", "cosine_schedule",
           "global_norm", "init_error_state", "sgd"]
