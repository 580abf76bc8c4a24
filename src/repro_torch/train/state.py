"""Train state (port of ``repro.train.state``)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    # steps taken; a checkpoint stores it as the reference's 0-d int32
    # ``.step`` leaf
    step: int = dataclasses.field(metadata={"ckpt": "int32"})
    params: Any = None
    opt_state: Any = None
    alpha: torch.Tensor = None  # () float32 BWQ regularization strength

    @classmethod
    def create(cls, params, optimizer, alpha: float = 0.0) -> "TrainState":
        return cls(step=0, params=params, opt_state=optimizer.init(params),
                   alpha=torch.tensor(alpha, dtype=torch.float32))
