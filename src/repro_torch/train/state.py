"""Train state (port of ``repro.train.state``)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    step: int                  # steps taken
    params: Any
    opt_state: Any
    alpha: torch.Tensor        # () float32 BWQ regularization strength

    @classmethod
    def create(cls, params, optimizer, alpha: float = 0.0) -> "TrainState":
        return cls(step=0, params=params, opt_state=optimizer.init(params),
                   alpha=torch.tensor(alpha, dtype=torch.float32))
