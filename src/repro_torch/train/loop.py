"""Training loop: the BWQ-A schedule, paper Alg. 1 (port of
``repro.train.loop``).

* drive train steps over the deterministic data pipeline;
* re-quantize and adjust precision every ``requant_interval`` steps;
* grow the regularization strength alpha by ``delta_alpha`` each round
  while quality stays inside the budget (the Alg. 1 outer loop, step
  based).

Checkpointing (``ckpt_dir``, ``try_restore``, ``run_with_restarts``) is not
ported yet: a ``ckpt_dir`` raises rather than training without the saves
it asks for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..core.state import tensor_leaves
from ..optim.optimizers import Optimizer
from .state import TrainState
from .step import build_maintenance_step, build_train_step


@dataclasses.dataclass
class TrainerConfig:
    """The reference's fields less ``ckpt_every`` and ``keep_ckpts`` (no
    checkpoints yet); a ``ckpt_dir`` is refused."""
    total_steps: int = 1000
    ckpt_dir: Optional[str] = None
    log_every: int = 50
    requant_interval: int = 200
    alpha_round_steps: int = 0      # bump alpha every N steps (0 = fixed)
    delta_alpha: float = 0.0
    quality_budget: float = 0.01    # allowed degradation vs the baseline


class Trainer:
    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 lr_schedule: Callable, params: Any,
                 tcfg: TrainerConfig,
                 eval_fn: Optional[Callable[[Any], float]] = None,
                 alpha: float = 0.0):
        if tcfg.ckpt_dir:
            raise NotImplementedError(
                "checkpointing is not ported yet (repro.ckpt, "
                "Trainer.try_restore/_save); run without ckpt_dir")
        self.tcfg = tcfg
        self.train_step = build_train_step(loss_fn, optimizer, lr_schedule)
        self.maintenance = build_maintenance_step()
        self.state = TrainState.create(params, optimizer, alpha)
        self.device = next(t for _, t in tensor_leaves(params)).device
        self.eval_fn = eval_fn
        self.baseline_quality: Optional[float] = None
        self.history: list = []

    def run(self, data: Iterator, steps: Optional[int] = None
            ) -> Dict[str, Any]:
        """Train from the state's step to ``steps`` (default
        ``total_steps``), taking (step, batch) pairs from ``data``; batches
        move to the params' device.  Returns the last logged metrics.
        (The reference's ``fault_at`` hook serves ``run_with_restarts``,
        which is not ported.)"""
        tcfg = self.tcfg
        steps = steps or tcfg.total_steps
        t0 = time.time()
        last_metrics: Dict[str, Any] = {}
        for _ in range(self.state.step, steps):
            _, batch = next(data)
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            self.state, metrics = self.train_step(self.state, batch)
            step = self.state.step
            if tcfg.requant_interval and step % tcfg.requant_interval == 0:
                self.state = self.maintenance(self.state)
            if tcfg.alpha_round_steps and tcfg.delta_alpha and \
                    step % tcfg.alpha_round_steps == 0:
                self._alpha_round()
            if step % tcfg.log_every == 0 or step == steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = time.time() - t0
                self.history.append(m)
                last_metrics = m
        return last_metrics

    def _alpha_round(self):
        """Alg. 1 outer loop: raise alpha while quality stays in budget."""
        if self.eval_fn is not None:
            q = self.eval_fn(self.state.params)
            if self.baseline_quality is None:
                self.baseline_quality = q
            if q < self.baseline_quality - self.tcfg.quality_budget:
                return
        self.state.alpha = self.state.alpha + self.tcfg.delta_alpha
