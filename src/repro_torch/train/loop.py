"""Training loop: the BWQ-A schedule, paper Alg. 1 (port of
``repro.train.loop``).

* drive train steps over the deterministic data pipeline;
* re-quantize and adjust precision every ``requant_interval`` steps;
* grow the regularization strength alpha by ``delta_alpha`` each round
  while quality stays inside the budget (the Alg. 1 outer loop, step
  based);
* checkpoint every ``ckpt_every`` steps (atomic, async) and restore on
  start: the data pipeline is index-addressable, so a crash resumes
  exactly (``run_with_restarts``; ``run``'s ``fault_at`` injects one).

Under a process mesh (``dist.sharding.use_mesh``) every rank runs the
same trainer on the same global batches: the step splits each batch over
the data axes and sums the gradients (``train.step.data_parallel``), so
every rank holds the same state and the same ``history``.  Saves and
restores take the active mesh, as the reference's do: a save is sharded
one file a host coordinate, and a restore gives whole leaves on whatever
mesh is live (elastic restore).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..core.state import tensor_leaves
from ..dist.parallel import active_mesh, all_reduce
from ..dist.sharding import get_mesh
from ..optim.optimizers import Optimizer
from .state import TrainState
from .step import build_maintenance_step, build_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    ckpt_every: int = 200
    ckpt_dir: Optional[str] = None
    log_every: int = 50
    requant_interval: int = 200
    alpha_round_steps: int = 0      # bump alpha every N steps (0 = fixed)
    delta_alpha: float = 0.0
    quality_budget: float = 0.01    # allowed degradation vs the baseline
    keep_ckpts: int = 3


class Trainer:
    """The BWQ-A loop over ``loss_fn(params, batch) -> (loss, metrics)``.

    Under a mesh whose data axes split the batch, the loss must be a mean
    of per-row terms (over the ``mask``, or over the labels) plus terms
    of the params alone: then the ranks' share-weighted losses sum to the
    single-device loss exactly; a statistic of the whole batch (the MoE
    load-balancing term, the CNN's BatchNorm) is summed over the data
    axes (``dist.parallel.batch_sum``)."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 lr_schedule: Callable, params: Any,
                 tcfg: TrainerConfig,
                 eval_fn: Optional[Callable[[Any], float]] = None,
                 alpha: float = 0.0):
        self.tcfg = tcfg
        self.train_step = build_train_step(loss_fn, optimizer, lr_schedule)
        self.maintenance = build_maintenance_step()
        self.state = TrainState.create(params, optimizer, alpha)
        self.device = next(t for _, t in tensor_leaves(params)).device
        self.eval_fn = eval_fn
        self.baseline_quality: Optional[float] = None
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts) \
            if tcfg.ckpt_dir else None
        self.history: list = []

    # -- fault tolerance -------------------------------------------------
    def try_restore(self, template_state: Optional[TrainState] = None) -> int:
        """Resume from the latest checkpoint, whatever mesh saved it; each
        leaf lands whole on its template leaf's device.  Returns the
        restored step (0 if none)."""
        if self.ckpt is None:
            return 0
        meta, restored = self.ckpt.restore_latest(template_state
                                                  or self.state,
                                                  mesh=get_mesh())
        if restored is None:
            return 0
        self.state = restored
        return int(meta[0])

    def _save(self, step: int):
        if self.ckpt is not None:
            # the active mesh shards the save: one file a host, chunked
            # by each leaf's fitted spec (single-shard with no mesh)
            self.ckpt.save(step, self.state, dict(step=step),
                           mesh=get_mesh())

    # -- main loop ---------------------------------------------------------
    def run(self, data: Iterator, steps: Optional[int] = None,
            fault_at: Optional[int] = None) -> Dict[str, Any]:
        """Train from the state's step to ``steps`` (default
        ``total_steps``), taking (step, batch) pairs from ``data``; batches
        move to the params' device.  ``fault_at`` raises before the batch
        of that data step (the restart tests' injected crash); a save in
        flight then lands before the exception leaves.  Saves every
        ``ckpt_every`` steps and at the end.  Returns the last logged
        metrics."""
        try:
            return self._run(data, steps, fault_at)
        except BaseException:
            if self.ckpt is not None:
                self.ckpt.join()
            raise

    def _run(self, data, steps, fault_at):
        tcfg = self.tcfg
        steps = steps or tcfg.total_steps
        t0 = time.time()
        last_metrics: Dict[str, Any] = {}
        for _ in range(self.state.step, steps):
            step_idx, batch = next(data)
            if fault_at is not None and step_idx == fault_at:
                raise RuntimeError(f"injected fault at step {step_idx}")
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
                m["wall_s"] = self._wall_s(t0)
                self.history.append(m)
                last_metrics = m
            if tcfg.ckpt_every and step % tcfg.ckpt_every == 0:
                self._save(step)
        self._save(self.state.step)
        if self.ckpt:
            self.ckpt.wait()
        return last_metrics

    def _wall_s(self, t0: float) -> float:
        """Seconds since ``t0``; under a mesh the slowest rank's, so that
        every rank logs the same history."""
        wall = time.time() - t0
        if active_mesh() is None:
            return wall
        return float(all_reduce(torch.tensor([wall], dtype=torch.float64,
                                             device=self.device),
                                axis=None, op="max")[0])

    def _alpha_round(self):
        """Alg. 1 outer loop: raise alpha while quality stays in budget."""
        if self.eval_fn is not None:
            q = self.eval_fn(self.state.params)
            if self.baseline_quality is None:
                self.baseline_quality = q
            if q < self.baseline_quality - self.tcfg.quality_budget:
                return
        self.state.alpha = self.state.alpha + self.tcfg.delta_alpha


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      make_data: Callable[[int], Iterator],
                      total_steps: int, fault_at: Optional[int] = None,
                      max_restarts: int = 3) -> Trainer:
    """Crash-resilient driver: rebuild the trainer, restore, resume on
    failure (``fault_at`` crashes the first attempt only)."""
    attempts = 0
    while True:
        trainer = make_trainer()
        resumed = trainer.try_restore()
        data = make_data(resumed)
        try:
            trainer.run(data, steps=total_steps,
                        fault_at=fault_at if attempts == 0 else None)
            return trainer
        except RuntimeError:
            attempts += 1
            if attempts > max_restarts:
                raise
