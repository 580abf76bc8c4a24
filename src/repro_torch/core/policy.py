"""QAT schedule for BWQ-A, paper Algorithm 1 (port of
``repro.core.policy``).

The paper's outer loops (grow alpha until the accuracy loss passes 1%,
then lower the activation precision) are driven by ``repro_torch.train.
loop``; this module holds the schedule state and the step-level decision
of when to re-quantize and adjust precision.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BWQSchedule:
    init_weight_bits: int = 8
    init_act_bits: int = 8
    alpha: float = 0.0              # current regularization strength
    delta_alpha: float = 5e-4       # Alg. 1 outer-loop increment
    requant_interval: int = 200     # steps between re-quantization events
    acc_drop_budget: float = 0.01   # 1% (paper)
    per_block_scale: bool = False   # paper-faithful: per-layer scale
    wb_rows: int = 9
    wb_cols: int = 8

    def is_requant_step(self, step: int) -> bool:
        return step > 0 and self.requant_interval > 0 and \
            step % self.requant_interval == 0

    def bump_alpha(self) -> "BWQSchedule":
        return dataclasses.replace(self, alpha=self.alpha + self.delta_alpha)

    def lower_act_bits(self) -> "BWQSchedule":
        return dataclasses.replace(self, init_act_bits=self.init_act_bits - 1)
