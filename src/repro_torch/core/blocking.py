"""Weight-block (WB) partitioning (port of ``repro.core.blocking``).

Every weight matrix ``(K, N)`` (K = fan-in, N = fan-out) is partitioned
into 2-D Weight Blocks of ``wb_rows`` x ``wb_cols``: the hardware
Operation Unit of the paper (9x8), or a wider accelerator-aligned variant
(8x128).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BlockingSpec:
    """Shape bookkeeping for partitioning a (K, N) matrix into WBs."""

    wb_rows: int = 9   # wordlines  = input-dim rows per block (0 = whole dim)
    wb_cols: int = 8   # bitlines   = output-dim cols per block (0 = whole dim)

    def resolve(self, k: int, n: int) -> "BlockingSpec":
        """Concrete spec for a (k, n) matrix; 0-dims become the full
        extent (whole-layer blocks)."""
        if self.wb_rows and self.wb_cols:
            return self
        return BlockingSpec(self.wb_rows or k, self.wb_cols or n)

    def grid(self, k: int, n: int) -> Tuple[int, int]:
        """Number of blocks (GR, GC) covering a (k, n) matrix (ceil)."""
        r = self.resolve(k, n)
        return (-(-k // r.wb_rows), -(-n // r.wb_cols))

    def padded(self, k: int, n: int) -> Tuple[int, int]:
        gr, gc = self.grid(k, n)
        return gr * self.wb_rows, gc * self.wb_cols


def pad_to_blocks(w: torch.Tensor, spec: BlockingSpec) -> torch.Tensor:
    """Zero-pad the trailing two dims of ``w`` to block multiples."""
    k, n = w.shape[-2], w.shape[-1]
    kp, np_ = spec.padded(k, n)
    if (kp, np_) == (k, n):
        return w
    return F.pad(w, (0, np_ - n, 0, kp - k))


def block_view(w: torch.Tensor, spec: BlockingSpec) -> torch.Tensor:
    """(..., Kp, Np) -> (..., GR, GC, wb_rows, wb_cols); ``w`` must already
    be padded to block multiples."""
    *lead, kp, np_ = w.shape
    gr, gc = kp // spec.wb_rows, np_ // spec.wb_cols
    w = w.reshape(*lead, gr, spec.wb_rows, gc, spec.wb_cols)
    return torch.movedim(w, -3, -2)


def expand_block_map(per_block: torch.Tensor,
                     spec: BlockingSpec) -> torch.Tensor:
    """Broadcast a per-block map (..., GR, GC) to elements (..., Kp, Np)."""
    x = torch.repeat_interleave(per_block, spec.wb_rows, dim=-2)
    return torch.repeat_interleave(x, spec.wb_cols, dim=-1)
