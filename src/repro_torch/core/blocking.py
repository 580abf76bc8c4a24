"""Weight-block (WB) partitioning (port of ``repro.core.blocking``).

Every weight matrix ``(K, N)`` (K = fan-in, N = fan-out) is partitioned
into 2-D Weight Blocks of ``wb_rows`` x ``wb_cols``: the hardware
Operation Unit of the paper (9x8), or a wider accelerator-aligned variant
(8x128).  Convolutional weights ``(C_out, C_in, kh, kw)`` are first
flattened to ``(C_in*kh*kw, C_out)`` following the CSP reshaping (paper
§III-A, Fig. 2).
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


def conv_to_2d(w: torch.Tensor) -> torch.Tensor:
    """CSP reshape: (C_out, C_in, kh, kw) -> (C_in*kh*kw, C_out)."""
    return w.reshape(w.shape[0], -1).T


def conv_from_2d(w2d: torch.Tensor, conv_shape: Tuple[int, ...]
                 ) -> torch.Tensor:
    """Inverse of :func:`conv_to_2d`."""
    return w2d.T.reshape(conv_shape)


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


def block_count(shape_kn: Tuple[int, int], spec: BlockingSpec) -> int:
    gr, gc = spec.grid(*shape_kn)
    return gr * gc


def block_elem_counts(shape_kn: Tuple[int, int], spec: BlockingSpec,
                      device=None) -> torch.Tensor:
    """(GR, GC) int64 count of *real* (unpadded) weight elements in each
    block: edge blocks are partial when K/N are not block multiples, and
    bit counts must not bill the padding."""
    k, n = shape_kn
    gr, gc = spec.grid(k, n)
    rows = torch.clamp(k - torch.arange(gr, device=device) * spec.wb_rows,
                       0, spec.wb_rows)
    cols = torch.clamp(n - torch.arange(gc, device=device) * spec.wb_cols,
                       0, spec.wb_cols)
    return rows[:, None] * cols[None, :]
