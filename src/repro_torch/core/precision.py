"""Block-wise precision adjustment, paper Fig. 3b (port of
``repro.core.precision``).

For every WB, scan its bit planes from the MSB down; while a plane is
all-zero inside the block, clear its mask bit; stop at the first non-zero
plane.  The mask is always a *prefix* mask (ones for bits
``[0, bitwidth)``), and precision never grows: the new mask is intersected
with the old one.
"""
from __future__ import annotations

import dataclasses

import torch

from .bitrep import QuantizedTensor
from .blocking import block_view


def plane_block_any(planes: torch.Tensor, spec) -> torch.Tensor:
    """(n, ..., Kp, Np) -> (n, ..., GR, GC): does bit b have any non-zero
    in WB g?"""
    return torch.any(block_view(planes, spec) != 0, dim=-1).any(dim=-1)


def prefix_mask_from_nonzero(nz: torch.Tensor, dtype) -> torch.Tensor:
    """The MSB-down prefix mask from per-(bit, block) non-zeros:
    bitwidth(g) = 1 + max{b : nz[b, g]} (0 if every plane is zero), then
    mask[b, g] = b < bitwidth(g)."""
    n = nz.shape[0]
    bit_idx = torch.arange(n, device=nz.device).reshape(
        (n,) + (1,) * (nz.ndim - 1))
    highest = torch.amax(torch.where(nz, bit_idx + 1, 0), dim=0)
    return (bit_idx < highest[None]).to(dtype)


def adjust_precision(qt: QuantizedTensor) -> QuantizedTensor:
    """Apply block-wise precision adjustment; returns a new
    QuantizedTensor."""
    nz = plane_block_any(qt.planes * 1.0, qt.spec)
    # only planes that are live now can keep the block alive
    nz = torch.logical_and(nz, qt.mask > 0)
    new_mask = prefix_mask_from_nonzero(nz, qt.mask.dtype)
    new_mask = torch.minimum(new_mask, qt.mask)    # monotone: never re-grow
    return dataclasses.replace(qt, mask=new_mask)
