"""Layout operations on deployed weights that the kernels consume
unchanged (port of the part of ``repro.kernels.ops`` the serving path
needs)."""
from __future__ import annotations

import torch


def truncate_mask_topk(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Draft-model view of a bit-plane mask LUT: keep each block's top-k
    live planes.

    ``mask`` is (..., bits, GR, GC) binary f32, prefix-monotone along the
    bit axis (a block with occupancy ``o`` keeps planes ``0..o-1``).  The
    result keeps planes ``max(o-k, 0)..o-1``, so composing the same
    payload through it floors away the low ``o-k`` magnitude bits.  It is
    NOT prefix-monotone: it zeroes the low planes, and ``bitplane_matmul``
    honours the mask plane by plane."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    bits = mask.shape[-3]
    occ = torch.sum(mask, dim=-3, keepdim=True)       # (..., 1, GR, GC)
    idx = torch.arange(bits, dtype=mask.dtype,
                       device=mask.device).reshape(bits, 1, 1)
    return mask * (idx >= occ - float(k)).to(mask.dtype)
