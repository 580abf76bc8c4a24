"""int4 nibble packing: the one owner of the wire format shared by the
deployed weights (K axis) and the int4 KV cache (head axis)."""
from __future__ import annotations

import torch


def pack_int4(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack signed integer values (|q| < 8) as two's-complement nibble
    pairs along ``axis`` (whose length must be even): even positions land
    in the low nibble, odd in the high."""
    u = q.to(torch.int32) & 0xF
    um = torch.movedim(u, axis, -1)
    lo, hi = um[..., 0::2], um[..., 1::2]
    return torch.movedim((lo | (hi << 4)).to(torch.uint8), -1, axis)


def unpack_int4(u: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 nibble pairs -> int32 values in
    [-8, 7], interleaved back along ``axis`` (length doubles)."""
    um = torch.movedim(u, axis, -1).to(torch.int32)
    lo = um & 0xF
    hi = (um >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    st = torch.stack([lo, hi], dim=-1).reshape(*um.shape[:-1], -1)
    return torch.movedim(st, -1, axis)
