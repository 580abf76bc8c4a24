"""WB-level group Lasso regularizer, paper Eqs. 2-3 (port of
``repro.core.group_lasso``).

``B_GL(W^r) = sum_g sum_b || W_s^(g,b) * m^(g,b) ||_2``

The total objective weights each layer's regularizer by
``#Param(W^r) * #Bit(W^r) / #Param(total)``, so layers holding more bits
are penalized harder (Eq. 3).
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from .bitrep import QuantizedTensor, param_count
from .blocking import block_elem_counts, block_view


def wb_group_lasso(qt: QuantizedTensor) -> torch.Tensor:
    """Sum over (block, bit) groups of the L2 norm of the masked plane."""
    bw = block_view(qt.planes, qt.spec)               # (n, ..., GR, GC, r, c)
    sq = torch.sum(bw * bw, dim=(-1, -2))             # (n, ..., GR, GC)
    per_plane = torch.sqrt(sq + 1e-12) * qt.mask
    return torch.sum(per_plane.reshape(qt.n_bits, -1).sum(dim=1))


def layer_bit_count(qt: QuantizedTensor) -> torch.Tensor:
    """Current total live bits in the layer (edge-block padding
    excluded)."""
    elems = block_elem_counts((qt.shape[-2], qt.shape[-1]), qt.spec,
                              device=qt.mask.device)
    return torch.sum(qt.mask * elems.to(qt.mask.dtype))


def regularization_loss(qts: Dict[str, QuantizedTensor],
                        alpha: float) -> torch.Tensor:
    """Paper Eq. 3 second term over all quantized layers; the per-layer
    coefficient uses the *current* (stop-gradient) live bit count, so the
    schedule tracks compression as it happens."""
    if not qts or alpha == 0.0:
        return torch.tensor(0.0)
    total_params = float(sum(param_count(q) for q in qts.values()))
    loss = 0.0
    for q in qts.values():
        coeff = layer_bit_count(q).detach() / total_params
        loss = loss + coeff * wb_group_lasso(q)
    return alpha * loss


def model_compression_ratio(qts: Iterable[QuantizedTensor],
                            float_bits: int = 32) -> float:
    """Compression ratio against a float baseline (paper Table II)."""
    qts = list(qts)
    total_params = sum(param_count(q) for q in qts)
    total_bits = sum(float(layer_bit_count(q)) for q in qts)
    if total_bits == 0:
        return float("inf")
    return float_bits * total_params / total_bits
