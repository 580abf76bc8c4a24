"""Symmetric PACT activation quantization, forward only (port of
``repro.core.pact``): the activation quantizer in front of every quantized
matmul."""
from __future__ import annotations

import torch


def pact_sym(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Symmetric PACT: clip to [-beta, beta]."""
    return 0.5 * (torch.abs(x + beta) - torch.abs(x - beta))


def pact_sym_quant(x: torch.Tensor, beta: torch.Tensor,
                   act_bits: int) -> torch.Tensor:
    y = pact_sym(x, beta)
    if act_bits >= 32:
        return y
    levels = float(2 ** (act_bits - 1) - 1)
    b = torch.clamp(beta, min=1e-6)
    q = torch.round(y / b * levels)
    return (q * (b / levels)).to(x.dtype)
