"""PACT activation clipping + uniform activation quantization, paper Eq. 4
(port of ``repro.core.pact``).

``y = PACT(x) = 0.5 (|x| - |x - beta| + beta)`` clips to [0, beta] with a
trainable clip level beta (the gradient reaches beta on the saturated
side), followed by uniform quantization to ``act_bits`` with a
straight-through estimator.  Every ``abs``, ``maximum`` and ``clip`` keeps
the reference's gradient at its ties (``core.quantize.abs_``, ``maximum``,
``clip``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .quantize import abs_, clip, maximum, ste_round


def pact(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Parameterized clipping (Eq. 4); differentiable in x and beta."""
    return 0.5 * (abs_(x) - abs_(x - beta) + beta)


def pact_quant(x: torch.Tensor, beta: torch.Tensor,
               act_bits: int) -> torch.Tensor:
    """PACT clip then quantize to ``act_bits`` levels (STE gradients)."""
    y = pact(x, beta)
    if act_bits >= 32:
        return y
    levels = float(2 ** act_bits - 1)
    b = maximum(beta, 1e-6)
    q = ste_round(y / b * levels)
    return q * (b / levels)


def pact_sym(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Symmetric PACT (transformer adaptation): clip to [-beta, beta]."""
    return 0.5 * (abs_(x + beta) - abs_(x - beta))


def pact_sym_quant(x: torch.Tensor, beta: torch.Tensor,
                   act_bits: int) -> torch.Tensor:
    y = pact_sym(x, beta)
    if act_bits >= 32:
        return y
    levels = float(2 ** (act_bits - 1) - 1)
    b = maximum(beta, 1e-6)
    q = ste_round(y / b * levels)
    return (q * (b / levels)).to(x.dtype)


def quantize_signed(x: torch.Tensor, bits: int,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric signed uniform quantization with STE."""
    if bits >= 32:
        return x
    levels = float(2 ** (bits - 1) - 1)
    s = torch.amax(abs_(x)) if scale is None else scale
    s = maximum(s, 1e-6)
    q = ste_round(clip(x / s, -1.0, 1.0) * levels)
    return q * (s / levels)
