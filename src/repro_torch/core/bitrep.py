"""Bit-level weight representation, paper Eq. 1 (port of
``repro.core.bitrep``).

``W = sign(W) * s / (2^n - 1) * sum_b W_s^(b) * 2^b * m^(g,b)``

The bit tensor ``planes`` is trained as continuous non-negative floats
(BSQ-style relaxation); re-quantization (``core.quantize.requantize``)
snaps it back to exact binary at scheduled intervals.  The per-(block,
bit) mask ``m`` is binary and not trained; precision adjustment only ever
clears bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .blocking import (BlockingSpec, block_view, expand_block_map,
                       pad_to_blocks)


@dataclasses.dataclass
class QuantizedTensor:
    """Bit-level representation of one weight matrix (or a stacked
    (L, K, N)); the bit axis leads ``planes`` and ``mask``."""

    planes: torch.Tensor     # (n_bits, ..., Kp, Np) non-negative float
    sign: torch.Tensor       # (..., Kp, Np) in {-1, +1}
    scale: torch.Tensor      # per-layer () / (L,) or per-block (..., GR, GC)
    mask: torch.Tensor       # (n_bits, ..., GR, GC) in {0., 1.}
    shape: Tuple[int, ...]
    spec: BlockingSpec

    @property
    def n_bits(self) -> int:
        return self.planes.shape[0]

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer ``i`` of a stacked (L, ...) leaf (views, no copy)."""
        return dataclasses.replace(
            self, planes=self.planes[:, i], sign=self.sign[i],
            scale=self.scale[i] if self.scale.ndim else self.scale,
            mask=self.mask[:, i], shape=self.shape[1:])

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, planes=self.planes.to(device),
                                   sign=self.sign.to(device),
                                   scale=self.scale.to(device),
                                   mask=self.mask.to(device))


def _levels(n_bits: int) -> float:
    """Largest magnitude of an ``n_bits`` unsigned grid: ``2^n - 1``."""
    return float(2 ** n_bits - 1)


def from_float(w: torch.Tensor, n_bits: int = 8,
               spec: Optional[BlockingSpec] = None,
               per_block_scale: bool = False) -> QuantizedTensor:
    """Decompose a float matrix (..., K, N) into its bit-level
    representation."""
    spec = (spec or BlockingSpec()).resolve(w.shape[-2], w.shape[-1])
    shape = tuple(w.shape)
    wp = pad_to_blocks(w, spec)
    sign = torch.where(wp < 0, -1.0, 1.0).to(wp.dtype)
    absw = torch.abs(wp)
    if per_block_scale:
        scale = torch.amax(block_view(absw, spec), dim=(-1, -2))
        scale = torch.clamp(scale, min=1e-8)             # (..., GR, GC)
        s_full = expand_block_map(scale, spec)
    else:
        scale = torch.clamp(torch.amax(absw, dim=(-2, -1)), min=1e-8)
        s_full = scale[..., None, None] if scale.ndim else scale
    q = torch.round(absw / s_full * _levels(n_bits))
    q = torch.clamp(q, 0, _levels(n_bits))
    planes = extract_planes(q, n_bits)                   # (n, ..., Kp, Np)
    gr, gc = spec.grid(shape[-2], shape[-1])
    mask = torch.ones((n_bits, *shape[:-2], gr, gc), dtype=wp.dtype,
                      device=wp.device)
    return QuantizedTensor(planes=planes, sign=sign, scale=scale, mask=mask,
                           shape=shape, spec=spec)


def extract_planes(q_int: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Integer tensor (values in [0, 2^n-1]) -> binary planes (n, ...)."""
    q = q_int.to(torch.int32)
    return torch.stack([((q >> b) & 1).to(q_int.dtype)
                        for b in range(n_bits)], dim=0)


def compose_int(qt: QuantizedTensor) -> torch.Tensor:
    """sum_b planes[b] * 2^b * m[b]  (continuous during training), summed
    from bit 0 up, the order of the reference's contraction, so a drifted
    tree composes to the reference's values bit for bit."""
    contrib = qt.planes * expand_block_map(qt.mask, qt.spec)
    q = torch.zeros_like(contrib[0])
    for b in range(qt.n_bits):
        q = q + 2.0 ** b * contrib[b]
    return q                                              # (..., Kp, Np)


def compose(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Materialize the float weight matrix (..., K, N) per paper Eq. 1."""
    q = compose_int(qt)
    if qt.scale.ndim >= 1 and qt.scale.shape[-2:] == qt.mask.shape[-2:]:
        s_full = expand_block_map(qt.scale, qt.spec)
    elif qt.scale.ndim:
        s_full = qt.scale[..., None, None]
    else:
        s_full = qt.scale
    w = qt.sign * q * (s_full / _levels(qt.n_bits))
    w = w[..., :qt.shape[-2], :qt.shape[-1]]
    return w.to(dtype) if dtype is not None else w


def live_bits(qt: QuantizedTensor) -> torch.Tensor:
    """Total live (unmasked) bit count, counting wb elements under each
    mask entry."""
    return torch.sum(qt.mask) * float(qt.spec.wb_rows * qt.spec.wb_cols)


def bitwidths(qt: QuantizedTensor) -> torch.Tensor:
    """Per-block effective bit-width (bit axis reduced): (..., GR, GC)."""
    return torch.sum(qt.mask, dim=0)


def param_count(qt: QuantizedTensor) -> int:
    lead = 1
    for d in qt.shape[:-2]:
        lead *= d
    return lead * qt.shape[-2] * qt.shape[-1]
