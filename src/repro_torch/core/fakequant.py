"""Memory-scalable BWQ-A weights (forward only; port of
``repro.core.fakequant``).

A ``FakeQuantTensor`` keeps one float master weight plus the per-WB
bit-width LUT; composing it rounds to the layer scale grid and saturates
each WB at its ``2^bw - 1`` magnitude ceiling.  The port serves, it does
not train, so rounding is plain ``round`` (the reference wraps it in a
straight-through estimator for gradients).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .bitrep import _levels
from .blocking import BlockingSpec, expand_block_map, pad_to_blocks


@dataclasses.dataclass
class FakeQuantTensor:
    w: torch.Tensor          # (..., K, N) float master weight
    scale: torch.Tensor      # per-layer (lead dims) scale
    bitwidth: torch.Tensor   # (..., GR, GC) float live-bit LUT
    shape: Tuple[int, ...]
    spec: BlockingSpec
    n_bits: int = 8

    def layer(self, i: int) -> "FakeQuantTensor":
        """Slice layer ``i`` of a stacked (L, ...) leaf (views, no copy)."""
        return dataclasses.replace(self, w=self.w[i], scale=self.scale[i],
                                   bitwidth=self.bitwidth[i])

    def to(self, device) -> "FakeQuantTensor":
        return dataclasses.replace(self, w=self.w.to(device),
                                   scale=self.scale.to(device),
                                   bitwidth=self.bitwidth.to(device))


def fq_from_float(w: torch.Tensor, n_bits: int = 8,
                  spec: Optional[BlockingSpec] = None) -> FakeQuantTensor:
    spec = (spec or BlockingSpec()).resolve(w.shape[-2], w.shape[-1])
    shape = tuple(w.shape)
    scale = torch.clamp(torch.amax(torch.abs(w), dim=(-2, -1)), min=1e-8)
    gr, gc = spec.grid(shape[-2], shape[-1])
    bitwidth = torch.full((*shape[:-2], gr, gc), float(n_bits),
                          dtype=w.dtype, device=w.device)
    return FakeQuantTensor(w=w, scale=scale, bitwidth=bitwidth, shape=shape,
                           spec=spec, n_bits=n_bits)


def fq_compose(fq: FakeQuantTensor, dtype=None) -> torch.Tensor:
    """Fake-quantized weight with per-WB saturation (Eq. 1 semantics)."""
    wp = pad_to_blocks(fq.w, fq.spec)
    s = fq.scale[..., None, None] if fq.scale.ndim else fq.scale
    levels = _levels(fq.n_bits)
    q = torch.round(torch.abs(wp) / s * levels)
    cap = expand_block_map(2.0 ** fq.bitwidth - 1.0, fq.spec)
    q = torch.minimum(torch.clamp(q, min=0.0), cap)
    sign = torch.where(wp < 0, -1.0, 1.0).to(wp.dtype)
    w = sign * q * (s / levels)
    k, n = fq.shape[-2], fq.shape[-1]
    w = w[..., :k, :n]
    return w.to(dtype) if dtype is not None else w
