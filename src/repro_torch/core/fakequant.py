"""Memory-scalable BWQ-A mode for billion-parameter training (port of
``repro.core.fakequant``).

The paper trains weights in bit-level representation (8 float planes per
weight); a ``FakeQuantTensor`` keeps one float master weight plus the
per-WB bit-width LUT instead.  Composing it rounds to the layer scale grid
through a straight-through estimator and saturates each WB at its
``2^bw - 1`` magnitude ceiling: for exact-binary states the same weight as
the bit-plane mode.  Its group-Lasso surrogate is a per-WB L2 on the
scaled weights; maintenance snaps the master weight onto the grid and
lowers each WB's bit-width to what its largest magnitude needs (never
raising it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .bitrep import _levels
from .blocking import (BlockingSpec, block_elem_counts, block_view,
                       expand_block_map, pad_to_blocks)
from .quantize import abs_, clip, ste_round


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


def _scale_full(fq: FakeQuantTensor) -> torch.Tensor:
    return fq.scale[..., None, None] if fq.scale.ndim else fq.scale


def fq_compose(fq: FakeQuantTensor, dtype=None) -> torch.Tensor:
    """STE fake-quantized weight with per-WB saturation (Eq. 1
    semantics)."""
    wp = pad_to_blocks(fq.w, fq.spec)
    s = _scale_full(fq)
    levels = _levels(fq.n_bits)
    q = ste_round(abs_(wp) / s * levels)
    cap = expand_block_map(2.0 ** fq.bitwidth - 1.0, fq.spec)
    q = clip(q, 0.0, cap)
    w = torch.where(wp < 0, -1.0, 1.0).to(wp.dtype) * q * (s / levels)
    w = w[..., :fq.shape[-2], :fq.shape[-1]]
    return w.to(dtype) if dtype is not None else w


def fq_maintenance(fq: FakeQuantTensor) -> FakeQuantTensor:
    """Re-quantization + block-wise precision adjustment (monotone).

    Snaps ``w`` to the grid, recomputes each WB's minimal bit-width (the
    position of the highest set bit over the block) and intersects it with
    the previous LUT, so precision never grows back."""
    wp = pad_to_blocks(fq.w, fq.spec)
    s = _scale_full(fq)
    levels = _levels(fq.n_bits)
    cap = expand_block_map(2.0 ** fq.bitwidth - 1.0, fq.spec)
    q = clip(torch.round(torch.abs(wp) / s * levels), 0.0, cap)
    blk_max = torch.amax(block_view(q, fq.spec), dim=(-1, -2))
    need = torch.ceil(torch.log2(blk_max + 1.0))
    new_bw = torch.minimum(fq.bitwidth, need)
    w_snapped = torch.where(wp < 0, -1.0, 1.0).to(wp.dtype) * q \
        * (s / levels)
    w_snapped = w_snapped[..., :fq.shape[-2], :fq.shape[-1]]
    return dataclasses.replace(fq, w=w_snapped.to(fq.w.dtype),
                               bitwidth=new_bw)


def fq_group_lasso(fq: FakeQuantTensor) -> torch.Tensor:
    """Per-WB L2 surrogate of the bit-level group Lasso
    (scale-normalized)."""
    wp = pad_to_blocks(fq.w, fq.spec)
    bw = block_view(wp / _scale_full(fq), fq.spec)
    sq = torch.sum(bw * bw, dim=(-1, -2))
    alive = (fq.bitwidth > 0).to(wp.dtype)
    return torch.sum(torch.sqrt(sq + 1e-12) * alive)


def fq_live_bits(fq: FakeQuantTensor) -> torch.Tensor:
    elems = block_elem_counts((fq.shape[-2], fq.shape[-1]), fq.spec,
                              device=fq.bitwidth.device)
    return torch.sum(fq.bitwidth * elems.to(fq.bitwidth.dtype))
