"""Re-quantization (paper Fig. 3a), deployment packing and the
straight-through helpers of quantization-aware training (port of
``repro.core.quantize``).

During QAT the bit planes drift away from exact binary; at scheduled steps
they are *re-quantized*: compose the (masked) integer value of each
weight, round and clip it to the representable range, and re-extract
exact binary planes.  Pruned planes (mask == 0) contribute nothing and
stay zero afterwards, so sparsity never decreases.

This module is also the one owner of the int4 nibble wire format shared by
the deployed weights (K axis) and the int4 KV cache (head axis).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .bitrep import QuantizedTensor, _levels, compose_int, extract_planes
from .blocking import block_view, expand_block_map


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


def requantize(qt: QuantizedTensor, rescale: bool = False) -> QuantizedTensor:
    """Snap the continuous bit planes back to exact binary values."""
    q = compose_int(qt)                                   # (..., Kp, Np)
    q = torch.clamp(torch.round(q), 0.0, _levels(qt.n_bits))
    planes = extract_planes(q, qt.n_bits).to(qt.planes.dtype)
    new = dataclasses.replace(qt, planes=planes)
    if rescale:
        # optional (beyond the paper): refit a per-block scale to the
        # surviving range
        blk_max = torch.amax(block_view(q, qt.spec), dim=(-1, -2))
        if qt.scale.shape[-2:] == qt.mask.shape[-2:] and qt.scale.ndim >= 2:
            denom = torch.clamp(blk_max, min=1.0)
            new = dataclasses.replace(
                new, scale=qt.scale * denom / _levels(qt.n_bits))
    return new


class PackedWeight(NamedTuple):
    """Deployment layout: integer magnitudes + per-block metadata.

    ``values`` holds sign*magnitude as int8 (n_bits <= 7) or int16 (8-bit
    magnitudes span [0, 255]); ``bitwidth`` is the memory controller's LUT
    of the paper (per-WB bit count)."""

    values: torch.Tensor     # (..., Kp, Np) int8/int16 signed magnitudes
    scale: torch.Tensor      # per-layer or per-block scale
    bitwidth: torch.Tensor   # (..., GR, GC) int32
    shape: tuple
    n_bits: int


def pack(qt: QuantizedTensor) -> PackedWeight:
    """QAT representation -> deployment representation (after
    :func:`requantize`)."""
    q = torch.clamp(torch.round(compose_int(qt)), 0.0, _levels(qt.n_bits))
    signed = qt.sign * q
    dt = torch.int16 if qt.n_bits >= 8 else torch.int8
    bw = torch.sum(qt.mask, dim=0).to(torch.int32)
    return PackedWeight(values=signed.to(dt), scale=qt.scale, bitwidth=bw,
                        shape=qt.shape, n_bits=qt.n_bits)


def unpack_to_float(pw: PackedWeight, spec,
                    dtype=torch.float32) -> torch.Tensor:
    """Dequantize a PackedWeight back to (..., K, N) float (reference
    path)."""
    vals = pw.values.to(dtype)
    if pw.scale.ndim >= 2 and pw.scale.shape[-2:] == pw.bitwidth.shape[-2:]:
        s_full = expand_block_map(pw.scale.to(dtype), spec)
    elif pw.scale.ndim:
        s_full = pw.scale.to(dtype)[..., None, None]
    else:
        s_full = pw.scale.to(dtype)
    w = vals * (s_full / _levels(pw.n_bits))
    k, n_ = pw.shape[-2], pw.shape[-1]
    return w[..., :k, :n_]


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through rounding (identity gradient), the reference's own
    expression: the forward value is ``x + (round(x) - x)``, which is not
    always ``round(x)`` bit for bit."""
    return x + (torch.round(x) - x).detach()


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Abs(torch.autograd.Function):
    """``|x|`` with the reference framework's gradient: +1 at x = +-0
    (``where(x >= 0, g, -g)``), where ``torch.abs`` passes 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose gradient at +-0 is +1, as the reference's (see
    :class:`_Abs`).  Every ``abs`` on a quantizer's gradient path goes
    through here; without a gradient to track it is ``torch.abs``."""
    return _Abs.apply(x) if _tracked(x) else torch.abs(x)


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``maximum(x, lo)`` for a number ``lo``, as the reference's
    ``jnp.maximum``: at a tie x passes half the gradient (``torch.clamp``
    passes all of it).  Without a gradient to track it is the clamp (the
    same values, with no constant tensor to build)."""
    if _tracked(x):
        return torch.maximum(x, x.new_full((), lo))
    return torch.clamp(x, min=lo)


def clip(x: torch.Tensor, lo: float, hi) -> torch.Tensor:
    """``clip(x, lo, hi)`` as the reference's ``jnp.clip``:
    ``minimum(maximum(x, lo), hi)``, a tie at either end passing half the
    gradient.  ``hi`` is a number or a tensor broadcasting with ``x``."""
    y = maximum(x, lo)
    if isinstance(hi, torch.Tensor):
        return torch.minimum(y, hi)
    if _tracked(y):
        return torch.minimum(y, y.new_full((), hi))
    return torch.clamp(y, max=hi)
