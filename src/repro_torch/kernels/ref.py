"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

They materialize what the kernels exist to avoid (the dequantized f32
weight, the contiguous f32 KV view), so they are the allclose targets
and the CPU path, never the hot path on the card.

Layouts:

* packed-int: ``w_int`` int8 (K, N) signed values (int8 mode) or
  (ceil(K/2), N) uint8 nibble pairs (int4 mode, row 2j in the low
  nibble); ``scale`` (K//wbr, N//wbc) per-WB effective f32 scale.
* page pool: k/v (P, page, KV, dh) int8 / float, or (P, page, KV, dh//2)
  uint8 nibble pairs along dh; per-token scales (P, page, KV) f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .tiling import pad_dim

NEG_INF = -2.0e38


def expand_mask(mask: torch.Tensor, wbr: int, wbc: int) -> torch.Tensor:
    m = torch.repeat_interleave(mask, wbr, dim=-2)
    return torch.repeat_interleave(m, wbc, dim=-1)


def _unpack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """(..., d//2) uint8 nibble pairs -> (..., d) int32 in [-8, 7]
    (``core.quantize.pack_int4`` layout: even positions in the low
    nibble)."""
    ui = u.to(torch.int32)
    lo = ui & 0xF
    hi = (ui >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*u.shape[:-1],
                                                 u.shape[-1] * 2)


def packed_matmul_ref(x: torch.Tensor, w_int: torch.Tensor,
                      scale: torch.Tensor, bits: int = 8, wbr: int = 8,
                      wbc: int = 128) -> torch.Tensor:
    """y = x @ (dequant(w_int) * per-block scale), f32 (M, N).

    Shares the kernel's geometry contract: K/N come from the scale grid;
    an int4 odd block-padded K carries one zero pad row in the last byte
    (trimmed here), and x may have fewer than K columns (zero-filled)."""
    if bits == 8:
        w = w_int.to(torch.float32)
    elif bits == 4:
        # nibble pairs run along K (dim -2): unpack on the last dim of the
        # transpose, then turn back
        w = _unpack_nibbles(w_int.transpose(0, 1)).transpose(0, 1)
        w = w.to(torch.float32)
    else:
        raise ValueError(bits)
    s = expand_mask(scale.to(torch.float32), wbr, wbc)
    w = w[:s.shape[0]]
    x = pad_dim(x.to(torch.float32), 1, s.shape[0])
    return x @ (w * s)


def paged_attention_ref(q, k_pages, v_pages, k_scale, v_scale, table,
                        kv_len, *, window: Optional[int] = None,
                        softcap: float = 0.0) -> torch.Tensor:
    """Gather-then-softmax version of ``kernels.paged_attention``.

    q (B, KV, G, dh); pool leaves (P, page, KV, dh|dh//2); per-token scales
    or None; (B, nb) table; (B,) fill levels.  Returns (B, KV, G, dh) f32."""
    b, kv, g, dh = q.shape

    def gather(leaf):
        x = leaf[table.long()]                       # (B, nb, page, ...)
        return x.reshape(b, -1, *leaf.shape[2:])     # (B, nb*page, ...)

    k, v = gather(k_pages), gather(v_pages)
    if k.dtype == torch.uint8:                       # nibble-packed int4
        k, v = _unpack_nibbles(k), _unpack_nibbles(v)
    k, v = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        k = k * gather(k_scale)[..., None]
        v = v * gather(v_scale)[..., None]
    t = k.shape[1]
    s = torch.einsum("bkgd,btkd->bkgt", q.to(torch.float32), k)
    s = s / math.sqrt(float(dh))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(t, dtype=torch.int32, device=q.device)[None, :]
    ln = torch.as_tensor(kv_len, dtype=torch.int32,
                         device=q.device).reshape(b)[:, None]
    valid = pos < ln
    if window is not None and int(window) > 0:
        valid = valid & (pos >= ln - int(window))
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, v)
