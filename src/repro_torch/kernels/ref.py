"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

They materialize what the kernels exist to avoid (the dequantized f32
weight, the contiguous f32 KV view), so they are the allclose targets
and the CPU path, never the hot path on the card.

Layouts:

* bit-plane: ``planes`` (n, K8//8, N) uint8, bit r of byte j = the plane's
  value at row 8j+r; ``sign`` (K8//8, N) uint8 (1 = negative); ``mask``
  (n, K//wbr, N//wbc) f32 in {0, 1}; ``scale`` (K//wbr, N//wbc) per-WB
  effective f32 scale, or a per-layer (1,) scalar.
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


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//8, N) uint8 -> (..., K, N) {0, 1} float32 (row-major
    bits: row 8j+r is bit r of byte j)."""
    return _unpack_bits_u8(packed).to(torch.float32)


def _unpack_bits_u8(packed: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    x = (packed.unsqueeze(-2) >> shifts[:, None]) & 1   # (..., K//8, 8, N)
    return x.reshape(*packed.shape[:-2], packed.shape[-2] * 8,
                     packed.shape[-1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., K, N) {0, 1} -> (..., K//8, N) uint8 (inverse of
    :func:`unpack_bits`; K must be a multiple of 8)."""
    k = bits.shape[-2]
    x = bits.reshape(*bits.shape[:-2], k // 8, 8, bits.shape[-1])
    x = x.to(torch.uint8)
    out = torch.zeros(x.shape[:-2] + (x.shape[-1],), dtype=torch.uint8,
                      device=bits.device)
    for r in range(8):
        out |= x[..., r, :] << r
    return out


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


def bitplane_matmul_ref(x: torch.Tensor, planes: torch.Tensor,
                        sign: torch.Tensor, mask: torch.Tensor,
                        scale: torch.Tensor, wbr: int = 8,
                        wbc: int = 128) -> torch.Tensor:
    """y = x @ W, W = (1 - 2*sign) * sum_b 2^b * plane_b * mask_b * scale,
    f32 (M, N) with N = ``planes.shape[-1]``.

    ``scale`` is the per-WB effective LUT (K//wbr, N//wbc), applied as
    is, or a per-layer (1,) scalar divided by ``2^n - 1`` here.  Byte-pad
    rows of ``planes`` past the mask's K//wbr WB rows are trimmed, ``x``
    with fewer than K columns is zero-filled, and ``planes`` may have
    fewer columns than the mask grid covers (ragged N).  The magnitudes
    are composed in integers, which equals the reference's float sum for
    a mask of 0s and 1s (the layout's contract)."""
    n = planes.shape[0]
    kp, ncol = mask.shape[-2] * wbr, planes.shape[-1]
    live = expand_mask(mask != 0, wbr, wbc)[..., :ncol]  # (n, Kp, N)
    bits = _unpack_bits_u8(planes)[:, :kp]
    mag = torch.zeros(bits.shape[1:], dtype=torch.int32, device=x.device)
    for b in range(n):
        mag |= (bits[b] & live[b]).to(torch.int32) << b
    del bits, live
    neg = _unpack_bits_u8(sign)[:kp].bool()
    w = torch.where(neg, -mag, mag).to(torch.float32)
    if scale.ndim == 2:
        w = w * expand_mask(scale.to(torch.float32), wbr, wbc)[:, :ncol]
    else:
        w = w * (scale.to(torch.float32).reshape(()) / (2.0 ** n - 1.0))
    return pad_dim(x.to(torch.float32), 1, kp) @ w


def pact_quant_ref(x: torch.Tensor, beta: torch.Tensor,
                   act_bits: int) -> torch.Tensor:
    """Symmetric PACT clip + uniform quantization, computed in x's dtype
    (as the TPU kernel does; for f32 it is the reference oracle)."""
    levels = torch.tensor(float(2 ** (act_bits - 1) - 1), dtype=x.dtype,
                          device=x.device)
    b = torch.clamp(beta.reshape(()).to(torch.float32), min=1e-6).to(x.dtype)
    y = torch.minimum(torch.maximum(x, -b), b)
    return torch.round(y / b * levels) * (b / levels)


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
