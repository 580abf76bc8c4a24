"""Kernel-ready layouts of a trained weight and the dense calls on them
(port of ``repro.kernels.ops``).

``to_bitplane_layout`` / ``to_packed_layout`` turn one trained
``QuantizedTensor`` matrix (after re-quantization) into the tensors that
``bitplane_matmul`` / ``packed_matmul`` consume, bit for bit the
reference's; ``bwq_dense_bitplane`` / ``bwq_dense_packed`` are ``y = x @
W`` on them: the CUDA kernel for a CUDA ``x``, its plain version for a
CPU ``x`` (the wrappers' own dispatch), and an error on any other device.
The layouts are contiguous, so a layer view of a stacked leaf converts
too.  ``truncate_mask_topk`` is the speculative draft's view of a
bit-plane mask LUT.  The wire-format contract (``SW*`` / ``BP*`` rules) is the
reference module's docstring; ``serve.deploy`` carries the same formats
inside a param tree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.bitrep import QuantizedTensor, _levels, compose_int
from ..core.blocking import expand_block_map
from ..core.quantize import pack_int4
from .bitplane_matmul import bitplane_matmul
from .packed_matmul import packed_matmul
from .ref import pack_bits


class BitplaneLayout(NamedTuple):
    planes_packed: torch.Tensor  # (n, K//8, N) uint8
    sign_packed: torch.Tensor    # (K//8, N) uint8
    mask: torch.Tensor           # (n, K//wbr, N//wbc) f32
    scale: torch.Tensor          # (1,) per-layer OR (K//wbr, N//wbc) per-WB
    n_bits: int
    wbr: int
    wbc: int


class PackedLayout(NamedTuple):
    w_int: torch.Tensor          # int8 (K, N) or uint8 (K//2, N) nibbles
    scale: torch.Tensor          # (K//wbr, N//wbc)
    bits: int
    wbr: int
    wbc: int


def _magnitudes(qt: QuantizedTensor) -> torch.Tensor:
    """The integer magnitudes ``round(compose_int)`` clipped to the
    ``n_bits`` grid, as f32 (Kp, Np)."""
    return torch.clamp(torch.round(compose_int(qt)), 0.0,
                       _levels(qt.n_bits))


def to_bitplane_layout(qt: QuantizedTensor) -> BitplaneLayout:
    """One matrix's bit planes and sign, 8 rows a byte, its mask LUT and
    its per-layer scale as a (1,) tensor; the block-padded K must be a
    multiple of 8."""
    if qt.planes.ndim != 3:
        raise ValueError(f"one matrix expected, got planes "
                         f"{tuple(qt.planes.shape)}")
    q = _magnitudes(qt).to(torch.int32)
    planes = torch.stack([((q >> b) & 1).to(torch.uint8)
                          for b in range(qt.n_bits)])
    sign = pack_bits((qt.sign < 0).to(torch.uint8)[None])[0]
    return BitplaneLayout(pack_bits(planes), sign,
                          qt.mask.to(torch.float32).contiguous(),
                          qt.scale.to(torch.float32).reshape(1), qt.n_bits,
                          qt.spec.wb_rows, qt.spec.wb_cols)


def to_packed_layout(qt: QuantizedTensor, bits: int = 8) -> PackedLayout:
    """Signed magnitudes on a ``bits`` grid with each WB's scale folded:
    a block whose live bit-width ``bw`` exceeds the container's ``bits -
    1`` magnitude bits is divided by ``2^(bw - bits + 1)`` (rounded) and
    its scale entry multiplied by the same, exact when ``bw <= bits -
    1``.  int4 packs nibble pairs along K (row 2j in the low nibble)."""
    if bits not in (8, 4):
        raise ValueError(bits)
    signed = qt.sign * _magnitudes(qt)
    gscale = qt.scale.to(torch.float32) / _levels(qt.n_bits)
    gr, gc = qt.mask.shape[-2], qt.mask.shape[-1]
    block_scale = gscale.reshape(1, 1).expand(gr, gc)
    bw = torch.sum(qt.mask, dim=0)                         # (GR, GC)
    factor = 2.0 ** torch.clamp(bw - float(bits - 1), min=0.0)
    lim = 2 ** (bits - 1)
    wq = torch.clamp(torch.round(signed / expand_block_map(factor, qt.spec)),
                     -lim, lim - 1).to(torch.int32)
    w_int = wq.to(torch.int8) if bits == 8 else pack_int4(wq, axis=0)
    return PackedLayout(w_int.contiguous(), block_scale * factor, bits,
                        qt.spec.wb_rows, qt.spec.wb_cols)


def truncate_mask_topk(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Draft-model view of a bit-plane mask LUT: keep each block's top-k
    live planes.

    ``mask`` is (..., bits, GR, GC) binary f32, prefix-monotone along the
    bit axis (a block with occupancy ``o`` keeps planes ``0..o-1``).  The
    result keeps planes ``max(o-k, 0)..o-1``, so composing the same
    payload through it floors away the low ``o-k`` magnitude bits.  It is
    NOT prefix-monotone: it zeroes the low planes, and ``bitplane_matmul``
    honours the mask plane by plane."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    bits = mask.shape[-3]
    occ = torch.sum(mask, dim=-3, keepdim=True)       # (..., 1, GR, GC)
    idx = torch.arange(bits, dtype=mask.dtype,
                       device=mask.device).reshape(bits, 1, 1)
    return mask * (idx >= occ - float(k)).to(mask.dtype)


def bwq_dense_bitplane(x: torch.Tensor, layout: BitplaneLayout
                       ) -> torch.Tensor:
    """y = x @ W from the bit-plane layout, f32 (M, N)."""
    if layout.planes_packed.shape[0] != layout.n_bits:
        raise ValueError(f"layout of {layout.n_bits} bits holds "
                         f"{layout.planes_packed.shape[0]} planes")
    return bitplane_matmul(x, layout.planes_packed, layout.sign_packed,
                           layout.mask, layout.scale, wbr=layout.wbr,
                           wbc=layout.wbc)


def bwq_dense_packed(x: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """y = x @ W from the packed-integer layout, f32 (M, N)."""
    return packed_matmul(x, layout.w_int, layout.scale, bits=layout.bits,
                         wbr=layout.wbr, wbc=layout.wbc)
