"""Deployment transform: QAT weights -> compressed serving weights (port of
the live-tree part of ``repro.serve.deploy``).

``to_serving_params`` converts every ``FakeQuantTensor`` leaf of a live
param tree into one of two wire formats sharing the same integer grid
(``_integer_grid``):

* ``layout="packed"`` — :class:`ServingWeight`: int8 (or nibble-packed
  int4) values plus the per-WB effective scale, read by ``packed_matmul``;
* ``layout="bitplane"`` — :class:`BitplaneServingWeight`: the paper's
  precision-aware mapping, 1-bit planes (8 rows a byte), a packed sign
  plane, the binary (bit, block) mask LUT and the per-WB effective scale,
  read by ``bitplane_matmul``.  A block quantized to b bits keeps
  ``min(b, bits)`` live planes.

Layer-stack dims lead every tensor, so a stacked leaf is sliced one layer
at a time by the model's layer loop.  Checkpoint cold-start is not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..core.bitrep import _levels
from ..core.blocking import BlockingSpec, expand_block_map, pad_to_blocks
from ..core.device import resolve_device
from ..core.fakequant import FakeQuantTensor
from ..core.quantize import pack_int4, unpack_int4
from ..kernels.ref import pack_bits, unpack_bits

SERVING_LAYOUTS = ("packed", "bitplane")


@dataclasses.dataclass
class ServingWeight:
    """Packed integer weight + per-WB dequant metadata."""
    w_int: torch.Tensor      # (..., Kp, Np) int8 | (..., ceil(Kp/2), Np) u8
    scale: torch.Tensor      # (..., GR, GC) f32 per-WB effective scale
    shape: Tuple[int, ...]   # true (unpadded) shape, stack dims included
    spec: BlockingSpec
    bits: int = 8

    def layer(self, i: int) -> "ServingWeight":
        """Layer ``i`` of a stacked (L, ...) leaf: contiguous views of the
        stacked payload and scales, no copy."""
        return dataclasses.replace(self, w_int=self.w_int[i],
                                   scale=self.scale[i])

    def to(self, device) -> "ServingWeight":
        return dataclasses.replace(self, w_int=self.w_int.to(device),
                                   scale=self.scale.to(device))


@dataclasses.dataclass
class BitplaneServingWeight:
    """Bit-plane-sliced weight: the paper's precision-aware OU mapping.

    ``Kp8`` is the WB-padded row count rounded up to a byte: an odd
    block-padded K (the 9x8 geometry) packs zero rows up to the next
    multiple of 8.  ``mask[b, g, h]`` is 1 iff block (g, h) keeps plane
    ``b`` live; the weight is ``(1 - 2*sign) * sum_b 2^b plane_b mask_b *
    scale`` with the per-WB effective ``scale`` folding /(2^n - 1) and each
    block's power-of-two container rescale."""
    planes: torch.Tensor     # (..., bits, Kp8//8, Np) uint8 packed planes
    sign: torch.Tensor       # (..., Kp8//8, Np) uint8 packed sign plane
    mask: torch.Tensor       # (..., bits, GR, GC) f32 in {0., 1.}
    scale: torch.Tensor      # (..., GR, GC) f32 per-WB effective scale
    shape: Tuple[int, ...]   # true (unpadded) shape, stack dims included
    spec: BlockingSpec
    bits: int = 8

    def layer(self, i: int) -> "BitplaneServingWeight":
        """Layer ``i`` of a stacked (L, ...) leaf: contiguous views, no
        copy."""
        return dataclasses.replace(self, planes=self.planes[i],
                                   sign=self.sign[i], mask=self.mask[i],
                                   scale=self.scale[i])

    def to(self, device) -> "BitplaneServingWeight":
        return dataclasses.replace(self, planes=self.planes.to(device),
                                   sign=self.sign.to(device),
                                   mask=self.mask.to(device),
                                   scale=self.scale.to(device))


def _integer_grid(w, scale, bitwidth, spec, n_bits, bits):
    """Quantization math of the serving layouts.

    Returns ``(wq, gscale, shape)``: block-padded signed integers
    (..., Kp, Np) in [-2^(bits-1), 2^(bits-1)-1], the per-WB effective
    scale (..., GR, GC) with each block's power-of-two container rescale
    folded in, and the true (unpadded) shape."""
    shape = tuple(w.shape)
    wp = pad_to_blocks(w, spec)
    s = scale[..., None, None] if scale.ndim else scale
    levels = _levels(n_bits)
    q = torch.round(torch.abs(wp) / s * levels)
    cap = expand_block_map(2.0 ** bitwidth - 1.0, spec)
    q = torch.minimum(torch.clamp(q, min=0.0), cap)
    signed = torch.where(wp < 0, -1.0, 1.0).to(q.dtype) * q
    del wp, q
    # rescale blocks exceeding the container (bits-1 magnitude bits)
    shift = torch.clamp(bitwidth - float(bits - 1), min=0.0)
    factor = 2.0 ** shift
    f_full = expand_block_map(factor, spec)
    lim = 2 ** (bits - 1)
    wq = torch.clamp(torch.round(signed / f_full), -lim,
                     lim - 1).to(torch.int32)
    gscale = torch.broadcast_to(s / levels, bitwidth.shape) * factor
    return wq, gscale.to(torch.float32), shape


def _pack_packed(wq, gscale, shape, spec, bits) -> ServingWeight:
    if bits == 8:
        w_int = wq.to(torch.int8)
    elif bits == 4:
        if wq.shape[-2] % 2:
            # nibble pairs pack along K: pad odd block-padded K with a zero
            # row (serving_compose trims back to ``shape``)
            wq = F.pad(wq, (0, 0, 0, 1))
        w_int = pack_int4(wq, axis=-2)
    else:
        raise ValueError(bits)
    return ServingWeight(w_int=w_int.contiguous(), scale=gscale.contiguous(),
                         shape=shape, spec=spec, bits=bits)


def _pack_bitplane(wq, gscale, bitwidth, shape, spec,
                   bits) -> BitplaneServingWeight:
    """Slice the shared integer grid into packed 1-bit planes.

    A block whose live bit-width is bw keeps ``min(bw, bits)`` planes:
    below the container every magnitude fits in bw bits; at or above it
    the container rescale leaves at most ``bits`` significant bits."""
    kp = wq.shape[-2]
    kp8 = -(-kp // 8) * 8
    if kp8 != kp:                    # odd block-padded K: zero byte-pad rows
        wq = F.pad(wq, (0, 0, 0, kp8 - kp))
    mag = torch.abs(wq)
    planes = torch.stack([((mag >> b) & 1).to(torch.uint8)
                          for b in range(bits)], dim=-3)
    planes_packed = pack_bits(planes)              # (..., bits, Kp8//8, Np)
    del planes, mag
    sign_packed = pack_bits((wq < 0).to(torch.uint8))
    live = torch.clamp(bitwidth, max=float(bits))  # (..., GR, GC)
    plane_idx = torch.arange(bits, dtype=live.dtype,
                             device=live.device).reshape(bits, 1, 1)
    mask = (plane_idx < live[..., None, :, :]).to(torch.float32)
    return BitplaneServingWeight(planes=planes_packed.contiguous(),
                                 sign=sign_packed.contiguous(),
                                 mask=mask.contiguous(),
                                 scale=gscale.contiguous(), shape=shape,
                                 spec=spec, bits=bits)


def _convert_leaf(x, bits: int, layout: str = "packed"):
    if isinstance(x, FakeQuantTensor):
        wq, gscale, shape = _integer_grid(x.w, x.scale, x.bitwidth, x.spec,
                                          x.n_bits, bits)
        if layout == "bitplane":
            return _pack_bitplane(wq, gscale, x.bitwidth, shape, x.spec,
                                  bits)
        return _pack_packed(wq, gscale, shape, x.spec, bits)
    return x


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested-dict param tree (quantized
    weights are leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_to(tree, device):
    """Move every tensor (and quantized weight) of a tree to ``device``."""
    return tree_map(lambda x: x.to(device) if hasattr(x, "to") else x, tree)


def to_serving_params(params: Any, bits: int = 8, layout: str = "packed",
                      device=None) -> Any:
    """Convert every quantized leaf of a live QAT tree to the chosen wire
    format (``layout`` "packed" or "bitplane").  The tree is moved to
    ``device`` (the CUDA card unless the caller names another) and
    converted there, one leaf at a time."""
    if layout not in SERVING_LAYOUTS:
        raise ValueError(f"unknown serving layout {layout!r}; choose from "
                         f"{SERVING_LAYOUTS}")
    dev = resolve_device(device)
    return tree_map(lambda x: _convert_leaf(
        x.to(dev) if hasattr(x, "to") else x, bits, layout), params)


def bitplane_stream_bytes(sw: BitplaneServingWeight) -> int:
    """Streamed bytes for one pass over a bit-plane leaf, by occupancy.

    Each live (bit, block) mask entry streams one wbr x wbc 1-bit tile; a
    block with any live plane also streams its sign tile (fully masked
    blocks are skipped whole).  The per-WB scale LUT counts as stored f32
    and the binary mask LUT at one bit per entry.  Byte-pad rows are not
    billed."""
    wbr, wbc = sw.spec.wb_rows, sw.spec.wb_cols
    live_planes = int(sw.mask.sum(dtype=torch.float64))  # exact count
    live_blocks = int((sw.mask.sum(dim=-3) > 0).sum())
    plane_bits = (live_planes + live_blocks) * wbr * wbc
    return int(-(-plane_bits // 8) + -(-sw.mask.numel() // 8)
               + sw.scale.nbytes)


def weight_stream_bytes(params) -> int:
    """Device-memory bytes of weight state one full forward step streams:
    a bit-plane leaf counts its per-block plane occupancy
    (:func:`bitplane_stream_bytes`), a packed ServingWeight its payload
    plus per-WB scales, a FakeQuantTensor and a plain tensor every array
    they hold."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, BitplaneServingWeight):
            total += bitplane_stream_bytes(leaf)
        elif isinstance(leaf, ServingWeight):
            total += leaf.w_int.nbytes + leaf.scale.nbytes
        elif isinstance(leaf, FakeQuantTensor):
            total += leaf.w.nbytes + leaf.scale.nbytes + leaf.bitwidth.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.nbytes
    return int(total)


def serving_compose(sw: ServingWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantization of a packed leaf (int8/int4 -> ``dtype`` weights)."""
    if sw.bits == 8:
        wq = sw.w_int.to(torch.float32)
    else:
        wq = unpack_int4(sw.w_int, axis=-2).to(torch.float32)
    s_full = expand_block_map(sw.scale, sw.spec)
    # odd block-padded K packs one zero row; trim back to the scale map
    wq = wq[..., :s_full.shape[-2], :]
    w = wq * s_full
    k, n = sw.shape[-2], sw.shape[-1]
    return w[..., :k, :n].to(dtype)


def bitplane_serving_compose(sw: BitplaneServingWeight,
                             dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantization of a bit-plane leaf (the dense backend).

    Elementwise identical to :func:`serving_compose` on the packed form of
    the same leaf: the plane sum reproduces each |wq| exactly and the
    per-WB effective scale is the same LUT."""
    planes = unpack_bits(sw.planes)                # (..., bits, Kp8, Np)
    sign = 1.0 - 2.0 * unpack_bits(sw.sign)        # (..., Kp8, Np)
    m_full = expand_block_map(sw.mask, sw.spec)    # (..., bits, Kp, Np)
    kp = m_full.shape[-2]
    weights = (2.0 ** torch.arange(sw.bits, dtype=torch.float32,
                                   device=planes.device)).reshape(sw.bits,
                                                                  1, 1)
    mag = torch.sum(planes[..., :kp, :] * m_full * weights, dim=-3)
    del planes, m_full
    w = sign[..., :kp, :] * (mag * expand_block_map(sw.scale, sw.spec))
    k, n = sw.shape[-2], sw.shape[-1]
    return w[..., :k, :n].to(dtype)
