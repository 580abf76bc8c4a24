"""Deployment transform: QAT weights -> packed serving weights (port of the
``layout="packed"`` part of ``repro.serve.deploy``).

``to_serving_params`` converts every ``FakeQuantTensor`` leaf of a live
param tree into a :class:`ServingWeight`: int8 (or nibble-packed int4)
values plus the per-WB effective scale, the wire format the
``packed_matmul`` kernel reads.  Layer-stack dims lead every tensor, so a
stacked leaf is sliced one layer at a time by the model's layer loop.
Checkpoint cold-start and the bit-plane layout are not ported yet.
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


def _convert_leaf(x, bits: int):
    if isinstance(x, FakeQuantTensor):
        wq, gscale, shape = _integer_grid(x.w, x.scale, x.bitwidth, x.spec,
                                          x.n_bits, bits)
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
    """Convert every quantized leaf of a live QAT tree to the packed wire
    format.  The tree is moved to ``device`` (the CUDA card unless the
    caller names another) and converted there, one leaf at a time."""
    if layout != "packed":
        raise ValueError(f"layout {layout!r} is not ported yet; the port "
                         f"serves layout='packed'")
    dev = resolve_device(device)
    return tree_map(lambda x: _convert_leaf(
        x.to(dev) if hasattr(x, "to") else x, bits), params)


def weight_stream_bytes(params) -> int:
    """Device-memory bytes of weight state one full forward step streams:
    a packed ServingWeight counts its payload plus per-WB scales, a
    FakeQuantTensor and a plain tensor every array they hold."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, ServingWeight):
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
