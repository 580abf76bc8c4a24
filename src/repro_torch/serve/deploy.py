"""Deployment transform: QAT weights -> compressed serving weights (port of
the live-tree part of ``repro.serve.deploy``).

``to_serving_params`` converts every quantized leaf (``QuantizedTensor``
or ``FakeQuantTensor``) of a live param tree into one of two wire formats
sharing the same integer grid (``_integer_grid``):

* ``layout="packed"`` — :class:`ServingWeight`: int8 (or nibble-packed
  int4) values plus the per-WB effective scale, read by ``packed_matmul``;
* ``layout="bitplane"`` — :class:`BitplaneServingWeight`: the paper's
  precision-aware mapping, 1-bit planes (8 rows a byte), a packed sign
  plane, the binary (bit, block) mask LUT and the per-WB effective scale,
  read by ``bitplane_matmul``.  A block quantized to b bits keeps
  ``min(b, bits)`` live planes.

Layer-stack dims lead every tensor, so a stacked leaf is sliced one layer
at a time by the model's layer loop (and an MoE expert stack (L, E, K, N)
one expert at a time by the capacity dispatch).  A stacked quantized leaf
is converted one layer at a time and the results stacked: the conversion
is elementwise, so the payload is the same bit for bit, and the f32
temporaries shrink to one layer's size.

``to_serving_params`` also cold-starts from a **checkpoint directory**
(a training save, ``repro_torch.ckpt``): each quantized leaf is read on
the host, moved to the device, converted there and its host arrays
dropped, so neither the host nor the device ever holds the dense tree
(``stats`` reports the host's peak against the dense tree's bytes).  By
default the result is contract-checked (``analysis.contracts``).
:func:`repack_bitplane_leaf` re-packs a bit-plane leaf to lower per-block
occupancies (the autotuner's output).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F

from ..core.bitrep import QuantizedTensor, _levels, compose
from ..core.blocking import BlockingSpec, expand_block_map, pad_to_blocks
from ..core.device import resolve_device
from ..core.fakequant import FakeQuantTensor
from ..core.quantize import pack_int4, unpack_int4
from ..core.state import quant_nodes, replace_nodes, tree_leaves, tree_map
from ..kernels.ref import pack_bits, unpack_bits, unpack_bits_u8

_QUANT = (QuantizedTensor, FakeQuantTensor)

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
    # the leaf's tree path, set by the autotune calibration
    # (``tag_bitplane_leaves``): carried by ``layer()`` and ``to()``, it
    # lets ``qmatmul``'s recorder key activation moments back to the
    # stacked leaf.  Empty outside calibration.
    tag: str = ""

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


@dataclasses.dataclass
class ShardedServingWeight(ServingWeight):
    """A rank's shard of a packed leaf under a mesh: ``w_int`` holds its
    window, ``scale`` stays whole, ``shard`` (a ``dist.parallel.
    LocalShard``) says where the window lies."""
    shard: Any = None


@dataclasses.dataclass
class ShardedBitplaneServingWeight(BitplaneServingWeight):
    """A rank's shard of a bit-plane leaf under a mesh: ``planes`` and
    ``sign`` hold its window, ``mask`` and ``scale`` stay whole."""
    shard: Any = None


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


def _quantize_leaf(w, scale, bitwidth, spec, n_bits, bits, layout):
    wq, gscale, shape = _integer_grid(w, scale, bitwidth, spec, n_bits, bits)
    if layout == "bitplane":
        return _pack_bitplane(wq, gscale, bitwidth, shape, spec, bits)
    return _pack_packed(wq, gscale, shape, spec, bits)


def _stack_leaves(parts: List[Any], shape: Tuple[int, ...]) -> Any:
    """Stack per-layer serving weights back into one (L, ...) leaf."""
    fields = [f.name for f in dataclasses.fields(parts[0])
              if isinstance(getattr(parts[0], f.name), torch.Tensor)]
    return dataclasses.replace(parts[0], shape=shape, **{
        name: torch.stack([getattr(p, name) for p in parts])
        for name in fields})


def _convert_leaf(x, bits: int, layout: str = "packed"):
    """A leaf's serving form; a stacked quantized leaf (more than two
    dims) converts one layer at a time."""
    if isinstance(x, (QuantizedTensor, FakeQuantTensor)):
        payload = x.w if isinstance(x, FakeQuantTensor) else x.sign
        if payload.ndim > 2:
            return _stack_leaves(
                [_convert_layer(x.layer(i), bits, layout)
                 for i in range(payload.shape[0])], tuple(x.shape))
    return _convert_layer(x, bits, layout)


def _convert_layer(x, bits: int, layout: str):
    if isinstance(x, QuantizedTensor):
        return _quantize_leaf(compose(x), x.scale, torch.sum(x.mask, dim=0),
                              x.spec, x.n_bits, bits, layout)
    if isinstance(x, FakeQuantTensor):
        return _quantize_leaf(x.w, x.scale, x.bitwidth, x.spec, x.n_bits,
                              bits, layout)
    return x


def tree_to(tree, device):
    """Move every tensor (and quantized weight) of a tree to ``device``."""
    return tree_map(lambda x: x.to(device) if hasattr(x, "to") else x, tree)


def _serving_params_from_ckpt(path: str, bits: int, layout: str,
                              template: Any, stats: Any, dev) -> Any:
    """Stream a checkpoint into serving form, one leaf at a time.

    A leaf's arrays are read on the host, moved to ``dev`` and converted
    there (``_convert_leaf``, a stacked leaf a layer at a time); the host
    arrays are dropped before the next leaf is read.  ``template`` (the
    abstract tree of ``ModelAPI.abstract_params``) carries the static
    structure the checkpoint does not store.  A ``TrainState``
    checkpoint is recognized by its ``.params`` key prefix, and its
    optimizer state is never read."""
    from ..ckpt.checkpoint import CheckpointReader, to_tensor
    reader = CheckpointReader(path)
    try:
        keys = set(reader.keys())
        nodes = list(quant_nodes(template, _QUANT + (torch.Tensor,))
                     .items())
        prefix = ""
        probe = nodes[0][0] if nodes else ""
        if not any(k.startswith(probe) for k in keys) \
                and any(k.startswith(".params") for k in keys):
            prefix = ".params"
        peak = in_flight = dense = 0
        out = {}
        for p, node in nodes:
            base = prefix + p
            if isinstance(node, _QUANT):
                names = [f.name for f in dataclasses.fields(node)
                         if isinstance(getattr(node, f.name), torch.Tensor)]
                keyed = [(n, f"{base}.{n}") for n in names]
            else:
                keyed = [(None, base)]
            arrays = [reader.read(k) for _, k in keyed]
            in_flight += sum(a.nbytes for a in arrays)
            peak = max(peak, in_flight)
            tensors = [to_tensor(a, reader.manifest[k].get("dtype"), dev)
                       for a, (_, k) in zip(arrays, keyed)]
            for a in arrays:
                in_flight -= a.nbytes
                dense += a.nbytes
            del arrays
            if isinstance(node, _QUANT):
                rebuilt = dataclasses.replace(node, **{
                    n: t for (n, _), t in zip(keyed, tensors)})
                out[p] = _convert_leaf(rebuilt, bits, layout)
            else:
                out[p] = tensors[0]
            del tensors
        if isinstance(stats, dict):
            stats.update(peak_host_bytes=peak, dense_tree_bytes=dense,
                         leaves=len(nodes), source=path)
        return replace_nodes(template, out)
    finally:
        reader.close()


def to_serving_params(params: Any, bits: int = 8, layout: str = "packed",
                      device=None, validate: bool = True,
                      template: Any = None, stats: Any = None) -> Any:
    """Convert every quantized leaf to the chosen wire format (``layout``
    "packed" or "bitplane") on ``device`` (the CUDA card unless the caller
    names another), one leaf at a time.

    ``params`` is a live QAT tree (moved to the device and converted
    there) or a **checkpoint directory path**, streamed by
    :func:`_serving_params_from_ckpt`; that needs ``template`` (the
    abstract QAT tree, ``api.abstract_params()``), and ``stats`` (a dict,
    updated in place) then reports ``peak_host_bytes`` against
    ``dense_tree_bytes``.  ``validate`` contract-checks the result (SW/BP
    rules) and raises on an error finding."""
    if layout not in SERVING_LAYOUTS:
        raise ValueError(f"unknown serving layout {layout!r}; choose from "
                         f"{SERVING_LAYOUTS}")
    dev = resolve_device(device)
    if isinstance(params, str):
        if template is None:
            raise ValueError(
                "to_serving_params(checkpoint_path, ...) needs template= "
                "(the abstract QAT tree from api.abstract_params())")
        out = _serving_params_from_ckpt(params, bits, layout, template,
                                        stats, dev)
    else:
        out = tree_map(lambda x: _convert_leaf(
            x.to(dev) if hasattr(x, "to") else x, bits, layout), params)
    if validate:
        from ..analysis.contracts import validate_serving_tree
        bad = [f for f in validate_serving_tree(out)
               if f.severity == "error"]
        if bad:
            raise ValueError(
                "deployment produced a contract-violating tree:\n"
                + "\n".join(f.format() for f in bad[:8]))
    return out


def default_deploy_bits(backend: str, deploy_bits: int) -> int:
    """CLI rule: the integer execution backends need deployed weights, so
    an unset ``--deploy-bits`` defaults to int8 for them."""
    return deploy_bits or (8 if backend != "dense" else 0)


def default_deploy_layout(backend: str) -> str:
    """The wire format a backend executes natively: ``bitplane`` streams
    plane-sliced weights, everything else the packed integer form."""
    return "bitplane" if backend == "bitplane" else "packed"


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
    """Dequantization of a bit-plane leaf (the dense backend, and the MoE
    ``ragged`` product's expert stacks).

    Elementwise identical to :func:`serving_compose` on the packed form of
    the same leaf: the masked planes reproduce each |wq| exactly (each
    live plane b contributes bit b, so the magnitude is assembled in
    uint8, a quarter of the bytes of a float plane sum) and the per-WB
    effective scale is the same LUT."""
    planes = unpack_bits_u8(sw.planes)            # (..., bits, Kp8, Np)
    live = expand_block_map(sw.mask.to(torch.uint8), sw.spec)
    kp = live.shape[-2]                            # (..., bits, Kp, Np)
    shifts = torch.arange(sw.bits, dtype=torch.uint8,
                          device=planes.device).reshape(sw.bits, 1, 1)
    mag = torch.sum((planes[..., :kp, :] & live) << shifts, dim=-3,
                    dtype=torch.uint8)
    del planes, live
    sign = 1.0 - 2.0 * unpack_bits(sw.sign)        # (..., Kp8, Np)
    w = sign[..., :kp, :] * (mag.to(torch.float32)
                             * expand_block_map(sw.scale, sw.spec))
    k, n = sw.shape[-2], sw.shape[-1]
    return w[..., :k, :n].to(dtype)


def _repack_layer(planes, mask, scale, occ, new_occ, spec, bits):
    """One layer's (bits, Kp8//8, Np) planes re-packed to ``new_occ``."""
    wbr, wbc = spec.wb_rows, spec.wb_cols
    gr, gc = mask.shape[-2], mask.shape[-1]
    kp = gr * wbr
    pl = unpack_bits_u8(planes)                    # (bits, Kp8, Np)
    kp8 = pl.shape[-2]
    live = expand_block_map(mask.to(torch.uint8), spec)   # (bits, Kp, Np)
    shifts = torch.arange(bits, device=pl.device,
                          dtype=torch.int32).reshape(bits, 1, 1)
    mag = torch.sum((pl[:, :kp, :] & live).to(torch.int32) << shifts,
                    dim=0)
    del pl, live
    drop = occ - new_occ                           # (GR, GC) float64
    q = torch.round(mag.to(torch.float64)
                    / expand_block_map(2.0 ** drop, spec))
    # round() can carry into plane new_occ (q near the old ceiling); clip
    # back onto the coarser grid so the prefix mask stays exact
    q = torch.minimum(q, expand_block_map(2.0 ** new_occ - 1.0, spec))
    q = q.to(torch.int32)
    if kp8 != kp:                                  # restore byte-pad rows
        q = F.pad(q, (0, 0, 0, kp8 - kp))
    new_planes = pack_bits(torch.stack([(q >> b) & 1 for b in range(bits)]))
    plane_idx = torch.arange(bits, dtype=torch.float64,
                             device=mask.device).reshape(bits, 1, 1)
    new_mask = (plane_idx < new_occ[None]).to(torch.float32)
    new_scale = (scale.to(torch.float64) * 2.0 ** drop).to(torch.float32)
    return new_planes, new_mask, new_scale


def repack_bitplane_leaf(sw: BitplaneServingWeight,
                         new_occ) -> BitplaneServingWeight:
    """Re-pack a bit-plane leaf to reduced per-block plane occupancies.

    ``new_occ`` is an (..., GR, GC) integer-valued array or tensor with
    ``0 <= new_occ <= current occupancy``.  A block dropping ``d`` planes
    re-rounds its magnitudes onto the coarser grid, ``q' = clip(round(q /
    2^d), 0, 2^new_occ - 1)`` (round half to even, as the reference's
    ``np.round``), and folds ``2^d`` into its effective scale entry: the
    mask stays prefix-monotone (BP2) and byte-pad rows zero (BP1).  A
    block with ``d == 0`` is reproduced bit for bit, so a full-budget
    allocation round-trips the deployed tree exactly.  Runs on the leaf's
    device, one layer of a stacked leaf at a time."""
    mask = sw.mask
    occ = mask.to(torch.float64).sum(dim=-3)       # (..., GR, GC)
    new_occ = torch.as_tensor(new_occ).to(device=mask.device,
                                          dtype=torch.float64)
    if tuple(new_occ.shape) != tuple(occ.shape):
        raise ValueError(f"new_occ shape {tuple(new_occ.shape)} != grid "
                         f"{tuple(occ.shape)}")
    if bool((new_occ < 0).any()) or bool((new_occ > occ).any()):
        raise ValueError("new occupancy must lie in [0, deployed occupancy]")
    lead = tuple(mask.shape[:-3])
    flat = [t.reshape((-1,) + tuple(t.shape[len(lead):]))
            for t in (sw.planes, mask, sw.scale, occ, new_occ)]
    parts = [_repack_layer(*(t[i] for t in flat), sw.spec, sw.bits)
             for i in range(flat[0].shape[0])]
    planes, new_mask, scale = (torch.stack(list(x)).reshape(
        lead + tuple(x[0].shape)) for x in zip(*parts))
    return dataclasses.replace(sw, planes=planes.contiguous(),
                               mask=new_mask.contiguous(),
                               scale=scale.contiguous())
