"""Plane-drop sensitivity calibration on the deployed bit-plane tree (port
of ``repro.serve.autotune.sensitivity``).

Dropping plane ``b`` of block (g, h) perturbs every covered weight by
``2^b * scale[g, h] * plane_b[k, n]``; under a diagonal activation model
the induced output MSE is ``sum_{k, n in block} E[x_k^2] * (2^b * scale *
plane_b[k, n])^2``.  It is evaluated exactly from the deployed planes,
and needs only the per-input-feature second moments ``E[x_k^2]`` of the
activations that feed each leaf.

Those moments come from one calibration prefill under the ``dense``
backend: the port's layer loop is eager, so each layer slice of a tagged
bit-plane leaf reaches ``qmatmul`` carrying its ``tag`` and the
:func:`repro_torch.models.common.record_qmatmul_inputs` context records
the moments in layer order.  A leaf consumed a different number of times
than its stack size (an expert stack in the grouped product) falls back
to weight-only scores (``E[x_k^2] = 1``).

Scores are computed on the leaf's device in float64, one layer of a
stacked leaf at a time (the reference unpacks every plane of a leaf to
float64 on the host at once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ...core.state import quant_nodes, replace_nodes, tensor_leaves
from ...kernels.ref import unpack_bits_u8
from ...models.common import record_qmatmul_inputs
from ..deploy import BitplaneServingWeight


def tag_bitplane_leaves(params: Any) -> Any:
    """Copy of the tree with every bit-plane leaf's ``tag`` set to its
    path (payload tensors shared); ``layer()`` slices keep the tag."""
    return replace_nodes(params, {
        p: dataclasses.replace(leaf, tag=p)
        for p, leaf in quant_nodes(params, BitplaneServingWeight).items()})


def _device(params) -> torch.device:
    return next(t for _, t in tensor_leaves(params)).device


def calibrate_activations(api, params: Any, batch: Dict[str, Any]
                          ) -> Dict[str, Optional[torch.Tensor]]:
    """One prefill over ``batch`` (the ``dense`` backend) on the params'
    device; per-leaf activation moments.

    Returns ``{path: (stack..., K) float64 tensor or None}`` for every
    bit-plane leaf, on the params' device; ``None`` marks the weight-only
    fallback (the leaf was consumed a different number of times than its
    stack size)."""
    tagged = tag_bitplane_leaves(params)
    dev = _device(params)
    feed = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    with torch.no_grad(), record_qmatmul_inputs() as store:
        api.prefill(tagged, feed, backend="dense")
    out: Dict[str, Optional[torch.Tensor]] = {}
    for path, leaf in quant_nodes(tagged, BitplaneServingWeight).items():
        stack_dims = tuple(leaf.shape[:-2])
        recs = store.get(path, [])
        if len(recs) != math.prod(stack_dims):
            out[path] = None
            continue
        arr = torch.stack(recs).to(torch.float64)
        out[path] = arr.reshape(stack_dims + (arr.shape[-1],))
    return out


def _layer_scores(planes, mask, scale, a_pad, spec, bits):
    """One layer's (bits, GR, GC) scores from its packed planes."""
    wbr, wbc = spec.wb_rows, spec.wb_cols
    gr, gc = mask.shape[-2], mask.shape[-1]
    kp = gr * wbr
    pl = unpack_bits_u8(planes)[:, :kp, :gc * wbc]        # (bits, Kp, Np)
    # set bits of each row within each block column, exact in int32
    cnt = pl.reshape(bits, kp, gc, wbc).sum(dim=-1, dtype=torch.int32)
    del pl
    weighted = cnt.to(torch.float64) * a_pad[None, :, None]
    per_block = weighted.reshape(bits, gr, wbr, gc).sum(dim=2)
    pw2 = (4.0 ** torch.arange(bits, dtype=torch.float64,
                               device=mask.device)).reshape(bits, 1, 1)
    scale2 = scale.to(torch.float64) ** 2
    return per_block * pw2 * scale2[None] * mask.to(torch.float64)


def leaf_plane_sensitivity(leaf: BitplaneServingWeight,
                           act2=None) -> torch.Tensor:
    """Scores shaped exactly like ``leaf.mask``: (stack..., bits, GR, GC)
    float64 on the leaf's device.  ``scores[..., b, g, h]`` is the
    predicted output-MSE contribution of dropping plane ``b`` from block
    (g, h); dead planes score zero.  ``act2`` is the (stack..., K) second
    moment array of :func:`calibrate_activations` (``None``: weight-only,
    all ones)."""
    dev = leaf.mask.device
    wbr = leaf.spec.wb_rows
    gr = leaf.mask.shape[-2]
    kp = gr * wbr
    k_true = leaf.shape[-2]
    stack_dims = tuple(leaf.shape[:-2])
    if act2 is None:
        a = torch.ones(stack_dims + (k_true,), dtype=torch.float64,
                       device=dev)
    else:
        a = torch.as_tensor(act2).to(device=dev, dtype=torch.float64)
        a = a.broadcast_to(stack_dims + (k_true,))
    a_pad = torch.zeros(stack_dims + (kp,), dtype=torch.float64, device=dev)
    a_pad[..., :k_true] = a
    n = math.prod(stack_dims)
    flat = [t.reshape((n,) + tuple(t.shape[len(stack_dims):]))
            for t in (leaf.planes, leaf.mask, leaf.scale, a_pad)]
    out = torch.stack([_layer_scores(*(t[i] for t in flat), leaf.spec,
                                     leaf.bits) for i in range(n)])
    return out.reshape(tuple(leaf.mask.shape))


def sensitivity_tree(params: Any,
                     act2_map: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Sensitivity scores for every deployed bit-plane leaf, keyed by
    path, each shaped like that leaf's mask LUT.  ``act2_map`` is the
    output of :func:`calibrate_activations`; omitted entries use
    weight-only scores."""
    act2_map = act2_map or {}
    return {path: leaf_plane_sensitivity(leaf, act2_map.get(path))
            for path, leaf in quant_nodes(params,
                                          BitplaneServingWeight).items()}
