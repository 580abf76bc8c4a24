"""Top-k token-choice Mixture-of-Experts with sort-based grouped dispatch
(port of the single-device path of ``repro.models.moe``).

Tokens are sorted by expert id and each expert's contiguous row group is
multiplied by that expert's weight.  Two dispatch implementations, chosen
by ``GROUPED_IMPL["impl"]`` as in the reference:

* ``ragged`` (default) — exact, no drops: the expert stack is dequantized
  once (``common.qdense``) and the row groups run as one batched plain
  product (:func:`grouped_matmul`, the counterpart of
  ``jax.lax.ragged_dot``).  The group sizes are read on the host, one
  sync a layer.
* ``capacity`` — GShard-style fixed capacity: a loop over the experts
  takes ``capacity`` rows from each group's start, masks rows past the
  group's size, and runs ``qmatmul`` on that expert's 2-D slice, so a
  deployed expert stack streams through ``packed_matmul`` /
  ``bitplane_matmul`` one expert at a time.  Tokens past an expert's
  capacity are dropped.

The router is kept out of BWQ quantization: its logits are taken in f32
from the (compute-dtype) router weight.  Routing matches the reference
where torch promises less than JAX: top-k is a stable descending sort
(lower expert id first on ties, as ``jax.lax.top_k``), the token sort is
stable, and the combine adds each token's k expert outputs in ascending
expert id, in the activation dtype, without atomics.

Training differentiates both dispatches: the ragged product through
its own backward (:class:`_GroupedMatmul`, the reference's custom VJP),
the capacity loop through autograd; the router's gradient flows through
the gathered top-k probabilities and the aux term's ``frac_probs``
(``frac_tokens`` is a count).  Under a mesh the layer takes the
reference's sharded path (:func:`_moe_forward_sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bitrep import QuantizedTensor
from ..dist.parallel import (Cols, active_mesh, all_reduce, batch_sum,
                             even_ranges, split_mesh, take_cols, unshard)
from .common import make_weight, qdense, qmatmul, window_weight

# Implementation selector: 'ragged' (exact, no drops) or 'capacity'
# (fixed per-expert capacity, tokens past it dropped).
GROUPED_IMPL = {"impl": "ragged", "capacity_factor": 2.0}


def _sizes(group_sizes: Union[torch.Tensor, Sequence[int]]) -> List[int]:
    if isinstance(group_sizes, torch.Tensor):
        return [int(s) for s in group_sizes.tolist()]
    return [int(s) for s in group_sizes]


def _counts(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """(E,) rows routed to each expert, on the device (no host read)."""
    return torch.zeros((e,), dtype=torch.long, device=flat_expert.device
                       ).scatter_add_(0, flat_expert,
                                      torch.ones_like(flat_expert))


def _group_sizes(flat_expert: torch.Tensor, e: int):
    """The group sizes the dispatch takes: a device tensor for
    ``capacity`` (no host read), ints read on the host once for the
    ragged product (one sync a layer)."""
    counts = _counts(flat_expert, e)
    return counts if GROUPED_IMPL["impl"] == "capacity" else _sizes(counts)


def _pad_slots(sizes: List[int], device) -> Tuple[torch.Tensor, int]:
    """Where each of the ``sum(sizes)`` sorted rows lands in a zero-padded
    (G, C) block of groups, and C: the largest group's size, at least 2.
    BLAS multiplies a single row through a matrix-vector path whose sums
    run in another order, and a row's result must not depend on how many
    rows share its expert."""
    g, total = len(sizes), sum(sizes)
    c = max(max(sizes, default=0), 2)
    starts = np.cumsum([0] + sizes[:-1])
    slot = torch.as_tensor(np.repeat(np.arange(g) * c - starts, sizes)
                           + np.arange(total), device=device)
    return slot, c


def _padded(x: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """The first ``sum(sizes)`` rows of ``x`` in (G, C, cols) zero-padded
    group blocks (:func:`_pad_slots`)."""
    slot, c = _pad_slots(sizes, x.device)
    xp = x.new_zeros((len(sizes) * c, x.shape[1]))
    xp[slot] = x[:len(slot)]
    return xp.view(len(sizes), c, x.shape[1])


def _grouped_forward(x: torch.Tensor, w: torch.Tensor,
                     sizes: List[int]) -> torch.Tensor:
    """The ragged product of :func:`grouped_matmul` without autograd."""
    m, n = x.shape[0], w.shape[-1]
    slot, _ = _pad_slots(sizes, x.device)
    y = torch.bmm(_padded(x, sizes), w).view(-1, n)[slot]
    if len(slot) < m:
        y = torch.cat([y, x.new_zeros((m - len(slot), n))])
    return y


class _GroupedMatmul(torch.autograd.Function):
    """The grouped product with the reference's custom VJP: both
    directions stay ragged.  ``dx`` is the grouped product of ``dy`` with
    each expert's ``w^T``; ``dw[g] = x_g^T dy_g`` over group g's own rows
    (one batched product over the same zero-padded (G, C) blocks as the
    forward).  No (G, M, K) or (T, E, K) tensor is built.  An expert with
    no rows gets ``dw`` exactly 0 and rows past the groups' sum get ``dx``
    exactly 0; ``dx`` and ``dw`` take the dtypes of ``x`` and ``w``."""

    @staticmethod
    def forward(ctx, x, w, sizes):
        ctx.save_for_backward(x, w)
        ctx.sizes = sizes
        return _grouped_forward(x, w, sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        sizes = ctx.sizes
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped_forward(dy, w.transpose(1, 2), sizes).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(_padded(x, sizes).transpose(1, 2),
                           _padded(dy.to(x.dtype), sizes))
            empty = torch.as_tensor([s == 0 for s in sizes],
                                    device=dw.device)
            dw = dw.masked_fill(empty[:, None, None], 0).to(w.dtype)
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes) -> torch.Tensor:
    """y[M, N] = per-group x[M, K] @ w[g, K, N], tokens sorted by group
    (``jax.lax.ragged_dot``, with the reference's ragged backward:
    :class:`_GroupedMatmul`).  Rows past the sum of the group sizes are
    zero.  ``group_sizes`` is a (G,) tensor (read on the host) or a
    sequence of ints.

    One batched product: each group's rows are placed in a zero-padded
    (G, C, K) block, C the largest group's size (at least 2,
    :func:`_pad_slots`), and multiplied by its expert in one
    ``torch.bmm``.  The padding is not bounded: memory and operations
    grow with G x C, not with the M real rows, so skewed routing costs up
    to G / k times the work of the rows (G / k = 5 for granite's top-8
    over 40 experts, 16 for llama4-scout's top-1 over 16)."""
    return _GroupedMatmul.apply(x, w, _sizes(group_sizes))


def _expert(w, e: int):
    """Expert ``e``'s 2-D slice of an (E, K, N) stack: views of a plain
    tensor or of every payload field of a quantized weight."""
    return w.layer(e) if hasattr(w, "layer") else w[e]


def _n_experts(w) -> int:
    """The leading (expert) dim of a plain or quantized (E, K, N) stack
    (a quantized weight's ``shape`` keeps its full stacked shape)."""
    if isinstance(w, torch.Tensor):
        return w.shape[0]
    for name in ("w_int", "sign", "w"):
        if hasattr(w, name):
            return getattr(w, name).shape[0]
    raise TypeError(f"not an expert stack: {type(w).__name__}")


def grouped_matmul_capacity(x: torch.Tensor, w, group_sizes, capacity: int,
                            backend: str = "dense", start=0) -> torch.Tensor:
    """Capacity-bounded grouped matmul over sorted tokens.

    ``x`` (M, K) sorted by group, the first group starting at row
    ``start``; ``w`` an (E, K, N) stack, plain or quantized.  Each
    expert's ``capacity``-row window from its group's start (rows past
    the group's size masked to zero) runs ``qmatmul`` against that
    expert's 2-D slice, so a deployed stack runs its kernel one expert at
    a time.  Returns (M, N), zero for tokens past their group's capacity
    and for rows before ``start``.  ``group_sizes`` (and ``start``) may
    be device tensors: the windows are gathered and added back by index,
    so nothing is read on the host (the dry run's ``meta`` tensors)."""
    m, k = x.shape
    sizes = torch.as_tensor(group_sizes, device=x.device)
    starts = torch.cumsum(sizes, 0) - sizes + start
    x_pad = torch.cat([x, x.new_zeros((capacity, k))])
    y = None
    rows = torch.arange(capacity, device=x.device)
    for e in range(sizes.shape[0]):
        idx = starts[e] + rows
        mask = (rows < sizes[e])[:, None].to(x.dtype)
        ys = qmatmul(x_pad.index_select(0, idx) * mask, _expert(w, e),
                     backend) * mask
        if y is None:
            y = x.new_zeros((m + capacity, ys.shape[-1]))
        y.index_add_(0, idx, ys)
    return y[:m]


def _capacity(m: int, e: int) -> int:
    """Per-expert token capacity: factor * mean load, rounded up to 8."""
    cap = int(GROUPED_IMPL["capacity_factor"] * m / e + 0.999)
    return max(8, min(m, -(-cap // 8) * 8))


def _grouped(x: torch.Tensor, w, group_sizes,
             backend: str = "dense") -> torch.Tensor:
    """Grouped dispatch over possibly quantized expert weights.  The
    capacity loop consumes quantized experts one 2-D slice at a time; the
    ragged product needs a dense (E, K, N) operand, dequantized through
    ``common.qdense``."""
    if isinstance(w, QuantizedTensor):
        w = qdense(w, x.dtype)     # bit axis leads: not sliceable
    if GROUPED_IMPL["impl"] == "capacity":
        return grouped_matmul_capacity(
            x, w, group_sizes, _capacity(x.shape[0], _n_experts(w)),
            backend)
    return grouped_matmul(x, qdense(w, x.dtype), group_sizes)


def init_moe(d_model: int, d_ff: int, n_experts: int, top_k: int, qc,
             n_shared: int = 0, *, generator: torch.Generator, device,
             stack: Tuple[int, ...] = ()) -> Dict:
    """One MoE block's params: the f32 router, the (E, ...) expert stacks
    and, with ``n_shared``, the shared expert (the reference's layout),
    each leaf led by the ``stack`` dims (the model's (L,) layer stack)."""
    mk = dict(generator=generator, device=device)
    s, e, d = tuple(stack), n_experts, d_model
    p = {
        "router_w": torch.randn((*s, d, e), dtype=torch.float32, **mk)
        * 0.02,
        "expert_gate": make_weight((*s, e, d, d_ff), qc, **mk),
        "expert_up": make_weight((*s, e, d, d_ff), qc, **mk),
        "expert_down": make_weight((*s, e, d_ff, d), qc, **mk),
    }
    if n_shared:
        f = n_shared * d_ff
        p["shared_gate"] = make_weight((*s, d, f), qc, **mk)
        p["shared_up"] = make_weight((*s, d, f), qc, **mk)
        p["shared_down"] = make_weight((*s, f, d), qc, **mk)
    return p


def moe_forward(p: Dict, x: torch.Tensor, top_k: int,
                backend: str = "dense") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Under an active mesh of more
    than one rank this runs :func:`_moe_forward_sharded`: routing and the
    sort stay local to each data shard, the experts run expert- or
    tensor-parallel over ``model`` and the partial outputs are summed
    over it."""
    mesh = active_mesh()
    if mesh is not None:
        return _moe_forward_sharded(p, x, top_k, backend, mesh)
    return _moe_forward_local(p, x, top_k, backend)


def _route(xt: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """f32 router probabilities (T, E) and the top-k (gates, experts),
    lower expert id first on ties."""
    logits = xt.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)
    return probs, gate_vals, expert_idx


def _combine(ys: torch.Tensor, order: torch.Tensor, t: int,
             top_k: int) -> torch.Tensor:
    """out[t] = sum of token t's k rows of the sorted ``ys``, added in
    sorted order (ascending expert id) in ``ys``'s dtype, from zero: the
    reference's ``zeros.at[tok_sorted].add(ys)``, with no atomics."""
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.sort(pos.reshape(t, top_k), dim=1).values
    out = torch.zeros((t, ys.shape[-1]), dtype=ys.dtype, device=ys.device)
    for j in range(top_k):
        out = out + ys[pos[:, j]]
    return out


def _moe_forward_local(p: Dict, x: torch.Tensor, top_k: int,
                       backend: str = "dense"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e = p["router_w"].shape[-1]
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, expert_idx = _route(xt, p["router_w"], top_k)

    flat_expert = expert_idx.reshape(-1)                     # (T*k,)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    tok_sorted = torch.div(order, top_k, rounding_mode="floor")
    xs = xt[tok_sorted]                                      # (T*k, D)
    group_sizes = _group_sizes(flat_expert, e)

    gate = _grouped(xs, p["expert_gate"], group_sizes, backend)
    up = _grouped(xs, p["expert_up"], group_sizes, backend)
    h = F.silu(gate) * up
    ys = _grouped(h, p["expert_down"], group_sizes, backend)  # (T*k, D)

    ys = ys * flat_gate[order][:, None].to(ys.dtype)
    out = _combine(ys, order, t, top_k).reshape(b, s, d)

    if "shared_gate" in p:
        hs = F.silu(qmatmul(x, p["shared_gate"], backend)) \
            * qmatmul(x, p["shared_up"], backend)
        out = out + qmatmul(hs, p["shared_down"], backend)

    # load-balance auxiliary loss (Switch-style)
    return out, _aux_loss(probs, expert_idx, e)


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, e: int
              ) -> torch.Tensor:
    """The load-balancing term ``e * sum(mean(hit) * mean(probs))`` over
    the whole batch.  Under a training step's
    :func:`~repro_torch.dist.parallel.batch_split` the means are the whole
    batch's: each rank's sums of ``hit`` and ``probs`` and its row count
    are summed over the data axes before the product, through
    :func:`~repro_torch.dist.parallel.batch_sum`, whose backward carries
    the gradient of ``mean(probs)``."""
    t = probs.shape[0]
    hit = torch.zeros((t, e), dtype=torch.float32, device=probs.device)
    hit.scatter_(1, expert_idx, 1.0)
    if split_mesh() is None:
        return e * torch.sum(torch.mean(hit, 0) * torch.mean(probs, 0))
    count = torch.full((1,), float(t), dtype=torch.float32,
                       device=probs.device)
    sums = batch_sum(torch.cat([hit.sum(0), probs.sum(0), count]))
    n = sums[2 * e]
    return e * torch.sum((sums[:e] / n) * (sums[e:2 * e] / n))


def _local_experts(w, e0: int, n: int, dtype) -> torch.Tensor:
    """Experts ``[e0, e0 + n)`` of an (E, K, N) stack, dequantized
    (``common.qdense``, the sanctioned MoE dequant), and no other: a
    placed shard first moves those experts' windows here from every model
    rank (:func:`~repro_torch.dist.parallel.unshard` with an expert range:
    one all-to-all over ``model``, every rank calling it with its own
    range), a whole leaf is cut to them."""
    if getattr(w, "shard", None) is not None:
        return qdense(unshard(w, (e0, n)), dtype)
    if isinstance(w, QuantizedTensor):
        return qdense(w, dtype)[e0:e0 + n]     # bit axis leads
    if isinstance(w, torch.Tensor):
        return w[e0:e0 + n].to(dtype)
    cut = {f.name: getattr(w, f.name).narrow(0, e0, n)
           for f in dataclasses.fields(w)
           if isinstance(getattr(w, f.name), torch.Tensor)}
    shape = (*w.shape[:-3], n, *w.shape[-2:])    # stack dims kept
    return qdense(dataclasses.replace(w, **cut, shape=shape), dtype)


def _ff_slice(w, dim: int, dtype, mesh):
    """This rank's d_ff slice of an (E, K, N) stack under in-expert
    tensor parallelism, dequantized: the columns of ``expert_gate`` /
    ``expert_up`` (``dim`` -1) or the rows of ``expert_down`` (-2), and
    every model rank's range of d_ff.  A placed shard dequantizes its own
    window alone (:func:`~repro_torch.models.common.window_weight`: no
    gather over ``model``); a whole leaf is dequantized and cut evenly."""
    sh = getattr(w, "shard", None)
    if sh is not None and sh.kind in ("col", "row"):
        lo, hi = sh.own
        win = qdense(window_weight(w), dtype)
        return win.narrow(dim, lo - sh.window[0], hi - lo), sh.ranges
    if sh is not None:
        w = unshard(w)
    dense = qdense(w, dtype)
    f, m = dense.shape[dim], mesh.axis_size("model")
    ranges = even_ranges(-(-f // m) * m, m, f)
    lo, hi = ranges[mesh.coord("model")]
    return dense.narrow(dim, lo, hi - lo), ranges


def _moe_forward_sharded(p: Dict, x: torch.Tensor, top_k: int,
                         backend: str, mesh
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` MoE on one rank: local routing and
    sort over this data shard's tokens, then the expert FFNs.

    * Expert parallel when E divides ``model``: this rank computes its
      E / model experts' rows of the sorted tokens; ``ragged`` keeps the
      reference's exact no-drop dispatch, in which a zero dummy expert
      takes the other ranks' rows (its product is zero, written as zeros
      rather than multiplied); ``capacity`` runs the capacity loop over
      the rank's experts.  Only the rank's experts are moved here (the
      placed stacks hold d_ff on ``model``) and dequantized.
    * Otherwise in-expert tensor parallelism: every expert's d_ff slice
      of this rank (gate / up columns, down rows), the window a placed
      rank holds, dequantized alone; the gate's and the down
      projection's slices may differ (a 9x8 row shard is a block wider),
      and the activation's columns then follow the down rows'
      (:func:`~repro_torch.dist.parallel.take_cols`).

    The experts are dequantized on this path, as the reference's are,
    and the partial outputs are summed over ``model``.  The aux term is
    this rank's rows' own (:func:`_aux_loss`): serving reads no aux, so it
    costs no collective."""
    b, s, d = x.shape
    e = p["router_w"].shape[-1]
    t = b * s
    m, r = mesh.axis_size("model"), mesh.coord("model")
    ep = e % m == 0
    names = ("expert_gate", "expert_up", "expert_down")
    if ep:
        e_loc = e // m
        e0 = r * e_loc
        wg, wu, wd = (_local_experts(p[n], e0, e_loc, x.dtype)
                      for n in names)
    else:
        (wg, rg), (wu, ru), (wd, rd) = (
            _ff_slice(p[n], dim, x.dtype, mesh)
            for n, dim in zip(names, (-1, -1, -2)))

    xt = x.reshape(t, d)
    probs, gate_vals, expert_idx = _route(xt, p["router_w"], top_k)
    flat_expert = expert_idx.reshape(-1)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    tok_sorted = torch.div(order, top_k, rounding_mode="floor")
    xs = xt[tok_sorted]
    sizes = _group_sizes(flat_expert, e)
    if ep:
        gs_local = sizes[e0:e0 + e_loc]
        if GROUPED_IMPL["impl"] == "ragged":
            start0, n_loc = sum(sizes[:e0]), sum(gs_local)
            rows = xs[start0:start0 + n_loc]
            h = F.silu(grouped_matmul(rows, wg, gs_local)) \
                * grouped_matmul(rows, wu, gs_local)
            ys = xs.new_zeros((xs.shape[0], d))
            ys[start0:start0 + n_loc] = grouped_matmul(h, wd, gs_local)
        else:
            cap = _capacity(t * top_k, e)
            start0 = sizes[:e0].sum()
            h = F.silu(grouped_matmul_capacity(xs, wg, gs_local, cap,
                                               start=start0)) \
                * grouped_matmul_capacity(xs, wu, gs_local, cap,
                                          start=start0)
            ys = grouped_matmul_capacity(h, wd, gs_local, cap, start=start0)
    else:
        f = p["expert_gate"].shape[-1]
        g = Cols(_grouped(xs, wg, sizes), *rg[r], f, rg)
        u = Cols(_grouped(xs, wu, sizes), *ru[r], f, ru)
        h = dataclasses.replace(g, t=F.silu(g.t) * take_cols(u, rg))
        ys = _grouped(take_cols(h, rd), wd, sizes)
    ys = ys * flat_gate[order][:, None].to(ys.dtype)
    out = all_reduce(_combine(ys, order, t, top_k), "model")
    out = out.reshape(b, s, d)

    if "shared_gate" in p:
        hs = F.silu(qmatmul(x, p["shared_gate"], backend)) \
            * qmatmul(x, p["shared_up"], backend)
        out = out + qmatmul(hs, p["shared_down"], backend)

    return out, _aux_loss(probs, expert_idx, e)
