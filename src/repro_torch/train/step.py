"""Train and maintenance steps with the BWQ-A hooks (port of
``repro.train.step``).

* ``quant_reg_loss`` — paper Eq. 3 regularizer over every quantized leaf
  (bit-plane mode: the exact WB group Lasso; fake mode: its per-WB L2
  surrogate);
* ``freeze_mask`` — gradients of the quantization metadata (mask, sign,
  bitwidth, scale) are zero; only bit planes / master weights (and the
  plain params) train.  Those leaves never ask autograd for a gradient;
  the mask hands the optimizer their zeros, as the reference's does;
* ``build_maintenance_step`` — re-quantization + block-wise precision
  adjustment every ``requant_interval`` steps (paper Alg. 1 lines 11-14),
  in place, a layer at a time.

The reference jits a functional step that donates the old state; here the
step runs eagerly and updates the state in place.

**Under a process mesh** (``dist.sharding.use_mesh`` of a
``dist.parallel.Mesh`` of more than one rank) the step is numerically the
single-device step, as the reference's is under GSPMD, which splits only
the activations by the batch: every rank holds the whole train state,
runs the loss and its backward on its rows of the global batch
(:func:`~repro_torch.dist.parallel.batch_rows`) with the mesh context
suspended (the model's serving collectives have no autograd), and the
gradients and metrics are summed over every rank of the mesh
(:func:`data_parallel`), each rank's weighted by its share of the batch's
label count over ``1 / model`` replicas.  That is exact for a loss that
is a mean of per-row terms plus terms of the params alone.  A term built
from a statistic of the whole batch (the MoE load-balancing term's batch
means, BatchNorm's moments) reads it through
:func:`~repro_torch.dist.parallel.batch_sum` inside the step's
:func:`~repro_torch.dist.parallel.batch_split`: the ranks' partial
statistics are summed over the data axes, and their gradients back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.bitrep import QuantizedTensor, param_count
from ..core.fakequant import (FakeQuantTensor, fq_group_lasso, fq_live_bits,
                              fq_maintenance)
from ..core.group_lasso import layer_bit_count, wb_group_lasso
from ..core.precision import adjust_precision
from ..core.quantize import requantize
from ..core.state import map_tensors, quant_nodes, tensor_leaves, tree_map
from ..dist.parallel import (active_mesh, all_reduce_tensors, batch_coord,
                             batch_group_size, batch_rows, batch_split)
from ..dist.sharding import use_mesh
from ..optim.optimizers import Optimizer, global_norm
from .state import TrainState

FROZEN_FIELDS = (".mask", ".sign", ".bitwidth", ".scale")


def _frozen(path: str) -> bool:
    return any(path.endswith(f) for f in FROZEN_FIELDS)


def _node_params(q) -> int:
    return param_count(q) if isinstance(q, QuantizedTensor) else q.w.numel()


def quant_reg_loss(params, alpha) -> torch.Tensor:
    """alpha * sum_r coeff_r * B_GL(W^r)   (Eq. 3).

    The fake-mode surrogate is recomputed in the backward
    (``torch.utils.checkpoint``) instead of saving its scaled weights: at
    full width those would be one more weight-sized f32 copy."""
    nodes = quant_nodes(params)
    if not nodes:
        return torch.zeros((), dtype=torch.float32)
    total_params = float(sum(_node_params(q) for q in nodes.values()))
    loss = 0.0
    for q in nodes.values():
        if isinstance(q, QuantizedTensor):
            bits = layer_bit_count(q)
            gl = wb_group_lasso(q)
        else:
            bits = fq_live_bits(q)
            gl = checkpoint(fq_group_lasso, q, use_reentrant=False) \
                if q.w.requires_grad else fq_group_lasso(q)
        coeff = bits.detach() / total_params
        loss = loss + coeff.to(torch.float32) * gl.to(torch.float32)
    return alpha * loss


@torch.no_grad()
def quant_stats(params) -> Dict[str, torch.Tensor]:
    nodes = quant_nodes(params)
    if not nodes:
        return dict(avg_bitwidth=torch.tensor(0.0),
                    compression_x=torch.tensor(1.0))
    tot_p, tot_b = 0.0, 0.0
    for q in nodes.values():
        tot_p += _node_params(q)
        tot_b = tot_b + (layer_bit_count(q) if isinstance(q, QuantizedTensor)
                         else fq_live_bits(q))
    return dict(avg_bitwidth=tot_b / tot_p,
                compression_x=32.0 * tot_p / torch.clamp(tot_b, min=1.0))


def freeze_mask(grads):
    """Zero the gradients of quantization metadata leaves (by path
    suffix)."""
    def one(path, node):
        if isinstance(node, dict):
            return {k: one(f"{path}[{k!r}]", v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(one(f"{path}[{i}]", v)
                              for i, v in enumerate(node))
        if isinstance(node, (QuantizedTensor, FakeQuantTensor)):
            return dataclasses.replace(node, **{
                f.name: one(f"{path}.{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)
                if isinstance(getattr(node, f.name), torch.Tensor)})
        if isinstance(node, torch.Tensor) and _frozen(path):
            return torch.zeros_like(node)
        return node
    return one("", grads)


def _detached(x):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                    else t, x)


def microbatched_value_and_grad(loss_fn: Callable, num_mb: int = 1):
    """``fn(params, batch) -> ((loss, aux), grads)`` for
    ``loss_fn(params, batch) -> (loss, aux)``.

    Gradients of every float leaf outside the frozen metadata come from
    autograd (the leaves ask for a gradient only for the call); the frozen
    leaves' are zero.  With ``num_mb > 1`` the batch is cut into that many
    microbatches along dim 0, which bounds activation memory to one: the
    gradients and losses are averaged, ``aux`` comes from the last."""
    def fn(params, batch):
        live = [t for p, t in tensor_leaves(params)
                if t.is_floating_point() and not _frozen(p)]
        for t in live:
            t.requires_grad_(True)
            t.grad = None
        try:
            if num_mb <= 1:
                loss, aux = loss_fn(params, batch)
                loss.backward()
            else:
                loss = 0.0
                for mb in zip(*(torch.chunk(v, num_mb) for v in
                                batch.values())):
                    l_mb, aux = loss_fn(params, dict(zip(batch, mb)))
                    l_mb.backward()
                    loss = loss + l_mb.detach()
                loss = loss / num_mb
            grads = map_tensors(
                lambda t: (t.grad / num_mb if num_mb > 1 else t.grad)
                if t.grad is not None else torch.zeros_like(t), params)
        finally:
            for t in live:
                t.grad = None
                t.requires_grad_(False)
        return (loss.detach(), _detached(aux)), freeze_mask(grads)
    return fn


def _row_count(batch: Dict[str, torch.Tensor], lo: int, hi: int) -> float:
    """Rows [lo, hi)'s weight in the loss's mean: their ``mask`` sum, or
    their label count (also for a ``meta`` mask, whose sum the host
    cannot read: the dry run's batches carry no mask)."""
    mask = batch.get("mask")
    if mask is not None and not mask.is_meta:
        return float(mask[lo:hi].sum())
    return float(batch["labels"][lo:hi].numel())


def rank_share(batch: Dict[str, torch.Tensor], mesh
               ) -> Tuple[Dict[str, torch.Tensor], float]:
    """This rank's rows of the global ``batch`` and their share ``w`` of
    its label count, summed over the data axes (each coordinate's rows,
    counted again where an indivisible batch is whole on every
    coordinate), so that the ranks' ``w``-weighted means sum to the
    global one and a term of the params alone counts once."""
    n_rows = next(iter(batch.values())).shape[0]
    rows = batch_rows(n_rows, mesh)
    counts = [_row_count(batch, lo, hi) for lo, hi in rows]
    me = batch_coord(mesh)
    total = sum(counts)
    share = counts[me] / total if total else 1.0 / len(rows)
    lo, hi = rows[me]
    return {k: v[lo:hi] for k, v in batch.items()}, share


def data_parallel(value_and_grad: Callable) -> Callable:
    """``value_and_grad(params, batch) -> ((loss, aux), grads)`` under the
    active mesh: each rank runs it on its rows (:func:`rank_share`) with
    the mesh suspended, then its gradient leaves outside the frozen
    metadata and every tensor of ``(loss, aux)`` are scaled by ``w /
    model`` and summed over every rank of the mesh (flat buffers), so that
    every rank holds the global values, bit for bit the same.  The rows
    run inside :func:`~repro_torch.dist.parallel.batch_split`, so that a
    statistic of the whole batch is summed over the data axes.  With no
    mesh, ``value_and_grad`` itself."""
    def fn(params, batch):
        mesh = active_mesh()
        if mesh is None:
            return value_and_grad(params, batch)
        local, share = rank_share(batch, mesh)
        with use_mesh(None), batch_split(mesh, share):
            (loss, aux), grads = value_and_grad(params, local)
        scale = share * batch_group_size(mesh) / mesh.size
        all_reduce_tensors([g for p, g in tensor_leaves(grads)
                            if g.is_floating_point() and not _frozen(p)],
                           scale=scale)
        loss = loss.clone()
        all_reduce_tensors([loss] + [t for _, t in tensor_leaves(aux)
                                     if t.is_floating_point()], scale=scale)
        return (loss, aux), grads
    return fn


def build_train_step(loss_fn: Callable, optimizer: Optimizer,
                     lr_schedule: Callable, num_mb: int = 1):
    """``loss_fn(params, batch) -> (loss, metrics dict)``; the step
    updates ``state`` in place and returns it with the metrics (tensors;
    the caller reads them when it logs).  Under a process mesh the step
    takes the global batch and runs :func:`data_parallel`."""
    def total_loss(alpha):
        def fn(params, batch):
            # the regularizer is built before the forward so that its
            # backward runs last, after the layers' gradients are stacked:
            # its weight-sized gradients are then not held across the
            # whole backward.  With alpha 0 it and its gradient are
            # exactly zero, and it is not built.
            reg = quant_reg_loss(params, alpha) if float(alpha) else None
            loss, metrics = loss_fn(params, batch)
            if reg is None:
                reg = torch.zeros_like(loss)
            return loss + reg, (metrics, reg)
        return fn

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        vg = data_parallel(microbatched_value_and_grad(
            total_loss(state.alpha), num_mb))
        (loss, (metrics, reg)), grads = vg(state.params, batch)
        grad_norm = global_norm(grads)
        lr = lr_schedule(state.step)
        optimizer.update(grads, state.opt_state, state.params, lr)
        del grads
        state.step += 1
        metrics = dict(metrics, loss=loss, reg=reg, lr=lr,
                       grad_norm=grad_norm, **quant_stats(state.params))
        return state, metrics

    return step


def _maintain_leaf(q):
    if isinstance(q, QuantizedTensor):
        return adjust_precision(requantize(q))
    if isinstance(q, FakeQuantTensor):
        return fq_maintenance(q)
    return q


def _layers(q):
    """``q`` one layer at a time (views) for a stacked leaf, else whole.
    An MoE expert stack (L, E, K, N) gives (E, K, N) pieces: every rule
    acts within one (K, N) matrix, so a piece's result is its slice of
    the whole-leaf one."""
    if len(q.shape) > 2:
        return [q.layer(i) for i in range(q.shape[0])]
    return [q]


def build_maintenance_step():
    """Re-quantize + precision-adjust every quantized leaf (Alg. 1 l.
    11-14), in place and a layer at a time (every rule acts within a layer,
    so the values are the whole-leaf reference's)."""
    @torch.no_grad()
    def maintain(state: TrainState) -> TrainState:
        for q in quant_nodes(state.params).values():
            for piece in _layers(q):
                new = _maintain_leaf(piece)
                for f in dataclasses.fields(piece):
                    old, fresh = getattr(piece, f.name), getattr(new, f.name)
                    if isinstance(old, torch.Tensor) and fresh is not old:
                        old.copy_(fresh)
        return state
    return maintain
