"""Budgeted per-block bit allocation over the deployed bit-plane tree (port
of ``repro.serve.autotune.allocate``).

Greedy marginal-utility search: every (leaf, block) starts at zero planes
and candidate increments — "give this block one more plane, recovered
top-down from its deployed occupancy" — are taken in order of predicted
error reduction per streamed byte.  The cost model is the occupancy
accounting of ``bitplane_stream_bytes`` / ``weight_stream_bytes``: one
live plane streams one wbr x wbc 1-bit tile, a block's first plane also
streams its sign tile, and the per-leaf ceil-to-byte totals are those of
the sequence taken, so the emitted tree respects the budget exactly under
the accounting the AT1 contract re-checks.  The sequence does not depend
on the budget: a budget buys its longest affordable prefix.

Two searches give the same sequence:

* ``search="sorted"`` (the default) — vectorized, on the scores' device.
  The reference pushes a block's increment ``t+1`` only after ``t`` is
  taken, so an increment is popped at the smallest ratio along its
  block's chain so far: give each increment the running minimum of its
  own and its predecessors' ratios, and one stable sort by that value,
  descending, over the increments listed in (leaf index in sorted path
  order, stack index, g, h, t) order takes them in the heap's order, ties
  included.  The longest affordable prefix comes from per-leaf running
  counts (a grouped cumulative sum), not step by step.
* ``search="heap"`` — the reference's Python heap over every block's next
  increment, on the host (the plain version the tests hold the sorted
  search against).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core.state import quant_nodes, replace_nodes
from ..deploy import (BitplaneServingWeight, bitplane_stream_bytes,
                      repack_bitplane_leaf, weight_stream_bytes)
from .sensitivity import _device, calibrate_activations, sensitivity_tree


@dataclasses.dataclass
class Allocation:
    """Result of a greedy budget search (plus the optional quality gate)."""
    params: Any                    # re-packed serving tree
    budget_bytes: int
    total_bytes: int               # weight_stream_bytes(params), <= budget
    predicted_error: float         # sum of scores of planes left dropped
    baseline_error: float          # error of the all-zero assignment
    occupancies: Dict[str, np.ndarray]   # path -> (stack..., GR, GC) ints
    steps_taken: int
    steps_available: int
    gate: Optional[dict] = None


def _leaf_bytes(leaf, live_planes: int, live_blocks: int) -> int:
    """bitplane_stream_bytes at a hypothetical occupancy (same math)."""
    wbr, wbc = leaf.spec.wb_rows, leaf.spec.wb_cols
    plane_bits = (live_planes + live_blocks) * wbr * wbc
    return int(-(-plane_bits // 8) + -(-leaf.mask.numel() // 8)
               + leaf.scale.nbytes)


def _host_scores(s) -> np.ndarray:
    if isinstance(s, torch.Tensor):
        return s.detach().to("cpu", torch.float64).numpy()
    return np.asarray(s, dtype=np.float64)


def _search_heap(leaves, paths, scores, total, budget_bytes):
    """The reference's heap search on the host: (occupancies, steps,
    predicted error)."""
    leaf_state = {p: [0, 0] for p in paths}  # [live_planes, live_blocks]
    occ_full: Dict[str, np.ndarray] = {}
    taken: Dict[str, np.ndarray] = {}
    s_flat: Dict[str, np.ndarray] = {}
    heap = []
    baseline_error = 0.0
    for li, p in enumerate(paths):
        leaf = leaves[p]
        s = _host_scores(scores[p])
        occ = leaf.mask.detach().cpu().numpy().sum(axis=-3).astype(np.int64)
        occ_full[p] = occ
        taken[p] = np.zeros_like(occ)
        baseline_error += float(s.sum())
        tile = leaf.spec.wb_rows * leaf.spec.wb_cols / 8.0
        s2 = s.reshape((-1,) + s.shape[-3:])
        s_flat[p] = s2
        o2 = occ.reshape((-1,) + occ.shape[-2:])
        for st, g, h in zip(*np.nonzero(o2)):
            o = int(o2[st, g, h])
            # increment t recovers plane o - t; the first one also streams
            # the block's sign tile
            gain = float(s2[st, o - 1, g, h])
            heapq.heappush(heap, (-(gain / (2 * tile)), li, int(st), int(g),
                                  int(h), 1))
    err = baseline_error
    steps = 0
    while heap:
        _, li, st, g, h, t = heapq.heappop(heap)
        p = paths[li]
        leaf = leaves[p]
        tk = taken[p].reshape((-1,) + taken[p].shape[-2:])
        o = int(occ_full[p].reshape(tk.shape)[st, g, h])
        lp, lb = leaf_state[p]
        new_lb = lb + (1 if t == 1 else 0)
        new_total = total - _leaf_bytes(leaf, lp, lb) \
            + _leaf_bytes(leaf, lp + 1, new_lb)
        if new_total > budget_bytes:
            break                       # longest affordable prefix
        total = new_total
        leaf_state[p] = [lp + 1, new_lb]
        tk[st, g, h] = t
        s2 = s_flat[p]
        err -= float(s2[st, o - t, g, h])
        steps += 1
        if t < o:
            tile = leaf.spec.wb_rows * leaf.spec.wb_cols / 8.0
            gain = float(s2[st, o - t - 1, g, h])
            heapq.heappush(heap, (-(gain / tile), li, st, g, h, t + 1))
    return taken, steps, err, baseline_error


def _search_sorted(leaves, paths, scores, total, budget_bytes):
    """The heap's sequence by one stable sort, on the scores' device:
    (occupancies, steps, predicted error)."""
    dev = leaves[paths[0]].mask.device
    eff, gain, li_seq, first, block, sizes, baseline_error = \
        [], [], [], [], [], [], 0.0
    tile_bits = []
    n_blocks = 0
    for li, p in enumerate(paths):
        leaf = leaves[p]
        s = torch.as_tensor(scores[p]).to(device=dev, dtype=torch.float64)
        baseline_error += float(_host_scores(s).sum())
        bits = s.shape[-3]
        s2 = s.reshape((-1,) + tuple(s.shape[-3:]))        # (S, bits, G, H)
        occ = leaf.mask.to(torch.float64).sum(dim=-3).to(torch.int64)
        o2 = occ.reshape((-1,) + tuple(occ.shape[-2:]))    # (S, G, H)
        tile = leaf.spec.wb_rows * leaf.spec.wb_cols / 8.0
        b = torch.arange(bits, device=dev).reshape(1, bits, 1, 1)
        top = b == (o2[:, None] - 1)
        ratio = torch.where(top, s2 / (2 * tile), s2 / tile)
        live = b < o2[:, None]
        ratio = torch.where(live, ratio, torch.full_like(ratio, np.inf))
        # running minimum down the chain (plane o-1 first, then o-2, ...)
        run = torch.flip(torch.cummin(torch.flip(ratio, [1]), 1).values,
                         [1])
        live_seq = torch.flip(live.permute(0, 2, 3, 1), [-1])

        def seq(x):
            # (S, bits, G, H) -> (S, G, H, bits) with t ascending (planes
            # high to low), live increments only
            return torch.flip(x.permute(0, 2, 3, 1), [-1])[live_seq]
        eff.append(seq(run))
        gain.append(seq(s2))
        first.append(seq(top))
        ids = torch.arange(o2.numel(), device=dev).reshape(o2.shape)
        block.append(seq((ids + n_blocks)[:, None].expand_as(s2)))
        li_seq.append(torch.full_like(eff[-1], li, dtype=torch.int64))
        tile_bits.append(leaf.spec.wb_rows * leaf.spec.wb_cols)
        sizes.append(o2.numel())
        n_blocks += o2.numel()
    eff, gain, first, block, li_seq = (torch.cat(x) for x in
                                       (eff, gain, first, block, li_seq))
    order = torch.sort(eff, descending=True, stable=True).indices
    gain, first, block, li_seq = (x[order] for x in
                                  (gain, first, block, li_seq))
    # per-leaf running count of streamed tiles (a plane, plus the sign
    # tile on a block's first increment), by a grouped cumulative sum
    inc = 1 + first.to(torch.int64)
    grouped = torch.sort(li_seq, stable=True).indices
    cs = torch.cumsum(inc[grouped], 0)
    counts = torch.bincount(li_seq, minlength=len(paths))
    starts = torch.cumsum(counts, 0) - counts
    base = torch.cat([cs.new_zeros(1), cs])[starts]
    cum = torch.empty_like(cs)
    cum[grouped] = cs - base[li_seq[grouped]]
    tb = torch.tensor(tile_bits, device=dev)[li_seq]
    after = -(-(cum * tb) // 8)
    before = -(-((cum - inc) * tb) // 8)
    totals = total + torch.cumsum(after - before, 0)
    steps = int((totals <= budget_bytes).sum())    # totals never decrease
    per_block = torch.bincount(block[:steps], minlength=n_blocks)
    taken = {}
    for p, part in zip(paths, torch.split(per_block, sizes)):
        taken[p] = part.reshape(tuple(leaves[p].mask.shape[:-3])
                                + tuple(leaves[p].mask.shape[-2:])
                                ).cpu().numpy()
    err = np.subtract.accumulate(np.concatenate(
        [[baseline_error], gain[:steps].cpu().numpy()]))[-1]
    return taken, steps, float(err), baseline_error


class _Clock:
    """``clock(name, fn)`` runs ``fn`` and, given a ``timings`` dict,
    records its wall seconds there (the params' card synchronized)."""

    def __init__(self, params, timings: Optional[dict]):
        self.timings = timings
        self.cuda = timings is not None and _device(params).type == "cuda"

    def __call__(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.cuda:
            torch.cuda.synchronize()
        if self.timings is not None:
            self.timings[name] = time.perf_counter() - t0
        return out


def greedy_allocate(params: Any, scores: Dict[str, Any], budget_bytes: int,
                    search: str = "sorted",
                    timings: Optional[dict] = None) -> Allocation:
    """Assign per-block plane occupancies under ``budget_bytes``.

    ``scores`` comes from :func:`sensitivity_tree` (mask-aligned, one
    entry per bit-plane leaf).  Raises if even the zero-plane tree (mask
    and scale LUTs plus every other leaf) exceeds the budget.  ``search``
    is ``"sorted"`` (vectorized) or ``"heap"`` (the reference's loop);
    they take the same sequence.  ``timings`` (a dict) receives the
    search's and the re-pack's wall seconds."""
    leaves = quant_nodes(params, BitplaneServingWeight)
    missing = sorted(set(leaves) - set(scores))
    if missing:
        raise ValueError(f"scores missing for leaves: {missing[:4]}")
    paths = sorted(leaves)
    for p in paths:
        if tuple(scores[p].shape) != tuple(leaves[p].mask.shape):
            raise ValueError(f"{p}: scores shape {tuple(scores[p].shape)} "
                             f"!= mask {tuple(leaves[p].mask.shape)}")
    # non-bit-plane bytes do not depend on the budget
    nonbp = weight_stream_bytes(params) - sum(
        bitplane_stream_bytes(leaves[p]) for p in paths)
    total = nonbp + sum(_leaf_bytes(leaves[p], 0, 0) for p in paths)
    if total > budget_bytes:
        raise ValueError(
            f"budget {budget_bytes} B infeasible: fixed overhead (mask + "
            f"scale LUTs + non-bitplane leaves) is {total} B")
    steps_available = sum(int(leaves[p].mask.sum(dtype=torch.float64))
                          for p in paths)
    run = {"sorted": _search_sorted, "heap": _search_heap}[search]
    clock = _Clock(params, timings)
    taken, steps, err, baseline_error = clock("search_s", lambda: run(
        leaves, paths, scores, total, budget_bytes)) if paths \
        else ({}, 0, 0.0, 0.0)
    out = clock("repack_s", lambda: replace_nodes(params, {
        p: repack_bitplane_leaf(leaves[p], taken[p]) for p in paths}))

    from ...analysis.contracts import (validate_allocation,
                                       validate_serving_tree)
    bad = [f for f in validate_serving_tree(out) if f.severity == "error"]
    bad += [f for f in validate_allocation(out, budget_bytes)
            if f.severity == "error"]
    if bad:
        raise ValueError("allocation produced a contract-violating tree:\n"
                         + "\n".join(f.format() for f in bad[:8]))
    return Allocation(params=out, budget_bytes=int(budget_bytes),
                      total_bytes=weight_stream_bytes(out),
                      predicted_error=err, baseline_error=baseline_error,
                      occupancies=taken, steps_taken=steps,
                      steps_available=steps_available)


def quality_gate(api, deployed: Any, tuned: Any, batch: Dict[str, Any], *,
                 backend: str = "dense",
                 min_top1_agreement: float = 1.0) -> dict:
    """Prefill-logit check of the tuned tree against the full deployment:
    top-1 agreement of the last-token logits across the batch and the
    largest absolute logit drift.  Returns the metrics with ``ok`` set."""
    dev = _device(deployed)
    feed = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def last_logits(tree):
        with torch.no_grad():
            logits = api.prefill(tree, feed, backend=backend)[0]
        return logits.to("cpu", torch.float64).numpy()
    full, test = last_logits(deployed), last_logits(tuned)
    agree = float(np.mean(np.argmax(full, -1) == np.argmax(test, -1)))
    return {"top1_agreement": agree,
            "max_abs_logit_diff": float(np.max(np.abs(full - test))),
            "min_top1_agreement": float(min_top1_agreement),
            "ok": agree >= min_top1_agreement}


def autotune_params(api, params: Any, budget_bytes: int, *,
                    batch: Optional[Dict[str, Any]] = None,
                    backend: str = "dense",
                    min_top1_agreement: float = 0.0,
                    require_gate: bool = False,
                    timings: Optional[dict] = None) -> Allocation:
    """Calibrate -> score -> allocate -> gate, on the params' device.

    ``batch`` (a prefill feed) drives both the activation calibration and
    the quality gate; omit it for weight-only scores and no gate.
    ``require_gate`` raises if the gate fails.  ``timings`` (a dict)
    receives each stage's wall seconds, the device synchronized."""
    stage = _Clock(params, timings)
    act2 = stage("calibrate_s", lambda: calibrate_activations(
        api, params, batch)) if batch else None
    scores = stage("sensitivity_s", lambda: sensitivity_tree(params, act2))
    alloc = greedy_allocate(params, scores, budget_bytes, timings=timings)
    if batch is not None:
        alloc.gate = stage("gate_s", lambda: quality_gate(
            api, params, alloc.params, batch, backend=backend,
            min_top1_agreement=min_top1_agreement))
        if require_gate and not alloc.gate["ok"]:
            raise ValueError(f"autotune quality gate failed: {alloc.gate}")
    return alloc
