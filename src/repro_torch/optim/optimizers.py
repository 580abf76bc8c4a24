"""SGD with momentum and AdamW over param trees, plus the cosine schedule
(port of ``repro.optim.optimizers``).

The formulas and their order of operations are the reference's, term for
term, so one step gives the same values to rounding.  Where the reference
is functional and returns new trees (its jitted step donates the old
ones), the port updates the params and the state **in place, leaf by
leaf**, a layer slice at a time: at full width a second copy of params, m
and v would not fit the card.  Updates apply to every float leaf; the
train step zeroes the gradients of frozen quantization metadata (mask,
sign, bitwidth, scale) before calling in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Tuple

import torch

from ..core.state import map_tensors, tensor_leaves


def _leaves(tree) -> list:
    return [t for _, t in tensor_leaves(tree)]


_SLICE_ELEMS = 1 << 24


def _slices(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of same-shape tensors, cut along the leading dim
    into slices of about ``_SLICE_ELEMS`` elements (a stacked leaf: one
    layer at a time), so an update's temporaries stay small."""
    t0 = ts[0]
    if t0.ndim == 0:
        yield ts
        return
    rows = max(1, _SLICE_ELEMS // max(1, t0[0].numel()))
    yield from zip(*(torch.split(t, rows) for t in ts))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in _leaves(tree)]
    return torch.sqrt(sum(leaves) + 1e-20)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]
    # update(grads, opt_state, params, lr) -> (params, opt_state), both
    # updated in place; ``grads`` may be scaled in place (clipping)


def _clip_(grads, grad_clip: float) -> None:
    gn = global_norm(grads)
    scale = torch.clamp(grad_clip / (gn + 1e-9), max=1.0)
    for g in _leaves(grads):
        g.mul_(scale)


def sgd(momentum: float = 0.9, weight_decay: float = 1e-4,
        nesterov: bool = False, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": map_tensors(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        if grad_clip:
            _clip_(grads, grad_clip)
        for p_, g_, mu_ in zip(_leaves(params), _leaves(grads),
                               _leaves(state["mu"])):
            for p, g, mu in _slices(p_, g_, mu_):
                if weight_decay:
                    g = g + weight_decay * p
                mu.mul_(momentum).add_(g)
                d = momentum * mu + g if nesterov else mu
                p.sub_(lr * d)
        return params, state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": map_tensors(torch.zeros_like, params),
                "v": map_tensors(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        if grad_clip:
            _clip_(grads, grad_clip)
        t = state["t"] + 1
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)
        for p_, g_, m_, v_ in zip(_leaves(params), _leaves(grads),
                                  _leaves(state["m"]), _leaves(state["v"])):
            for p, g, m, v in _slices(p_, g_, m_, v_):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                p.sub_(lr * (step + weight_decay * p))
        state["t"] = t
        return params, state

    return Optimizer(init, update)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup: int = 0, min_frac: float = 0.0):
    """lr(step) as a 0-d float32 tensor, the reference's f32 arithmetic."""
    def lr(step):
        step = torch.tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * (min_frac + (1 - min_frac) * cos)
    return lr
