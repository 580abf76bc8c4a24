"""Error-feedback int8 gradient compression (port of
``repro.optim.grad_compress``).

``compress_decompress`` is the error-feedback quantizer: a per-leaf scale
``max|g + err| / 127``, rounding half to even (as ``jnp.round``), the
residual carried to the next call, so the long-run mean of what is sent
converges to the true gradient.  :func:`compressed_all_reduce` is the
collective (the reference's ``compressed_psum``): each rank's scale is
reduced with MAX, ``x`` is re-quantized against that shared scale, the
int8 levels travel (an all-gather over the axis, summed in int32 on each
rank: the reference's psum of the int32 levels, exactly, at a quarter of
its bytes) and the sum is rescaled.  :func:`compressed_sum` is the same
formula over every rank's ``x`` in one process.  Nothing in the trainer
calls these, as nothing in the reference's does.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from ..core.state import map_tensors
from ..dist.parallel import all_gather, all_reduce


def init_error_state(grads: Any) -> Any:
    return map_tensors(torch.zeros_like, grads)


def _scale(x: torch.Tensor) -> torch.Tensor:
    """The int8 step of ``x``: ``max(max|x|, 1e-12) / 127``."""
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def _levels(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compress_decompress(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Quantize ``grads + err`` to int8, a scale a leaf; returns
    (dequantized, new error)."""
    x = map_tensors(torch.add, grads, err)
    deq = map_tensors(lambda t, g: _levels(t, _scale(t)).to(g.dtype)
                      * _scale(t), x, grads)
    return deq, map_tensors(torch.sub, x, deq)


def compressed_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """What :func:`compressed_all_reduce` returns on every rank, given
    every rank's ``x``."""
    s_max = torch.stack([_scale(x) for x in xs]).max()
    total = sum(_levels(x, s_max).to(torch.int32) for x in xs)
    return total.to(xs[0].dtype) * s_max


def compressed_all_reduce(x: torch.Tensor, axis: str = "data"
                          ) -> torch.Tensor:
    """The int8-compressed sum of ``x`` over ``axis`` of the active mesh
    (every rank calls it; with no mesh, ``x`` through int8 and back)."""
    s_max = all_reduce(_scale(x).reshape(1), axis, op="max")[0]
    parts = all_gather(_levels(x, s_max), axis)
    total = torch.stack(parts).to(torch.int32).sum(0)
    return total.to(x.dtype) * s_max
