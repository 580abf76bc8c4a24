"""Feed-forward blocks: SwiGLU / GELU / ReLU MLPs (port of
``repro.models.ffn``), in their tensor-parallel form."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..dist.parallel import take_cols
from .common import col_matmul, make_weight, row_matmul


def init_mlp(d_model: int, d_ff: int, qc, *, generator: torch.Generator,
             device, kind: str = "swiglu") -> Dict:
    """One unstacked MLP parameter set (zamba2's shared block)."""
    mk = dict(generator=generator, device=device)
    if kind == "swiglu":
        return {"w_gate": make_weight((d_model, d_ff), qc, **mk),
                "w_up": make_weight((d_model, d_ff), qc, **mk),
                "w_down": make_weight((d_ff, d_model), qc, **mk)}
    return {"w_in": make_weight((d_model, d_ff), qc, **mk),
            "w_out": make_weight((d_ff, d_model), qc, **mk)}


def mlp_forward(p: Dict, x: torch.Tensor, kind: str = "swiglu",
                backend: str = "dense") -> torch.Tensor:
    """The MLP as column- and row-parallel products: the up / gate
    (``w_in``) projections keep each rank's d_ff columns of a leaf sharded
    on ``model``, the down (``w_out``) projection multiplies them and
    all-reduces over ``model``.  Unsharded leaves (no mesh) give the
    whole product at each step."""
    if kind == "swiglu":
        g = col_matmul(x, p["w_gate"], backend)
        u = col_matmul(x, p["w_up"], backend)
        h = dataclasses.replace(g, t=F.silu(g.t) * take_cols(u, g.wants))
        return row_matmul(h, p["w_down"], backend)
    # jax.nn.gelu defaults to the tanh approximation
    act = (lambda t: F.gelu(t, approximate="tanh")) if kind == "gelu" \
        else torch.relu
    h = col_matmul(x, p["w_in"], backend)
    return row_matmul(dataclasses.replace(h, t=act(h.t)), p["w_out"],
                      backend)
