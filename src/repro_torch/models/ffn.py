"""Feed-forward blocks: SwiGLU / GELU / ReLU MLPs (port of
``repro.models.ffn``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import make_weight, qmatmul


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
    if kind == "swiglu":
        h = F.silu(qmatmul(x, p["w_gate"], backend)) \
            * qmatmul(x, p["w_up"], backend)
        return qmatmul(h, p["w_down"], backend)
    # jax.nn.gelu defaults to the tanh approximation
    act = (lambda t: F.gelu(t, approximate="tanh")) if kind == "gelu" \
        else torch.relu
    h = act(qmatmul(x, p["w_in"], backend))
    return qmatmul(h, p["w_out"], backend)
