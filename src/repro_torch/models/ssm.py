"""Mamba-2 (SSD) block (port of ``repro.models.ssm``).

A prompt whose width is a multiple of the chunk runs the chunked SSD
algorithm (intra-chunk attention-form products + an inter-chunk state
recurrence); any other width, decode among them, runs the per-token
recurrence, taking the reference's branch on every call (the two differ
in f32 summation).  Decode keeps a per-layer recurrent state of O(H*N*P)
and the causal conv's trailing inputs.  Projections are split
(x/z/B/C/dt), each a ``qmatmul``; dt/A/D and the conv stay unquantized.
Both scans are plain PyTorch: the reference has no scan kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import chunk_call, make_weight, qmatmul, rms_norm


def init_mamba2(d_model: int, n_state: int, qc, *,
                generator: torch.Generator, device, expand: int = 2,
                headdim: int = 64, conv_k: int = 4, stack: int = 0) -> Dict:
    """``stack`` > 0 builds stacked (stack, ...) leaves."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    lead = (stack,) if stack else ()
    mk = dict(generator=generator, device=device)

    def weight(k, n):
        return make_weight((*lead, k, n), qc, **mk)

    def full(value, *shape):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=device)

    return {
        "in_x": weight(d_model, d_inner),
        "in_z": weight(d_model, d_inner),
        "in_B": weight(d_model, n_state),
        "in_C": weight(d_model, n_state),
        "in_dt": weight(d_model, n_heads),
        "conv1d_w": torch.randn((*lead, conv_k, d_inner), generator=generator,
                                device=device, dtype=torch.float32) * 0.2,
        "conv1d_b": full(0.0, d_inner),
        "a_log": full(0.0, n_heads),     # A = -exp(a_log)
        "d_skip": full(1.0, n_heads),
        "dt_bias": full(0.0, n_heads),
        "norm_scale": full(0.0, d_inner),
        "out_proj": weight(d_inner, d_model),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x: (B, L, C), w: (K, C).

    Returns (y, new_state) where the state holds the trailing K-1 inputs.
    """
    k = w.shape[0]
    if state is None:
        hist = F.pad(x, (0, 0, k - 1, 0))
    else:
        hist = torch.cat([state, x], dim=1)
    y = sum(hist[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_state = hist[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y + b), new_state


def _ssd_chunked(xh, dt, da, B, C, h0, chunk: int):
    """Chunked SSD scan.

    xh: (b, L, H, P)   inputs per head
    dt: (b, L, H)      discretization steps (post-softplus)
    da: (b, L, H)      log decay per step (negative)
    B, C: (b, L, N)    input/output projections (single group)
    h0: (b, H, N, P)   initial state
    Returns (y (b, L, H, P), h_final).  With a graph to build, each chunk
    is recomputed in the backward (:func:`chunk_call`), as the reference's
    ``jax.checkpoint(chunk_step)``.
    """
    L = xh.shape[1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))

    def chunk_step(h, xh_c, dt_c, da_c, b_c, c_c):
        lcum = torch.cumsum(da_c, dim=1)                   # (b,Q,H)
        xdt = xh_c * dt_c[..., None]                       # (b,Q,H,P)
        rel = lcum[:, :, None, :] - lcum[:, None, :, :]    # (b,Q,Q,H)
        # masked before the exp: above the diagonal rel is a sum of
        # positive decays, whose exp overflows in a long chunk, and the
        # backward of a where after the exp would then read 0 * inf
        att = torch.exp(torch.where(tri[None, :, :, None], rel,
                                    torch.full_like(rel, -torch.inf)))
        cb = torch.einsum("bqn,bsn->bqs", c_c, b_c)        # (b,Q,Q)
        y_intra = torch.einsum("bqs,bqsh,bshp->bqhp", cb, att, xdt)
        y_inter = torch.einsum("bqn,bhnp->bqhp", c_c, h) \
            * torch.exp(lcum)[..., None]
        dec_out = torch.exp(lcum[:, -1:, :] - lcum)        # (b,Q,H)
        s_chunk = torch.einsum("bsn,bsh,bshp->bhnp", b_c, dec_out, xdt)
        h = h * torch.exp(lcum[:, -1, :])[:, :, None, None] + s_chunk
        return y_intra + y_inter, h

    h = h0
    ys = []
    for c0 in range(0, L, chunk):
        y, h = chunk_call(chunk_step, h, *(a[:, c0:c0 + chunk]
                                           for a in (xh, dt, da, B, C)))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssd_steps(xh, dt, da, B, C, h0):
    """The same recurrence one token at a time (decode, and prompts whose
    width is not a multiple of the chunk)."""
    hc = h0
    ys = []
    for t in range(xh.shape[1]):
        hc = hc * torch.exp(da[:, t])[:, :, None, None] + \
            torch.einsum("bn,bh,bhp->bhnp", B[:, t], dt[:, t], xh[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], hc))
    return torch.stack(ys, dim=1), hc


def mamba2_forward(p: Dict, x: torch.Tensor, *, n_state: int,
                   headdim: int = 64, chunk: int = 128,
                   state: Optional[Dict] = None, backend: str = "dense"
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, L, D).  With ``state`` (decode), L is typically 1.  Plain
    float leaves of ``p`` are in x's dtype (``prepare_params``)."""
    b, L, d = x.shape
    chunk = min(chunk, L)
    f32 = torch.float32
    xi = qmatmul(x, p["in_x"], backend)
    z = qmatmul(x, p["in_z"], backend)
    Bp = qmatmul(x, p["in_B"], backend)
    Cp = qmatmul(x, p["in_C"], backend)
    dt_in = qmatmul(x, p["in_dt"], backend) + p["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))   # softplus
    nh = dt.shape[-1]
    a = -torch.exp(p["a_log"].to(f32))
    da = dt.to(f32) * a                                    # log decay

    conv_state = state["conv"] if state is not None else None
    xi, new_conv = _causal_conv(xi, p["conv1d_w"], p["conv1d_b"],
                                conv_state)
    xh = xi.reshape(b, L, nh, headdim)

    h0 = state["ssm"] if state is not None else \
        torch.zeros((b, nh, n_state, headdim), dtype=f32, device=x.device)
    args = (xh.to(f32), dt.to(f32), da, Bp.to(f32), Cp.to(f32), h0)
    if L % chunk == 0 and L > 1:      # training AND chunked prefill
        y, h_fin = _ssd_chunked(*args, chunk)
    else:
        y, h_fin = _ssd_steps(*args)

    y = y + p["d_skip"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(b, L, nh * headdim).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_scale"])
    out = qmatmul(y, p["out_proj"], backend)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": h_fin}
    return out, new_state


def mamba2_init_state(batch: int, d_model: int, n_state: int, dtype,
                      device, expand: int = 2, headdim: int = 64,
                      conv_k: int = 4) -> Dict:
    d_inner = expand * d_model
    h = d_inner // headdim
    return {
        "conv": torch.zeros((batch, conv_k - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, n_state, headdim), dtype=torch.float32,
                           device=device),
    }
