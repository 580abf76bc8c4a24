"""RWKV-6 "Finch" block: data-dependent per-channel decay linear attention
(port of ``repro.models.rwkv``).

Time-mix uses the GLA-style chunked form (log-space cumulative decays,
intra-chunk masked matmul + inter-chunk state recurrence) for a prompt
whose width is a multiple of the chunk, and the per-token recurrence
otherwise (decode among them), taking the reference's branch on every
call: the two differ in f32 summation.  Decode carries an O(H * dk * dv)
state per layer.  The data-dependent decay ``w_t`` comes from the LoRA-style
map w0 + tanh(x A) B.  Decay and bonus vectors stay unquantized; every
projection goes through ``qmatmul``.  Both scans are plain PyTorch: the
reference has no scan kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import chunk_call, make_weight, qmatmul, rms_norm


def init_rwkv6(d_model: int, n_heads: int, qc, *,
               generator: torch.Generator, device, lora_r: int = 64,
               stack: int = 0, d_ff: int = 0) -> Dict:
    """``stack`` > 0 builds stacked (stack, ...) leaves."""
    dh = d_model // n_heads
    d_ff = d_ff or 7 * d_model // 2
    lead = (stack,) if stack else ()
    mk = dict(generator=generator, device=device)

    def weight(k, n):
        return make_weight((*lead, k, n), qc, **mk)

    def full(value, *shape):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=device)

    def normal(*shape):
        return torch.randn((*lead, *shape), generator=generator,
                           device=device, dtype=torch.float32) * 0.02

    return {
        # time mix
        "wr": weight(d_model, d_model),
        "wk": weight(d_model, d_model),
        "wv": weight(d_model, d_model),
        "wg": weight(d_model, d_model),
        "wo_t": weight(d_model, d_model),
        "decay_w0": full(-6.0, d_model),
        "decay_a": normal(d_model, lora_r),
        "decay_b": normal(lora_r, d_model),
        "bonus_u": full(0.0, n_heads, dh),
        "mix_r": full(0.5, d_model),
        "mix_k": full(0.5, d_model),
        "mix_v": full(0.5, d_model),
        "mix_w": full(0.5, d_model),
        "ln_x_scale": full(1.0, d_model),
        # channel mix
        "cm_wr": weight(d_model, d_model),
        "cm_wk": weight(d_model, d_ff),
        "cm_wv": weight(d_ff, d_model),
        "cm_mix_r": full(0.5, d_model),
        "cm_mix_k": full(0.5, d_model),
        "ln_t": full(0.0, d_model),
        "ln_c": full(0.0, d_model),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """shifted[t] = x[t-1]; ``prev`` carries the last token across calls."""
    if prev is None:
        shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        shifted = torch.cat([prev[:, None, :], x[:, :-1]], dim=1)
    return shifted, x[:, -1, :]


def _wkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """Chunked linear attention with per-channel decay.

    r,k: (b, L, H, K); v: (b, L, H, V); logw: (b, L, H, K) (negative);
    u: (H, K) bonus for the diagonal; s0: (b, H, K, V).
    o_t = (u*k_t . r_t) v_t + r_t . S_{t-1};  S_t = w_t*S_{t-1} + k_t v_t^T
    (decay applied with the *current* token's w).  Intra-chunk
    A[q,s] = sum_k r_qk k_sk exp(dprev_q,k - dcum_s,k) in factored matmul
    form with a per-channel midpoint offset, so neither factor overflows
    f32 (per-step logw clamped >= -4 upstream; with chunk <= 32 the worst
    exponent is ~17*4 < 88).  With a graph to build, each chunk is
    recomputed in the backward (:func:`chunk_call`), so the backward holds
    one chunk's intermediates at a time, as the reference's
    ``jax.checkpoint(chunk_step)``."""
    L = r.shape[1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    eu = torch.exp(u)

    def chunk_step(s, r_c, k_c, v_c, lw_c):
        dcum = torch.cumsum(lw_c, dim=1)                 # (b,Q,H,K)
        dprev = dcum - lw_c
        mid = dcum[:, chunk // 2: chunk // 2 + 1]
        qk = torch.einsum("bqhk,bshk->bhqs", r_c * torch.exp(dprev - mid),
                          k_c * torch.exp(mid - dcum))
        qk = torch.where(tri, qk, torch.zeros_like(qk))
        diag = torch.einsum("bqhk,hk,bqhk->bhq", r_c, eu, k_c)
        o_intra = torch.einsum("bhqs,bshv->bqhv", qk, v_c) + \
            torch.einsum("bhq,bqhv->bqhv", diag, v_c)
        o_inter = torch.einsum("bqhk,bhkv->bqhv", r_c * torch.exp(dprev), s)
        s_chunk = torch.einsum("bshk,bshv->bhkv",
                               k_c * torch.exp(dcum[:, -1:] - dcum), v_c)
        s = s * torch.exp(dcum[:, -1])[..., None] + s_chunk
        return o_intra + o_inter, s

    s = s0
    outs = []
    for c0 in range(0, L, chunk):
        o, s = chunk_call(chunk_step, s, *(a[:, c0:c0 + chunk]
                                           for a in (r, k, v, logw)))
        outs.append(o)
    return torch.cat(outs, dim=1), s


def _wkv_steps(r, k, v, logw, u, s0):
    """The same recurrence one token at a time (decode, and prompts whose
    width is not a multiple of the chunk)."""
    eu = torch.exp(u)
    s = s0
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, lw_t = r[:, t], k[:, t], v[:, t], logw[:, t]
        o_t = torch.einsum("bhk,bhkv->bhv", r_t, s) + \
            torch.einsum("bhk,hk,bhk,bhv->bhv", r_t, eu, k_t, v_t)
        s = s * torch.exp(lw_t)[..., None] + \
            torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        outs.append(o_t)
    return torch.stack(outs, dim=1), s


def rwkv6_forward(p: Dict, h: torch.Tensor, *, n_heads: int,
                  chunk: int = 32, state: Optional[Dict] = None,
                  backend: str = "dense"
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full RWKV6 layer: h = h + TimeMix(LN(h)); h = h + ChannelMix(LN(h)).
    Plain float leaves of ``p`` are in h's dtype (``prepare_params``).
    Returns (h, the new state, or None without ``state``)."""
    b, L, d = h.shape
    chunk = min(chunk, L)
    dh = d // n_heads
    f32 = torch.float32
    x = rms_norm(h, p["ln_t"])
    prev_t = state["shift_t"] if state is not None else None
    shifted, last_t = _token_shift(x, prev_t)

    def mix(mu):
        return x + (shifted - x) * mu

    r = qmatmul(mix(p["mix_r"]), p["wr"], backend).reshape(b, L, n_heads, dh)
    k = qmatmul(mix(p["mix_k"]), p["wk"], backend).reshape(b, L, n_heads, dh)
    v = qmatmul(mix(p["mix_v"]), p["wv"], backend).reshape(b, L, n_heads, dh)
    g = F.silu(qmatmul(mix(p["mix_w"]), p["wg"], backend))

    xw = mix(p["mix_w"])
    logw = -torch.exp(p["decay_w0"] +
                      torch.tanh(xw @ p["decay_a"]) @ p["decay_b"])
    logw = torch.clamp(logw, min=-4.0)  # decay floor (_wkv_chunked note)
    logw = logw.reshape(b, L, n_heads, dh).to(f32)

    s0 = state["wkv"] if state is not None else \
        torch.zeros((b, n_heads, dh, dh), dtype=f32, device=h.device)
    args = (r.to(f32), k.to(f32), v.to(f32), logw, p["bonus_u"].to(f32), s0)
    if L % chunk == 0 and L > 1:      # training AND chunked prefill
        o, s_fin = _wkv_chunked(*args, chunk)
    else:
        o, s_fin = _wkv_steps(*args)

    o = o.reshape(b, L, d).to(x.dtype)
    o = rms_norm(o, p["ln_x_scale"] - 1.0) * g
    h = h + qmatmul(o, p["wo_t"], backend)

    # channel mix (with its own token shift) on the updated residual stream
    xc = rms_norm(h, p["ln_c"])
    prev_c = state["shift_c"] if state is not None else None
    shifted_c, last_c = _token_shift(xc, prev_c)

    def mixc(mu):
        return xc + (shifted_c - xc) * mu

    rc = torch.sigmoid(qmatmul(mixc(p["cm_mix_r"]), p["cm_wr"], backend))
    kc = torch.square(torch.relu(qmatmul(mixc(p["cm_mix_k"]), p["cm_wk"],
                                         backend)))
    h = h + rc * qmatmul(kc, p["cm_wv"], backend)

    new_state = None
    if state is not None:
        new_state = {"shift_t": last_t, "shift_c": last_c, "wkv": s_fin}
    return h, new_state


def rwkv6_init_state(batch: int, d_model: int, n_heads: int, dtype,
                     device) -> Dict:
    dh = d_model // n_heads
    return {
        "shift_t": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, n_heads, dh, dh), dtype=torch.float32,
                           device=device),
    }
