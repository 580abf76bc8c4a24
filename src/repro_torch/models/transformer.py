"""Decoder-only LM assembly, dense family (port of the dense and cache parts
of ``repro.models.transformer``).

Params hold stacked (L, ...) leaves.  Where the reference scans over
layers, the port runs a Python loop that slices layer ``i`` out of every
stacked leaf (views, no copies): a deployed ``ServingWeight`` reaches
``qmatmul`` as the layer's contiguous (Kp, Np) payload, so the packed
kernel reads the stacked tensor in place.  The KV cache is written in
place through per-layer views.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..core.fakequant import FakeQuantTensor
from ..serve.deploy import BitplaneServingWeight, ServingWeight
from .attention import attn_forward, fill_levels
from .common import (act_quant, embed_init, make_weight, prepare_params,
                     qmatmul, rms_norm, softcap)
from .ffn import mlp_forward


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts or cfg.mrope:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves the "
            f"dense family")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, stack: int, generator: torch.Generator,
                device) -> Dict:
    """One stacked parameter set for ``stack`` homogeneous dense layers."""
    _check_family(cfg)
    qc = cfg.quant
    d, dh = cfg.d_model, cfg.head_dim
    mk = dict(generator=generator, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    p: Dict[str, Any] = {"ln_attn": zeros(stack, d),
                         "ln_mlp": zeros(stack, d)}
    if cfg.use_post_norms:
        p["ln_attn_post"] = zeros(stack, d)
        p["ln_mlp_post"] = zeros(stack, d)
    p["attn"] = {
        "wq": make_weight((stack, d, cfg.n_heads * dh), qc, **mk),
        "wk": make_weight((stack, d, cfg.n_kv_heads * dh), qc, **mk),
        "wv": make_weight((stack, d, cfg.n_kv_heads * dh), qc, **mk),
        "wo": make_weight((stack, cfg.n_heads * dh, d), qc, **mk),
    }
    if cfg.qkv_bias:
        p["attn"]["bq"] = zeros(stack, cfg.n_heads * dh)
        p["attn"]["bk"] = zeros(stack, cfg.n_kv_heads * dh)
        p["attn"]["bv"] = zeros(stack, cfg.n_kv_heads * dh)
    if cfg.mlp_kind == "swiglu":
        p["mlp"] = {
            "w_gate": make_weight((stack, d, cfg.d_ff), qc, **mk),
            "w_up": make_weight((stack, d, cfg.d_ff), qc, **mk),
            "w_down": make_weight((stack, cfg.d_ff, d), qc, **mk),
        }
    else:
        p["mlp"] = {
            "w_in": make_weight((stack, d, cfg.d_ff), qc, **mk),
            "w_out": make_weight((stack, cfg.d_ff, d), qc, **mk),
        }
    if qc.enabled and qc.act_bits < 32:
        p["beta_attn"] = torch.full((stack,), qc.pact_init,
                                    dtype=torch.float32, device=device)
        p["beta_mlp"] = torch.full((stack,), qc.pact_init,
                                   dtype=torch.float32, device=device)
    return p


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(cfg.vocab, d, generator=generator,
                            device=device),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=device),
        "layers": _init_block(cfg, cfg.n_layers, generator, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = make_weight(
            (d, cfg.vocab), cfg.quant, generator=generator, device=device,
            quantize=cfg.quant.quantize_embeddings)
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked (L, ...) leaves (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (FakeQuantTensor, ServingWeight,
                         BitplaneServingWeight)):
        return tree.layer(i)
    return tree[i]


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attn_block(lp, h, positions, cfg: ModelConfig, layer: int, cache,
                index, backend: str, attn_backend: str):
    x = rms_norm(h, lp["ln_attn"])
    x = act_quant(x, lp.get("beta_attn"), cfg.quant)
    if cfg.alt_local_global:
        window = cfg.sliding_window if layer % 2 == 0 else 0
    else:
        window = cfg.sliding_window or 0
    out, new_cache = attn_forward(
        lp["attn"], x, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, causal=True,
        window=window, attn_softcap=cfg.attn_softcap, cache=cache,
        cache_index=index, backend=backend, attn_backend=attn_backend)
    if cfg.use_post_norms:
        out = rms_norm(out, lp["ln_attn_post"])
    return h + out, new_cache


def _mlp_block(lp, h, cfg: ModelConfig, backend: str):
    x = rms_norm(h, lp["ln_mlp"])
    x = act_quant(x, lp.get("beta_mlp"), cfg.quant)
    out = mlp_forward(lp["mlp"], x, cfg.mlp_kind, backend)
    if cfg.use_post_norms:
        out = rms_norm(out, lp["ln_mlp_post"])
    return h + out


def _walk_dense(mp, cfg, h, positions, cache, index, backend, attn_backend):
    """Loop over the homogeneous attention+FFN layers; each layer's cache
    view is written in place."""
    for i in range(cfg.n_layers):
        lp = _layer(mp["layers"], i)
        layer_cache = _layer(cache, i) if cache is not None else None
        h, _ = _attn_block(lp, h, positions, cfg, i, layer_cache, index,
                           backend, attn_backend)
        h = _mlp_block(lp, h, cfg, backend)
    return h, cache


def _embed_inputs(mp, cfg: ModelConfig, tokens, positions):
    h = mp["embed"][tokens.long()]
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(b, s)
    return h.to(_cdtype(cfg)), positions


def forward(params, cfg: ModelConfig, tokens, *, positions=None, cache=None,
            index=None, backend: str = "dense",
            attn_backend: str = "gather"):
    """Returns (logits f32 (B, S, V), cache written in place)."""
    _check_family(cfg)
    mp = prepare_params(params, _cdtype(cfg))
    h, positions = _embed_inputs(mp, cfg, tokens, positions)
    h, cache = _walk_dense(mp, cfg, h, positions, cache, index, backend,
                           attn_backend)
    h = rms_norm(h, mp["final_norm"])
    head = mp["lm_head"] if "lm_head" in mp else mp["embed"].T
    logits = qmatmul(h, head, backend).to(torch.float32)
    return softcap(logits, cfg.logit_softcap), cache


# ---------------------------------------------------------------------------
# caches (decode)
# ---------------------------------------------------------------------------

def make_kv_cache(cfg: ModelConfig, stack: int, batch: int, max_len: int,
                  device) -> Dict:
    """One stacked K/V cache at ``cfg.kv_cache_bits`` precision: int8, or
    int4 nibble-packed along the head dim, plus per-token/head scales; any
    other width stores the compute dtype."""
    dh, kv = cfg.head_dim, cfg.n_kv_heads
    shape = (stack, batch, max_len, kv, dh)
    bits = cfg.kv_cache_bits

    def z(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    if bits == 8:
        return {"k": z(shape, torch.int8), "v": z(shape, torch.int8),
                "k_scale": z(shape[:-1], torch.float32),
                "v_scale": z(shape[:-1], torch.float32)}
    if bits == 4:
        if dh % 2:
            raise ValueError(f"int4 KV cache needs an even head_dim, got "
                             f"{dh}")
        pshape = shape[:-1] + (dh // 2,)
        return {"k": z(pshape, torch.uint8), "v": z(pshape, torch.uint8),
                "k_scale": z(shape[:-1], torch.float32),
                "v_scale": z(shape[:-1], torch.float32)}
    dt = _cdtype(cfg)
    return {"k": z(shape, dt), "v": z(shape, dt)}


def rebatch_cache_tree(cache, n_slots: int, time_len: int):
    """Zero contiguous decode cache of ``n_slots`` slots of ``time_len``
    positions, mirroring ``cache``'s tree and dtypes."""
    return {n: torch.zeros((l.shape[0], n_slots, time_len, *l.shape[3:]),
                           dtype=l.dtype, device=l.device)
            for n, l in cache.items()}


def paginate_cache_tree(cache, n_slots: int, n_pages: int, page_size: int,
                        nb: int):
    """Zero *paged* decode cache mirroring contiguous ``cache``: pool
    leaves (stack, n_pages, page_size, ...) in the same storage dtypes and
    a (stack, n_slots, nb) block table that starts all-trash (page 0)."""
    k = cache["k"]
    return {
        "pages": {n: torch.zeros((l.shape[0], n_pages, page_size,
                                  *l.shape[3:]), dtype=l.dtype,
                                 device=l.device)
                  for n, l in cache.items()},
        "table": torch.zeros((k.shape[0], n_slots, nb), dtype=torch.int32,
                             device=k.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    _check_family(cfg)
    return make_kv_cache(cfg, cfg.n_layers, batch, max_len, device)


def decode_positions(index, batch: int, seq: int = 1,
                     device=None) -> torch.Tensor:
    """(B, S) int32 absolute positions from a scalar or per-slot (B,)
    index."""
    base = fill_levels(index, batch, device)[:, None]
    return base + torch.arange(seq, dtype=torch.int32, device=device)


def decode_step(params, cfg: ModelConfig, tokens, cache, index, *,
                backend: str = "dense", attn_backend: str = "gather"):
    """One-token step.  tokens: (B, 1); index: the shared fill level (int
    or 0-d) or a per-slot (B,) vector."""
    positions = decode_positions(index, tokens.shape[0], 1, tokens.device)
    logits, cache = forward(params, cfg, tokens, positions=positions,
                            cache=cache, index=index, backend=backend,
                            attn_backend=attn_backend)
    return logits[:, -1], cache


def verify_step(params, cfg: ModelConfig, tokens, cache, index, *,
                backend: str = "dense", attn_backend: str = "gather"):
    """W-token decode forward for speculative verification.

    ``tokens`` (B, W): a slot's last accepted token followed by its draft
    proposals; ``index``: scalar or per-slot (B,) fill levels.  Returns the
    full (B, W, V) logits and the cache with all W positions (re)written
    (attention reads through the gather path: the fused kernel serves one
    token)."""
    positions = decode_positions(index, tokens.shape[0], tokens.shape[1],
                                 tokens.device)
    return forward(params, cfg, tokens, positions=positions, cache=cache,
                   index=index, backend=backend, attn_backend=attn_backend)
