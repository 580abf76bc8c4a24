"""Encoder-decoder model, seamless-m4t style (port of the serving parts of
``repro.models.encdec``): a conformer-ish speech encoder over
precomputed frame embeddings (the frontend is a stub: the caller supplies
the frames) and a causal text decoder with cross-attention.  Same stacked
layout as the decoder-only LM: each forward takes the (L, ...) stacks
apart once (``transformer._unstack``) and walks the layers in a Python
loop; the decoder's KV cache is written in place through per-layer views.

Cross-attention K/V are projected from ``enc_out`` at every decoder call
(prefill, chunk and decode step), as in the reference, which keeps no
cross-KV cache.  Training runs through :func:`encdec_loss` (an unmasked
mean cross entropy, aux 0, as the reference's); under ``cfg.remat`` a
forward that builds a graph recomputes each encoder and decoder layer in
the backward, as the reference's ``jax.checkpoint`` of both bodies.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..dist.parallel import ShardedTensor
from .attention import attn_forward
from .common import (builds_graph, embed_init, make_weight, prepare_params,
                     qmatmul, remat_call, rms_norm)
from .ffn import mlp_forward
from .transformer import (_cdtype, _embed_lookup, _layer, _unstack,
                          _vocab_logits, decode_positions, make_kv_cache)


def _attn_weights(cfg: ModelConfig, stack: int, mk) -> Dict:
    d, dh, qc = cfg.d_model, cfg.head_dim, cfg.quant
    return {
        "wq": make_weight((stack, d, cfg.n_heads * dh), qc, **mk),
        "wk": make_weight((stack, d, cfg.n_kv_heads * dh), qc, **mk),
        "wv": make_weight((stack, d, cfg.n_kv_heads * dh), qc, **mk),
        "wo": make_weight((stack, cfg.n_heads * dh, d), qc, **mk),
    }


def _mlp_weights(cfg: ModelConfig, stack: int, mk) -> Dict:
    d, qc = cfg.d_model, cfg.quant
    return {"w_in": make_weight((stack, d, cfg.d_ff), qc, **mk),
            "w_out": make_weight((stack, cfg.d_ff, d), qc, **mk)}


def _zeros(device, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _enc_block_init(cfg: ModelConfig, stack: int,
                    generator: torch.Generator, device) -> Dict:
    d = cfg.d_model
    mk = dict(generator=generator, device=device)
    p: Dict[str, Any] = {"ln_attn": _zeros(device, stack, d),
                         "ln_mlp": _zeros(device, stack, d),
                         "attn": _attn_weights(cfg, stack, mk),
                         "mlp": _mlp_weights(cfg, stack, mk)}
    if cfg.conformer_encoder:
        p["ln_conv"] = _zeros(device, stack, d)
        p["conv_pw1"] = make_weight((stack, d, 2 * d), cfg.quant, **mk)
        p["conv_dw"] = torch.randn((stack, 15, d), generator=generator,
                                   device=device, dtype=torch.float32) * 0.1
        p["conv_pw2"] = make_weight((stack, d, d), cfg.quant, **mk)
    return p


def _dec_block_init(cfg: ModelConfig, stack: int,
                    generator: torch.Generator, device) -> Dict:
    d = cfg.d_model
    mk = dict(generator=generator, device=device)
    return {"ln_self": _zeros(device, stack, d),
            "ln_cross": _zeros(device, stack, d),
            "ln_mlp": _zeros(device, stack, d),
            "self_attn": _attn_weights(cfg, stack, mk),
            "cross_attn": _attn_weights(cfg, stack, mk),
            "mlp": _mlp_weights(cfg, stack, mk)}


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict:
    d = cfg.d_model
    return {
        "embed": embed_init(cfg.vocab, d, generator=generator,
                            device=device),
        "enc_layers": _enc_block_init(cfg, cfg.enc_layers, generator,
                                      device),
        "dec_layers": _dec_block_init(cfg, cfg.n_layers, generator, device),
        "enc_norm": _zeros(device, d),
        "final_norm": _zeros(device, d),
    }


def _conformer_conv(lp, x, backend: str = "dense"):
    """Pointwise GLU -> depthwise conv over time -> pointwise (simplified
    Conformer).  The depthwise kernel (K, d) is a cross-correlation padded
    K//2 in front and K-1-K//2 behind, as ``conv_general_dilated``."""
    h = qmatmul(x, lp["conv_pw1"], backend)
    a, b = torch.chunk(h, 2, dim=-1)
    h = a * torch.sigmoid(b)                              # GLU
    w = lp["conv_dw"]                                     # (K, d)
    k, d = w.shape
    hc = F.pad(h.transpose(1, 2), (k // 2, k - 1 - k // 2))
    h = F.conv1d(hc, w.T[:, None, :].to(h.dtype), groups=d).transpose(1, 2)
    return qmatmul(F.silu(h), lp["conv_pw2"], backend)


def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


def encode(mp, cfg: ModelConfig, frames: torch.Tensor,
           backend: str = "dense") -> torch.Tensor:
    """frames: (B, S_enc, d_model) precomputed frontend embeddings ->
    (B, S_enc, d_model) encoder output in the compute dtype."""
    h = frames.to(_cdtype(cfg))
    b, s, _ = h.shape
    pos = _arange_positions(b, s, h.device)

    def body(lp, h):
        out, _ = attn_forward(lp["attn"], rms_norm(h, lp["ln_attn"]), pos,
                              n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                              d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                              causal=False, backend=backend,
                              head_shards=cfg.head_shards)
        h = h + out
        if cfg.conformer_encoder:
            h = h + _conformer_conv(lp, rms_norm(h, lp["ln_conv"]), backend)
        return h + mlp_forward(lp["mlp"], rms_norm(h, lp["ln_mlp"]), "gelu",
                               backend)

    remat = cfg.remat and builds_graph(h, mp["enc_layers"])
    for lp in _unstack(mp["enc_layers"], cfg.enc_layers):
        h = remat_call(remat, body, lp, h)
    return rms_norm(h, mp["enc_norm"])


def decode(mp, cfg: ModelConfig, tokens, enc_out, cache=None, index=None,
           backend: str = "dense", attn_backend: str = "gather"):
    """Decoder over a (B, S) token block: self-attention through the cache
    (written in place at ``index``), cross-attention over ``enc_out``, the
    GELU MLP; the head is ``embed.T`` (under a mesh the vocab-sharded
    table's lookup and logits, ``transformer._embed_lookup`` /
    ``_vocab_logits``).  Returns (f32 (B, S, V) logits, cache)."""
    h = _embed_lookup(mp["embed"], tokens).to(_cdtype(cfg))
    b, s, _ = h.shape
    pos = _arange_positions(b, s, h.device) if index is None else \
        decode_positions(index, b, s, h.device)
    enc_pos = _arange_positions(b, enc_out.shape[1], h.device)
    heads = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                 d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                 backend=backend, head_shards=cfg.head_shards)

    def body(lp, h, enc_out, layer_cache):
        out, _ = attn_forward(lp["self_attn"], rms_norm(h, lp["ln_self"]),
                              pos, causal=True, cache=layer_cache,
                              cache_index=index, attn_backend=attn_backend,
                              **heads)
        h = h + out
        out, _ = attn_forward(lp["cross_attn"], rms_norm(h, lp["ln_cross"]),
                              pos, x_kv=enc_out, kv_positions=enc_pos,
                              **heads)
        h = h + out
        return h + mlp_forward(lp["mlp"], rms_norm(h, lp["ln_mlp"]), "gelu",
                               backend)

    remat = cfg.remat and builds_graph(h, enc_out, mp["dec_layers"])
    for i, lp in enumerate(_unstack(mp["dec_layers"], cfg.n_layers)):
        layer_cache = _layer(cache, i) if cache is not None else None
        h = remat_call(remat, body, lp, h, enc_out, layer_cache)
    h = rms_norm(h, mp["final_norm"])
    if isinstance(mp["embed"], ShardedTensor):
        return _vocab_logits(h, mp["embed"], backend), cache
    logits = qmatmul(h, mp["embed"].T, backend).to(torch.float32)
    return logits, cache


def encdec_forward(params, cfg: ModelConfig, frames, tokens, cache=None,
                   index=None, backend: str = "dense",
                   attn_backend: str = "gather"):
    """Encoder then decoder.  Returns (logits, cache, enc_out)."""
    mp = prepare_params(params, _cdtype(cfg))
    enc_out = encode(mp, cfg, frames, backend)
    logits, cache = decode(mp, cfg, tokens, enc_out, cache, index, backend,
                           attn_backend)
    return logits, cache, enc_out


def encdec_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Training loss: the decoder's next-token cross entropy over
    ``batch["frames"]`` (B, S_enc, d_model) and ``tokens`` / ``labels``,
    an unmasked mean; the family has no auxiliary term (aux 0)."""
    logits, _, _ = encdec_forward(params, cfg, batch["frames"],
                                  batch["tokens"])
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(lse - ll)
    return ce, dict(ce=ce, aux=torch.zeros((), dtype=torch.float32,
                                           device=ce.device))


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Dict:
    return make_kv_cache(cfg, cfg.n_layers, batch, max_len, device)


def encdec_decode_tokens(params, cfg: ModelConfig, tokens, cache, index,
                         enc_out, backend: str = "dense",
                         attn_backend: str = "gather"):
    """Decoder-only forward over a (B, S) token block starting at cache
    position ``index`` (encoder output precomputed): full (B, S, V)
    logits.  S=1 is the decode step; S>1 a chunked-prefill insertion."""
    mp = prepare_params(params, _cdtype(cfg))
    return decode(mp, cfg, tokens, enc_out, cache, index, backend,
                  attn_backend)


def encdec_decode_step(params, cfg: ModelConfig, tokens, cache, index,
                       enc_out, backend: str = "dense",
                       attn_backend: str = "gather"):
    """One decoder token; ``index`` is a scalar or a per-slot (B,)
    vector of fill levels."""
    logits, cache = encdec_decode_tokens(params, cfg, tokens, cache, index,
                                         enc_out, backend, attn_backend)
    return logits[:, -1], cache
