"""Decoder-only LM assembly: dense / MoE / vlm / ssm / hybrid families
(port of ``repro.models.transformer``); the encoder-decoder family
(``models/encdec.py``) reuses its layer walk helpers and caches.

The vlm family (qwen2-vl) is the dense walk with M-RoPE and a vision
prefix projected through ``vision_proj``; ssm (rwkv6) walks RWKV-6 layers
with a recurrent state a layer; hybrid (zamba2) walks Mamba-2 layers and
calls ONE shared attention + MLP block every ``hybrid_attn_every`` layers
on ``concat(h, emb0)``, with a KV cache of its own for each call.  A
decode cache is a tree: KV sub-dicts (``{"k", "v", ...}`` leaves with a
time axis, or their paged ``{"pages", "table"}`` form) and recurrent
leaves (no time axis), nested for the hybrid (``{"mamba", "attn"}``).

Params hold stacked (L, ...) leaves.  Where the reference scans over
layers, the port runs a Python loop over the layers, which each forward
takes apart once (``torch.unbind``: views, no copies).  A deployed
``ServingWeight`` reaches ``qmatmul`` as the layer's contiguous (Kp, Np)
payload, so the packed kernel reads the stacked tensor in place; in
training the backward stacks each leaf's layer gradients once (slicing a
layer with ``tensor[i]`` would write a zero buffer the size of the whole
stack for every layer).  With ``cfg.remat`` each layer body is
recomputed in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` (``common.remat_call``; the ssm layers and
the hybrid's Mamba-2 layers too).  The KV cache and the recurrent states
are written in place through per-layer views; a training forward has no
cache, so no such write touches a tensor autograd saved.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from ..configs.base import ModelConfig
from ..dist.parallel import (ShardedTensor, all_gather, all_reduce,
                             gather_payload)
from .attention import attn_forward, fill_levels, init_attn
from .common import (act_quant, builds_graph, embed_init, make_weight,
                     prepare_params, qmatmul, remat_call, rms_norm, softcap)
from .ffn import init_mlp, mlp_forward
from .moe import init_moe, moe_forward
from .rwkv import init_rwkv6, rwkv6_forward, rwkv6_init_state
from .ssm import init_mamba2, mamba2_forward, mamba2_init_state

_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if not (cfg.family in _FAMILIES or cfg.is_encdec):
        raise ValueError(f"unknown family {cfg.family!r}; the port serves "
                         f"{_FAMILIES} and the encoder-decoder family")


def check_trainable(cfg: ModelConfig) -> None:
    """Every family the port serves also trains, as in the reference: the
    dense, MoE (the grouped product's ragged backward and ``0.01 x`` the
    load-balancing term), vlm, ssm and hybrid families through
    :func:`loss_fn`, the encoder-decoder family through
    ``encdec.encdec_loss``.  Raises only for a family the port does not
    know."""
    _check_family(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, stack: int, generator: torch.Generator,
                device) -> Dict:
    """One stacked parameter set for ``stack`` homogeneous layers: an MoE
    config holds a ``"moe"`` subtree where a dense one holds ``"mlp"``;
    ssm layers are RWKV-6 blocks, hybrid ones Mamba-2 blocks with their
    pre-norm ``ln``."""
    _check_family(cfg)
    qc = cfg.quant
    d, dh = cfg.d_model, cfg.head_dim
    mk = dict(generator=generator, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if cfg.family == "ssm":
        return init_rwkv6(d, cfg.n_heads, qc, stack=stack, d_ff=cfg.d_ff,
                          **mk)
    if cfg.family == "hybrid":
        p = init_mamba2(d, cfg.ssm_state, qc, expand=cfg.ssm_expand,
                        headdim=cfg.ssm_headdim, stack=stack, **mk)
        p["ln"] = zeros(stack, d)
        return p
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
    if cfg.family == "moe" or cfg.n_experts:
        p["moe"] = init_moe(d, cfg.d_ff, cfg.n_experts, cfg.top_k, qc,
                            cfg.n_shared_experts, stack=(stack,), **mk)
    elif cfg.mlp_kind == "swiglu":
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
    mk = dict(generator=generator, device=device)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        # zamba2: ONE shared attention block, called every k layers on
        # concat(hidden, original embedding) (2 * d input)
        params["shared_attn"] = init_attn(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.quant,
            d_model_in=2 * d, **mk)
        params["shared_ln"] = torch.zeros((2 * d,), dtype=torch.float32,
                                          device=device)
        params["shared_mlp"] = init_mlp(d, cfg.d_ff, cfg.quant,
                                        kind=cfg.mlp_kind, **mk)
        params["shared_ln2"] = torch.zeros((d,), dtype=torch.float32,
                                           device=device)
    if cfg.family == "vlm":
        params["vision_proj"] = make_weight((d, d), cfg.quant, **mk)
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked (L, ...) tensors (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> List:
    """The ``n`` layers of a tree of stacked (L, ...) leaves, taken apart
    once: every tensor, and every tensor field of a quantized weight, is
    unbound along its leading dim (views)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if dataclasses.is_dataclass(tree):
        fields = {f.name: torch.unbind(getattr(tree, f.name))
                  for f in dataclasses.fields(tree)
                  if isinstance(getattr(tree, f.name), torch.Tensor)}
        return [dataclasses.replace(tree, **{k: v[i]
                                             for k, v in fields.items()})
                for i in range(n)]
    return list(torch.unbind(tree))


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
        window=window, attn_softcap=cfg.attn_softcap, mrope=cfg.mrope,
        cache=cache, cache_index=index, backend=backend,
        attn_backend=attn_backend, head_shards=cfg.head_shards)
    if cfg.use_post_norms:
        out = rms_norm(out, lp["ln_attn_post"])
    return h + out, new_cache


def _mlp_block(lp, h, cfg: ModelConfig, backend: str):
    """FFN or MoE sublayer; returns (h, the layer's MoE aux loss)."""
    x = rms_norm(h, lp["ln_mlp"])
    x = act_quant(x, lp.get("beta_mlp"), cfg.quant)
    aux = None
    if "moe" in lp:
        out, aux = moe_forward(lp["moe"], x, cfg.top_k, backend)
    else:
        out = mlp_forward(lp["mlp"], x, cfg.mlp_kind, backend)
    if cfg.use_post_norms:
        out = rms_norm(out, lp["ln_mlp_post"])
    return h + out, aux


def _layer_body(lp, h, positions, cfg, i, layer_cache, index, backend,
                attn_backend):
    h, _ = _attn_block(lp, h, positions, cfg, i, layer_cache, index,
                       backend, attn_backend)
    return _mlp_block(lp, h, cfg, backend)


def _walk_dense(mp, cfg, h, positions, cache, index, backend, attn_backend):
    """Loop over the homogeneous attention+FFN (or MoE) layers; each
    layer's cache view is written in place and the MoE aux losses are
    summed over the layers, as the reference's scan carries them.  A
    forward that builds a graph recomputes each layer in the backward
    when ``cfg.remat``.  Returns (h, aux, cache); aux is 0 for a dense
    model."""
    remat = cfg.remat and builds_graph(h, mp["layers"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, lp in enumerate(_unstack(mp["layers"], cfg.n_layers)):
        layer_cache = _layer(cache, i) if cache is not None else None
        h, aux_l = remat_call(remat, _layer_body, lp, h, positions, cfg, i,
                              layer_cache, index, backend, attn_backend)
        if aux_l is not None:
            aux = aux + aux_l
    return h, aux, cache


def _write_state(view: Dict, new: Dict) -> None:
    """Write a layer's new recurrent state into its cache views."""
    for name, val in new.items():
        view[name].copy_(val)


def _walk_ssm(mp, cfg, h, cache, backend):
    """Loop over the RWKV-6 layers; each layer's state views are written
    in place.  A forward that builds a graph recomputes each layer in the
    backward when ``cfg.remat``."""
    def body(lp, h, state):
        return rwkv6_forward(lp, h, n_heads=cfg.n_heads,
                             chunk=cfg.rwkv_chunk, state=state,
                             backend=backend)

    remat = cfg.remat and builds_graph(h, mp["layers"])
    for i, lp in enumerate(_unstack(mp["layers"], cfg.n_layers)):
        state = _layer(cache, i) if cache is not None else None
        h, new = remat_call(remat, body, lp, h, state)
        if state is not None:
            _write_state(state, new)
    return h, cache


def _walk_hybrid(mp, cfg, h, emb0, positions, cache, index, backend,
                 attn_backend):
    """zamba2: the Mamba-2 trunk, and after every ``period`` layers ONE
    shared attention + MLP block on ``concat(h, emb0)`` with its own KV
    cache for that call; the ``n_layers % period`` last layers form a tail
    with no shared call after it.  Every state is written in place.  A
    forward that builds a graph recomputes each Mamba-2 layer in the
    backward when ``cfg.remat`` (the reference remats those bodies, not
    the shared block's calls)."""
    period = cfg.hybrid_attn_every
    n = cfg.n_layers
    n_super = n // period if period else 0
    layers = _unstack(mp["layers"], n)
    remat = cfg.remat and builds_graph(h, mp["layers"])
    mstates = cache["mamba"] if cache is not None else None
    acaches = cache["attn"] if cache is not None else None

    def body(lp, h, state):
        out, new = mamba2_forward(
            {k: v for k, v in lp.items() if k != "ln"},
            rms_norm(h, lp["ln"]), n_state=cfg.ssm_state,
            headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk, state=state,
            backend=backend)
        return h + out, new

    def mamba(li, h):
        state = _layer(mstates, li) if mstates is not None else None
        h, new = remat_call(remat, body, layers[li], h, state)
        if state is not None:
            _write_state(state, new)
        return h

    for si in range(n_super):
        for li in range(si * period, (si + 1) * period):
            h = mamba(li, h)
        xcat = rms_norm(torch.cat([h, emb0], dim=-1), mp["shared_ln"])
        out, _ = attn_forward(
            mp["shared_attn"], xcat, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            rope_theta=cfg.rope_theta, causal=True,
            cache=_layer(acaches, si) if acaches is not None else None,
            cache_index=index, backend=backend, attn_backend=attn_backend,
            head_shards=cfg.head_shards)
        h = h + out
        h = h + mlp_forward(mp["shared_mlp"], rms_norm(h, mp["shared_ln2"]),
                            cfg.mlp_kind, backend)
    for li in range(n_super * period, n):
        h = mamba(li, h)
    return h, cache


def _embed_inputs(mp, cfg: ModelConfig, tokens, vision_embeds, positions,
                  backend):
    """Token embeddings, a vlm prompt's projected vision prefix in front,
    and the default positions: 0.. over the whole sequence, three equal
    streams under M-RoPE."""
    h = _embed_lookup(mp["embed"], tokens)
    if cfg.family == "vlm" and vision_embeds is not None:
        v = qmatmul(vision_embeds, mp["vision_proj"], backend)
        h = torch.cat([v.to(h.dtype), h], dim=1)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(b, s)
        if cfg.mrope:
            positions = torch.stack([positions] * 3, dim=-1)
    return h.to(_cdtype(cfg)), positions


def forward_aux(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
                positions=None, cache=None, index=None,
                backend: str = "dense", attn_backend: str = "gather"):
    """Returns (logits f32 (B, S, V), the summed MoE aux loss, cache
    written in place), the reference's ``forward``."""
    _check_family(cfg)
    mp = prepare_params(params, _cdtype(cfg))
    h, positions = _embed_inputs(mp, cfg, tokens, vision_embeds, positions,
                                 backend)
    emb0 = h
    if cfg.family == "ssm":
        h, cache = _walk_ssm(mp, cfg, h, cache, backend)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    elif cfg.family == "hybrid":
        h, cache = _walk_hybrid(mp, cfg, h, emb0, positions, cache, index,
                                backend, attn_backend)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        h, aux, cache = _walk_dense(mp, cfg, h, positions, cache, index,
                                    backend, attn_backend)
    h = rms_norm(h, mp["final_norm"])
    head = mp.get("lm_head", mp["embed"])
    if isinstance(head, ShardedTensor):
        logits = _vocab_logits(h, head, backend)
    else:
        head = mp["lm_head"] if "lm_head" in mp else mp["embed"].T
        logits = qmatmul(h, head, backend).to(torch.float32)
    return softcap(logits, cfg.logit_softcap), aux, cache


def _embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings.  Under a mesh the table's vocab rows lie on
    ``model``: each rank looks up the tokens its rows hold (zero for the
    rest) and the all-reduce over ``model`` sums the one nonzero row a
    token has."""
    if not isinstance(embed, ShardedTensor):
        return embed[tokens.long()]
    table = gather_payload(embed)["t"]
    start, stop = embed.shard.window
    idx = tokens.long() - start
    valid = (idx >= 0) & (idx < stop - start)
    h = table[idx.clamp(0, stop - start - 1)] * valid[..., None].to(
        table.dtype)
    return all_reduce(h)


def _vocab_logits(h: torch.Tensor, head: ShardedTensor,
                  backend: str) -> torch.Tensor:
    """f32 logits through a vocab-sharded LM head (the tied embedding's
    rows, or an unquantized head's columns): each rank's vocab slice,
    gathered over ``model`` and cut back to the true vocab, so a padding
    row's logit never reaches the argmax."""
    table = gather_payload(head)["t"]
    w = table.T if head.shard.kind == "row" else table
    local = qmatmul(h, w, backend).to(torch.float32)
    vocab = head.shape[-2] if head.shard.kind == "row" else head.shape[-1]
    return torch.cat(all_gather(local, "model"), dim=-1)[..., :vocab]


def forward(params, cfg: ModelConfig, tokens, **kw):
    """Returns (logits f32 (B, S, V), cache written in place); the
    serving forward drops the MoE aux loss."""
    logits, _, cache = forward_aux(params, cfg, tokens, **kw)
    return logits, cache


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross entropy plus ``0.01 x`` the summed MoE
    load-balancing term (0 for the families without experts).  batch:
    tokens, labels, [mask], [positions], and a vlm batch's
    [vision_embeds], whose prefix positions carry no label: the logits
    are cut to the last ``labels.shape[1]`` positions."""
    check_trainable(cfg)
    logits, aux, _ = forward_aux(params, cfg, batch["tokens"],
                                 vision_embeds=batch.get("vision_embeds"),
                                 positions=batch.get("positions"))
    labels = batch["labels"].long()
    if cfg.family == "vlm" and batch.get("vision_embeds") is not None:
        logits = logits[:, -labels.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    mask = batch.get("mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = float(nll.numel())
    ce = torch.sum(nll) / denom
    return ce + 0.01 * aux, dict(ce=ce, aux=aux)


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


def _walk_cache_tree(cache, kv_fn, leaf_fn):
    """Apply ``kv_fn`` to the KV sub-dicts ({"k", "v", ...} leaves with a
    time axis) and ``leaf_fn`` to the recurrent leaves (no time axis) of a
    stacked decode-cache tree."""
    if isinstance(cache, dict):
        if "k" in cache and "v" in cache:
            return kv_fn(cache)
        return {k: _walk_cache_tree(v, kv_fn, leaf_fn)
                for k, v in cache.items()}
    return leaf_fn(cache)


def _zeros_like_rows(leaf: torch.Tensor, n_slots: int) -> torch.Tensor:
    return torch.zeros((leaf.shape[0], n_slots, *leaf.shape[2:]),
                       dtype=leaf.dtype, device=leaf.device)


def rebatch_cache_tree(cache, n_slots: int, time_len: int):
    """Zero contiguous decode cache of ``n_slots`` slots of ``time_len``
    positions, mirroring ``cache``'s tree and dtypes; recurrent leaves
    become ``n_slots`` zero rows."""
    return _walk_cache_tree(
        cache,
        lambda node: {n: torch.zeros((l.shape[0], n_slots, time_len,
                                      *l.shape[3:]), dtype=l.dtype,
                                     device=l.device)
                      for n, l in node.items()},
        lambda l: _zeros_like_rows(l, n_slots))


def paginate_cache_tree(cache, n_slots: int, n_pages: int, page_size: int,
                        nb: int):
    """Zero *paged* decode cache mirroring contiguous ``cache``: every KV
    sub-dict becomes pool leaves (stack, n_pages, page_size, ...) in the
    same storage dtypes and a (stack, n_slots, nb) block table that starts
    all-trash (page 0); recurrent leaves are re-batched rows, as in
    :func:`rebatch_cache_tree`."""
    def kv(node):
        k = node["k"]
        return {
            "pages": {n: torch.zeros((l.shape[0], n_pages, page_size,
                                      *l.shape[3:]), dtype=l.dtype,
                                     device=l.device)
                      for n, l in node.items()},
            "table": torch.zeros((k.shape[0], n_slots, nb),
                                 dtype=torch.int32, device=k.device)}
    return _walk_cache_tree(cache, kv, lambda l: _zeros_like_rows(l, n_slots))


def _stacked(state: Dict, n: int) -> Dict:
    return {k: torch.zeros((n, *a.shape), dtype=a.dtype, device=a.device)
            for k, a in state.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    """A zero decode cache: KV for the dense / MoE / vlm families, the
    stacked RWKV-6 states for ssm, ``{"mamba", "attn"}`` for the hybrid
    (the shared block's KV stack holds one layer a shared call)."""
    _check_family(cfg)
    dt = _cdtype(cfg)
    if cfg.family == "ssm":
        return _stacked(rwkv6_init_state(batch, cfg.d_model, cfg.n_heads,
                                         dt, device), cfg.n_layers)
    if cfg.family == "hybrid":
        mst = mamba2_init_state(batch, cfg.d_model, cfg.ssm_state, dt,
                                device, cfg.ssm_expand, cfg.ssm_headdim)
        n_super = cfg.n_layers // cfg.hybrid_attn_every \
            if cfg.hybrid_attn_every else 0
        return {"mamba": _stacked(mst, cfg.n_layers),
                "attn": make_kv_cache(cfg, n_super, batch, max_len, device)}
    return make_kv_cache(cfg, cfg.n_layers, batch, max_len, device)


def decode_positions(index, batch: int, seq: int = 1,
                     device=None) -> torch.Tensor:
    """(B, S) int32 absolute positions from a scalar or per-slot (B,)
    index."""
    base = fill_levels(index, batch, device)[:, None]
    return base + torch.arange(seq, dtype=torch.int32, device=device)


def model_positions(cfg: ModelConfig, index, batch: int, seq: int = 1,
                    device=None) -> torch.Tensor:
    """:func:`decode_positions`, as three equal streams (B, S, 3) under
    M-RoPE."""
    pos = decode_positions(index, batch, seq, device)
    return torch.stack([pos] * 3, dim=-1) if cfg.mrope else pos


def decode_step(params, cfg: ModelConfig, tokens, cache, index, *,
                backend: str = "dense", attn_backend: str = "gather"):
    """One-token step.  tokens: (B, 1); index: the shared fill level (int
    or 0-d) or a per-slot (B,) vector."""
    positions = model_positions(cfg, index, tokens.shape[0], 1,
                                tokens.device)
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
    positions = model_positions(cfg, index, tokens.shape[0], tokens.shape[1],
                                tokens.device)
    return forward(params, cfg, tokens, positions=positions, cache=cache,
                   index=index, backend=backend, attn_backend=attn_backend)
