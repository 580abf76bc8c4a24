"""Grouped-query attention with RoPE, sliding windows, softcaps and a
KV-cache decode path (port of ``repro.models.attention``).

The KV cache is updated IN PLACE: where the reference rebuilds the cache
functionally (``dynamic_update_slice`` / ``.at[].set`` and a new dict per
step), the port writes into the stacked cache tensors through views and
returns the same dict.  Prefill attention stays plain einsum/softmax, as
the reference leaves it to XLA; decode attention reads the cache in its
stored (quantized) form through :func:`paged_attn`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..core.quantize import pack_int4, unpack_int4
from ..kernels.paged_attention import paged_attention
from ..kernels.ref import paged_attention_ref
from ..kernels.tiling import fit_block
from .common import qmatmul
from .common import softcap as _softcap
from .rope import apply_rope, rope_angles

NEG_INF = -2.0e38
INT32_MIN = -2 ** 31

# Blockwise-attention dispatch knobs (problems of more score elements than
# min_elems run the flash-style core).
ATTN_OPTS = {"min_elems": 4096 * 2048, "q_block": 512, "kv_block": 1024}

# Decode-attention backends: ``gather`` reads the cache back into a
# contiguous dequantized view and runs attention_core; ``fused`` runs the
# paged_attention kernel over the stored cache; ``ref`` is that kernel's
# plain PyTorch version.  Non-gather backends serve one-token causal decode
# only; every other shape takes the gather read side.
PAGED_ATTN_BACKENDS = ("gather", "fused", "ref")


def fill_levels(idx, b: int, device) -> torch.Tensor:
    """A scalar (int or 0-d tensor) or (B,) fill level as a (B,) int32
    tensor on ``device``.  An int becomes a fill kernel, not a host copy,
    so the decode loop never waits on the card."""
    if isinstance(idx, int):
        return torch.full((b,), idx, dtype=torch.int32, device=device)
    t = torch.as_tensor(idx, device=device).to(torch.int32)
    return t.expand(b).contiguous() if t.ndim == 0 else t


# ---------------------------------------------------------------------------
# quantized-at-rest KV cache
# ---------------------------------------------------------------------------

def cache_bits(cache) -> int:
    """Storage precision of a KV cache dict: 32 (float), 8, or 4."""
    if "pages" in cache:
        cache = cache["pages"]
    dt = cache["k"].dtype
    if dt == torch.int8:
        return 8
    if dt == torch.uint8:
        return 4
    return 32


def quantize_kv(x: torch.Tensor, bits: int):
    """(B, S, KV, dh) float -> (quantized, scale(B, S, KV)).

    int8: one int8 per element; int4: two's-complement nibbles packed in
    uint8 pairs along dh (dh must be even)."""
    lim = 127.0 if bits == 8 else 7.0
    xf = x.to(torch.float32)
    s = torch.amax(torch.abs(xf), dim=-1) / lim
    s = torch.clamp(s, min=1e-6)
    q = torch.clamp(torch.round(xf / s[..., None]), -lim, lim)
    if bits == 8:
        return q.to(torch.int8), s
    return pack_int4(q, axis=-1), s


def dequantize_kv(qx: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (int8 or packed-int4 -> ``dtype``)."""
    w = qx if qx.dtype == torch.int8 else unpack_int4(qx, axis=-1)
    return w.to(dtype) * scale[..., None].to(dtype)


def _cache_write(buf: torch.Tensor, update: torch.Tensor, idx) -> None:
    """Write ``update`` (B, S, ...) into ``buf`` (B, T, ...) in place at
    offset ``idx`` along dim 1.

    A scalar ``idx`` writes every row at the same offset; a (B,) vector
    writes each row at its own.  Like ``dynamic_update_slice``, the start
    is clamped to [0, T - S], so a write that would run past the end lands
    on the last S positions."""
    b, t, s = buf.shape[0], buf.shape[1], update.shape[1]
    if isinstance(idx, int):
        start = min(max(idx, 0), t - s)
        buf[:, start:start + s] = update
        return
    start = fill_levels(idx, b, buf.device).clamp(0, t - s).long()
    pos = start[:, None] + torch.arange(s, device=buf.device)
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, pos] = update.to(buf.dtype)


# ---------------------------------------------------------------------------
# paged cache (block-granular pool + per-slot block tables)
# ---------------------------------------------------------------------------
#
# A paged layer cache is ``{"pages": {k, v[, k_scale, v_scale]}, "table"}``:
# pool leaves carry a global page axis (P, page, KV, ...) and ``table``
# (B, nb) maps each slot's block b to the pool page holding its tokens
# [b*page, (b+1)*page).  Page 0 is the reserved trash page: unallocated
# table entries point at it, and everything routed there stays masked by
# the per-slot fill level.

def page_coords(table: torch.Tensor, idx, seq: int, page: int):
    """Slot-relative write positions -> (pool page ids, in-page offsets).

    ``table``: (B, nb) block table; ``idx``: scalar or (B,) fill level.
    Returns two (B, seq) int32 tensors for positions idx .. idx+seq-1.
    A position past the table end gets page id INT32_MIN, as the
    reference's gather fills it, and :func:`paged_write` drops its write
    (nothing is clamped into the last block)."""
    b, nb = table.shape
    base = fill_levels(idx, b, table.device)[:, None]
    pos = base + torch.arange(seq, dtype=torch.int32, device=table.device)
    blk = torch.div(pos, page, rounding_mode="floor")
    pids = torch.gather(table, 1, blk.clamp(0, nb - 1).long())
    pids = torch.where(blk < nb, pids, torch.full_like(pids, INT32_MIN))
    return pids, pos % page


def paged_write(leaf: torch.Tensor, pids: torch.Tensor, offs: torch.Tensor,
                vals: torch.Tensor) -> None:
    """Scatter ``vals`` (B, S, ...) into pool ``leaf`` (P, page, ...) in
    place at (pids, offs); entries with a negative page id are dropped.

    A dropped entry is aimed at the trash page 0 at its offset and writes
    back the value already there, so the scatter keeps a fixed shape and
    never waits for the card.  Only a kept write to page 0 at the same
    offset in the same call can then land or not; page 0 is never read
    unmasked."""
    keep = pids >= 0
    p = torch.where(keep, pids, torch.zeros_like(pids)).long()
    o = offs.long()
    keep = keep.reshape(*keep.shape, *([1] * (vals.ndim - 2)))
    leaf[p, o] = torch.where(keep, vals.to(leaf.dtype), leaf[p, o])


def paged_gather(pool_leaf: torch.Tensor, table: torch.Tensor):
    """(P, page, ...) pool leaf + (B, nb) table -> contiguous (B, T, ...)
    per-slot view (T = nb * page), token order preserved."""
    g = pool_leaf[table.long()]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def paged_attn(q: torch.Tensor, store: Dict, table: torch.Tensor,
               kv_len: torch.Tensor, *, window: int = 0,
               attn_softcap: float = 0.0,
               backend: str = "fused") -> torch.Tensor:
    """One decode step of attention straight over a (quantized) page pool.

    q: (B, 1, H, dh) roped queries; ``store``: pool leaves
    ``{"k", "v"[, "k_scale", "v_scale"]}`` (P, page, KV, ...);
    ``table``: (B, nb); ``kv_len``: (B,) fill levels *including* the token
    just written.  Returns (B, 1, H, dh) in q's dtype."""
    b, s, h, dh = q.shape
    kv = store["k"].shape[2]
    qg = q.reshape(b, kv, h // kv, dh)
    win = int(window) or None
    args = (qg, store["k"], store["v"], store.get("k_scale"),
            store.get("v_scale"), table, kv_len)
    if backend == "fused":
        out = paged_attention(*args, window=win, softcap=attn_softcap)
    elif backend == "ref":
        out = paged_attention_ref(*args, window=win, softcap=attn_softcap)
    else:
        raise ValueError(f"paged_attn executes 'fused' or 'ref', "
                         f"got {backend!r}")
    return out.reshape(b, s, h, dh).to(q.dtype)


def _as_pool(leaf: torch.Tensor, page: int) -> torch.Tensor:
    """(B, T, ...) contiguous cache leaf -> (B*(T//page), page, ...) pool
    view (a free reshape — paging as a view, not a copy)."""
    b, t = leaf.shape[0], leaf.shape[1]
    return leaf.reshape(b * (t // page), page, *leaf.shape[2:])


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _mask_for(q_pos, kv_pos, causal: bool, window: int, kv_len):
    """(B, S, T) boolean mask from position tensors."""
    mask = torch.ones((q_pos.shape[0], q_pos.shape[-1], kv_pos.shape[-1]),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    if kv_len is not None:
        mask &= kv_pos[:, None, :] < kv_len[:, None, None]
    return mask


def blockwise_attention_core(q, k, v, q_pos, kv_pos, *, causal=True,
                             window=0, attn_softcap=0.0, kv_len=None,
                             q_block: int = 512,
                             kv_block: int = 1024) -> torch.Tensor:
    """Flash-style memory-efficient attention: never materializes (S, T).

    Outer loop over query blocks, inner loop over KV blocks with running
    (max, denom, acc) — O(q_block * kv_block) live scores."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q_block = min(q_block, s)
    kv_block = min(kv_block, t)
    if s % q_block or t % kv_block:
        raise ValueError(f"blocks must divide: S={s} T={t} "
                         f"q_block={q_block} kv_block={kv_block}")
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for qi in range(0, s, q_block):
        qb = q[:, qi:qi + q_block].reshape(b, q_block, kv, g, dh)
        qp = q_pos[:, qi:qi + q_block]
        m = torch.full((b, kv, g, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kv, g, q_block, dh), dtype=torch.float32,
                          device=q.device)
        for ki in range(0, t, kv_block):
            kb = k[:, ki:ki + kv_block]
            vb = v[:, ki:ki + kv_block]
            kp = kv_pos[:, ki:ki + kv_block]
            sc = torch.einsum("bqkgd,btkd->bkgqt", qb.float(),
                              kb.float()) * scale
            if attn_softcap:
                sc = _softcap(sc, attn_softcap)
            msk = _mask_for(qp, kp, causal, window, kv_len)
            sc = torch.where(msk[:, None, None], sc,
                             torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(vb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(torch.movedim(out, 3, 1))        # (b, qb, kv, g, dh)
    out = torch.cat(outs, dim=1)
    return out.reshape(b, s, h, dh).to(q.dtype)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   attn_softcap: float = 0.0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,S,H,dh), k/v: (B,T,KV,dh), positions: (B,S)/(B,T) ->
    (B,S,H,dh).  Scores are taken in f32; large (S x T) problems run the
    blockwise core."""
    qb, kb = ATTN_OPTS["q_block"], ATTN_OPTS["kv_block"]
    if q.shape[1] * k.shape[1] > ATTN_OPTS["min_elems"] and \
            q.shape[1] % qb == 0 and k.shape[1] % kb == 0:
        return blockwise_attention_core(
            q, k, v, q_pos, kv_pos, causal=causal, window=window,
            attn_softcap=attn_softcap, kv_len=kv_len,
            q_block=qb, kv_block=kb)
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / math.sqrt(dh)
    if attn_softcap:
        scores = _softcap(scores, attn_softcap)
    mask = _mask_for(q_pos, kv_pos, causal, window, kv_len)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(q.dtype))
    return out.reshape(b, s, h, dh)


def attn_forward(p: Dict, x: torch.Tensor, positions: torch.Tensor, *,
                 n_heads: int, n_kv: int, d_head: int, rope_theta: float,
                 causal: bool = True, window: int = 0,
                 attn_softcap: float = 0.0, cache: Optional[Dict] = None,
                 cache_index=None, backend: str = "dense",
                 attn_backend: str = "gather"
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention sub-layer: projections + rope + core + output proj.

    With ``cache`` given, writes K/V at ``cache_index`` (in place) and
    attends over the cache (decode / incremental prefill)."""
    b = x.shape[0]
    q = qmatmul(x, p["wq"], backend)
    k = qmatmul(x, p["wk"], backend)
    v = qmatmul(x, p["wv"], backend)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(*q.shape[:-1], n_heads, d_head)
    k = k.reshape(*k.shape[:-1], n_kv, d_head)
    v = v.reshape(*v.shape[:-1], n_kv, d_head)
    ang = rope_angles(positions, d_head, rope_theta)
    q = apply_rope(q, ang)
    k = apply_rope(k, ang)
    q_pos = kv_pos = positions

    new_cache = None
    kv_len = None
    out = None
    if cache is not None:
        idx = cache_index  # int / 0-d: shared fill level; (B,): per slot
        kq, vq = k, v
        bits = cache_bits(cache)
        decode_only = attn_backend != "gather" and x.shape[1] == 1 \
            and causal
        if bits < 32:
            # quantized-at-rest cache: each written position is rounded
            # once; reads dequantize (gather) or run in the kernel (fused)
            kq, ks_sc = quantize_kv(k, bits)
            vq, vs_sc = quantize_kv(v, bits)
        if "table" in cache:
            table, store = cache["table"], cache["pages"]
            pids, offs = page_coords(table, idx, k.shape[1],
                                     store["k"].shape[1])
            paged_write(store["k"], pids, offs, kq)
            paged_write(store["v"], pids, offs, vq)
            if bits < 32:
                paged_write(store["k_scale"], pids, offs, ks_sc)
                paged_write(store["v_scale"], pids, offs, vs_sc)
            new_cache = cache
            if decode_only:
                kv_len = fill_levels(idx, b, x.device) + 1
                out = paged_attn(q, store, table, kv_len, window=window,
                                 attn_softcap=attn_softcap,
                                 backend=attn_backend)
            else:
                ck = paged_gather(store["k"], table)
                cv = paged_gather(store["v"], table)
                if bits < 32:
                    k = dequantize_kv(ck, paged_gather(store["k_scale"],
                                                       table), q.dtype)
                    v = dequantize_kv(cv, paged_gather(store["v_scale"],
                                                       table), q.dtype)
                else:
                    k, v = ck, cv
        else:
            ck, cv = cache["k"], cache["v"]
            _cache_write(ck, kq, idx)
            _cache_write(cv, vq, idx)
            if bits < 32:
                _cache_write(cache["k_scale"], ks_sc, idx)
                _cache_write(cache["v_scale"], vs_sc, idx)
            new_cache = cache
            if decode_only:
                # serve the contiguous cache through the same kernel by
                # viewing each slot's (T, ...) row as T//page pages with
                # an identity block table (free reshape, no trash page)
                t = ck.shape[1]
                page = fit_block(min(128, t), t, 1)
                pool = {n: _as_pool(cache[n], page) for n in cache}
                ident = torch.arange(b * (t // page), dtype=torch.int32,
                                     device=x.device).reshape(b, t // page)
                kv_len = fill_levels(idx, b, x.device) + 1
                out = paged_attn(q, pool, ident, kv_len, window=window,
                                 attn_softcap=attn_softcap,
                                 backend=attn_backend)
            elif bits < 32:
                k = dequantize_kv(ck, cache["k_scale"], q.dtype)
                v = dequantize_kv(cv, cache["v_scale"], q.dtype)
            else:
                k, v = ck, cv
        if out is None:
            t = ck.shape[1]
            kv_pos = torch.arange(t, device=x.device)[None, :].expand(b, t)
            kv_len = fill_levels(idx, b, x.device) + x.shape[1]

    if out is None:
        out = attention_core(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window, attn_softcap=attn_softcap,
                             kv_len=kv_len)
    out = out.reshape(*x.shape[:-1], n_heads * d_head)
    return qmatmul(out, p["wo"], backend), new_cache
