"""Model API over the decoder-only LM (dense, MoE, vlm, ssm and hybrid
families) and the encoder-decoder family (port of ``repro.models.api``):
init and the abstract template of a checkpoint restore, the training
loss of every family, prefill, decode, and
per-slot insertion into a live decode state.  The MoE family differs
only in its forward; an encoder-decoder state also holds the encoder
output, one ``(S_enc, d_model)`` row a slot (``enc_out``), written by a
prompt's first chunk and read by its later chunks and decode steps.  A
vlm prompt carries ``vision_embeds`` (B, vision_tokens, d_model), which
ride its first chunk and fill the first ``vision_tokens`` cache
positions; the ssm and hybrid caches hold recurrent rows, which a new
request's first chunk zeroes.  The reference's abstract input specs per
shape cell (``jax.ShapeDtypeStruct``) are tensors on the ``meta`` device
here: shapes and dtypes, nothing allocated.

The decode state is updated in place: methods that take a state write its
cache tensors and return a state dict holding the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..core.device import resolve_device
from . import encdec, transformer


def _write_rows(big: torch.Tensor, small: torch.Tensor, slot: int,
                batch_dim: int) -> None:
    """Write ``small`` into ``big`` in place at offset ``slot`` along
    ``batch_dim`` (offset 0 elsewhere: time axes write from position 0).
    Like ``dynamic_update_slice``, the offset is clamped so the write fits."""
    n = small.shape[batch_dim]
    slot = min(max(int(slot), 0), big.shape[batch_dim] - n)
    index = [slice(0, d) for d in small.shape]
    index[batch_dim] = slice(slot, slot + n)
    big[tuple(index)] = small.to(big.dtype)


def _write_tree(big, small, slot: int) -> None:
    """Write every leaf of a standalone prefill's cache tree ``small`` into
    the live cache ``big`` at batch row ``slot`` (dim 1 of the stacked
    leaves; time axes from position 0)."""
    if isinstance(big, dict):
        for name, leaf in big.items():
            _write_tree(leaf, small[name], slot)
        return
    _write_rows(big, small, slot, batch_dim=1)


def _write_enc_out(state, enc_out: torch.Tensor, slot: int) -> None:
    """Write a prompt's encoder output into ``state["enc_out"]`` at row
    ``slot``; cross-attention has no per-row length mask, so every row
    must share one encoder length."""
    if enc_out.shape[1] != state["enc_out"].shape[1]:
        raise ValueError(
            "enc-dec slot insertion needs the same encoder length as the "
            f"live batch: {enc_out.shape[1]} != {state['enc_out'].shape[1]} "
            "(cross-attention has no per-row length masking)")
    _write_rows(state["enc_out"], enc_out, slot, batch_dim=0)


def cache_is_paged(cache) -> bool:
    """True if any KV sub-dict of a decode cache carries a block table."""
    if isinstance(cache, dict):
        return "table" in cache or any(cache_is_paged(v)
                                       for v in cache.values())
    return False


def _row_cache_view(cache, slot: int, fresh: bool = False):
    """Single-slot view of a decode cache: paged sub-dicts keep the whole
    page pool but narrow the block table to ``slot``'s row; contiguous KV
    and recurrent leaves (stack, B, ...) are row-sliced on the batch dim.
    All views, so writes through them land in ``cache``.

    ``fresh`` zeroes the slot's *recurrent* rows in place: a view that
    starts a new request (its first prompt chunk) must read the zero
    state a standalone prefill starts from, not the rwkv / mamba state of
    the slot's previous occupant.  KV rows are left as they are: stale
    positions stay masked by the fill level."""
    if isinstance(cache, dict):
        if "table" in cache:
            return dict(cache, table=cache["table"][:, slot:slot + 1])
        if "k" in cache and "v" in cache:
            return {k: v[:, slot:slot + 1] for k, v in cache.items()}
        return {k: _row_cache_view(v, slot, fresh) for k, v in cache.items()}
    row = cache[:, slot:slot + 1]
    if fresh:
        row.zero_()
    return row


def _row_cache_unview(big, row, slot: int):
    """Merge an updated single-slot view back.  The view's writes already
    landed in ``big`` (paged pools are shared, contiguous rows are views),
    so the full cache is returned as it stands."""
    return big


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig

    # ---- parameters ---------------------------------------------------
    def init(self, seed: int = 0, device=None) -> Any:
        """Random QAT params from ``seed`` on ``device`` (the CUDA card
        unless the caller names another).  The draw uses a
        ``torch.Generator`` and does not reproduce the reference's
        ``jax.random`` values; carry those across with
        :func:`repro_torch.bridge.params_from_numpy`."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if self.cfg.is_encdec:
            return encdec.init_encdec(self.cfg, gen, dev)
        return transformer.init_lm(self.cfg, gen, dev)

    def abstract_params(self) -> Any:
        """The param tree's template (the reference's ``jax.eval_shape``
        of ``init``): every tensor on the ``meta`` device, so nothing is
        allocated, with the static fields (shapes, blocking specs, bit
        counts) a checkpoint does not store.  The draw comes from a CPU
        generator (a ``meta`` generator does not exist)."""
        gen = torch.Generator().manual_seed(0)
        dev = torch.device("meta")
        if self.cfg.is_encdec:
            return encdec.init_encdec(self.cfg, gen, dev)
        return transformer.init_lm(self.cfg, gen, dev)

    # ---- losses / steps ------------------------------------------------
    def loss(self, params, batch) -> tuple:
        """The training loss and its metrics (``ce``, ``aux``); the
        full-sequence forward runs with autograd live.  The
        encoder-decoder family's is ``encdec_loss`` (its batch carries
        ``frames``), every other family's ``transformer.loss_fn`` (cross
        entropy plus ``0.01 x`` the MoE aux term)."""
        if self.cfg.is_encdec:
            return encdec.encdec_loss(params, self.cfg, batch)
        return transformer.loss_fn(params, self.cfg, batch)

    def prefill(self, params, batch, extra_slots: int = 0, *,
                backend: str = "dense", attn_backend: str = "gather"
                ) -> tuple:
        """Full-sequence forward that also fills a new decode cache;
        ``extra_slots`` reserves positions for the decode steps that
        follow.  Returns (last-token logits, {"cache": ...}); an
        encoder-decoder batch also carries ``frames`` (B, S_enc, d_model),
        and the state its ``enc_out``; a vlm batch carries
        ``vision_embeds``, whose prefix the cache holds in front of the
        tokens."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cfg = self.cfg
        if cfg.is_encdec:
            cache = encdec.encdec_init_cache(cfg, b, s + extra_slots,
                                             tokens.device)
            logits, cache, enc_out = encdec.encdec_forward(
                params, cfg, batch["frames"], tokens, cache, 0,
                backend=backend, attn_backend=attn_backend)
            return logits[:, -1], {"cache": cache, "enc_out": enc_out}
        extra = (cfg.vision_tokens if cfg.family == "vlm" else 0) + \
            extra_slots
        cache = transformer.init_cache(cfg, b, s + extra, tokens.device)
        logits, cache = transformer.forward(
            params, cfg, tokens, vision_embeds=batch.get("vision_embeds"),
            positions=batch.get("positions"), cache=cache, index=0,
            backend=backend, attn_backend=attn_backend)
        return logits[:, -1], {"cache": cache}

    def decode_step(self, params, tokens, state, index, *,
                    backend: str = "dense", attn_backend: str = "gather"
                    ) -> tuple:
        """One decode step; ``index`` is the shared fill level or a
        per-slot (B,) vector of fill levels."""
        if self.cfg.is_encdec:
            logits, cache = encdec.encdec_decode_step(
                params, self.cfg, tokens, state["cache"], index,
                state["enc_out"], backend=backend, attn_backend=attn_backend)
            return logits, {**state, "cache": cache}
        logits, cache = transformer.decode_step(
            params, self.cfg, tokens, state["cache"], index,
            backend=backend, attn_backend=attn_backend)
        return logits, {**state, "cache": cache}

    def verify_step(self, params, tokens, state, index, *,
                    backend: str = "dense", attn_backend: str = "gather"
                    ) -> tuple:
        """Batched multi-token decode forward (speculative verification).

        ``tokens`` (B, W) are each slot's last accepted token followed by
        its draft proposals, written at fill levels ``index ..
        index+W-1``.  Returns ((B, W, V) logits, state).  The
        encoder-decoder family has none, as in the reference."""
        if self.cfg.is_encdec:
            raise NotImplementedError(
                "speculative verify is decoder-only (KV rollback is "
                "positional; enc-dec cross attention is out of scope)")
        logits, cache = transformer.verify_step(
            params, self.cfg, tokens, state["cache"], index,
            backend=backend, attn_backend=attn_backend)
        return logits, {**state, "cache": cache}

    def init_decode_state(self, params, batch, n_slots: int, max_len: int,
                          page_size: int = 0,
                          n_pages: Optional[int] = None) -> Any:
        """Empty decode state for ``n_slots`` slots, built directly (the
        reference derives the tree with ``jax.eval_shape``).  ``page_size
        > 0`` builds the paged layout: a pool of ``n_pages`` pages (default
        ``1 + n_slots * nb``, worst-case demand plus the trash page)
        instead of contiguous ``max_len``-wide slots.  An
        encoder-decoder state adds a zero ``enc_out`` buffer
        (n_slots, S_enc, d_model) in the compute dtype, S_enc the example
        batch's frames width."""
        dev = batch["tokens"].device
        template = transformer.init_cache(self.cfg, 1, 1, dev)
        if page_size > 0:
            nb = -(-max_len // page_size)
            n_pages = n_pages or (1 + n_slots * nb)
            cache = transformer.paginate_cache_tree(template, n_slots,
                                                    n_pages, page_size, nb)
        else:
            cache = transformer.rebatch_cache_tree(template, n_slots,
                                                   max_len)
        state = {"cache": cache}
        if self.cfg.is_encdec:
            state["enc_out"] = torch.zeros(
                (n_slots, batch["frames"].shape[1], self.cfg.d_model),
                dtype=transformer._cdtype(self.cfg), device=dev)
        return state

    def prefill_chunk_at(self, params, batch, state, slot: int, start: int,
                         *, backend: str = "dense",
                         attn_backend: str = "gather") -> tuple:
        """Insert a prompt chunk (1, W) into row ``slot`` of a live state
        at cache position ``start``, attending over the slot's cached
        prefix.  Returns the full (1, W, V) chunk logits and the state.

        An encoder-decoder prompt's ``frames`` go with its first chunk
        only (``start == 0``): that chunk runs the encoder and writes the
        slot's ``enc_out`` row, and later chunks read that row.  A vlm
        prompt's ``vision_embeds`` ride its first chunk likewise; its
        later chunks start at their cache position, the vision prefix
        included.  A chunk at ``start == 0`` zeroes the slot's recurrent
        rows first."""
        row_cache = _row_cache_view(state["cache"], slot, fresh=start == 0)
        if self.cfg.is_encdec:
            be = dict(backend=backend, attn_backend=attn_backend)
            if "frames" in batch:
                logits, row_cache, enc_out = encdec.encdec_forward(
                    params, self.cfg, batch["frames"], batch["tokens"],
                    row_cache, start, **be)
                _write_enc_out(state, enc_out, slot)
            else:
                logits, row_cache = encdec.encdec_decode_tokens(
                    params, self.cfg, batch["tokens"], row_cache, start,
                    state["enc_out"][slot:slot + 1], **be)
            return logits, state
        positions = None
        if batch.get("vision_embeds") is None:
            positions = transformer.model_positions(
                self.cfg, start, 1, batch["tokens"].shape[1],
                batch["tokens"].device)
        logits, row_cache = transformer.forward(
            params, self.cfg, batch["tokens"],
            vision_embeds=batch.get("vision_embeds"), positions=positions,
            cache=row_cache, index=start, backend=backend,
            attn_backend=attn_backend)
        return logits, dict(state, cache=_row_cache_unview(
            state["cache"], row_cache, slot))

    def prefill_at(self, params, batch, state, slot: int, *,
                   backend: str = "dense", attn_backend: str = "gather"
                   ) -> tuple:
        """Prefill ``batch`` INTO an existing decode state at row ``slot``.

        A paged state takes one whole-prompt chunk at ``start=0`` through
        the slot's block table; a contiguous state runs a standalone
        prefill and writes its cache rows (and encoder rows) into [slot,
        slot + rows); an encoder length other than the state's raises
        ``ValueError``.  Returns (last-token logits of the inserted rows,
        state)."""
        be = dict(backend=backend, attn_backend=attn_backend)
        if cache_is_paged(state["cache"]):
            logits, state = self.prefill_chunk_at(params, batch, state,
                                                  slot, 0, **be)
            return logits[:, -1], state
        logits, sub = self.prefill(params, batch, extra_slots=0, **be)
        if "enc_out" in state:
            _write_enc_out(state, sub["enc_out"], slot)
        _write_tree(state["cache"], sub["cache"], slot)
        return logits, state

    # ---- abstract input specs per shape cell ----------------------------
    def train_batch_spec(self, cell: ShapeCell) -> Dict[str, torch.Tensor]:
        """A training batch's tensors for ``cell`` on the ``meta`` device:
        tokens and labels; an encoder-decoder batch's bf16 ``frames``
        (one frame a position); a vlm batch's text cut to ``seq_len -
        vision_tokens``, its bf16 ``vision_embeds`` and (B, S, 3) M-RoPE
        ``positions``."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        if cfg.is_encdec:
            return {"frames": _meta((b, s, cfg.d_model), torch.bfloat16),
                    "tokens": _meta((b, s), torch.int32),
                    "labels": _meta((b, s), torch.int32)}
        if cfg.family == "vlm":
            tv = cfg.vision_tokens
            return {"tokens": _meta((b, s - tv), torch.int32),
                    "labels": _meta((b, s - tv), torch.int32),
                    "vision_embeds": _meta((b, tv, cfg.d_model),
                                           torch.bfloat16),
                    "positions": _meta((b, s, 3), torch.int32)}
        return {"tokens": _meta((b, s), torch.int32),
                "labels": _meta((b, s), torch.int32)}

    def decode_state_spec(self, cell: ShapeCell) -> Dict[str, Any]:
        """The decode state of ``cell`` (``global_batch`` rows of
        ``seq_len`` positions) on the ``meta`` device: the cache tree and
        an encoder-decoder state's ``enc_out``."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        meta = torch.device("meta")
        if cfg.is_encdec:
            return {"cache": encdec.encdec_init_cache(cfg, b, s, meta),
                    "enc_out": _meta((b, s, cfg.d_model),
                                     transformer._cdtype(cfg))}
        return {"cache": transformer.init_cache(cfg, b, s, meta)}

    def decode_token_spec(self, cell: ShapeCell) -> torch.Tensor:
        return _meta((cell.global_batch, 1), torch.int32)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(cfg)
