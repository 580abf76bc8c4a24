"""Model API over the dense decoder (port of the serving part of
``repro.models.api``): init, prefill, decode, and per-slot insertion into
a live decode state.

The decode state is updated in place: methods that take a state write its
cache tensors and return a state dict holding the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import transformer


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


def cache_is_paged(cache) -> bool:
    """True if any KV sub-dict of a decode cache carries a block table."""
    if isinstance(cache, dict):
        return "table" in cache or any(cache_is_paged(v)
                                       for v in cache.values())
    return False


def _row_cache_view(cache, slot: int):
    """Single-slot view of a decode cache: a paged cache keeps the whole
    page pool but narrows the block table to ``slot``'s row; contiguous
    leaves (stack, B, ...) are row-sliced on the batch dim.  All views, so
    writes through them land in ``cache``.  (The dense family has no
    recurrent rows to zero for a fresh request.)"""
    if "table" in cache:
        return dict(cache, table=cache["table"][:, slot:slot + 1])
    return {k: v[:, slot:slot + 1] for k, v in cache.items()}


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
        return transformer.init_lm(self.cfg, gen, dev)

    # ---- steps ----------------------------------------------------------
    def prefill(self, params, batch, extra_slots: int = 0, *,
                backend: str = "dense", attn_backend: str = "gather"
                ) -> tuple:
        """Full-sequence forward that also fills a new decode cache;
        ``extra_slots`` reserves positions for the decode steps that
        follow.  Returns (last-token logits, {"cache": ...})."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = transformer.init_cache(self.cfg, b, s + extra_slots,
                                       tokens.device)
        logits, cache = transformer.forward(
            params, self.cfg, tokens, positions=batch.get("positions"),
            cache=cache, index=0, backend=backend, attn_backend=attn_backend)
        return logits[:, -1], {"cache": cache}

    def decode_step(self, params, tokens, state, index, *,
                    backend: str = "dense", attn_backend: str = "gather"
                    ) -> tuple:
        """One decode step; ``index`` is the shared fill level or a
        per-slot (B,) vector of fill levels."""
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
        index+W-1``.  Returns ((B, W, V) logits, state)."""
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
        instead of contiguous ``max_len``-wide slots."""
        template = transformer.init_cache(self.cfg, 1, 1,
                                          batch["tokens"].device)
        if page_size > 0:
            nb = -(-max_len // page_size)
            n_pages = n_pages or (1 + n_slots * nb)
            cache = transformer.paginate_cache_tree(template, n_slots,
                                                    n_pages, page_size, nb)
        else:
            cache = transformer.rebatch_cache_tree(template, n_slots,
                                                   max_len)
        return {"cache": cache}

    def prefill_chunk_at(self, params, batch, state, slot: int, start: int,
                         *, backend: str = "dense",
                         attn_backend: str = "gather") -> tuple:
        """Insert a prompt chunk (1, W) into row ``slot`` of a live state
        at cache position ``start``, attending over the slot's cached
        prefix.  Returns the full (1, W, V) chunk logits and the state."""
        row_cache = _row_cache_view(state["cache"], slot)
        positions = transformer.decode_positions(
            start, 1, batch["tokens"].shape[1], batch["tokens"].device)
        logits, row_cache = transformer.forward(
            params, self.cfg, batch["tokens"], positions=positions,
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
        prefill and writes its cache rows into [slot, slot + rows).
        Returns (last-token logits of the inserted rows, state)."""
        be = dict(backend=backend, attn_backend=attn_backend)
        if cache_is_paged(state["cache"]):
            logits, state = self.prefill_chunk_at(params, batch, state,
                                                  slot, 0, **be)
            return logits[:, -1], state
        logits, sub = self.prefill(params, batch, extra_slots=0, **be)
        for name, big in state["cache"].items():
            _write_rows(big, sub["cache"][name], slot, batch_dim=1)
        return logits, state


def build(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(cfg)
