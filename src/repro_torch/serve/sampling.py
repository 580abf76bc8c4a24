"""Sampling parameters and token selection (port of the part of
``repro.serve.sampling`` the engine uses)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decode controls: ``temperature <= 0`` is greedy argmax; ``top_k > 0``
    restricts sampling to the k best logits.  (The reference's request
    fields — eos_id, seed, priority — arrive with the scheduler.)"""
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep EXACTLY the k best logits (-inf elsewhere).  A ``l < kth``
    threshold would keep every logit tied with the k-th value; the stable
    double argsort ranks ties by token id instead."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return torch.where(rank < k, logits,
                       torch.full_like(logits, float("-inf")))


def sample_token(logits: torch.Tensor, sp: SamplingParams,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Token(s) from (V,) or batched (..., V) logits under ``sp`` (greedy
    when temperature <= 0 or no generator).  The draw uses ``generator``,
    which must live on the logits' device; it does not reproduce the
    reference's ``jax.random`` draws."""
    if sp.temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = logits.to(torch.float32) / sp.temperature
    if 0 < sp.top_k < l.shape[-1]:
        l = top_k_mask(l, sp.top_k)
    probs = torch.softmax(l, dim=-1).reshape(-1, l.shape[-1])
    tok = torch.multinomial(probs, 1, generator=generator)
    return tok.reshape(l.shape[:-1]).to(torch.int32)
