"""Request-level serving types: sampling parameters, requests, results
(port of ``repro.serve.sampling``).

The serving surface is request-oriented: callers submit :class:`Request`
objects carrying their own prompt tensors and :class:`SamplingParams`;
the scheduler streams them through a fixed-capacity decode batch and
hands back a :class:`GenerationResult` per request.

Sampled draws cannot reproduce the reference's ``jax.random`` ones.  The
scheduler keeps its property that a request's draw depends only on (its
seed, the token's index), never on which other slots are live: each
sampled token is drawn on the host copy of its logits row with the CPU
generator :func:`token_generator` returns for that pair.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls.

    ``temperature <= 0`` is greedy argmax (deterministic); ``top_k > 0``
    restricts sampling to the k highest-probability tokens.  ``eos_id``
    retires the request early ('stop'); otherwise it runs to
    ``max_new_tokens`` ('length').  ``seed`` keys the request's sampled
    draws.  ``priority`` orders scheduler admission and preemption: higher
    values admit first and are parked last when an overcommitted page pool
    runs dry (ties break by arrival tick, then submission order)."""
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    seed: int = 0
    priority: int = 0


@dataclasses.dataclass
class Request:
    """One generation request.

    ``inputs`` holds single-request prompt tensors with a leading batch dim
    of 1 (``tokens`` (1, P)).  ``arrival`` is the scheduler tick at which
    the request becomes visible."""
    uid: int
    inputs: Dict[str, Any]
    sampling: SamplingParams = SamplingParams()
    arrival: int = 0


@dataclasses.dataclass
class GenerationResult:
    uid: int
    tokens: List[int]
    finish_reason: str             # 'length' | 'stop'
    prompt_len: int
    admitted_tick: int             # tick the prompt entered the batch
    finished_tick: int


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep EXACTLY the k best logits (-inf elsewhere).  A ``l < kth``
    threshold would keep every logit tied with the k-th value; the stable
    double argsort ranks ties by token id instead."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return torch.where(rank < k, logits,
                       torch.full_like(logits, float("-inf")))


def token_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator that draws token ``index`` of a request seeded
    ``seed``: a fixed function of the pair (numpy's ``SeedSequence``), so
    the draw is the same whatever else runs in the batch, on any device."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                    int(index)]).generate_state(2)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31 | int(state[1])) & (2 ** 63 - 1))


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
