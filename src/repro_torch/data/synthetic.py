"""Deterministic, index-addressable synthetic data (port of
``repro.data.synthetic``: the LM stream and the CIFAR-like stream).

Every global batch is a pure function of (seed, step), so any process can
regenerate any batch without coordination and a restart at step N needs
no replay.  The LM stream has planted bigram structure (a peaked random
successor table), so cross-entropy decreases under training; the
CIFAR-like stream plants class templates plus noise for the paper's CNN
experiments.

The successor table and the class templates come from
``numpy.random.default_rng`` (seeded ``seed`` and ``seed + 1``), as the
reference's do, and equal them bit for bit.  The per-batch draws (the
walk's start tokens and successor choices; the image labels and noise;
a vlm batch's vision embeddings and an encoder-decoder batch's frames)
are drawn by ``jax.random`` in the reference, which torch cannot
reproduce: here they come from a ``torch.Generator`` seeded from (seed,
step), so the port's batches follow the same law but are not the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


def batch_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of batch ``step``: seeded from (seed, step)
    through ``numpy.random.SeedSequence``."""
    key = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(key[0]) << 32 | int(key[1]))


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 4          # candidate successors per token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.succ = rng.integers(0, self.vocab,
                                 size=(self.vocab, self.branching))

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of step: (tokens, labels) int32 host tensors with
        labels = next token."""
        gen = batch_generator(self.seed, step)
        start = torch.randint(0, self.vocab, (self.batch,), generator=gen)
        choices = torch.randint(0, self.branching,
                                (self.batch, self.seq_len + 1),
                                generator=gen)
        succ = torch.from_numpy(self.succ)
        seq = torch.empty((self.batch, self.seq_len + 1), dtype=torch.int64)
        tok = start
        for t in range(self.seq_len + 1):
            tok = succ[tok, choices[:, t]]
            seq[:, t] = tok
        return {"tokens": seq[:, :-1].to(torch.int32),
                "labels": seq[:, 1:].to(torch.int32)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class SyntheticCIFAR:
    num_classes: int = 10
    image: int = 32
    batch: int = 128
    seed: int = 0
    noise: float = 0.6

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 1)
        self.templates = rng.normal(
            size=(self.num_classes, self.image, self.image, 3)).astype("f4")

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of step: NHWC f32 ``images`` (the labels' class
        templates plus ``noise`` x normal) and int32 ``labels``, host
        tensors."""
        gen = batch_generator(self.seed, step)
        labels = torch.randint(0, self.num_classes, (self.batch,),
                               generator=gen)
        base = torch.from_numpy(self.templates)[labels]
        noise = torch.randn(base.shape, generator=gen) * self.noise
        return {"images": base + noise, "labels": labels.to(torch.int32)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def lm_batch_for(cfg, cell, step: int = 0, seed: int = 0):
    """Concrete batch for a cell's ``seq_len`` and ``global_batch``, the
    shapes of ``ModelAPI.train_batch_spec``: the bigram stream's tokens
    and labels; a vlm batch's cut to ``seq_len - vision_tokens`` beside
    f32 ``vision_embeds`` (B, vision_tokens, d_model); an encoder-decoder
    batch's beside f32 ``frames`` (B, seq_len, d_model).  Both are 0.1 x
    standard normal drawn by the generator of (seed + 7, step) and (seed
    + 9, step): the reference's law, not its ``jax.random`` draws."""
    b = SyntheticLM(cfg.vocab, cell.seq_len, cell.global_batch,
                    seed).batch_at(step)
    if cfg.family == "vlm":
        st = cell.seq_len - cfg.vision_tokens
        gen = batch_generator(seed + 7, step)
        b = {"tokens": b["tokens"][:, :st], "labels": b["labels"][:, :st],
             "vision_embeds": torch.randn(
                 (cell.global_batch, cfg.vision_tokens, cfg.d_model),
                 generator=gen) * 0.1}
    if cfg.is_encdec:
        gen = batch_generator(seed + 9, step)
        b = {"tokens": b["tokens"], "labels": b["labels"],
             "frames": torch.randn(
                 (cell.global_batch, cell.seq_len, cfg.d_model),
                 generator=gen) * 0.1}
    return b


def make_lm_pipeline(cfg, seq_len: int, batch: int, seed: int = 0,
                     start_step: int = 0):
    """Resumable iterator of (step, batch); a restart at ``start_step``
    continues the same sequence."""
    gen = SyntheticLM(cfg.vocab, seq_len, batch, seed)
    step = start_step
    while True:
        yield step, gen.batch_at(step)
        step += 1
