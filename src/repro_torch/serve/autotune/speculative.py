"""Self-speculative decoding via bit-plane truncation (port of
``repro.serve.autotune.speculative``).

Truncating every block's mask LUT to its top-k live planes
(:func:`repro_torch.kernels.ops.truncate_mask_topk`) gives a coarser read
of the *same* deployed payload: the draft tree shares the planes, sign
and scale tensors of the deployed tree, and only the masks are new.

Protocol per round (greedy): draft γ tokens with the truncated tree, one
decode step each, writing draft K/V at ``index .. index+γ-1``; one
batched verify forward with the full tree over ``[last_tok, d_1 .. d_γ]``
at the same offsets, which overwrites every drafted K/V entry at full
precision; accept the longest prefix of drafts that match the verify
argmax, plus one correction (or bonus) token.  Every cache position below
the accepted fill level was last written by a verify pass, so greedy
speculative decoding gives the tokens of non-speculative decoding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np

from ...kernels.ops import truncate_mask_topk
from ..deploy import BitplaneServingWeight, tree_map


def make_draft_params(params: Any, k: int) -> Any:
    """Truncated-mask view of a deployed tree: the free draft model.

    Payload tensors are the deployed tree's own (no copy); only the mask
    LUTs are recomputed.  Raises if the tree has no bit-plane leaf."""
    if k < 1:
        raise ValueError(f"speculate_planes must be >= 1, got {k}")
    n_bp = 0

    def conv(x):
        nonlocal n_bp
        if isinstance(x, BitplaneServingWeight):
            n_bp += 1
            return dataclasses.replace(x, mask=truncate_mask_topk(x.mask, k))
        return x
    out = tree_map(conv, params)
    if n_bp == 0:
        raise ValueError(
            "speculative decoding needs a plane-sliced tree (no "
            "BitplaneServingWeight leaves found); deploy with "
            "layout='bitplane'")
    return out


def greedy_verify(draft_tokens: np.ndarray, verify_logits: np.ndarray
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Host-side greedy acceptance for one speculative round.

    ``draft_tokens`` (B, γ) int; ``verify_logits`` (B, γ+1, V) from the
    full-mask verify forward, or their argmax (B, γ+1).  Per row: accept
    drafts while they match the verify argmax, then append the correction
    (first mismatch) or bonus (all matched) token.  Returns the per-row
    accepted token arrays (each of length 1..γ+1) and the per-row count of
    accepted *draft* tokens."""
    draft = np.asarray(draft_tokens)
    v = np.asarray(verify_logits)
    ref = np.argmax(v, axis=-1) if v.ndim == 3 else v    # (B, γ+1)
    b, gamma = draft.shape
    accepted: List[np.ndarray] = []
    n_draft = np.zeros((b,), dtype=np.int64)
    for r in range(b):
        toks = []
        for j in range(gamma):
            toks.append(int(ref[r, j]))    # the draft itself or the correction
            if int(draft[r, j]) != int(ref[r, j]):
                break
        else:
            toks.append(int(ref[r, gamma]))       # bonus
        n_draft[r] = len(toks) - 1       # last token is correction/bonus
        accepted.append(np.asarray(toks, dtype=np.int64))
    return accepted, n_draft
