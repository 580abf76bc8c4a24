"""Serving engine: prefill / decode / generate over the ModelAPI (port of
the one-shot and slot-insertion surface of ``repro.serve.engine``).

``kv_quant_bits`` of 8 or 4 rebuilds the model config so the KV cache
stores int8 / nibble-packed int4 entries plus per-token scales; each
written position is rounded once.  ``backend`` selects how deployed
matmuls execute (``dense`` | ``kernel`` | ``bitplane`` | ``ref``;
``kernel`` is the counterpart of the reference's ``pallas``) and
``attn_backend`` how decode attention reads the cache (``gather`` |
``fused`` | ``ref``).  Both are passed explicitly into every model call.

``speculate_planes=k`` turns greedy ``generate`` into self-speculative
decoding: a draft tree reads the same bit-plane payload through masks
truncated to each block's top-k planes, proposes ``draft_gamma`` tokens a
round, and one full-precision verify forward accepts the longest matching
prefix (``serve/autotune/speculative.py``).  The tokens are those of
non-speculative greedy decoding.

The engine runs on ``device``: the CUDA card unless the caller names
another; it raises when no card is present and the caller did not ask for
the CPU.  At construction it moves the params there and casts plain float
leaves to the compute dtype once, so no step repeats that cast.

Not ported yet: mesh placement, the scheduler (``serve``) and its
speculative path, park/restore and construction-time contract validation.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.api import ModelAPI
from ..models.attention import PAGED_ATTN_BACKENDS
from ..models.common import MATMUL_BACKENDS, prepare_params
from ..models.transformer import _cdtype
from ..core.device import resolve_device
from .autotune.speculative import greedy_verify, make_draft_params
from .deploy import ServingWeight, tree_leaves, tree_to
from .sampling import SamplingParams, sample_token


def _roundup64(n: int) -> int:
    # decode headroom rounded up, so cache widths match the reference's
    return -(-n // 64) * 64


@dataclasses.dataclass
class ServeEngine:
    api: ModelAPI
    params: Any
    kv_quant_bits: int = 32       # 8 / 4 select the quantized-at-rest cache
    backend: str = "dense"        # 'dense'|'kernel'|'bitplane'|'ref' matmul
    attn_backend: str = "gather"  # 'gather' | 'fused' | 'ref' decode attn
    device: Any = None            # None = the CUDA card
    speculate_planes: int = 0     # >0: self-speculative decode, top-k draft
    draft_gamma: int = 4          # draft tokens proposed per round

    def __post_init__(self):
        if self.backend not in MATMUL_BACKENDS:
            raise ValueError(f"backend must be one of {MATMUL_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.attn_backend not in PAGED_ATTN_BACKENDS:
            raise ValueError(
                f"attn_backend must be one of {PAGED_ATTN_BACKENDS}, "
                f"got {self.attn_backend!r}")
        self.device = resolve_device(self.device)
        cfg = self.api.cfg
        if self.kv_quant_bits < 32:
            if self.kv_quant_bits not in (4, 8):
                raise ValueError(f"kv_quant_bits must be 4, 8 or >=32, "
                                 f"got {self.kv_quant_bits}")
            cfg = dataclasses.replace(cfg, kv_cache_bits=self.kv_quant_bits)
            self.api = ModelAPI(cfg)
        if self.backend == "bitplane":
            n_packed = sum(isinstance(leaf, ServingWeight)
                           for leaf in tree_leaves(self.params))
            if n_packed:
                warnings.warn(
                    f"backend='bitplane' executes only the plane-sliced "
                    f"layout; {n_packed} packed ServingWeight leaves fall "
                    f"back to the dense dequant matmul (deploy with "
                    f"layout='bitplane')", stacklevel=2)
        self.params = prepare_params(tree_to(self.params, self.device),
                                     _cdtype(cfg))
        self.draft_params = None
        # one entry per speculative round of the last speculative_generate:
        # gamma (drafts, or 0 for a plain decode step), drafted,
        # accepted_drafts and emitted token counts over the batch
        self.round_log: List[Dict[str, int]] = []
        if self.speculate_planes:
            if self.draft_gamma < 1:
                raise ValueError(f"draft_gamma must be >= 1, "
                                 f"got {self.draft_gamma}")
            # a view: payload tensors shared, only the masks are new
            self.draft_params = make_draft_params(self.params,
                                                  self.speculate_planes)

    @property
    def _be(self) -> Dict[str, str]:
        return {"backend": self.backend, "attn_backend": self.attn_backend}

    def _inputs(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # ---- core ops ---------------------------------------------------------
    def prefill(self, batch: Dict[str, Any], extra_slots: int = 0) -> tuple:
        """Whole-prompt forward; returns (last-token logits, decode
        state)."""
        return self.api.prefill(self.params, self._inputs(batch),
                                extra_slots=extra_slots, **self._be)

    def prefill_at(self, batch: Dict[str, Any], state: Any,
                   slot: int) -> tuple:
        """Insert a prompt into batch row ``slot`` of a live decode state."""
        return self.api.prefill_at(self.params, self._inputs(batch), state,
                                   slot, **self._be)

    def prefill_chunk_at(self, batch: Dict[str, Any], state: Any, slot: int,
                         start: int) -> tuple:
        """Insert a prompt chunk at cache position ``start`` of row
        ``slot``; returns (full (1, W, V) chunk logits, state)."""
        return self.api.prefill_chunk_at(self.params, self._inputs(batch),
                                         state, slot, start, **self._be)

    def init_decode_state(self, example: Dict[str, Any], n_slots: int,
                          max_len: int, page_size: int = 0,
                          n_pages: Optional[int] = None) -> Any:
        """Empty (zeroed) decode state, paged when ``page_size > 0``."""
        return self.api.init_decode_state(self.params, self._inputs(example),
                                          n_slots, max_len,
                                          page_size=page_size,
                                          n_pages=n_pages)

    def set_tables(self, state: Any, tables) -> Any:
        """Copy host-side block tables ((n_slots, nb) int32) into every
        paged KV sub-dict of ``state`` (broadcast over the stack dim), in
        place."""
        tables = torch.as_tensor(np.asarray(tables, np.int32))

        def walk(cache):
            if "table" in cache:
                cache["table"].copy_(tables.expand_as(cache["table"]))
            else:
                for v in cache.values():
                    if isinstance(v, dict):
                        walk(v)
        walk(state["cache"])
        return state

    def decode(self, tokens: torch.Tensor, state: Any, index) -> tuple:
        """One decode step; ``index`` is the shared fill level (int or 0-d)
        or a per-slot (B,) vector."""
        return self.api.decode_step(self.params, tokens.to(self.device),
                                    state, index, **self._be)

    def draft_decode(self, tokens: torch.Tensor, state: Any, index) -> tuple:
        """One decode step with the truncated-mask draft tree.  Its K/V
        writes are transient: the verify pass rewrites every drafted
        position at full precision before it is read below the accepted
        fill level."""
        if self.draft_params is None:
            raise ValueError("engine built without speculate_planes")
        return self.api.decode_step(self.draft_params,
                                    tokens.to(self.device), state, index,
                                    **self._be)

    def verify(self, tokens: torch.Tensor, state: Any, index) -> tuple:
        """Batched W-token verify forward with the full deployed tree.

        ``tokens`` (B, W): each slot's last accepted token followed by its
        draft proposals; returns ((B, W, V) logits, state) with all W
        positions (re)written at full precision."""
        if self.draft_params is None:
            raise ValueError("engine built without speculate_planes")
        return self.api.verify_step(self.params, tokens.to(self.device),
                                    state, index, **self._be)

    # ---- one-shot API (static batch) ------------------------------------
    def generate(self, batch: Dict[str, Any], max_new: int = 16,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
        """batch: {"tokens": (B, P)}.  Returns (B, max_new) int32 tokens.

        ``greedy`` (or no ``generator``) takes the per-step argmax;
        otherwise tokens are drawn at ``temperature`` over the ``top_k``
        best logits with ``generator`` (on the engine's device).  With
        ``speculate_planes`` set, greedy decoding runs the draft/verify
        protocol (:meth:`speculative_generate`): the same tokens, fewer
        full-precision passes."""
        if self.speculate_planes and (greedy or generator is None):
            return self.speculative_generate(batch, max_new)[0]
        logits, state = self.prefill(batch, extra_slots=_roundup64(max_new))
        sp = SamplingParams(temperature=temperature, top_k=top_k)

        def pick(logits):
            if greedy or generator is None:
                return torch.argmax(logits, -1)[:, None].to(torch.int32)
            return sample_token(logits, sp, generator)[:, None]

        outs: List[torch.Tensor] = []
        tok = pick(logits)            # first token sampled like the rest
        outs.append(tok[:, 0])
        index = int(batch["tokens"].shape[1])
        for _ in range(max_new - 1):  # max_new-1 steps, like the scheduler
            logits, state = self.decode(tok, state, index)
            tok = pick(logits)
            outs.append(tok[:, 0])
            index += 1
        return torch.stack(outs, dim=1)

    def speculative_generate(self, batch: Dict[str, Any], max_new: int = 16,
                             keep_logits: bool = False) -> tuple:
        """Greedy static-batch decoding by draft/verify rounds.

        Returns the (B, max_new) int32 tokens and, with ``keep_logits``,
        the (max_new, B, V) f32 full-precision logits each emitted token
        was chosen from (else None).  Rows accept different draft counts,
        so fill levels are per-row (B,) vectors; a row that reaches
        ``max_new`` stops taking tokens (its index freezes and later writes
        land in masked headroom).  Fills :attr:`round_log`."""
        if self.draft_params is None:
            raise ValueError("engine built without speculate_planes")
        gamma = self.draft_gamma
        logits, state = self.prefill(
            batch, extra_slots=_roundup64(max_new + gamma + 1))
        b, p = (int(d) for d in batch["tokens"].shape)
        first = torch.argmax(logits, -1)
        kept = None
        if keep_logits:
            kept = torch.zeros((max_new, b, logits.shape[-1]),
                               dtype=torch.float32, device=self.device)
            kept[0] = logits
        outs: List[List[int]] = [[t] for t in first.tolist()]
        counts = np.ones((b,), dtype=np.int64)
        index = np.full((b,), p, dtype=np.int64)
        self.round_log = []

        def at(idx):
            return torch.as_tensor(idx, dtype=torch.int32).to(self.device)

        tok = first[:, None].to(torch.int32)
        while int(counts.min()) < max_new:
            g = min(gamma, max_new - int(counts.min()) - 1)
            active = counts < max_new
            if g < 1:                      # last token: plain decode step
                logits, state = self.decode(tok, state, at(index))
                vlogits = logits[:, None]
                accepted = [np.asarray([t]) for t in
                            torch.argmax(logits, -1).tolist()]
                n_draft = np.zeros((b,), dtype=np.int64)
            else:
                cur, drafts = tok, []
                for j in range(g):
                    lg, state = self.draft_decode(cur, state, at(index + j))
                    cur = torch.argmax(lg, -1)[:, None].to(torch.int32)
                    drafts.append(cur)
                vtoks = torch.cat([tok] + drafts, dim=1)       # (B, g+1)
                vlogits, state = self.verify(vtoks, state, at(index))
                accepted, n_draft = greedy_verify(
                    vtoks[:, 1:].cpu().numpy(),
                    torch.argmax(vlogits, -1).cpu().numpy())
            rec = dict(gamma=g, drafted=0, accepted_drafts=0, emitted=0)
            for r in range(b):
                take = min(len(accepted[r]), max_new - int(counts[r]))
                if kept is not None and take:
                    kept[counts[r]:counts[r] + take, r] = vlogits[r, :take]
                outs[r].extend(int(t) for t in accepted[r][:take])
                rec["drafted"] += g * int(active[r])
                rec["accepted_drafts"] += min(int(n_draft[r]), take)
                rec["emitted"] += take
                counts[r] += take
                index[r] += take
            self.round_log.append(rec)
            tok = torch.tensor([[o[-1]] for o in outs], dtype=torch.int32,
                               device=self.device)
        tokens = torch.tensor([o[:max_new] for o in outs], dtype=torch.int32,
                              device=self.device)
        return tokens, kept
