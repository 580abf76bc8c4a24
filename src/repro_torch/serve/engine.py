"""Serving engine: prefill / decode / generate over the ModelAPI (port of
the one-shot and slot-insertion surface of ``repro.serve.engine``).

``kv_quant_bits`` of 8 or 4 rebuilds the model config so the KV cache
stores int8 / nibble-packed int4 entries plus per-token scales; each
written position is rounded once.  ``backend`` selects how deployed
matmuls execute (``dense`` | ``kernel`` | ``ref``; ``kernel`` is the
counterpart of the reference's ``pallas``) and ``attn_backend`` how decode
attention reads the cache (``gather`` | ``fused`` | ``ref``).  Both are
passed explicitly into every model call.

The engine runs on ``device``: the CUDA card unless the caller names
another; it raises when no card is present and the caller did not ask for
the CPU.  At construction it moves the params there and casts plain float
leaves to the compute dtype once, so no step repeats that cast.

Not ported yet: mesh placement, the scheduler (``serve``), speculative
decoding, park/restore and construction-time contract validation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.api import ModelAPI
from ..models.attention import PAGED_ATTN_BACKENDS
from ..models.common import MATMUL_BACKENDS, prepare_params
from ..models.transformer import _cdtype
from ..core.device import resolve_device
from .deploy import tree_to
from .sampling import SamplingParams, sample_token


def _roundup64(n: int) -> int:
    # decode headroom rounded up, so cache widths match the reference's
    return -(-n // 64) * 64


@dataclasses.dataclass
class ServeEngine:
    api: ModelAPI
    params: Any
    kv_quant_bits: int = 32       # 8 / 4 select the quantized-at-rest cache
    backend: str = "dense"        # 'dense' | 'kernel' | 'ref' matmul exec
    attn_backend: str = "gather"  # 'gather' | 'fused' | 'ref' decode attn
    device: Any = None            # None = the CUDA card

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
        self.params = prepare_params(tree_to(self.params, self.device),
                                     _cdtype(cfg))

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

    # ---- one-shot API (static batch) ------------------------------------
    def generate(self, batch: Dict[str, Any], max_new: int = 16,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
        """batch: {"tokens": (B, P)}.  Returns (B, max_new) int32 tokens.

        ``greedy`` (or no ``generator``) takes the per-step argmax;
        otherwise tokens are drawn at ``temperature`` over the ``top_k``
        best logits with ``generator`` (on the engine's device)."""
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
