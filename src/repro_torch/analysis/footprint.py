"""Call-shape footprint: enumerate every (entry point, token-block shape)
signature a serving workload reaches, statically (port of
``repro.analysis.footprint``).

The reference counts XLA compiles: one program per distinct input
signature.  The port runs eagerly, so a *signature* here is one distinct
call shape of an engine entry point: one entry of the kernels' launch
plans (``kernels/*.py::_args`` builds and keeps one launch-argument block,
and its split-K scratch, a shape), and one graph to capture once decode
and chunk steps are replayed as CUDA graphs.  The scheduler was designed
so steady-state serving reaches O(1) of them (decode is always
``(n_slots, 1)``; chunked prefill pads the final chunk to the chunk
width), but the monolithic insertion paths reach one a distinct prompt
width.  This pass mirrors the scheduler's shape decisions
(:meth:`Scheduler._plan_chunks`, the lazy-init broadcast, ``generate``'s
64-rounded headroom) as pure arithmetic, so a blowup is a lint failure
with a census.

``chunk_widths`` must stay in lockstep with ``Scheduler._plan_chunks`` —
tests/test_torch_footprint.py cross-checks them chunk for chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .report import Finding


@dataclasses.dataclass(frozen=True)
class CompileSig:
    """One distinct call signature: entry point + token-block shape."""
    fn: str                    # 'prefill' | 'prefill_at' | 'chunk' | 'decode'
    shape: Tuple[int, ...]     # token block (B, W)
    static: Tuple = ()         # static args of the call (extra_slots)

    def format(self) -> str:
        s = f" static={self.static}" if self.static else ""
        return f"{self.fn}{list(self.shape)}{s}"


def _roundup64(n: int) -> int:
    return -(-n // 64) * 64


def chunk_widths(p: int, chunk: int, total_len: int,
                 vision_tokens: int = 0,
                 family: str = "decoder") -> List[Tuple[int, int]]:
    """(width, start) of every insertion chunk for a ``p``-token prompt.

    Pure mirror of ``Scheduler._plan_chunks``: recurrent-state families
    (ssm/hybrid) and prompts at most one chunk wide insert monolithic; the
    final chunk of a longer prompt is padded to the chunk width, clamped
    to the slot's remaining cache extent."""
    tv = vision_tokens
    if chunk <= 0 or p <= chunk or family in ("ssm", "hybrid"):
        return [(p, 0)]
    out = []
    n_c = -(-p // chunk)
    for c in range(n_c):
        lo, hi = c * chunk, min((c + 1) * chunk, p)
        w = hi - lo
        if c == n_c - 1 and w < chunk:
            w = min(chunk, total_len - (tv + lo))
        out.append((w, 0 if c == 0 else tv + lo))
    return out


def serve_signatures(prompt_widths: Sequence[int], max_new: int,
                     n_slots: int, max_len: Optional[int] = None,
                     page_size: int = 0, prefill_chunk: int = 0,
                     vision_tokens: int = 0,
                     family: str = "decoder") -> List[CompileSig]:
    """Distinct call signatures for a scheduler run over prompts of the
    given token widths (``prompt_widths`` excludes the vision prefix,
    mirroring ``batch['tokens'].shape[1]``)."""
    if max_len is None:
        max_len = max(p + vision_tokens + _roundup64(max_new)
                      for p in prompt_widths)
    total_len = (-(-max_len // page_size) * page_size if page_size > 0
                 else max_len)
    sigs = {CompileSig("decode", (n_slots, 1))}
    insert_path = page_size > 0 or prefill_chunk > 0
    for p in sorted(set(prompt_widths)):
        if insert_path:
            for w, _start in chunk_widths(p, prefill_chunk, total_len,
                                          vision_tokens, family):
                sigs.add(CompileSig("chunk", (1, w)))
        else:
            pw = p + vision_tokens
            # lazy-init first admission prefills at full cache width
            sigs.add(CompileSig("prefill", (1, p),
                                static=(max_len - pw,)))
            sigs.add(CompileSig("prefill_at", (1, p)))
    return sorted(sigs, key=lambda s: (s.fn, s.shape, s.static))


def generate_signatures(batch: int, prompt_width: int,
                        max_new: int) -> List[CompileSig]:
    """Signatures of the one-shot ``ServeEngine.generate`` path."""
    return [CompileSig("prefill", (batch, prompt_width),
                       static=(_roundup64(max_new),)),
            CompileSig("decode", (batch, 1))]


def footprint_findings(sigs: Sequence[CompileSig],
                       budget: int = 8) -> List[Finding]:
    """Lint the signature census against a budget (the reference's rule
    ids and text: ``census``, ``recompile-blowup``)."""
    by_fn: Dict[str, int] = {}
    for s in sigs:
        by_fn[s.fn] = by_fn.get(s.fn, 0) + 1
    census = ", ".join(s.format() for s in sigs)
    findings = [Finding(
        severity="info", pass_name="footprint", rule="census",
        path="scheduler",
        message=f"{len(sigs)} compile signature(s): {census}")]
    if len(sigs) > budget:
        worst = max(by_fn, key=lambda k: by_fn[k])
        findings.append(Finding(
            severity="error", pass_name="footprint", rule="recompile-blowup",
            path=f"scheduler:{worst}",
            message=f"{len(sigs)} distinct compile signatures exceed the "
                    f"budget of {budget} ({worst} alone compiles "
                    f"{by_fn[worst]} programs); chunk prefill "
                    f"(prefill_chunk>0) or bucket prompt widths"))
    return findings


def scheduler_footprint(sched: Any,
                        prompt_widths: Optional[Sequence[int]] = None
                        ) -> List[CompileSig]:
    """Signature census for a live :class:`~repro_torch.serve.scheduler.
    Scheduler`.

    ``prompt_widths`` defaults to the widths of everything submitted
    (waiting, parked included, + live slots)."""
    if prompt_widths is None:
        from ..serve.scheduler import _entry_req
        reqs = [_entry_req(e) for e in sched.waiting] + \
            [s.req for s in sched.slots if s is not None]
        prompt_widths = [r.inputs["tokens"].shape[1] for r in reqs]
        if not prompt_widths:
            prompt_widths = [sched.max_len - 64 if sched.max_len > 64
                             else sched.max_len // 2 or 1]
    cfg = sched.engine.api.cfg
    tv = cfg.vision_tokens if cfg.family == "vlm" else 0
    max_new = max((s.req.sampling.max_new_tokens
                   for s in sched.slots if s is not None), default=16)
    return serve_signatures(
        prompt_widths, max_new, sched.n_slots, max_len=sched.max_len,
        page_size=sched.page_size, prefill_chunk=sched.prefill_chunk,
        vision_tokens=tv, family=cfg.family)
