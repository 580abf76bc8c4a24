"""Static analysis of the serving stack (port of ``repro.analysis``):
contract, graph and compile-footprint lint, rolled into one
:class:`~repro_torch.analysis.report.LintReport`.

* :mod:`~repro_torch.analysis.contracts` — schema checks of deployed
  ``ServingWeight`` / ``BitplaneServingWeight`` leaves, checkpoints,
  autotuned and draft trees, paged decode caches and the scheduler's
  ledger (rules SW*/BP*/CK*/AT*/PC*/PA*/PX*).
* :mod:`~repro_torch.analysis.graph_lint` — taint tracking over the ops
  the prefill / decode / chunk entry points dispatch: dequant
  materialization, payload convert / transpose, the KV read side, and
  the in-place decode state.  Where the reference traces jaxprs and
  executes nothing, the port executes each entry point once, under an op
  recorder, on a scratch decode state built at lint sizes; the engine's
  live state is never touched.
* :mod:`~repro_torch.analysis.sharding_lint` — replayed spec derivation
  with every ``fit_spec`` drop and pad surfaced, deviceless production
  meshes included.
* :mod:`~repro_torch.analysis.footprint` — static census of the call
  signatures the scheduler's shape decisions reach.

:func:`lint_engine` is the one-call entry point (the CLI ``python -m
repro_torch.launch.lint`` and the serve launcher's ``--lint`` wrap it);
the passes are importable on their own.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .contracts import (validate_allocation, validate_checkpoint,
                        validate_decode_state, validate_draft_truncation,
                        validate_scheduler, validate_serving_tree)
from .footprint import (CompileSig, chunk_widths, footprint_findings,
                        generate_signatures, scheduler_footprint,
                        serve_signatures)
from .graph_lint import (check_decode_donation, deployed_leaves,
                         fallback_leaf_paths, lint_traced_fn)
from .report import Finding, LintReport
from .sharding_lint import (ShapeOnlyMesh, lint_sharding,
                            production_mesh_shape)

__all__ = [
    "CompileSig", "Finding", "LintReport", "ShapeOnlyMesh",
    "check_decode_donation", "chunk_widths", "deployed_leaves",
    "example_batch", "fallback_leaf_paths", "footprint_findings",
    "generate_signatures", "lint_engine", "lint_sharding",
    "lint_traced_fn", "production_mesh_shape", "scheduler_footprint",
    "serve_signatures", "validate_allocation", "validate_checkpoint",
    "validate_decode_state", "validate_draft_truncation",
    "validate_scheduler", "validate_serving_tree",
]


def example_batch(cfg, batch_size: int, prompt_len: int,
                  device=None) -> Dict[str, Any]:
    """A zero prompt batch for ``cfg``'s family on ``device`` — the
    lint-side mirror of ``launch.serve._prompts`` (the reference's is
    abstract; the port's recorder executes, so it is concrete)."""
    batch = {"tokens": torch.zeros((batch_size, prompt_len),
                                   dtype=torch.int32, device=device)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (batch_size, cfg.vision_tokens, cfg.d_model),
            dtype=torch.float32, device=device)
    if cfg.is_encdec:
        batch["frames"] = torch.zeros((batch_size, prompt_len, cfg.d_model),
                                      dtype=torch.float32, device=device)
    return batch


def _roundup64(n: int) -> int:
    return -(-n // 64) * 64


def lint_engine(engine, prompt_len: int = 16, n_slots: int = 4,
                max_new: int = 16, budget: int = 8,
                mesh=None, prompt_widths: Optional[Sequence[int]] = None,
                autotune_budget_bytes: Optional[int] = None) -> LintReport:
    """Run every analysis pass against ``engine``.

    The graph lint executes prefill, decode and chunk once each, and the
    donation check one more decode, on a zero prompt and a scratch decode
    state (``n_slots`` slots, ``prompt_len`` + 64-rounded ``max_new``
    wide, the engine's paging); ``report.calls`` records each of these
    calls' kernel-boundary ops and launch counts.  ``prompt_widths`` widens the
    footprint census beyond the single ``prompt_len``;
    ``autotune_budget_bytes`` asserts the AT1 budget contract against the
    engine's deployed tree.  ``mesh`` (a process mesh or a
    :class:`ShapeOnlyMesh`), or the mesh an engine was placed on, adds the
    sharding lint of the engine's params, the example prompt and the
    decode state against that mesh; a placed engine's params are linted
    at their padded global shapes, as the reference lints its placed
    arrays, and its entry points run under its mesh on every rank."""
    cfg = engine.api.cfg
    dev = engine.device
    report = LintReport(context={
        "arch": cfg.name, "family": cfg.family, "backend": engine.backend,
        "attn_backend": engine.attn_backend,
        "kv_quant_bits": engine.kv_quant_bits,
        "page_size": engine.page_size,
        "prefill_chunk": engine.prefill_chunk,
        "speculate_planes": engine.speculate_planes,
    })
    calls = report.calls
    be = {"backend": engine.backend, "attn_backend": engine.attn_backend}

    # -- contracts ---------------------------------------------------------
    # (a placed engine's shards are checked as the whole leaves they form)
    report.extend(validate_serving_tree(engine.whole_params()))

    # A bitplane engine that would silently dense-fall-back is an ERROR
    # under preflight (the engine itself only warns at construction):
    # each offending leaf is named so the deploy call can be fixed.
    if engine.backend == "bitplane":
        for p in fallback_leaf_paths(engine.params, engine.backend):
            report.add("error", "contracts", "bitplane-dense-fallback", p,
                       "packed ServingWeight under backend='bitplane' "
                       "executes as a dense dequant matmul — deploy with "
                       "to_serving_params(..., layout='bitplane')")

    # -- autotune / speculative contracts (AT1-AT2) ------------------------
    if autotune_budget_bytes is not None:
        report.extend(validate_allocation(engine.params,
                                          autotune_budget_bytes))
    if engine.speculate_planes and engine.draft_params is not None:
        report.extend(validate_draft_truncation(engine.draft_params,
                                                engine.params))

    # -- graph lint --------------------------------------------------------
    batch = example_batch(cfg, 1, prompt_len, dev)
    extra = _roundup64(max_new)
    run = engine._run
    report.extend(lint_traced_fn(
        lambda p, b: run(engine.api.prefill, p, b, extra_slots=extra, **be),
        (engine.params, batch), fn_name="prefill", calls=calls, **be))

    page_size = 0 if cfg.family == "ssm" else engine.page_size
    max_len = prompt_len + \
        (cfg.vision_tokens if cfg.family == "vlm" else 0) + extra
    try:
        state = engine.init_decode_state(batch, n_slots, max_len,
                                         page_size=page_size,
                                         n_pages=engine.n_pages)
    except Exception as e:
        report.add("error", "graph", "state-shape", "init_decode_state",
                   f"could not build the decode-state tree "
                   f"({type(e).__name__}: {e})")
        state = None
    if state is not None:
        report.extend(validate_decode_state(state, n_slots=n_slots))
        tokens = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        index = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        # the engine's step: under a mesh, this rank's rows of the tokens
        # and of the state (a contiguous state holds only those)
        report.extend(lint_traced_fn(
            lambda p, t, s, i: engine._step(engine.api.decode_step, p, t,
                                            s, i),
            (engine.params, tokens, state, index), fn_name="decode",
            calls=calls, **be))
        if engine.prefill_chunk > 0 and cfg.family not in ("ssm", "hybrid"):
            cb = {"tokens": torch.zeros((1, engine.prefill_chunk),
                                        dtype=torch.int32, device=dev)}
            report.extend(lint_traced_fn(
                lambda p, b, s, slot, start: run(
                    engine.api.prefill_chunk_at, p, b, s, slot, start,
                    **be),
                (engine.params, cb, state, 0, 0), fn_name="chunk",
                calls=calls, **be))
        report.extend(check_decode_donation(engine, tokens, state, index,
                                            calls=calls))

    # -- scheduler ledger (PX1-PX3) ----------------------------------------
    # Build a real Scheduler (host-side ledgers only — it allocates no
    # device state before its first admission) and stage a synthetic
    # admission: one slot owning pages with one page registered in the
    # refcounted prefix cache.  validate_scheduler must come back clean,
    # proving the allocator / cache / block-table accounting closes
    # before any workload runs.
    if page_size:
        import numpy as np
        from ..serve.sampling import Request as _Req
        from ..serve.sampling import SamplingParams as _SP
        from ..serve.scheduler import Scheduler, _Slot
        shareable = cfg.family in ("dense", "moe")
        sched = Scheduler(engine, n_slots=n_slots, max_len=max_len,
                          page_size=page_size, n_pages=engine.n_pages,
                          overcommit=2.0, prefix_cache=shareable)
        req = _Req(uid=0,
                   inputs={"tokens": np.zeros((1, page_size + 1), np.int32)},
                   sampling=_SP(max_new_tokens=4, priority=1))
        owned = sched.allocator.alloc(2)
        slot = _Slot(req=req, index=page_size + 1, last_tok=0, generated=[],
                     admitted_tick=0, pages=list(owned), reserve_left=0)
        if sched.prefix_cache is not None:
            sched.prefix_cache.register(b"lint-smoke", slot.pages.pop(0))
            slot.shared_pages.append(owned[0])
            slot.prefix_hashes.append(b"lint-smoke")
        sched.slots[0] = slot
        sched.tables[0, :slot.n_blocks] = slot.block_pages
        report.extend(validate_scheduler(sched))
        report.add("info", "contracts", "PX-smoke", "scheduler",
                   f"ledger smoke ran: {len(owned)} pages, prefix cache "
                   f"{'on' if sched.prefix_cache is not None else 'off'}, "
                   f"overcommit {sched.overcommit}")

    # -- call-signature footprint ------------------------------------------
    sigs = serve_signatures(
        list(prompt_widths or [prompt_len]), max_new, n_slots,
        max_len=max_len, page_size=page_size,
        prefill_chunk=engine.prefill_chunk,
        vision_tokens=cfg.vision_tokens if cfg.family == "vlm" else 0,
        family=cfg.family)
    report.extend(footprint_findings(sigs, budget=budget))

    # -- sharding ----------------------------------------------------------
    mesh = mesh if mesh is not None else getattr(engine, "mesh", None)
    if mesh is not None:
        params, shard_state = engine.params, state
        if getattr(engine, "global_params", None) is not None:
            # a placed engine: its global (padded) shapes and a global
            # decode state on the meta device
            params = engine.global_params
            meta_batch = example_batch(cfg, 1, prompt_len, "meta")
            shard_state = engine.global_api.init_decode_state(
                None, meta_batch, n_slots, max_len, page_size=page_size,
                n_pages=engine.n_pages)
        report.extend(lint_sharding(params, mesh, batch=batch,
                                    state=shard_state, n_slots=n_slots))
    return report
