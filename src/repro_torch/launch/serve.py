"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(port of ``repro.launch.serve``).

Initializes a model from a seed, converts it to packed or bit-plane
integer serving weights (BWQ deployment), and decodes either as one
static batch (default) or as staggered requests through the
continuous-batching scheduler (``--requests``).  ``--kv-bits {4,8}``
selects the quantized-at-rest KV cache; ``--temperature``/``--top-k``
enable sampling.  Everything runs on ``--device`` (default ``cuda``; the
launcher raises without a card unless given ``--device cpu``).

Scheduler knobs (``--requests``): ``--page-size`` pages the KV cache,
``--prefill-chunk`` inserts prompts in chunks, ``--priority`` assigns
cycling per-request priority classes, ``--overcommit`` admits past pool
capacity (parking victims to host memory when growth runs dry),
``--prefix-cache`` shares identical prompt-prefix pages by content hash,
``--shared-prefix N`` makes the first N prompt tokens a common system
prompt, ``--speculate-planes``/``--draft-gamma`` run speculative ticks on
a bit-plane tree, and ``--stats-out`` dumps the scheduler's cache,
preemption and prefix stats with its contract findings as JSON.

Beyond the reference's flags: ``--device``; ``--act-bits`` and
``--dtype`` (activation quantization and compute dtype; the reference
fixes 8 and the config's); ``--prompt-lens``, ``--max-news`` and
``--shared-every`` (per-request prompt widths, budgets and prefix
sharers, each cycled over the requests); ``--validate-every`` (contract
checks during the run).  ``--no-tiny`` keeps the registered config's
weight-block geometry (8x128 for every registered dense and MoE config);
the tiny config takes the reference launcher's (9x8).  An MoE
architecture serves through the dispatch ``models.moe.GROUPED_IMPL``
selects (exact ``ragged`` unless a caller sets ``capacity``).  Prompts
come from ``numpy.random.default_rng(seed)``.  An encoder-decoder
architecture (``seamless-m4t-large-v2``) also gives each request frames
(1, ``--prompt-len``, d_model), 0.1 x standard normal from the same
generator: every request shares one encoder length, as the reference's
launcher gives them, while ``--prompt-lens`` still varies the tokens.  A
vlm architecture (``qwen2-vl-2b``) gives each request its stub vision
prefix, ``vision_embeds`` (1, vision_tokens, d_model), 0.1 x standard
normal from a ``torch.Generator`` seeded with ``--seed``.  The ssm
architecture (``rwkv6-1.6b``) has no KV cache: ``--page-size`` and
``--kv-bits`` are ignored for it with a warning.  ``--lint`` runs the
serving-graph lint (:func:`repro_torch.analysis.lint_engine`) on the
built engine before serving — on a scratch decode state, so the served
state is untouched — prints its report and aborts on errors.

``main(argv, params=None, record_ticks=False)`` returns what it served
(engine, scheduler, requests, results), the tree it deployed
(``deployed``, before any autotune), the cold start's ``stats``, the
autotune's ``allocation`` (with its stage seconds in
``autotune_timings``) and, with ``--lint``, the ``lint`` report; ``params`` replaces the seeded init with a
caller's deployed tree, and ``record_ticks`` has the scheduler keep its
per-tick log.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _ints(text: str) -> List[int]:
    return [int(v) for v in text.split(",") if v.strip() != ""]


def build_parser() -> argparse.ArgumentParser:
    from ..configs import REGISTRY
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda raises without a card)")
    ap.add_argument("--dtype", default="",
                    help="compute dtype ('' = the config's: float32 tiny, "
                         "the registered dtype otherwise)")
    ap.add_argument("--act-bits", type=int, default=8,
                    help="PACT activation bits (32 = unquantized)")
    ap.add_argument("--deploy-bits", type=int, default=0,
                    choices=[0, 4, 8], help="0 = QAT weights")
    ap.add_argument("--kv-bits", type=int, default=32, choices=[4, 8, 32],
                    help="quantized-at-rest KV cache precision")
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "kernel", "ref", "bitplane"],
                    help="matmul execution backend for deployed weights "
                         "(non-dense implies --deploy-bits 8 unless set; "
                         "bitplane deploys the plane-sliced layout)")
    ap.add_argument("--attn-backend", default="gather",
                    choices=["gather", "fused", "ref"],
                    help="decode-attention read side: gather materializes "
                         "the contiguous KV view per step; fused runs the "
                         "paged_attention kernel over the stored "
                         "(quantized) cache; ref is its plain version")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts (requests with --requests)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated prompt widths cycled over the "
                         "requests (--requests only; overrides "
                         "--prompt-len)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-news", default="",
                    help="comma-separated token budgets cycled over the "
                         "requests (--requests only; overrides --max-new)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="prompt seed and base sampling seed (each request "
                         "adds its uid)")
    ap.add_argument("--requests", action="store_true",
                    help="feed the batch as staggered requests through the "
                         "continuous-batching scheduler")
    ap.add_argument("--n-slots", type=int, default=0,
                    help="decode slots for --requests (0 = batch size)")
    ap.add_argument("--arrival-gap", type=int, default=2,
                    help="ticks between request arrivals in --requests mode")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per page (0 = contiguous "
                         "fixed-width slots); --requests mode only")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page-pool capacity (0 = worst case + trash page)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="insert prompts in chunks this wide, interleaved "
                         "with decode (0 = monolithic prefill)")
    ap.add_argument("--priority", default="",
                    help="comma-separated priority classes cycled over the "
                         "batch, e.g. '0,1' alternates low/high ('' = all "
                         "equal); higher admits first, parks last")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="admit worst-case page reservations up to this "
                         "multiple of pool capacity; > 1 preempts (parks "
                         "to host memory) lowest-priority victims when "
                         "decode growth exhausts the free list")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed prompt-prefix page sharing: "
                         "identical full prompt pages are held once, "
                         "refcounted, across concurrent requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="make the first N prompt tokens identical across "
                         "the batch (a shared system prompt) to exercise "
                         "--prefix-cache")
    ap.add_argument("--shared-every", type=int, default=1,
                    help="with --shared-prefix: only requests whose uid is "
                         "a multiple of this share the prefix")
    ap.add_argument("--stats-out", default="",
                    help="write the scheduler stats JSON (cache report + "
                         "preemption / prefix-hit counters) to this file")
    ap.add_argument("--lint", action="store_true",
                    help="run the serving-graph lint before serving "
                         "and abort if it reports errors")
    ap.add_argument("--validate-every", type=int, default=0,
                    help="check the scheduler contracts every N ticks and "
                         "at the end; any finding aborts (0 = off)")
    ap.add_argument("--speculate-planes", type=int, default=0,
                    help="self-speculative decoding: draft with only the "
                         "top-k live planes of each block (0 = off)")
    ap.add_argument("--draft-gamma", type=int, default=4,
                    help="draft tokens proposed per speculative round")
    ap.add_argument("--autotune-budget-bytes", type=int, default=0,
                    help="search per-block bit-widths under this "
                         "weight-stream-bytes budget before serving "
                         "(bitplane layout only; 0 = off)")
    ap.add_argument("--ckpt", default="",
                    help="cold-start from a checkpoint directory (a "
                         "CheckpointManager dir or a single step_N dir): "
                         "weights stream leaf by leaf straight into the "
                         "serving wire format, never materializing the "
                         "dense tree")
    ap.add_argument("--ckpt-step", type=int, default=-1,
                    help="with --ckpt on a manager dir: the step to load "
                         "(-1 = latest)")
    return ap


def resolve_ckpt_dir(path: str, step: int = -1) -> str:
    """Resolve ``--ckpt`` to a checkpoint directory: the path itself (it
    holds a META) or a ``step_<N>`` child of a CheckpointManager
    directory (``step`` -1 picks the latest)."""
    import os
    if os.path.exists(os.path.join(path, "META")):
        return path
    if step < 0:
        from ..ckpt.checkpoint import CheckpointManager
        latest = CheckpointManager(path).latest_step()
        if latest is None:
            raise SystemExit(f"--ckpt {path}: no step_N checkpoints found")
        step = latest
    out = os.path.join(path, f"step_{step}")
    if not os.path.exists(os.path.join(out, "META")):
        raise SystemExit(f"--ckpt: {out} is not a checkpoint directory")
    return out


def _config(args):
    from ..configs import REGISTRY, QuantConfig
    cfg = REGISTRY[args.arch]
    if args.tiny:
        cfg = cfg.tiny(dtype="float32").with_quant(
            QuantConfig(mode="fake", n_bits=8, act_bits=args.act_bits))
    else:
        cfg = cfg.with_quant(dataclasses.replace(
            cfg.quant, mode="fake", n_bits=8, act_bits=args.act_bits))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    return cfg


def _prompts(cfg, args) -> List[Dict[str, np.ndarray]]:
    """One request's inputs (``--batch`` of them) from
    ``numpy.random.default_rng(seed)``: (1, P_i) int32 tokens, with
    ``--shared-prefix N`` the sharers' first N tokens request 0's; for an
    encoder-decoder config also (1, ``--prompt-len``, d_model) f32
    frames, drawn after every prompt's tokens; for a vlm config
    (1, vision_tokens, d_model) f32 ``vision_embeds`` from a CPU
    ``torch.Generator`` seeded with ``--seed``."""
    widths = _ints(args.prompt_lens) or [args.prompt_len]
    rng = np.random.default_rng(args.seed)
    toks = [rng.integers(0, cfg.vocab, (1, widths[i % len(widths)]))
            .astype(np.int32) for i in range(args.batch)]
    n = args.shared_prefix
    if n:
        if toks[0].shape[1] < n:
            raise SystemExit(f"--shared-prefix {n} is longer than request "
                             f"0's prompt ({toks[0].shape[1]})")
        for i in range(0, args.batch, max(args.shared_every, 1)):
            if toks[i].shape[1] >= n:
                toks[i][:, :n] = toks[0][:, :n]
    inputs = [{"tokens": t} for t in toks]
    if cfg.is_encdec:
        for x in inputs:
            x["frames"] = (rng.standard_normal(
                (1, args.prompt_len, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(args.seed)
        for x in inputs:
            x["vision_embeds"] = (torch.randn(
                (1, cfg.vision_tokens, cfg.d_model), generator=gen) *
                0.1).numpy()
    return inputs


def main(argv: Optional[List[str]] = None, params: Any = None,
         record_ticks: bool = False) -> Dict[str, Any]:
    from ..models.api import build
    from ..serve import Request, SamplingParams
    from ..serve.deploy import (default_deploy_bits, default_deploy_layout,
                                to_serving_params)
    from ..serve.engine import ServeEngine
    args = build_parser().parse_args(argv)
    if not args.requests and (args.prompt_lens or args.max_news):
        raise SystemExit("--prompt-lens / --max-news need --requests")

    cfg = _config(args)
    api = build(cfg)
    stats: Dict[str, Any] = {}
    if params is None:
        args.deploy_bits = default_deploy_bits(args.backend,
                                               args.deploy_bits)
        layout = default_deploy_layout(args.backend)
        if args.ckpt:
            path = resolve_ckpt_dir(args.ckpt, args.ckpt_step)
            params = to_serving_params(path, args.deploy_bits or 8,
                                       layout=layout, device=args.device,
                                       template=api.abstract_params(),
                                       stats=stats)
            print(f"cold-start: {path} -> {layout} "
                  f"int{args.deploy_bits or 8} serving weights "
                  f"(peak {stats['peak_host_bytes']} B host vs "
                  f"{stats['dense_tree_bytes']} B dense tree)")
        else:
            params = api.init(seed=0, device=args.device)
            if args.deploy_bits:
                params = to_serving_params(params, args.deploy_bits,
                                           layout=layout, device=args.device)
                print(f"deployed: {layout} int{args.deploy_bits} "
                      f"serving weights")
    deployed = params
    prompts = _prompts(cfg, args)

    alloc, timings = None, {}
    if args.autotune_budget_bytes:
        from ..serve.autotune import autotune_params
        from ..serve.deploy import weight_stream_bytes
        if len({x["tokens"].shape[1] for x in prompts}) > 1:
            raise SystemExit("--autotune-budget-bytes calibrates on the "
                             "prompt batch: give every request one width")
        batch = {k: np.concatenate([x[k] for x in prompts], axis=0)
                 for k in prompts[0]}
        before = weight_stream_bytes(params)
        alloc = autotune_params(api, params, args.autotune_budget_bytes,
                                batch=batch, timings=timings)
        params = alloc.params
        print(f"autotuned: {before} -> {alloc.total_bytes} B/step under a "
              f"{alloc.budget_bytes} B budget "
              f"({alloc.steps_taken}/{alloc.steps_available} plane "
              f"increments kept); gate {alloc.gate}")

    eng = ServeEngine(api, params, kv_quant_bits=args.kv_bits,
                      backend=args.backend, attn_backend=args.attn_backend,
                      page_size=args.page_size,
                      n_pages=args.n_pages or None,
                      prefill_chunk=args.prefill_chunk,
                      overcommit=args.overcommit,
                      prefix_cache=args.prefix_cache,
                      speculate_planes=args.speculate_planes,
                      draft_gamma=args.draft_gamma, device=args.device)
    served = dict(deployed=deployed, stats=stats, allocation=alloc,
                  autotune_timings=timings)

    if args.lint:
        from ..analysis import lint_engine
        report = lint_engine(
            eng, prompt_len=args.prompt_len,
            n_slots=args.n_slots or args.batch, max_new=args.max_new,
            autotune_budget_bytes=args.autotune_budget_bytes or None)
        print(report.format(max_info=0))
        if not report.ok:
            raise SystemExit("serving-graph lint failed; aborting launch")
        served["lint"] = report

    if args.requests:
        prios = _ints(args.priority) or [0]
        budgets = _ints(args.max_news) or [args.max_new]
        reqs = [Request(uid=i, inputs=prompts[i],
                        sampling=SamplingParams(
                            max_new_tokens=budgets[i % len(budgets)],
                            temperature=args.temperature,
                            top_k=args.top_k, eos_id=args.eos_id,
                            seed=args.seed + i,
                            priority=prios[i % len(prios)]),
                        arrival=i * args.arrival_gap)
                for i in range(args.batch)]
        sched = eng.make_scheduler(reqs, n_slots=args.n_slots or args.batch,
                                   record_ticks=record_ticks)
        results = sched.run(reqs, validate_every=args.validate_every)
        for r in results:
            print(f"[{r.uid}] arrived@{reqs[r.uid].arrival} "
                  f"admitted@{r.admitted_tick} done@{r.finished_tick} "
                  f"({r.finish_reason}): {r.tokens}")
        if args.page_size or args.stats_out:
            stats = sched.cache_report()
            print(json.dumps(stats))
            if args.stats_out:
                findings = sched.validate()
                stats["contract_findings"] = [f.format() for f in findings]
                with open(args.stats_out, "w") as f:
                    json.dump(stats, f, indent=2)
        if args.speculate_planes:
            print(f"speculative: {sched.spec_stats}")
        return dict(served, engine=eng, scheduler=sched, requests=reqs,
                    results=results)

    batch = {k: np.concatenate([x[k] for x in prompts], axis=0)
             for k in prompts[0]}
    gen = None
    if args.temperature > 0:
        gen = torch.Generator(device=eng.device).manual_seed(args.seed)
    out = eng.generate(batch, max_new=args.max_new,
                       greedy=args.temperature <= 0, generator=gen,
                       temperature=args.temperature, top_k=args.top_k)
    for i, row in enumerate(out.tolist()):
        print(f"[{i}] {row}")
    return dict(served, engine=eng, tokens=out)


if __name__ == "__main__":
    main()
