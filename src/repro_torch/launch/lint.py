"""Serving-graph lint CLI: ``python -m repro_torch.launch.lint --arch <id>
--backend <b>`` (port of ``repro.launch.lint``).

Builds the engine ``launch.serve`` would (tiny config, fake-quant QAT
from seed 0, deployed serving weights in the backend's native layout),
then runs every pass of :func:`repro_torch.analysis.lint_engine` —
contract validation, the graph lint of prefill, decode and chunk, the
scheduler ledger smoke and the call-signature census — and prints the
report (``--json`` for the JSON text).  Exit code 1 iff the report
carries errors.

The reference's flags, with the port's backend names (``kernel`` for the
reference's ``pallas``) and ``--device`` (default ``cuda``; ``--device
cpu`` lints on the host, where each kernel wrapper runs its plain
version behind the same boundary).  Where the reference's lint executes
nothing, this one executes each entry point once on a scratch decode
state.  ``--no-tiny`` keeps the registered config's weight-block
geometry (8x128), as the serve launcher does.  With ``--mesh`` /
``--production-mesh`` (``--multi-pod``) the sharding lint runs against a
deviceless mesh stand-in.  ``main(argv, params=None)`` returns the exit
code; ``params`` lints a caller's deployed tree instead of the seeded
one.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, List, Optional


def build_engine(arch: str, backend: str, deploy_bits: int = 0,
                 layout: str = "", kv_bits: int = 32, page_size: int = 0,
                 prefill_chunk: int = 0, tiny: bool = True,
                 autotune_budget_bytes: int = 0,
                 speculate_planes: int = 0,
                 attn_backend: str = "gather", device: Any = None,
                 params: Any = None):
    """The serving stack as ``launch.serve`` assembles it, on ``device``
    (the card unless named).  ``params`` replaces the seeded init and
    deploy with a caller's deployed tree.

    ``autotune_budget_bytes`` runs the (weight-only) greedy budget search
    over the deployed tree before building the engine, so the AT1
    contract can be linted against a genuinely autotuned assignment."""
    from ..configs import REGISTRY, QuantConfig
    from ..models.api import build
    from ..serve.deploy import (default_deploy_bits, default_deploy_layout,
                                to_serving_params)
    from ..serve.engine import ServeEngine
    cfg = REGISTRY[arch]
    if tiny:
        cfg = cfg.tiny(dtype="float32").with_quant(
            QuantConfig(mode="fake", n_bits=8, act_bits=8))
    else:
        cfg = cfg.with_quant(dataclasses.replace(
            cfg.quant, mode="fake", n_bits=8, act_bits=8))
    api = build(cfg)
    if params is None:
        params = api.init(seed=0, device=device)
        deploy_bits = default_deploy_bits(backend, deploy_bits)
        if deploy_bits:
            params = to_serving_params(
                params, deploy_bits,
                layout=layout or default_deploy_layout(backend),
                device=device)
    if autotune_budget_bytes:
        from ..serve.autotune import greedy_allocate, sensitivity_tree
        params = greedy_allocate(params, sensitivity_tree(params),
                                 autotune_budget_bytes).params
    return ServeEngine(api, params, kv_quant_bits=kv_bits, backend=backend,
                       attn_backend=attn_backend, page_size=page_size,
                       prefill_chunk=prefill_chunk,
                       speculate_planes=speculate_planes, device=device)


def build_parser() -> argparse.ArgumentParser:
    from ..configs import REGISTRY
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.lint")
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "kernel", "ref", "bitplane"])
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="device to lint on (cuda raises without a card)")
    ap.add_argument("--deploy-bits", type=int, default=0,
                    choices=[0, 4, 8],
                    help="0 = backend default (int8 for packed backends)")
    ap.add_argument("--layout", default="",
                    choices=["", "packed", "bitplane"],
                    help="serving wire format (default: backend's native)")
    ap.add_argument("--kv-bits", type=int, default=32, choices=[4, 8, 32])
    ap.add_argument("--attn-backend", default="gather",
                    choices=["gather", "fused", "ref"],
                    help="decode-attention read side (fused = the "
                         "paged_attention kernel)")
    ap.add_argument("--page-size", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--budget", type=int, default=8,
                    help="call-signature budget (footprint pass)")
    ap.add_argument("--mesh", default="",
                    help="lint sharding against 'AXIS=N,...' sizes, e.g. "
                         "'data=2,model=4' (deviceless stand-in)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="lint sharding against the 16x16 production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: the 2x16x16 pod mesh")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--max-info", type=int, default=None,
                    help="truncate info findings in text output")
    ap.add_argument("--autotune-budget-bytes", type=int, default=0,
                    help="run the greedy budget search before linting and "
                         "check the AT1 contract against that budget")
    ap.add_argument("--speculate-planes", type=int, default=0,
                    help="build the top-k draft tree and check the AT2 "
                         "contract against the deployed tree")
    ap.add_argument("--ckpt", default="",
                    help="additionally validate a checkpoint directory's "
                         "shard manifests (CK1-CK3 contracts)")
    return ap


def main(argv: Optional[List[str]] = None, params: Any = None) -> int:
    from ..analysis import (ShapeOnlyMesh, lint_engine, production_mesh_shape,
                            validate_checkpoint)
    args = build_parser().parse_args(argv)
    engine = build_engine(args.arch, args.backend, args.deploy_bits,
                          args.layout, args.kv_bits, args.page_size,
                          args.prefill_chunk, args.tiny,
                          autotune_budget_bytes=args.autotune_budget_bytes,
                          speculate_planes=args.speculate_planes,
                          attn_backend=args.attn_backend,
                          device=args.device, params=params)
    mesh = None
    if args.production_mesh:
        mesh = ShapeOnlyMesh(production_mesh_shape(args.multi_pod))
    elif args.mesh:
        mesh = ShapeOnlyMesh({
            kv.split("=")[0].strip(): int(kv.split("=")[1])
            for kv in args.mesh.split(",")})
    report = lint_engine(engine, prompt_len=args.prompt_len,
                         n_slots=args.n_slots, max_new=args.max_new,
                         budget=args.budget, mesh=mesh,
                         autotune_budget_bytes=(args.autotune_budget_bytes
                                                or None))
    if args.ckpt:
        report.extend(validate_checkpoint(args.ckpt))
    if args.as_json:
        print(report.to_json())
    else:
        print(report.format(max_info=args.max_info))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
