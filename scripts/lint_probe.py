#!/usr/bin/env python3
"""Run the smoke's serving-graph lint alone on one NVIDIA GPU, from the
repository root:

    python3 scripts/lint_probe.py [drive] [moe]

It builds the four CUDA kernels, deploys full-width phi3-mini-3.8b
(32 layers, seed 0) packed int8 and int4 and as mixed-width bit planes,
as the smoke does, and runs ``chip_smoke.lint_phase``: ``lint_engine`` on
ten engines over those trees (each must pass with the reference's rules,
each recorded call's kernel ops equal to its launches), the four planted
faults and the lint launcher.  ``drive`` adds a short scheduler drive
through the serve launcher with ``--lint`` (4 requests; the lint's
launches zeroed before the drive's); ``moe`` lints granite-moe-3b-a800m
at ``chip_smoke.MOE_DEPTH`` layers.  The record goes to
``chiprun_out/lint_probe.json`` and the summary to stdout, with the
card's name and power limit.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        cs.log("lint_probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import REGISTRY
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "torch": torch.__version__,
           "build_s": time.perf_counter() - t0}
    path = ROOT / "chiprun_out" / "lint_probe.json"
    path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    qat = build(REGISTRY[cs.ARCH]).init(seed=0, device=cs.DEV)
    deployed = {b: to_serving_params(qat, b, device=cs.DEV) for b in (8, 4)}
    bp, _ = cs.deploy_bitplane(qat)
    del qat
    torch.cuda.empty_cache()
    out["deploy_s"] = time.perf_counter() - t0
    out["lint_phase"] = lp = cs.lint_phase(deployed, bp)
    path.write_text(json.dumps(out, indent=1, default=str))
    if "drive" in sys.argv[1:]:
        argv = ["--arch", cs.ARCH, "--no-tiny", "--device", cs.DEV,
                "--requests", "--backend", "kernel", "--attn-backend",
                "fused", "--kv-bits", "8", "--page-size", str(cs.PAGE),
                "--prefill-chunk", str(cs.SCHED_CHUNK), "--batch", "4",
                "--prompt-lens", "300,64", "--max-new", "8", "--lint"]
        with cs.TickCapture(aliased=False) as cap:
            drive = cs.launch(argv)
        rec = cs.drive_record(drive, "packed_matmul")
        out["drive"] = {"lint": drive["lint"], "launches": drive["launches"],
                        "ticks": rec["ticks"],
                        "captured": cap.case is not None,
                        "matmul_calls": rec["matmul_calls"]}
        assert drive["lint"]["rules"] == sorted(cs.LINT_RULES["paged"])
        del drive
    del deployed, bp
    torch.cuda.empty_cache()
    if "moe" in sys.argv[1:]:
        cfg = cs.served_config(cs.MOE_ARCH, 8, "bfloat16",
                               n_layers=cs.MOE_DEPTH)
        tree = to_serving_params(build(cfg).init(seed=0, device=cs.DEV), 8,
                                 device=cs.DEV)
        out["moe"] = cs.lint_case(f"{cs.MOE_ARCH} int8 kv8 paged", cfg, tree,
                                  "moe")
    path.write_text(json.dumps(out, indent=1, default=str))
    out["lint_phase_s"] = lp["phase_s"]
    print(json.dumps({"lint": {
        "phase_s": lp["phase_s"],
        "engines": {r["label"]: r["s"] for r in lp["cases"]},
        "faults": {k: r["s"] for k, r in lp["faults"].items()},
        "launcher_s": lp["launcher"]["s"],
        "drive": out.get("drive", {}).get("lint", {}).get("s"),
        "moe": out.get("moe", {}).get("s")}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
