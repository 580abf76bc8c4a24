#!/usr/bin/env python3
"""Run the smoke's families phase alone on one NVIDIA GPU, from the
repository root:

    python3 scripts/families_probe.py [kernels]

It builds the four CUDA kernels; with ``kernels`` it first runs
``chip_smoke.kernel_phase`` (each kernel against its plain version,
``paged_attention`` at the families' heads and the two weight matmuls at
their new shapes and at whole-layer blocks of 3072 rows among them).
Then ``chip_smoke.families_phase``: qwen2-vl-2b, rwkv6-1.6b and
zamba2-1.2b served at full width and depth through the kernels against
the plain versions, one decode step each profiled, the scheduler drives,
``packed_matmul`` at the families' new shapes and ``paged_attention`` at
their heads, and ``chip_smoke.check_families``.  The record goes to
``chiprun_out/families_probe.json`` and the summary to stdout, with the
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
        cs.log("families_probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "build_s": time.perf_counter() - t0}
    path = ROOT / "chiprun_out" / "families_probe.json"
    path.parent.mkdir(exist_ok=True)
    if "kernels" in sys.argv[1:]:
        t0 = time.perf_counter()
        out["kernel_phase"] = cs.kernel_phase()
        out["kernel_phase_s"] = time.perf_counter() - t0
        path.write_text(json.dumps(out, indent=1, default=str))
        cs.log(f"kernel phase ok in {out['kernel_phase_s']:.1f} s")
    res = out["families_phase"] = cs.families_phase()
    path.write_text(json.dumps(out, indent=1, default=str))
    cs.check_families(res)
    print(json.dumps({"families": dict(cs.families_summary(res),
                                       card=card)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
