#!/usr/bin/env python3
"""Run the smoke's MoE phase alone on one NVIDIA GPU, from the repository
root:

    python3 scripts/moe_probe.py

It builds the four CUDA kernels, runs ``chip_smoke.kernel_phase`` (each
kernel against its plain version), then ``chip_smoke.moe_phase``: the
MoE family served at full width (granite-moe-3b-a800m, 32 layers;
llama4-scout-17b-a16e cut to 2 layers) through the kernels against the
plain versions, the capacity dispatch, the grouped product's time and
row independence, ``packed_matmul`` at the expert shapes and the
scheduler drive, and ``chip_smoke.check_moe``.  The phase's record goes
to ``chiprun_out/moe_probe.json`` and its summary to stdout, with the
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
        cs.log("moe_probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "build_s": time.perf_counter() - t0}
    out["kernel_phase"] = cs.kernel_phase()
    res = out["moe_phase"] = cs.moe_phase()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "moe_probe.json").write_text(
        json.dumps(out, indent=1, default=str))
    cs.check_moe(res)
    print(json.dumps({"moe": dict(cs.moe_summary(res), card=card)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
