#!/usr/bin/env python3
"""Run the smoke's deploy phase alone on one NVIDIA GPU, from the
repository root:

    python3 scripts/deploy_probe.py [kernels]

It builds the four CUDA kernels, runs ``chip_smoke.kernel_phase`` when
given ``kernels`` (each kernel against its plain version), then
``chip_smoke.deploy_phase``: full-width phi3 cut to 2 layers trained
through the train launcher with checkpoints, crashed and restarted,
cold-started from the checkpoint into bit planes and packed integers,
autotuned under a byte budget and served through the scheduler, the
kernels against their plain versions; and ``chip_smoke.check_deploy``.
The phase writes its checkpoints under ``chiprun_out/deploy_ckpt`` and
removes them; its record goes to ``chiprun_out/deploy_probe.json`` and
its summary to stdout, with the card's name and power limit.
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        cs.log("deploy_probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "build_s": time.perf_counter() - t0}
    if "kernels" in argv:
        out["kernel_phase"] = cs.kernel_phase()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    path = ROOT / "chiprun_out" / "deploy_probe.json"
    try:
        res = out["deploy_phase"] = cs.deploy_phase()
    finally:
        path.write_text(json.dumps(out, indent=1, default=str))
    cs.check_deploy(res)
    print(json.dumps({"deploy": dict(cs.deploy_summary(res), card=card)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
