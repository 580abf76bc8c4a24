#!/usr/bin/env python3
"""Run the smoke's CNN phase alone on one NVIDIA GPU, from the repository
root:

    python3 scripts/cnn_probe.py [kernels]

It builds the four CUDA kernels, runs ``chip_smoke.kernel_phase`` when
given ``kernels`` (each kernel against its plain version), then
``chip_smoke.cnn_phase``: ResNet-20 and VGG-16-BN trained through the
CIFAR launcher at 9x8 blocks, deployed packed and as bit planes and run on
B=128 images through ``packed_matmul`` and ``bitplane_matmul`` against the
plain versions, each conv shape timed, one f32 step on the card against
the host, the simulator's figures; and ``chip_smoke.check_cnn``.  The
phase's record goes to ``chiprun_out/cnn_probe.json`` and its summary to
stdout, with the card's name and power limit.
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
        cs.log("cnn_probe: no CUDA device")
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
    path = ROOT / "chiprun_out" / "cnn_probe.json"
    try:
        res = out["cnn_phase"] = cs.cnn_phase()
    finally:
        path.write_text(json.dumps(out, indent=1, default=str))
    cs.check_cnn(res)
    print(json.dumps({"cnn": dict(cs.cnn_summary(res), card=card)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
