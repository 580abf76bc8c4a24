#!/usr/bin/env python3
"""Run the smoke's train families phase alone on one NVIDIA GPU, from the
repository root:

    python3 scripts/train_families_probe.py [ARCH ...]

It builds the four CUDA kernels, then runs ``chip_smoke.train_family``
for each named architecture of ``chip_smoke.TF_ARCHS`` (all five when
none is named): BWQ-A training at full width (bf16, fake mode, depth cut
as the smoke cuts it), the trained tree deployed and served through the
kernels against the plain versions, granite-moe's bit-plane leg and
``kernels.ops`` calls, and the card-against-host f32 step.  The record
goes to ``chiprun_out/train_families_probe.json`` and the summary to
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


def main() -> int:
    if not torch.cuda.is_available():
        cs.log("train_families_probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "build_s": time.perf_counter() - t0, "families": []}
    path = ROOT / "chiprun_out" / "train_families_probe.json"
    path.parent.mkdir(exist_ok=True)
    names = sys.argv[1:] or [a for a, _ in cs.TF_ARCHS]
    t0 = time.perf_counter()
    for arch in names:
        out["families"].append(cs.train_family(arch,
                                               dict(cs.TF_ARCHS)[arch]))
        path.write_text(json.dumps(out, indent=1, default=str))
    out["phase_s"] = time.perf_counter() - t0
    path.write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({"train_families": dict(
        cs.train_families_summary(out), card=card)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
