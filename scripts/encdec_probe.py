#!/usr/bin/env python3
"""Run the smoke's enc-dec phase alone on one NVIDIA GPU, from the
repository root:

    python3 scripts/encdec_probe.py

It builds the four CUDA kernels, runs ``chip_smoke.kernel_phase`` (each
kernel against its plain version, ``paged_attention`` at the enc-dec
decoder's head among them), then ``chip_smoke.encdec_phase``:
seamless-m4t-large-v2 served at full width and depth (24 + 24 layers)
through the kernels against the plain versions, one decode step profiled
and split by kernel, ``packed_matmul`` at the family's new shapes,
``paged_attention`` at its head and the scheduler drive, and
``chip_smoke.check_encdec``.  The phase's record goes to
``chiprun_out/encdec_probe.json`` and its summary to stdout, with the
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
        cs.log("encdec_probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "build_s": time.perf_counter() - t0}
    out["kernel_phase"] = cs.kernel_phase()
    res = out["encdec_phase"] = cs.encdec_phase()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "encdec_probe.json").write_text(
        json.dumps(out, indent=1, default=str))
    cs.check_encdec(res)
    print(json.dumps({"encdec": dict(cs.encdec_summary(res), card=card)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
