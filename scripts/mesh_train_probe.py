#!/usr/bin/env python3
"""Run the smoke's mesh train phase alone on one NVIDIA GPU, from the
repository root:

    python3 scripts/mesh_train_probe.py [tiny] [full]

It builds the four CUDA kernels and runs ``chip_smoke.mesh_train_phase``:
phi3-mini-3.8b (2 layers, f32, fake quantization, PACT off) trained by
the single process, then by two gloo ranks on the one card on (2, 1)
through a crash and a restart and, after an elastic restore, on (1, 2);
the step-6 checkpoint cold-started and served on (1, 2) through the
kernels on each rank's shards (``check_mesh_train``, which also requires
a planted fault to fail).  ``tiny`` runs it at the tiny config (9x8
blocks), ``full`` at full width (both, in that order, by default).  The
record goes to ``chiprun_out/mesh_train_probe.json`` and the summary to
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
        cs.log("mesh_train_probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "torch": torch.__version__,
           "build_s": time.perf_counter() - t0}
    path = ROOT / "chiprun_out" / "mesh_train_probe.json"
    path.parent.mkdir(exist_ok=True)
    sizes = [a for a in sys.argv[1:] if a in ("tiny", "full")] or \
        ["tiny", "full"]
    for size in sizes:
        res = cs.mesh_train_phase(("--tiny",) if size == "tiny"
                                  else ("--no-tiny",))
        out[size] = res
        path.write_text(json.dumps(out, indent=1, default=str))
        # the (2, 1) granite and ResNet legs' figures, before the check
        print(json.dumps({size: {"split": cs.mt_split_summary(res)}}),
              flush=True)
        cs.check_mesh_train(res)
        print(json.dumps({size: cs.mesh_train_summary(res)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
