#!/usr/bin/env python3
"""Run the smoke's dry run phase alone on one NVIDIA GPU, with the phases
it reads, from the repository root:

    python3 scripts/dryrun_probe.py

It builds the four CUDA kernels and runs ``chip_smoke.train_phase``, the
mesh phase (two gloo ranks on the card; each records one phi3 (1, 2)
decode step's collectives), the mesh train phase (with its (2, 1)
granite-moe and ResNet-20 legs and their planted faults) and
``chip_smoke.dryrun_phase``: the meta-device dry run's predicted
argument bytes and peak against the train phase's measured peak, its
recorded decode collectives against the live ranks', and the achieved
TFLOP/s of a train step.  Each phase's check runs as in the smoke.  The
record goes to ``chiprun_out/dryrun_probe.json`` and the summaries to
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
        cs.log("dryrun_probe: no CUDA device")
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
    path = ROOT / "chiprun_out" / "dryrun_probe.json"
    path.parent.mkdir(exist_ok=True)
    detail = out["detail"] = {}
    for name, phase, check in (
            ("train_phase", cs.train_phase, None),
            ("mesh_phase", cs.mesh_phase, cs.check_mesh),
            ("mesh_train_phase", cs.mesh_train_phase, cs.check_mesh_train)):
        t = time.perf_counter()
        detail[name] = phase()
        out[f"{name}_s"] = time.perf_counter() - t
        path.write_text(json.dumps(out, indent=1, default=str))
        if check:
            check(detail[name])
    print(json.dumps({"mesh_train_split":
                      cs.mt_split_summary(detail["mesh_train_phase"])}))
    dr = detail["dryrun_phase"] = cs.dryrun_phase(detail)
    path.write_text(json.dumps(out, indent=1, default=str))
    cs.check_dryrun(dr)
    print(json.dumps({"dryrun": cs.dryrun_summary(dr)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
