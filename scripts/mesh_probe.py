#!/usr/bin/env python3
"""Run the smoke's mesh phase alone on one NVIDIA GPU, from the
repository root:

    python3 scripts/mesh_probe.py [tiny] [full]

It builds the four CUDA kernels and runs ``chip_smoke.mesh_phase``: two
gloo ranks on the one card serve phi3-mini-3.8b (packed, bit planes and
speculative; packed also on (2, 1)), granite-moe-3b-a800m, qwen2-vl-2b,
rwkv6-1.6b, zamba2-1.2b and seamless-m4t-large-v2 under the mesh (1, 2),
and rwkv6 and zamba2 also under (2, 1), against the single-process engine
(``check_mesh``, which also requires a planted sharding fault to fail).
``tiny`` runs it at the tiny configs (9x8 blocks, whose shards start
inside a weight block), ``full`` at full width cut to
``chip_smoke.MESH_DEPTH`` / ``MESH_MOE_DEPTH`` / ``MESH_FAMILY_DEPTH``
layers (both, in that order, by default).  The record goes to
``chiprun_out/mesh_probe.json`` and the summary to stdout, with the
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
        cs.log("mesh_probe: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kbuild.build()
    out = {"card": card, "torch": torch.__version__,
           "build_s": time.perf_counter() - t0}
    path = ROOT / "chiprun_out" / "mesh_probe.json"
    path.parent.mkdir(exist_ok=True)
    sizes = [a for a in sys.argv[1:] if a in ("tiny", "full")] or \
        ["tiny", "full"]
    for size in sizes:
        res = cs.mesh_phase(("--tiny",) if size == "tiny"
                            else ("--no-tiny",))
        out[size] = res
        path.write_text(json.dumps(out, indent=1, default=str))
        cs.check_mesh(res)
        print(json.dumps({size: cs.mesh_summary(res)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
