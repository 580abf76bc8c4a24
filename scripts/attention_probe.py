#!/usr/bin/env python3
"""Check, time and sweep the split-KV decode attention kernel
(``paged_attention``) on one NVIDIA GPU, run from the repository root:

    python3 scripts/attention_probe.py [check] [time] [sweep] [variants]
                                       [baseline:DIR]

* ``check`` — builds the four CUDA kernels (printing ``nvcc``'s register
  and shared-memory report for ``paged_attention``) and runs
  ``chip_smoke.attention_kernel_phase`` and ``chip_smoke.repeat_phase``;
* ``time`` — ``chip_smoke.time_attention`` at every row the smoke times
  (kv_len 144, 1040 and 4096, int8 and int4, contiguous; int8 paged at
  4096): both of ``chip_smoke.cuda_times``' methods, the plain version,
  SDPA and the bound;
* ``sweep`` — the plan's choices as evidence: at kv_len 144 (t = 192),
  1040 (t = 1152) and 4096 (t = 4224), int8 and int4, B=4, KV=32,
  dh=96, split counts 1 to 16, head groups 4 and 1, and warp shares of a
  sub-chunk (32 and 16 positions) forced on the wrapper, each first held
  to the plain version (PA_TOL), then timed on device (KV cold, three
  rotated sets), with the CTAs an SM holds at once;
* ``variants`` — where the time goes: the kernel rebuilt with a stage
  taken out (``-DPA_PROBE=1``: copies and waits only; ``2``: the math
  only; ``4``: no P.V; ``8``: no score dot products) or with another ring
  depth or warp count (``-DPA_STAGES``, ``-DPA_WARPS``), each timed on
  device at kv_len 4096 (int8, int4) and 144 (int8) under several plans,
  with the CTAs an SM holds at once
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
* ``baseline:DIR`` — another checkout's ``chip_smoke.time_attention`` at
  the decode fill (kv_len 144, int8 and int4), its ``paged_attention``
  built from that checkout's sources, in a process of its own: an earlier
  kernel and wrapper timed on the same card in the same call.

``check`` and ``time`` by default.  Results go to stdout (one JSON object
a line) and to ``chiprun_out/attention_probe.json``, with the card's name
and power limit.
"""
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import tiling  # noqa: E402

SWEEP = ((cs.P + cs.NEW // 2, cs.P + 64), (1040, 1152), (4096, cs.T_LONG))
VARIANT_DIR = kbuild.BUILD_DIR / "variants"
# name: (nvcc defines, [(splits, heads, chunk), ...]); the ring depth is
# read back from the defines for the plan's shared-memory figure
PLANS = [(8, 4, 64), (8, 4, 32), (1, 1, 256)]
VARIANTS = {
    "base": ({}, PLANS),
    "no_compute": ({"PA_PROBE": 1}, PLANS),
    "no_loads": ({"PA_PROBE": 2}, PLANS),
    "no_pv": ({"PA_PROBE": 4}, PLANS),
    "no_scores": ({"PA_PROBE": 8}, PLANS),
    "stages3": ({"PA_STAGES": 3}, PLANS),
    "warps16": ({"PA_WARPS": 16}, PLANS),
}


def emit(out, r):
    out.append(r)
    print(json.dumps(r), flush=True)


@contextlib.contextmanager
def forced_plan(splits, chunk, **sized):
    """The wrapper launches with ``splits`` and ``chunk`` forced (None: the
    plan's own; its cached launch arguments are dropped on the way in and
    out); ``sized``: the head group or the ring depth of a variant build."""
    mod = sys.modules["repro_torch.kernels.paged_attention"]
    saved = mod.attention_plan

    def plan(*shape):
        return tiling.attention_plan(*shape, splits=splits, chunk=chunk,
                                     **sized)

    mod.attention_plan = plan
    mod._ARGS.clear()
    try:
        yield
    finally:
        mod.attention_plan = saved
        mod._ARGS.clear()


def check(rec):
    kbuild.build()
    print(kbuild.BUILD_LOGS.get("paged_attention", "").strip(),
          file=sys.stderr)
    for r in cs.attention_kernel_phase():
        emit(rec, dict(probe="check", **r))
    for r in cs.repeat_phase():
        emit(rec, dict(probe="repeat", **r))


def timing(rec):
    for kv_len, t in cs.ATTN_TIMED:
        for bits in (8, 4):
            emit(rec, dict(probe="time", **cs.time_attention(bits, kv_len,
                                                             t)))
    emit(rec, dict(probe="time", **cs.time_attention(8, 4096, cs.T_LONG,
                                                     paged=cs.PAGE)))


def sweep(rec):
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    for kv_len, t in SWEEP:
        page = tiling.fit_block(min(128, t), t, 1)
        lens = torch.full((cs.B,), kv_len, dtype=torch.int32, device=cs.DEV)
        for bits in (8, 4):
            sets = [cs.attention_pool(bits, 32, t, page, seed=s)
                    for s in (20, 21, 22)]
            it = {"i": 0}

            def call():
                it["i"] = (it["i"] + 1) % len(sets)
                q, pool, table = sets[it["i"]]
                return paged_attention(q, *pool, table, lens)

            q, pool, table = sets[0]
            want = paged_attention_ref(q, *pool, table, lens)
            default = tiling.attention_plan(cs.B, 32, 1, 96, page, t // page,
                                            bits)
            for splits in (1, 2, 4, 8, 16):
                for heads in (4, 1):
                    for pw in (32, 16):
                        chunk = pw * tiling.ATTN_WARPS // heads
                        with forced_plan(splits, chunk, heads=heads):
                            got = paged_attention(q, *pool, table, lens)
                            torch.cuda.synchronize()
                            err = float((got - want).abs().max())
                            ms, dev, host = cs.cuda_times(call, iters=50)
                            held = resident_ctas(bits, t, page)
                        emit(rec, dict(
                            probe="sweep", kv_len=kv_len, t=t, page=page,
                            bits=bits, splits=splits, heads=heads,
                            chunk=chunk, err=err, ms=ms, device_ms=dev,
                            host_ms=host, resident_per_sm=held,
                            default=(splits, heads, chunk) == (
                                default.splits, default.heads,
                                default.chunk)))
                        if not err <= cs.PA_TOL:
                            raise AssertionError(f"forced plan {rec[-1]}")


def build_variants():
    """Each variant of ``csrc/paged_attention.cu`` built once, all nvcc at
    once."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, (defs, _) in VARIANTS.items():
        if not defs:
            continue
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS,
               *(f"-D{k}={v}" for k, v in defs.items()),
               "-o", str(VARIANT_DIR / f"libpaged_attention-{name}.so"),
               str(kbuild.CSRC / "paged_attention.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")


@contextlib.contextmanager
def variant(name):
    """The wrapper launches the kernel of variant ``name``."""
    if not VARIANTS[name][0]:
        yield
        return
    saved = kbuild._LIBS.get("paged_attention")
    kbuild._LIBS["paged_attention"] = ctypes.CDLL(
        str(VARIANT_DIR / f"libpaged_attention-{name}.so"))
    try:
        yield
    finally:
        kbuild._LIBS["paged_attention"] = saved


def variants(rec):
    from repro_torch.kernels import paged_attention
    build_variants()
    rows = ((4096, cs.T_LONG, 8), (4096, cs.T_LONG, 4),
            (cs.P + cs.NEW // 2, cs.P + 64, 8))
    for kv_len, t, bits in rows:
        page = tiling.fit_block(min(128, t), t, 1)
        lens = torch.full((cs.B,), kv_len, dtype=torch.int32, device=cs.DEV)
        sets = [cs.attention_pool(bits, 32, t, page, seed=s)
                for s in (30, 31, 32)]
        it = {"i": 0}

        def call():
            it["i"] = (it["i"] + 1) % len(sets)
            q, pool, table = sets[it["i"]]
            return paged_attention(q, *pool, table, lens)

        for name, (defs, plans) in VARIANTS.items():
            sized = dict(stages=defs.get("PA_STAGES", tiling.ATTN_STAGES),
                         warps=defs.get("PA_WARPS", tiling.ATTN_WARPS))
            for splits, heads, chunk in plans:
                try:
                    tiling.attention_plan(cs.B, 32, 1, 96, page, t // page,
                                          bits, splits=splits, heads=heads,
                                          chunk=chunk, **sized)
                except ValueError as err:     # this build cannot take it
                    emit(rec, dict(probe="variant", variant=name,
                                   kv_len=kv_len, bits=bits, splits=splits,
                                   heads=heads, chunk=chunk,
                                   skipped=str(err)))
                    continue
                with variant(name), forced_plan(splits, chunk, heads=heads,
                                                **sized):
                    ms, dev, host = cs.cuda_times(call, iters=50)
                    held = resident_ctas(bits, t, page)
                emit(rec, dict(probe="variant", variant=name, kv_len=kv_len,
                               t=t, bits=bits, splits=splits, heads=heads,
                               chunk=chunk, device_ms=dev, ms=ms,
                               host_ms=host, resident_per_sm=held, **sized))


def resident_ctas(bits, t, page):
    """CTAs of the wrapper's current launch (B=4, KV=32, G=1, dh=96) that
    one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    mod = sys.modules["repro_torch.kernels.paged_attention"]
    fn = kbuild.load("paged_attention").paged_attention_resident
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    n = ctypes.c_int(0)
    rc = fn(mod._args((torch.device(cs.DEV, 0), cs.B, 32, 1, 96, page,
                       t // page, bits, 0, 0.0)), ctypes.byref(n))
    return n.value if rc == 0 else -rc


BASELINE = """
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import build
build.build(["paged_attention"])
for bits in (8, 4):
    print(json.dumps(cs.time_attention(bits, cs.P + cs.NEW // 2)))
"""


def baseline(rec, where):
    run = subprocess.run([sys.executable, "-c", BASELINE], cwd=where,
                         capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise RuntimeError(f"baseline in {where} failed:\n{run.stderr}")
    for line in run.stdout.splitlines():
        if line.startswith("{"):
            emit(rec, dict(probe="baseline", tree=str(where),
                           **json.loads(line)))


def main():
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    modes = [a for a in sys.argv[1:]] or ["check", "time"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    rec = [{"card": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}]
    print(json.dumps(rec[0]), flush=True)
    kbuild.build()
    try:
        for mode in modes:
            if mode.startswith("baseline:"):
                baseline(rec, ROOT / mode.split(":", 1)[1])
            else:
                {"check": check, "time": timing, "sweep": sweep,
                 "variants": variants}[mode](rec)
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "attention_probe.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
