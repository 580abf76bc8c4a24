#!/usr/bin/env python3
"""Check, time and take apart the two weight-matmul kernels
(``packed_matmul``, ``bitplane_matmul``) on one NVIDIA GPU, run from the
repository root:

    python3 scripts/matmul_probe.py [check] [time] [switch] [numerics]
                                    [variants] [profile]

Every timing is ``chip_smoke.time_packed`` / ``chip_smoke.time_bitplane``
(bf16 x, weights cold, both of ``chip_smoke.cuda_times``' methods, the
plain version, ``torch.matmul`` on the bf16 weight and the bound), with
``bitplane_matmul`` on the leaves of ``chip_smoke.deploy_bitplane``'s
full-width phi3 tree:

* ``check`` — builds the four CUDA kernels (printing ``nvcc``'s register
  and shared-memory report for the two matmuls) and runs
  ``chip_smoke.kernel_phase``;
* ``time`` — the phi3 projection shapes at M in {4, 20, 512};
* ``switch`` — the regime switch: each shape at M in {8, 12, 16, 20, 24}
  through the stream regime (as many 4-row tiles as M needs) and through
  the tensor regime, each forced plan first held to the plain version;
* ``numerics`` — the tensor regime's error (over the float64 product of
  the same operands) against K, at M = 512, N = 3072: the port's
  accumulation (each 32-row tile's products summed from zero, then added
  in f32) and the first design's (a whole K slice in the tensor cores'
  accumulator, built with ``-DWMM_PROBE=32``), each with K in one slice,
  in the plan's slices and in 32-row slices;
* ``variants`` — where the time goes: each kernel rebuilt with a stage
  taken out (``-DWMM_PROBE``, ``csrc/wmm_common.cuh``) and timed at the
  phi3 shapes, M in {4, 20, 512};
* ``profile`` — the calls at the phi3 shapes under ``torch.profiler``:
  device time per kernel name (a check of the event timings).

``check`` and ``time`` by default.  Results go to stdout (one JSON object
a line) and to ``chiprun_out/matmul_probe.json``, with the card's name
and power limit.
"""
import contextlib
import ctypes
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
from repro_torch.kernels import tiling  # noqa: E402

MS = (4, 20, 512)
SWITCH_MS = (8, 12, 16, 20, 24)
LEAVES = (("attn", "wq"), ("mlp", "w_gate"), ("mlp", "w_down"))
WRAPPERS = ("packed_matmul", "bitplane_matmul")
VARIANTS = {"base": 0, "launch": 1, "no_reduce": 2, "no_compute": 4,
            "no_decode": 8, "mma_only": 8 | 16, "chain": 32}
VARIANT_DIR = kbuild.BUILD_DIR / "variants"


def emit(out, r):
    out.append(r)
    print(json.dumps(r), flush=True)


@contextlib.contextmanager
def forced_plan(plan_fn):
    """Both wrappers launch with ``plan_fn(m, kend, n, unit=, wbr=)`` (their
    cached launch arguments are dropped on the way in and out)."""
    mods = [sys.modules[f"repro_torch.kernels.{w}"] for w in WRAPPERS]
    saved = [m.matmul_plan for m in mods]
    for m in mods:
        m.matmul_plan = plan_fn
        m._ARGS.clear()
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.matmul_plan = f
            m._ARGS.clear()


def build_variants(masks):
    """Each wrapper's source built once a mask, all nvcc at once."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for mask in set(masks) - {0}:
        for w in WRAPPERS:
            cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, f"-DWMM_PROBE={mask}",
                   "-o", str(VARIANT_DIR / f"lib{w}-{mask}.so"),
                   str(kbuild.CSRC / f"{w}.cu")]
            procs.append((mask, w, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for mask, w, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {w} -DWMM_PROBE={mask}:\n"
                               f"{log}")


@contextlib.contextmanager
def variant(mask):
    """Both wrappers launch the kernels built with -DWMM_PROBE=mask."""
    if mask == 0:
        yield
        return
    saved = {w: kbuild._LIBS.get(w) for w in WRAPPERS}
    for w in WRAPPERS:
        kbuild._LIBS[w] = ctypes.CDLL(str(VARIANT_DIR / f"lib{w}-{mask}.so"))
    try:
        yield
    finally:
        for w, lib in saved.items():
            if lib is None:
                kbuild._LIBS.pop(w)
            else:
                kbuild._LIBS[w] = lib


def bitplane_tree():
    from repro_torch.configs import REGISTRY
    from repro_torch.models.api import build
    qat = build(REGISTRY[cs.ARCH]).init(seed=0, device=cs.DEV)
    bp, _ = cs.deploy_bitplane(qat)
    del qat
    torch.cuda.empty_cache()
    return bp


def time_all(out, bp, ms, **tag):
    for m in ms:
        for k, n in cs.PHI3_SHAPES:
            for bits in (8, 4):
                emit(out, dict(kernel="packed_matmul", **tag,
                               **cs.time_packed(m, k, n, bits)))
        for sub, name in LEAVES:
            emit(out, dict(kernel="bitplane_matmul", **tag,
                           **cs.time_bitplane(bp, sub, name, m)))


def check(rec):
    t0 = time.perf_counter()
    kbuild.build()
    rec["build_s"] = time.perf_counter() - t0
    for name in WRAPPERS:
        cs.log(f"--- nvcc {name}\n{kbuild.BUILD_LOGS.get(name, '').strip()}")
    t0 = time.perf_counter()
    res = cs.kernel_phase()
    rec["kernel_phase_s"] = time.perf_counter() - t0
    rec["kernel_phase"] = res
    for name in WRAPPERS:
        worst = max(c["err"] / c["tol"] for c in res[name] if c["tol"] > 0)
        print(json.dumps({"kernel": name, "cases": len(res[name]),
                          "worst_err_over_tol": worst}))
    print(json.dumps({"repeat": res["repeat"]}))


def timing(rec, bp):
    rec["time"] = []
    time_all(rec["time"], bp, MS)


def switch(rec, bp):
    """Both regimes at the M around the switch, each forced plan checked
    against the plain version first."""
    from repro_torch.kernels import bitplane_matmul, packed_matmul
    from repro_torch.kernels.ref import bitplane_matmul_ref, packed_matmul_ref
    out = rec["switch"] = []
    for regime in ("stream", "tensor"):
        def plan(m, kend, n, *, unit, wbr):
            return tiling._plan(regime, m, kend, n, unit, wbr)
        tag = dict(regime=regime)
        with forced_plan(plan):
            for m in SWITCH_MS:
                for k, n in cs.PHI3_SHAPES:
                    for bits in (8, 4):
                        x, w, s = cs.packed_case(m, k, n, bits, 8, 128,
                                                 x_dtype=torch.bfloat16)
                        ref = packed_matmul_ref(x, w, s, bits, 8, 128)
                        err = (packed_matmul(x, w, s, bits=bits) - ref
                               ).abs().max() / ref.abs().max()
                        if not err <= cs.PM_TOL_REL:
                            raise AssertionError((tag, m, k, n, bits, err))
                for sub, name in LEAVES:
                    v = bp["layers"][sub][name].layer(0)
                    x = torch.randn((m, v.shape[-2]), device=cs.DEV,
                                    dtype=torch.bfloat16)
                    args = (v.planes, v.sign, v.mask, v.scale)
                    ref = bitplane_matmul_ref(x, *args, 8, 128)
                    err = (bitplane_matmul(x, *args) - ref).abs().max() \
                        / ref.abs().max()
                    if not err <= cs.BM_TOL_REL:
                        raise AssertionError((tag, m, name, err))
            time_all(out, bp, SWITCH_MS, **tag)


def numerics(rec):
    """Error over the float64 product against K, both accumulations, K in
    one slice, the plan's slices and 32-row slices."""
    from repro_torch.kernels import bitplane_matmul, packed_matmul
    from repro_torch.kernels.ref import bitplane_matmul_ref
    build_variants([VARIANTS["chain"]])
    out = rec["numerics"] = []
    m, n = 512, 3072
    tn = -(-n // tiling.BLOCK_N)
    cases = []
    for k in (1024, 3072, 8192, 16384):
        for dt in (torch.bfloat16, torch.float32):
            x, w, s = cs.packed_case(m, k, n, 8, 8, 128, x_dtype=dt)
            wd = w.float() * s.repeat_interleave(8, 0).repeat_interleave(
                128, 1)
            ref = x.double() @ wd.double()
            cases.append(("packed_matmul int8", k, dt, ref,
                          lambda x=x, w=w, s=s: packed_matmul(x, w, s)))
    for k in (3072, 8192):
        x, pl, sg, mk, sc = cs.bitplane_case(m, k, n, 8,
                                             x_dtype=torch.bfloat16)
        wd = bitplane_matmul_ref(torch.eye(k, device=cs.DEV), pl, sg, mk, sc,
                                 8, 128)
        ref = x.double() @ wd.double()
        cases.append(("bitplane_matmul", k, torch.bfloat16, ref,
                      lambda x=x, a=(pl, sg, mk, sc): bitplane_matmul(x, *a)))
    for name, k, dt, ref, fn in cases:
        default = tiling.matmul_plan(m, k, n, unit=8, wbr=8)
        splits = {"one slice": 1, "plan": default.ksplit, "32-row": k // 32}
        for acc, mask in (("per-tile", 0), ("chain", VARIANTS["chain"])):
            for how, ks in splits.items():
                kc = tiling.round_up(-(-k // ks), tiling.BLOCK_K)
                p = tiling.MatmulPlan("tensor", 128, -(-k // kc), kc,
                                      -(-m // 128), tn)
                with variant(mask), forced_plan(lambda *a, **kw: p):
                    y = fn()
                err = float((y.double() - ref).abs().max()
                            / ref.abs().max())
                emit(out, dict(kernel=name, k=k, m=m, n=n, x=str(dt),
                               accumulation=acc, slices=how,
                               ksplit=p.ksplit, err_rel=err))


def variants(rec, bp):
    build_variants(VARIANTS.values())
    out = rec["variants"] = []
    for name, mask in VARIANTS.items():
        with variant(mask):
            time_all(out, bp, MS, variant=name)


def profile(rec):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    from repro_torch.kernels import bitplane_matmul, packed_matmul
    out = rec["profile"] = []
    for m in MS:
        for k, n in cs.PHI3_SHAPES:
            x, w, s = cs.packed_case(m, k, n, 8, 8, 128,
                                     x_dtype=torch.bfloat16)
            xb, pl, sg, mk, sc = cs.bitplane_case(m, k, n, 8,
                                                  x_dtype=torch.bfloat16)
            calls = {"packed_matmul int8": lambda: packed_matmul(x, w, s),
                     "bitplane_matmul": lambda: bitplane_matmul(
                         xb, pl, sg, mk, sc)}
            for name, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
                for ev in prof.key_averages():
                    dev = getattr(ev, "device_time_total", None)
                    if dev is None:
                        dev = ev.cuda_time_total
                    emit(out, dict(call=name, m=m, k=k, n=n,
                                   kernel=ev.key[:60], count=ev.count,
                                   device_us_per_call=dev / 10))


def main():
    if not torch.cuda.is_available():
        print("matmul_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    what = sys.argv[1:] or ["check", "time"]
    if "check" not in what:            # build, and nothing else
        kbuild.build(WRAPPERS)
    rec = {"card": smi, "torch": torch.__version__}
    bp = bitplane_tree() if {"time", "switch", "variants"} & set(what) \
        else None
    try:
        for w in what:
            t0 = time.perf_counter()
            if w in ("check", "numerics", "profile"):
                {"check": check, "numerics": numerics, "profile": profile
                 }[w](rec)
            else:
                {"time": timing, "switch": switch, "variants": variants
                 }[w](rec, bp)
            rec[f"{w}_s"] = time.perf_counter() - t0
            cs.log(f"{w} done in {rec[f'{w}_s']:.1f} s")
    finally:
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "matmul_probe.json").write_text(
            json.dumps(rec, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
