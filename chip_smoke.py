#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel), then:

1. kernel phase — holds each kernel against its plain PyTorch version on
   the card at the serving path's shapes, f32 and bf16 activations, with
   stated tolerances;
2. path phase — serves full-width ``phi3-mini-3.8b`` (all 32 layers,
   random weights from seed 0) deployed to int8 and int4, in float32.
   Each configuration is driven through the kernels (``backend="kernel",
   attn_backend="fused"``) twice, contiguous and paged (16-token pages,
   non-identity block table, per-slot ``prefill_at`` and decode index),
   each drive with the launch counters zeroed just before and checked just
   after; then through the plain versions (``"ref", "ref"``):

   * the registered quantization (8-bit PACT activations) with int8 and
     int4 KV caches.  Its quantizers round to integer levels, so two
     summation orders part at rounding ties.  The check is the logit error
     at every step where the two runs' token prefixes still agree, against
     a limit set between a witness of that noise (the same plain path on
     the host CPU, weights dequantized once: same values, another
     summation order) and planted faults (K rows read one block off, swapped
     nibbles), which must read above it;
   * the same weights with activation quantization off and a float32 KV
     cache, where nothing rounds to levels: logits within 1e-4 of the
     largest and greedy tokens identical, kernels vs plain versions and
     paged vs contiguous;
3. time phase — in bfloat16 (the config's compute dtype): each kernel at
   the path's shapes with CUDA events, beside its bound, its plain version
   and one PyTorch library call; and the path's prefill ms, decode ms/step
   and tokens/s, contiguous and paged, each run counted.

Output: a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Details go
to ``chiprun_out/chip_smoke_detail.json``.  Any failure exits non-zero; so
does a machine without CUDA, or a directory without the repository.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "phi3-mini-3.8b"
B, P, NEW = 4, 128, 32          # prompts, prompt length, new tokens
PAGE = 16                       # paged leg
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
PM_TOL_REL = 1e-4               # packed_matmul: |err| <= 1e-4 * max|ref|
PA_TOL = 1e-4                   # paged_attention: |err| <= 1e-4 (abs)
EXACT_TOL_REL = 1e-4            # quantizer-free path: logits vs plain
# Quantized path (8-bit activations), logits while token prefixes agree,
# relative to the largest logit, by KV-cache bits.  Set between the noise
# of two summation orders and planted faults (H100, f32 unless noted):
#   int8 KV: kernel vs plain 0.032 / 0.038 (int8 / int4 weights), CPU
#     witness vs plain 0.033 / 0.034, paged vs contiguous 0.025 / 0.026,
#     bf16 kernel vs plain 0.038; faults 0.148 to 1.16;
#   int4 KV: kernel vs plain 0.058 / 0.129, witness 0.072 / 0.125, paged
#     0.023 / 0.025, bf16 0.099.
QUANT_TOL_REL = {8: 0.08, 4: 0.25}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` calls (events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(make, nbytes, budget=256 << 20):
    """Enough distinct copies of an operand to exceed the 50 MB L2, so
    timed calls read it cold, as each layer's weights are in decode."""
    n = max(2, min(64, -(-budget // max(nbytes, 1))))
    return [make() for _ in range(n)]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def packed_case(m, k, n, bits, wbr, wbc, k_x=None, x_dtype=None, seed=0):
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    gr, gc = -(-k // wbr), -(-n // wbc)
    kp = gr * wbr
    rows = kp if bits == 8 else (kp + 1) // 2
    w = torch.randint(-128 if bits == 8 else 0, 128 if bits == 8 else 256,
                      (rows, gc * wbc), generator=g, device=DEV)
    w = w.to(torch.int8 if bits == 8 else torch.uint8)
    if bits == 4 and kp % 2:
        w[-1] &= 0x0F                      # odd K: zero pad nibble row
    scale = torch.rand((gr, gc), generator=g, device=DEV) * 1e-2 + 1e-3
    x = torch.randn((m, k if k_x is None else k_x), generator=g,
                    device=DEV, dtype=x_dtype or torch.float32)
    return x, w, scale


PHI3_SHAPES = ((3072, 3072), (3072, 8192), (8192, 3072))


def kernel_phase():
    import torch
    from repro_torch.kernels import packed_matmul, paged_attention
    from repro_torch.kernels.ref import packed_matmul_ref, paged_attention_ref
    from repro_torch.models.attention import _as_pool, quantize_kv
    from repro_torch.kernels.tiling import fit_block

    out = {"packed_matmul": [], "paged_attention": []}
    f32, bf16 = torch.float32, torch.bfloat16
    # f32 x at decode and prefill M; bf16 x (the bf16 path's operands) at
    # the path's own M = B (decode) and B*P (prefill)
    cases = [(m, k, n, bits, 8, 128, None, f32)
             for bits in (8, 4) for m in (1, 16, B * P)
             for k, n in PHI3_SHAPES]
    cases += [(m, k, n, bits, 8, 128, None, bf16)
              for bits in (8, 4) for m in (B, B * P)
              for k, n in PHI3_SHAPES]
    cases += [(5, 27, 44, b, 9, 8, 25, f32) for b in (8, 4)]  # 9x8, odd Kp
    for m, k, n, bits, wbr, wbc, k_x, xdt in cases:
        x, w, s = packed_case(m, k, n, bits, wbr, wbc, k_x, xdt)
        got = packed_matmul(x, w, s, bits=bits, wbr=wbr, wbc=wbc)
        torch.cuda.synchronize()
        want = packed_matmul_ref(x, w, s, bits, wbr, wbc)
        err = float((got - want).abs().max())
        tol = PM_TOL_REL * float(want.abs().max())
        out["packed_matmul"].append(dict(m=m, k=k, n=n, bits=bits, wbr=wbr,
                                         wbc=wbc, k_x=k_x, x=str(xdt),
                                         err=err, tol=tol))
        if not (err <= tol):
            raise AssertionError(f"packed_matmul {m}x{k}x{n} int{bits} "
                                 f"{wbr}x{wbc} {xdt}: err {err} > tol {tol}")

    g = torch.Generator(device=DEV).manual_seed(1)
    t = P + 64                                  # generate's cache width
    page = fit_block(min(128, t), t, 1)         # contiguous page size: 96
    kv_len = torch.tensor([P + 1, P + 17, P + 40, t][:B], dtype=torch.int32,
                          device=DEV)
    for bits in (8, 4, 32):
        kf = torch.randn((B, t, 32, 96), generator=g, device=DEV)
        vf = torch.randn((B, t, 32, 96), generator=g, device=DEV)
        q = torch.randn((B, 32, 1, 96), generator=g, device=DEV)
        if bits < 32:
            (kq, ks), (vq, vs) = quantize_kv(kf, bits), quantize_kv(vf, bits)
            pool = [_as_pool(a, page) for a in (kq, vq, ks, vs)]
        else:
            pool = [_as_pool(kf, page), _as_pool(vf, page), None, None]
        ident = torch.arange(B * t // page, dtype=torch.int32,
                             device=DEV).reshape(B, -1)
        got = paged_attention(q, *pool, ident, kv_len)
        torch.cuda.synchronize()
        want = paged_attention_ref(q, *pool, ident, kv_len)
        err = float((got - want).abs().max())
        out["paged_attention"].append(dict(bits=bits, kv=32, g=1, dh=96,
                                           page=page, err=err, tol=PA_TOL))
        assert err <= PA_TOL, (bits, err)
    # GQA G=4 with window and softcap; blocks past kv_len route to page 0
    kvh, gq, nb = 8, 4, 6
    n_pages = 1 + B * nb
    kf = torch.randn((n_pages, PAGE, kvh, 96), generator=g, device=DEV)
    vf = torch.randn((n_pages, PAGE, kvh, 96), generator=g, device=DEV)
    (kq, ks), (vq, vs) = quantize_kv(kf, 8), quantize_kv(vf, 8)
    q = torch.randn((B, kvh, gq, 96), generator=g, device=DEV)
    lens = torch.tensor([5, 33, 60, 96][:B], dtype=torch.int32, device=DEV)
    table = torch.randperm(n_pages - 1, generator=g, device=DEV)[
        :B * nb].reshape(B, nb).to(torch.int32) + 1
    live = -(-lens.long() // PAGE)
    blk = torch.arange(nb, device=DEV)[None, :]
    table = torch.where(blk < live[:, None], table, torch.zeros_like(table))
    got = paged_attention(q, kq, vq, ks, vs, table, lens, window=40,
                          softcap=30.0)
    torch.cuda.synchronize()
    want = paged_attention_ref(q, kq, vq, ks, vs, table, lens, window=40,
                               softcap=30.0)
    err = float((got - want).abs().max())
    out["paged_attention"].append(dict(bits=8, kv=kvh, g=gq, dh=96,
                                       page=PAGE, window=40, softcap=30.0,
                                       err=err, tol=PA_TOL))
    assert err <= PA_TOL, ("gqa", err)
    return out


# ---------------------------------------------------------------------------
# the one greedy loop: comparison, counting and timing all run through it
# ---------------------------------------------------------------------------

def greedy(eng, tok, new, page=0):
    """Greedy decode as ``ServeEngine.generate`` runs it: a prefill, then
    ``new - 1`` decode steps, each taking the argmax.  With ``page`` the
    state is paged: a non-identity block table (page 0 reserved),
    ``prefill_at`` per slot and a per-slot (B,) decode index.

    Returns the tokens (B, new), every step's logits (new, B, V) in f32,
    and host-clock prefill ms and decode ms/step (synchronized)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import _roundup64
    b, p = tok.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if page:
        max_len = p + _roundup64(new)
        state = eng.init_decode_state({"tokens": tok[:1]}, n_slots=b,
                                      max_len=max_len, page_size=page)
        nb = -(-max_len // page)
        table = np.random.default_rng(5).permutation(
            np.arange(1, 1 + b * nb)).reshape(b, nb).astype(np.int32)
        state = eng.set_tables(state, table)
        rows = []
        for s in range(b):
            lg, state = eng.prefill_at({"tokens": tok[s:s + 1]}, state, s)
            rows.append(lg)
        logits = torch.cat(rows)
        index = torch.full((b,), p, dtype=torch.int32, device=eng.device)
    else:
        logits, state = eng.prefill({"tokens": tok},
                                    extra_slots=_roundup64(new))
        index = p
    cur = logits.argmax(-1)[:, None].to(torch.int32)
    steps, toks = [logits.float()], [cur[:, 0]]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(new - 1):
        logits, state = eng.decode(cur, state, index)
        cur = logits.argmax(-1)[:, None].to(torch.int32)
        steps.append(logits.float())
        toks.append(cur[:, 0])
        index = index + 1
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(tokens=torch.stack(toks, 1).cpu(),
                logits=torch.stack(steps).cpu(),
                prefill_ms=(t1 - t0) * 1e3,
                decode_ms_per_step=(t2 - t1) * 1e3 / max(new - 1, 1))


def counted(fn, expect):
    """Run ``fn`` with the launch counters zeroed just before; the counts
    read just after must equal ``expect``."""
    import torch
    from repro_torch import kernels as tk
    tk.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    got = tk.launch_counts()
    if got != expect:
        raise AssertionError(f"launch counts {got}, expected {expect}")
    res["launches"] = got
    return res


def expected_launches(n_layers, forwards, decode_steps):
    return {"packed_matmul": 7 * n_layers * forwards,
            "paged_attention": n_layers * decode_steps}


def compare(a, b):
    """Run ``a`` against run ``b``: the largest |logit difference| over the
    steps at which a row's token prefixes still agree (so both runs were
    fed the same tokens), relative to b's largest |logit|; token agreement
    and the earliest differing (row, step) with b's top-2 logit gap
    there."""
    import torch
    n = min(a["tokens"].shape[1], b["tokens"].shape[1])
    ta, tb = a["tokens"][:, :n], b["tokens"][:, :n]
    same = (ta == tb).int().cumprod(1)
    fed_same = torch.cat([torch.ones_like(same[:, :1]), same[:, :-1]], 1)
    d = (a["logits"][:n] - b["logits"][:n]).abs().amax(-1).T   # (B, n)
    diff = (ta != tb).nonzero()
    first = gap = None
    if len(diff):
        first = diff[diff[:, 1].argmin()].tolist()
        top2 = b["logits"][first[1], first[0]].topk(2).values
        gap = float(top2[0] - top2[1])
    return dict(err=float((d * fed_same).max() / b["logits"].abs().max()),
                token_agreement=float((ta == tb).float().mean()),
                first_diff=first, top2_gap_at_first_diff=gap,
                steps_compared=int(fed_same.sum()),
                finite=bool(torch.isfinite(a["logits"]).all()))


# ---------------------------------------------------------------------------
# path phase
# ---------------------------------------------------------------------------

# (weights, KV bits, activation bits): the registered quantization with
# int8 / int4 caches, then the same weights with nothing rounded to levels;
# grouped by weights so each CPU witness tree is built once
PATH_RUNS = ((8, 8, 8), (8, 4, 8), (8, 32, 32), (4, 8, 8), (4, 4, 8),
             (4, 32, 32))


def api_for(act_bits, dtype="float32"):
    from repro_torch.configs import REGISTRY
    from repro_torch.models.api import build
    base = dataclasses.replace(REGISTRY[ARCH], dtype=dtype)
    return build(base.with_quant(dataclasses.replace(base.quant,
                                                     act_bits=act_bits)))


def cpu_dense_tree(deployed):
    """The deployed tree with every packed weight dequantized once (the
    plain version's own f32 product) and moved to the host: the plain
    path with another summation order."""
    import torch
    from repro_torch.serve.deploy import (ServingWeight, serving_compose,
                                          tree_map)
    return tree_map(lambda x: serving_compose(x, torch.float32).cpu()
                    if isinstance(x, ServingWeight) else
                    x.cpu() if isinstance(x, torch.Tensor) else x, deployed)


def planted_faults(deployed):
    """Deployed trees that each carry one fault of the kind a wrong
    layout or index makes: (name, bits, KV widths where the path check
    must catch it, tree).  One doubled scale block of 9216 is below what
    a path-level check can resolve, and a fault in the last layer alone
    is at the int4-KV noise floor; their readings show the check's
    resolution (the kernel phase holds each element)."""
    import torch

    def with_leaf(bits, name, edit):
        sub = "attn" if name.startswith("w") and len(name) == 2 else "mlp"
        tree = dict(deployed[bits])
        tree["layers"] = dict(tree["layers"])
        tree["layers"][sub] = dict(tree["layers"][sub])
        sw = tree["layers"][sub][name]
        w, s = sw.w_int.clone(), sw.scale.clone()
        edit(w, s)
        tree["layers"][sub][name] = dataclasses.replace(sw, w_int=w, scale=s)
        return tree

    def one_scale(w, s):
        s[0, 0, 0] *= 2.0

    def shift_rows(w, s):
        w[0] = torch.roll(w[0], 8, dims=0)

    def swap_nibbles(layer):
        def edit(w, s):
            w[layer] = (w[layer] << 4) | (w[layer] >> 4)
        return edit

    return [
        ("int8 first layer wq: one WB scale doubled", 8, (),
         with_leaf(8, "wq", one_scale)),
        ("int8 first layer w_down: K rows read one WB row off", 8, (8, 4),
         with_leaf(8, "w_down", shift_rows)),
        ("int4 first layer wq: nibbles swapped", 4, (8, 4),
         with_leaf(4, "wq", swap_nibbles(0))),
        ("int4 last layer w_down: nibbles swapped", 4, (8,),
         with_leaf(4, "w_down", swap_nibbles(-1))),
    ]


def path_phase(deployed, tok):
    """Drive each configuration through the kernels (each drive counted),
    then through the plain versions, the CPU witness and the planted
    faults.  Returns the readings; :func:`check_path` judges them."""
    import torch
    from repro_torch.serve.engine import ServeEngine

    L = api_for(8).cfg.n_layers
    runs, plain_act8 = [], {}
    witness_bits, witness_tree = None, None
    for bits, kv, act in PATH_RUNS:
        api = api_for(act)
        ker = ServeEngine(api, deployed[bits], kv_quant_bits=kv,
                          backend="kernel", attn_backend="fused", device=DEV)
        ref = ServeEngine(api, deployed[bits], kv_quant_bits=kv,
                          backend="ref", attn_backend="ref", device=DEV)
        contig = counted(lambda: greedy(ker, tok, NEW),
                         expected_launches(L, NEW, NEW - 1))
        paged = counted(lambda: greedy(ker, tok, NEW, page=PAGE),
                        expected_launches(L, B + NEW - 1, NEW - 1))
        plain = greedy(ref, tok, NEW)
        run = dict(bits=bits, kv=kv, act_bits=act,
                   tokens=contig["tokens"].tolist(),
                   launches={"contiguous": contig["launches"],
                             "paged": paged["launches"]},
                   kernel_vs_plain=compare(contig, plain),
                   paged_vs_contiguous=compare(paged, contig))
        if act < 32:
            plain_act8[(bits, kv)] = plain
            if witness_bits != bits:
                witness_tree = None
                witness_tree = cpu_dense_tree(deployed[bits])
                witness_bits = bits
            t0 = time.perf_counter()
            host = ServeEngine(api, witness_tree, kv_quant_bits=kv,
                               backend="dense", attn_backend="ref",
                               device="cpu")
            run["witness_vs_plain"] = compare(greedy(host, tok.cpu(), NEW),
                                              plain)
            run["witness_s"] = time.perf_counter() - t0
        log(f"int{bits} kv{kv} act{act}: " + "; ".join(
            f"{k} err {v['err']:.3g} tokens {v['token_agreement']:.3f} "
            f"first diff {v['first_diff']}" for k, v in run.items()
            if isinstance(v, dict) and "err" in v))
        runs.append(run)
    del witness_tree

    faults = []
    for name, bits, catch_kv, tree in planted_faults(deployed):
        for kv in (8, 4):
            eng = ServeEngine(api_for(8), tree, kv_quant_bits=kv,
                              backend="kernel", attn_backend="fused",
                              device=DEV)
            reading = compare(greedy(eng, tok, 1), plain_act8[(bits, kv)])
            faults.append(dict(name=name, kv=kv, must_catch=kv in catch_kv,
                               **reading))
            log(f"planted fault {name}, int{kv} KV: prefill logit err "
                f"{reading['err']:.3g}")
            del eng
        del tree
    torch.cuda.empty_cache()
    return {"runs": runs, "faults": faults}


def check_path(res, timed):
    """Kernel-path logits finite, tokens of the right shape and vocabulary.
    Quantizer-free: logits within 1e-4 of the largest (f32 sums of up to
    8192 terms in another order) and tokens identical, kernels vs plain
    and paged vs contiguous.  Quantized: the logit error while prefixes
    agree, kernels vs plain and paged vs contiguous, within
    ``QUANT_TOL_REL`` for its KV width, which must also hold the CPU
    witness and the bf16 timed runs and sit below every planted fault
    marked to be caught."""
    import torch
    from repro_torch.configs import REGISTRY
    for run in res["runs"]:
        tag = (run["bits"], run["kv"], run["act_bits"])
        toks = torch.tensor(run["tokens"])
        assert toks.shape == (B, NEW), tag
        assert 0 <= int(toks.min()) <= int(toks.max()) < REGISTRY[ARCH].vocab
        kp, pc = run["kernel_vs_plain"], run["paged_vs_contiguous"]
        assert kp["finite"] and pc["finite"], tag
        if run["act_bits"] >= 32 and run["kv"] >= 32:
            for c in (kp, pc):
                assert c["err"] <= EXACT_TOL_REL and c["first_diff"] is None, \
                    (tag, c)
        else:
            for c in (kp, pc, run["witness_vs_plain"]):
                assert c["err"] <= QUANT_TOL_REL[run["kv"]], (tag, c)
    for t in timed:
        if "kernel_vs_plain" in t:
            assert t["kernel_vs_plain"]["err"] <= QUANT_TOL_REL[t["kv"]], t
    for f in res["faults"]:
        if f["must_catch"]:
            assert f["err"] > QUANT_TOL_REL[f["kv"]], ("fault not caught", f)


# ---------------------------------------------------------------------------
# time phase
# ---------------------------------------------------------------------------

def time_packed(m, k, n, bits):
    import torch
    from repro_torch.kernels import packed_matmul
    from repro_torch.kernels.ref import packed_matmul_ref
    from repro_torch.serve.deploy import ServingWeight, serving_compose
    from repro_torch.core.blocking import BlockingSpec

    x, w, s = packed_case(m, k, n, bits, 8, 128, x_dtype=torch.bfloat16)
    ws = rotating(lambda: packed_case(1, k, n, bits, 8, 128)[1:], w.nbytes)
    spec = BlockingSpec(8, 128)
    dense = rotating(lambda: serving_compose(
        ServingWeight(w, s, (k, n), spec, bits), torch.bfloat16), 2 * k * n)
    it = {"i": 0}

    def nxt(seq):
        it["i"] = (it["i"] + 1) % len(seq)
        return seq[it["i"]]

    ms = cuda_ms(lambda: packed_matmul(x, *nxt(ws), bits=bits))
    plain = cuda_ms(lambda: packed_matmul_ref(x, *nxt(ws), bits), iters=5)
    lib = cuda_ms(lambda: torch.matmul(x, nxt(dense)))
    nbytes = w.nbytes + s.nbytes + x.nbytes + m * n * 4
    flops = 2.0 * m * k * n
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    return dict(m=m, k=k, n=n, bits=bits, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bound, bound_by=by, bytes=nbytes,
                flops=flops)


def time_attention(bits, kv_len_val):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.kernels.tiling import fit_block
    from repro_torch.models.attention import _as_pool, dequantize_kv, \
        quantize_kv

    t = P + 64
    page = fit_block(min(128, t), t, 1)
    g = torch.Generator(device=DEV).manual_seed(2)
    q = torch.randn((B, 32, 1, 96), generator=g, device=DEV)
    kv_len = torch.full((B,), kv_len_val, dtype=torch.int32, device=DEV)
    ident = torch.arange(B * t // page, dtype=torch.int32,
                         device=DEV).reshape(B, -1)

    def make():
        kf = torch.randn((B, t, 32, 96), generator=g, device=DEV)
        vf = torch.randn((B, t, 32, 96), generator=g, device=DEV)
        (kq, ks), (vq, vs) = quantize_kv(kf, bits), quantize_kv(vf, bits)
        pool = [_as_pool(a, page) for a in (kq, vq, ks, vs)]
        kd = dequantize_kv(kq, ks, torch.bfloat16).transpose(1, 2)
        vd = dequantize_kv(vq, vs, torch.bfloat16).transpose(1, 2)
        return pool, (kd.contiguous(), vd.contiguous())

    sets = rotating(make, 2 * B * t * 32 * (96 * bits // 8 + 4))
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    mask = (torch.arange(t, device=DEV) < kv_len_val)[None, None, None]
    qb = q.reshape(B, 32, 1, 96).to(torch.bfloat16)
    ms = cuda_ms(lambda: paged_attention(q, *nxt()[0], ident, kv_len))
    plain = cuda_ms(lambda: paged_attention_ref(q, *nxt()[0], ident, kv_len))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, *nxt()[1], attn_mask=mask))
    nbytes = B * kv_len_val * 32 * (2 * 96 * bits / 8 + 8) \
        + 2 * q.nbytes + B * 32 * 4
    flops = 4.0 * B * 32 * kv_len_val * 96
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    return dict(bits=bits, b=B, kv=32, dh=96, t=t, page=page,
                kv_len=kv_len_val, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)


def time_path(deployed, tok):
    """The registered bf16 path: int8/int8-KV and int4/int4-KV through the
    kernels (contiguous, and paged for int8) and through the plain
    versions.  Kernel runs are counted; kernel tokens and logits are held
    against the plain run's.  ``generate`` warms each engine up and must
    give the loop's first tokens."""
    import torch
    from repro_torch.serve.engine import ServeEngine

    api = api_for(8, dtype="bfloat16")
    L = api.cfg.n_layers
    out = []
    for bits, kv in ((8, 8), (4, 4)):
        legs = [("kernel", "fused", 0), ("ref", "ref", 0)]
        if bits == 8:
            legs.insert(1, ("kernel", "fused", PAGE))
        runs = {}
        for be, ab, page in legs:
            eng = ServeEngine(api, deployed[bits], kv_quant_bits=kv,
                              backend=be, attn_backend=ab, device=DEV)
            warm = eng.generate({"tokens": tok}, max_new=4).cpu()
            if be == "ref":
                r = greedy(eng, tok, NEW)
            else:
                fwd = (B if page else 1) + NEW - 1
                r = counted(lambda: greedy(eng, tok, NEW, page=page),
                            expected_launches(L, fwd, NEW - 1))
            if not page:
                assert torch.equal(warm, r["tokens"][:, :4]), \
                    ("generate vs loop", be, bits, kv)
            runs[(be, page)] = r
            out.append(dict(
                bits=bits, kv=kv, backend=be, attn_backend=ab,
                leg="paged" if page else "contiguous", dtype="bfloat16",
                prefill_ms=r["prefill_ms"],
                decode_ms_per_step=r["decode_ms_per_step"],
                decode_tokens_per_s=B * 1e3 / r["decode_ms_per_step"],
                launches=r.get("launches")))
            if be == "ref":
                out[-1]["kernel_vs_plain"] = compare(runs[("kernel", 0)], r)
            del eng
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        log("chip_smoke: src/repro_torch not found beside this script; run "
            "it from a checkout of the repository")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build as kbuild

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    detail = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    kbuild.build()
    detail["build_s"] = time.perf_counter() - t0
    for name, text in kbuild.BUILD_LOGS.items():
        log(f"--- nvcc {name}\n{text.strip()}")
    detail["build_logs"] = kbuild.BUILD_LOGS

    kernels = run(detail)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(detail) -> list:
    """The three phases; fills ``detail`` and returns the kernels entries."""
    import torch
    t0 = time.perf_counter()
    detail["kernel_phase"] = kernel_phase()
    detail["kernel_phase_s"] = time.perf_counter() - t0
    log(f"kernel phase ok in {detail['kernel_phase_s']:.1f} s")

    from repro_torch.configs import REGISTRY
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    t0 = time.perf_counter()
    qat = build(REGISTRY[ARCH]).init(seed=0, device=DEV)
    deployed = {b: to_serving_params(qat, b, device=DEV) for b in (8, 4)}
    del qat
    torch.cuda.empty_cache()
    tok = torch.randint(0, REGISTRY[ARCH].vocab, (B, P),
                        generator=torch.Generator(device=DEV)
                        .manual_seed(3), device=DEV, dtype=torch.int32)
    detail["init_deploy_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    detail["path_phase"] = path_phase(deployed, tok)
    detail["path_phase_s"] = time.perf_counter() - t0
    log(f"path phase ran in {detail['path_phase_s']:.1f} s")
    save_detail(detail)

    t0 = time.perf_counter()
    shapes = ((3072, 3072, 4), (3072, 8192, 2), (8192, 3072, 1))
    pm = [time_packed(m, k, n, bits) for bits in (8, 4) for m in (B, B * P)
          for k, n, _ in shapes]
    pa = [time_attention(bits, P + NEW // 2) for bits in (8, 4)]
    paths = time_path(deployed, tok)
    detail["time_phase"] = {"packed_matmul": pm, "paged_attention": pa,
                            "path": paths}
    detail["time_phase_s"] = time.perf_counter() - t0
    detail["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for p in paths:
        log(f"path int{p['bits']} kv{p['kv']} {p['backend']}/"
            f"{p['attn_backend']} {p['leg']}: prefill "
            f"{p['prefill_ms']:.2f} ms, decode "
            f"{p['decode_ms_per_step']:.3f} ms/step, "
            f"{p['decode_tokens_per_s']:.1f} tok/s")

    # one kernels entry per kernel: the main path's decode workload
    # (int8 weights, int8 KV): a layer's 7 projections at M=B, and one
    # layer's attention read at mid-decode fill.  Launches: the counted
    # bf16 int8/int8-KV contiguous run of the registered configuration
    per_layer = {(k, n): c for k, n, c in shapes}
    dec8 = [r for r in pm if r["bits"] == 8 and r["m"] == B]

    def layer_sum(key):
        return sum(r[key] * per_layer[(r["k"], r["n"])] for r in dec8)

    a8 = next(r for r in pa if r["bits"] == 8)
    launches = next(p for p in paths if p["bits"] == 8 and
                    p["backend"] == "kernel" and
                    p["leg"] == "contiguous")["launches"]
    errs = detail["kernel_phase"]
    kernels = [
        {"name": "packed_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/packed_matmul.cu",
         "replaces": "src/repro/kernels/packed_matmul.py:61",
         "launches": launches["packed_matmul"],
         "max_abs_err": max(c["err"] for c in errs["packed_matmul"]),
         "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
         "bound_ms": layer_sum("bound_ms"), "bound_by": "bytes",
         "library_ms": layer_sum("library_ms"),
         "workload": f"one decode layer's 7 projections, int8, M={B}, bf16 x"},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:117",
         "launches": launches["paged_attention"],
         "max_abs_err": max(c["err"] for c in errs["paged_attention"]),
         "ms": a8["ms"], "plain_ms": a8["plain_ms"],
         "bound_ms": a8["bound_ms"], "bound_by": a8["bound_by"],
         "library_ms": a8["library_ms"],
         "workload": f"one layer's decode read, int8 KV, B={B}, KV=32, "
                     f"dh=96, kv_len={a8['kv_len']}, page={a8['page']}"},
    ]
    detail["kernels"] = kernels
    save_detail(detail)
    check_path(detail["path_phase"], paths)
    return kernels


def save_detail(detail):
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(
        json.dumps(detail, indent=1, default=str))


if __name__ == "__main__":
    sys.exit(main())
