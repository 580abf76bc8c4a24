#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel), then:

1. kernel phase — holds each kernel against its plain PyTorch version on
   the card at the serving path's shapes, f32 and bf16 activations, with
   stated tolerances: ``packed_matmul``, ``paged_attention``,
   ``bitplane_matmul`` (mixed, fully masked and truncated draft masks, both
   scale modes, 9x8 blocks with byte-pad rows, ragged N) and ``pact_quant``.
   The two matmuls run every edge case in both of their regimes (byte
   streaming at M <= ``kernels.tiling.STREAM_MAX_M``, tensor-core tiles
   above), the phi3 shapes at the switch point, one past it and the verify
   M, and two launches on the same inputs must agree bit for bit;
2. path phase — serves full-width ``phi3-mini-3.8b`` (all 32 layers,
   random weights from seed 0) in float32.

   * Packed: deployed to int8 and int4, driven through the kernels
     (``backend="kernel", attn_backend="fused"``) twice, contiguous and
     paged (16-token pages, non-identity block table, per-slot
     ``prefill_at`` and decode index), then through the plain versions
     (``"ref", "ref"``).
   * Bit-plane: the same QAT tree with each block's bit-width drawn from
     {0..8} (``BW_PROB``: mixed masks, some blocks empty, as BWQ training
     leaves them),
     deployed to ``layout="bitplane"``; its composed weights must equal the
     packed deploy of the same tree element for element.  Driven through
     ``backend="bitplane", attn_backend="fused"`` and the plain versions.
   * Speculative: the bit-plane tree with ``speculate_planes`` and
     ``draft_gamma`` (4, 4) and (6, 3), against the non-speculative
     bit-plane drive; launch counts checked against the engine's round log.

   Every kernel drive has the launch counters zeroed just before and
   checked just after.  The registered quantization (8-bit PACT
   activations) with int8 and int4 KV caches rounds to integer levels, so
   two summation orders part at rounding ties.  Its check is the logit
   error at every step where the two runs' token prefixes still agree,
   against a limit set between a witness of that noise (the same plain
   path on the host CPU, weights dequantized once: same values, another
   summation order) and planted faults (rows read one block off, swapped
   nibbles, bit planes and sign planes read one position off), which must
   read above it.  With activation quantization off and a float32 KV cache
   nothing rounds to levels: logits within 1e-4 of the largest and greedy
   tokens identical, kernels vs plain versions, paged vs contiguous and
   speculative vs not;
3. time phase — in bfloat16 (the config's compute dtype): each kernel at
   the path's shapes (``bitplane_matmul`` also at the verify M) with CUDA
   events around back-to-back calls (``ms``: the host's cost a call shows
   where it exceeds the device's) and around the same calls queued behind
   a sleeping kernel (``device_ms``), with the host's enqueue time a call,
   beside its bound, its plain version and one PyTorch library call (both
   ways); and each path's prefill ms, decode ms/step and
   tokens/s, each run counted, with the speculative runs' acceptance
   rate.

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
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
PM_TOL_REL = 1e-4               # packed_matmul: |err| <= 1e-4 * max|ref|
BM_TOL_REL = 1e-4               # bitplane_matmul: the same rule
# pact_quant repeats the plain version's operations, each rounded to x's
# dtype, so only the last f32 bit may differ
PQ_TOL_REL = 1e-6
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
SPEC = ((4, 4), (6, 3))         # (speculate_planes, draft_gamma)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn`` in ms over ``iters`` back-to-back calls, between
    two CUDA events: the device time where a call's work outlasts its
    enqueue, else the host's Python and launch time a call.  Every ``ms``
    of the kernels line is this (as in every run since the port began)."""
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


def cuda_times(fn, iters=20, warmup=3):
    """``(ms, device_ms, host_ms)`` of ``fn``, each a mean over ``iters``
    calls: ``cuda_ms``; the device time alone, from the same calls queued
    behind a sleeping kernel that outlasts their enqueue (the card then
    runs them back to back, whatever each call costs the host); and the
    host's enqueue time a call, read meanwhile."""
    import torch
    ms = cuda_ms(fn, iters, warmup)
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2 GHz SM clock; twice the enqueue time, at most 0.2 s
    torch.cuda._sleep(int(2e9 * min(0.2, 2 * host_s * iters)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return ms, start.elapsed_time(end) / iters, host_ms


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


# (K, N, projections of that shape in a layer)
LAYER_SHAPES = ((3072, 3072, 4), (3072, 8192, 2), (8192, 3072, 1))
PHI3_SHAPES = tuple((k, n) for k, n, _ in LAYER_SHAPES)
D_MODEL = 3072


def kernel_phase():
    import torch
    from repro_torch.kernels import packed_matmul, paged_attention
    from repro_torch.kernels.ref import packed_matmul_ref, paged_attention_ref
    from repro_torch.models.attention import _as_pool, quantize_kv
    from repro_torch.kernels.tiling import STREAM_MAX_M as SWITCH_M
    from repro_torch.kernels.tiling import fit_block

    out = {"packed_matmul": [], "paged_attention": []}
    f32, bf16 = torch.float32, torch.bfloat16
    # f32 x at decode and prefill M; bf16 x (the bf16 path's operands) at
    # the path's own M = B (decode), B*5 (verify) and B*P (prefill), and at
    # the regime switch (STREAM_MAX_M streams, one more runs tensor tiles)
    cases = [(m, k, n, bits, 8, 128, None, f32)
             for bits in (8, 4) for m in (1, 16, B * P)
             for k, n in PHI3_SHAPES]
    cases += [(m, k, n, bits, 8, 128, None, bf16)
              for bits in (8, 4) for m in (B, SWITCH_M, SWITCH_M + 1, B * 5,
                                           B * P)
              for k, n in PHI3_SHAPES]
    # edge geometry, each at a stream M and a tensor M: 9x8 with odd Kp and
    # narrow x; 8x128 with narrow x and N padded from 200 to 256
    cases += [(m, 27, 44, b, 9, 8, 25, dt) for b in (8, 4)
              for m in (5, SWITCH_M + 5) for dt in (f32, bf16)]
    cases += [(m, 72, 200, b, 8, 128, 70, f32) for b in (8, 4)
              for m in (3, 40)]
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
    out["repeat"] = repeat_phase()

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
    out["bitplane_matmul"] = bitplane_kernel_phase()
    out["pact_quant"] = pact_kernel_phase()
    return out


def bitplane_case(m, k, n, n_bits, wbr=8, wbc=128, *, k_x=None,
                  x_dtype=None, n_cols=None, draft=0, per_layer=False,
                  seed=0):
    """Random bit-plane operands: every block's occupancy drawn from
    {0..n_bits} (some blocks fully masked), byte-pad rows past the WB grid
    left random (they must never be read), optionally truncated to the
    top ``draft`` planes (the speculative draft's masks, not a prefix), a
    per-layer scalar scale, ``n_cols`` < GC*wbc (ragged N) and x narrower
    than K."""
    import torch
    from repro_torch.kernels.ops import truncate_mask_topk
    g = torch.Generator(device=DEV).manual_seed(seed)
    gr, gc = -(-k // wbr), -(-n // wbc)
    rows8 = -(-gr * wbr // 8)
    ncol = gc * wbc if n_cols is None else n_cols

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=DEV,
                             dtype=torch.uint8)

    planes, sign = u8(n_bits, rows8, ncol), u8(rows8, ncol)
    occ = torch.randint(0, n_bits + 1, (gr, gc), generator=g, device=DEV)
    mask = (torch.arange(n_bits, device=DEV)[:, None, None] < occ).float()
    if draft:
        mask = truncate_mask_topk(mask, draft)
    if per_layer:
        scale = torch.rand((1,), generator=g, device=DEV) + 0.5
    else:
        scale = torch.rand((gr, gc), generator=g, device=DEV) * 1e-2 + 1e-3
    x = torch.randn((m, k if k_x is None else k_x), generator=g, device=DEV,
                    dtype=x_dtype or torch.float32)
    return x, planes, sign, mask, scale


def bitplane_kernel_phase():
    """``bitplane_matmul`` against its plain version, within
    ``BM_TOL_REL`` of the case's largest output (f32 sums of up to 8192
    terms in another order)."""
    import torch
    from repro_torch.kernels import bitplane_matmul
    from repro_torch.kernels.ref import bitplane_matmul_ref
    from repro_torch.kernels.tiling import STREAM_MAX_M as SWITCH_M
    f32, bf16 = torch.float32, torch.bfloat16
    sq, up, down = PHI3_SHAPES
    # (m, k, n, n_bits, wbr, wbc, options); M = B*5 is a verify pass
    cases = [(m, k, n, nb, 8, 128, dict(x_dtype=dt))
             for nb in (8, 4) for k, n in PHI3_SHAPES for m in (B, B * P)
             for dt in (f32, bf16)]
    cases += [(m, k, n, 8, 8, 128, dict(x_dtype=bf16))
              for m in (SWITCH_M, SWITCH_M + 1, B * 5) for k, n in PHI3_SHAPES]
    edge = [
        (B, *up, 8, 8, 128, dict(draft=4)),                   # draft masks
        (B * 5, *down, 8, 8, 128, dict(draft=6, x_dtype=bf16)),
        (B, *sq, 4, 8, 128, dict(draft=2)),
        (B, *sq, 8, 8, 128, dict(per_layer=True)),            # scalar scale
        (B * P, *up, 4, 8, 128, dict(per_layer=True, x_dtype=bf16)),
        (5, 63, 44, 8, 9, 8, dict(k_x=60)),     # 9x8: Kp 63 in 64, narrow x
        (33, 27, 44, 4, 9, 8, dict(k_x=25, draft=3)),
        (B, 256, 128, 8, 8, 128, dict(n_cols=100)),           # ragged N
        (7, 45, 48, 8, 9, 8, dict(n_cols=41, per_layer=True)),
        (3, 30, 20, 5, 3, 5, {}),    # a byte row spans three WB rows
        (B, 256, 256, 8, 8, 128, dict(k_x=60)),   # narrow x, fast geometry
    ]
    # each edge case also at an M of the other regime
    cases += edge + [(B * 5 if m <= SWITCH_M else B, *rest)
                     for m, *rest in edge]
    out = []
    for i, (m, k, n, nb, wbr, wbc, opt) in enumerate(cases):
        x, pl, sg, mk, sc = bitplane_case(m, k, n, nb, wbr, wbc, seed=i,
                                          **opt)
        got = bitplane_matmul(x, pl, sg, mk, sc, wbr=wbr, wbc=wbc)
        torch.cuda.synchronize()
        want = bitplane_matmul_ref(x, pl, sg, mk, sc, wbr, wbc)
        err = float((got - want).abs().max())
        tol = BM_TOL_REL * float(want.abs().max())
        out.append(dict(m=m, k=k, n=n, n_bits=nb, wbr=wbr, wbc=wbc,
                        **{a: str(b) for a, b in opt.items()}, err=err,
                        tol=tol))
        if not (err <= tol and got.shape == want.shape):
            raise AssertionError(f"bitplane_matmul case {out[-1]}")
    return out


def repeat_phase():
    """Two launches of each weight-matmul kernel on the same inputs give
    bit-identical outputs, in both regimes, with K split across blocks at
    decode M, the stream regime's largest M (4 row tiles) and verify M
    (the split-K sums are added in slice order, never by float
    atomics)."""
    import torch
    from repro_torch.kernels import bitplane_matmul, packed_matmul
    from repro_torch.kernels.tiling import STREAM_MAX_M, matmul_plan
    sq, up, down = PHI3_SHAPES
    out = []
    for m in (B, STREAM_MAX_M, B * 5, B * P):
        x, w, s = packed_case(m, *down, 8, 8, 128, x_dtype=torch.bfloat16)
        a = packed_matmul(x, w, s, bits=8)
        b = packed_matmul(x, w, s, bits=8)
        x, pl, sg, mk, sc = bitplane_case(m, *down, 8, x_dtype=torch.bfloat16)
        c = bitplane_matmul(x, pl, sg, mk, sc)
        d = bitplane_matmul(x, pl, sg, mk, sc)
        torch.cuda.synchronize()
        plan = matmul_plan(m, down[0], down[1], unit=8, wbr=8)
        out.append(dict(m=m, k=down[0], n=down[1], regime=plan.regime,
                        ksplit=plan.ksplit,
                        packed_identical=bool(torch.equal(a, b)),
                        bitplane_identical=bool(torch.equal(c, d))))
        # decode and verify split K across blocks; prefill need not
        if not (out[-1]["packed_identical"] and out[-1]["bitplane_identical"]
                and (plan.ksplit > 1 or m > B * 5)):
            raise AssertionError(f"repeated launches differ: {out[-1]}")
    return out


def pact_kernel_phase():
    """``pact_quant`` against its plain version at (B*P, D_MODEL) and a row
    count that is no multiple of a vector or a block, f32 and bf16."""
    import torch
    from repro_torch.kernels import pact_quant
    from repro_torch.kernels.ref import pact_quant_ref
    g = torch.Generator(device=DEV).manual_seed(4)
    beta = torch.tensor([1.5], device=DEV)
    out = []
    for rows in (B * P, B * P + 3):
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((rows, D_MODEL), generator=g, device=DEV)
                 * 2).to(dt)
            x[0, :3] = torch.tensor([1.5, -7.0, 0.0])    # at and past beta
            for bits in (2, 4, 8):
                got = pact_quant(x, beta, act_bits=bits)
                torch.cuda.synchronize()
                want = pact_quant_ref(x, beta, bits)
                err = float((got.float() - want.float()).abs().max())
                tol = PQ_TOL_REL * float(want.float().abs().max())
                out.append(dict(rows=rows, cols=D_MODEL, dtype=str(dt),
                                act_bits=bits, err=err, tol=tol))
                if not (err <= tol and got.dtype == dt):
                    raise AssertionError(f"pact_quant case {out[-1]}")
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
    read just after must equal ``expect`` (a dict, or a function of
    ``fn``'s result that gives it)."""
    import torch
    from repro_torch import kernels as tk
    tk.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    got = tk.launch_counts()
    want = expect(res) if callable(expect) else expect
    if got != want:
        raise AssertionError(f"launch counts {got}, expected {want}")
    res["launches"] = got
    return res


def expected_launches(n_layers, forwards, decode_steps,
                      matmul="packed_matmul"):
    """7 projections a layer a forward through ``matmul``; one fused
    attention read a layer a single-token forward; nothing else."""
    out = {"packed_matmul": 0, "paged_attention": n_layers * decode_steps,
           "bitplane_matmul": 0, "pact_quant": 0}
    out[matmul] = 7 * n_layers * forwards
    return out


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
# path phase, bit-plane and speculative
# ---------------------------------------------------------------------------

# (KV bits, activation bits) of the bit-plane drives: quantizer-free, then
# the registered quantization with int8 and int4 caches
BP_RUNS = ((32, 32), (8, 8), (4, 8))
# P(bit-width = 0..8) of a block of the bit-plane tree: mixed masks with
# some empty blocks.  A uniform draw clips most blocks so hard that this
# random model repeats one token per row and accepts every draft (on an
# H100; scripts/bitplane_probe.py draws), which would leave the rejection
# path untested.
BW_PROB = (1, 1, 1, 1, 1, 1, 6, 6, 6)
LAYER_LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                ("attn", "wo"), ("mlp", "w_gate"), ("mlp", "w_up"),
                ("mlp", "w_down"))


def deploy_bitplane(qat):
    """The QAT tree with every block's bit-width drawn from {0..8} with
    odds ``BW_PROB`` (seed 7; mixed masks with empty blocks, as BWQ
    training leaves a tree), deployed to ``layout="bitplane"``, bits 8.  Leaf by leaf and layer by
    layer, its composed weights must equal those of the packed deploy of
    the same tree, element for element.  Returns the tree and a record."""
    import torch
    from repro_torch.core.fakequant import FakeQuantTensor
    from repro_torch.serve.deploy import (bitplane_serving_compose,
                                          bitplane_stream_bytes,
                                          serving_compose, to_serving_params)
    g = torch.Generator(device=DEV).manual_seed(7)
    odds = torch.tensor(BW_PROB, dtype=torch.float32, device=DEV)
    layers = dict(qat["layers"])
    for sub, name in LAYER_LEAVES:
        fq = layers[sub][name]
        assert isinstance(fq, FakeQuantTensor)
        bw = torch.multinomial(odds, fq.bitwidth.numel(), replacement=True,
                               generator=g).reshape(fq.bitwidth.shape)
        layers[sub] = dict(layers[sub])
        layers[sub][name] = dataclasses.replace(
            fq, bitwidth=bw.to(fq.bitwidth.dtype))
    mixed = dict(qat, layers=layers)
    bp = to_serving_params(mixed, 8, layout="bitplane", device=DEV)
    rec = {"compose_equal_layers": 0, "leaves": {}}
    for sub, name in LAYER_LEAVES:
        packed = to_serving_params({"w": mixed["layers"][sub][name]}, 8,
                                   device=DEV)["w"]
        leaf = bp["layers"][sub][name]
        for i in range(leaf.planes.shape[0]):
            a = bitplane_serving_compose(leaf.layer(i), torch.float32)
            b = serving_compose(packed.layer(i), torch.float32)
            if not torch.equal(a, b):
                raise AssertionError(f"bit-plane compose != packed compose: "
                                     f"{name} layer {i}")
            rec["compose_equal_layers"] += 1
        del packed
        occ = leaf.mask.sum(dim=-3)
        rec["leaves"][name] = dict(
            mean_live_planes=float(occ.mean()),
            empty_block_share=float((occ == 0).float().mean()),
            stream_bytes=bitplane_stream_bytes(leaf),
            stored_bytes=leaf.planes.nbytes + leaf.sign.nbytes
            + leaf.mask.nbytes + leaf.scale.nbytes)
    return bp, rec


def bitplane_faults(bp):
    """Bit-plane trees that each carry one fault of the format in the
    first layer: (name, KV widths where the path check must catch it,
    tree).  Faults in ``wq`` (attention scores only), a single plane read
    off, and the draft read (masks truncated to the top 4 planes) are at
    or below the int4-KV limit; their readings show what the check
    resolves (the kernel phase holds each element)."""
    from repro_torch.kernels.ops import truncate_mask_topk

    def with_leaf(sub, name, edit):
        tree = dict(bp)
        tree["layers"] = dict(tree["layers"])
        tree["layers"][sub] = dict(tree["layers"][sub])
        sw = tree["layers"][sub][name]
        planes, sign, mask = sw.planes.clone(), sw.sign.clone(), \
            sw.mask.clone()
        edit(planes, sign, mask)
        tree["layers"][sub][name] = dataclasses.replace(
            sw, planes=planes, sign=sign, mask=mask)
        return tree

    def planes_off(p, s, m):
        p[0] = p[0].roll(1, dims=0)  # plane b read at bit position b+1

    def plane_off(p, s, m):
        p[0, 4] = p[0, 5]            # plane 4 read from bit position 5

    def sign_off(p, s, m):
        s[0] = s[0].roll(1, dims=0)  # sign plane read one byte row off

    def draft_read(p, s, m):
        m[0] = truncate_mask_topk(m[0], 4)

    return [
        ("first layer w_down: every plane read one bit position up", (8, 4),
         with_leaf("mlp", "w_down", planes_off)),
        ("first layer w_down: sign plane read one byte row off", (8, 4),
         with_leaf("mlp", "w_down", sign_off)),
        ("first layer wq: sign plane read one byte row off", (8,),
         with_leaf("attn", "wq", sign_off)),
        ("first layer w_down: plane 4 read from bit position 5", (8,),
         with_leaf("mlp", "w_down", plane_off)),
        ("first layer w_gate: masks truncated to the top 4 planes", (),
         with_leaf("mlp", "w_gate", draft_read)),
    ]


def bitplane_path_phase(bp, tok):
    """Drive the bit-plane tree through ``bitplane``/``fused`` (counted)
    and the plain versions, then the planted faults.  Returns the readings
    and the kernel drives (the speculative phase's baselines)."""
    import torch
    from repro_torch.serve.engine import ServeEngine

    L = api_for(8).cfg.n_layers
    runs, base, plain_act8 = [], {}, {}
    for kv, act in BP_RUNS:
        api = api_for(act)
        ker = ServeEngine(api, bp, kv_quant_bits=kv, backend="bitplane",
                          attn_backend="fused", device=DEV)
        ref = ServeEngine(api, bp, kv_quant_bits=kv, backend="ref",
                          attn_backend="ref", device=DEV)
        contig = counted(lambda: greedy(ker, tok, NEW),
                         expected_launches(L, NEW, NEW - 1,
                                           "bitplane_matmul"))
        plain = greedy(ref, tok, NEW)
        base[(kv, act)] = contig
        if act < 32:
            plain_act8[kv] = plain
        runs.append(dict(kv=kv, act_bits=act,
                         tokens=contig["tokens"].tolist(),
                         launches=contig["launches"],
                         kernel_vs_plain=compare(contig, plain)))
        log(f"bitplane kv{kv} act{act}: kernel vs plain err "
            f"{runs[-1]['kernel_vs_plain']['err']:.3g} tokens "
            f"{runs[-1]['kernel_vs_plain']['token_agreement']:.3f}")
        del ker, ref
    faults = []
    for name, catch_kv, tree in bitplane_faults(bp):
        for kv in (8, 4):
            eng = ServeEngine(api_for(8), tree, kv_quant_bits=kv,
                              backend="bitplane", attn_backend="fused",
                              device=DEV)
            reading = compare(greedy(eng, tok, 1), plain_act8[kv])
            faults.append(dict(name=name, kv=kv, must_catch=kv in catch_kv,
                               **reading))
            log(f"planted fault {name}, int{kv} KV: prefill logit err "
                f"{reading['err']:.3g}")
            del eng
        del tree
    torch.cuda.empty_cache()
    return {"runs": runs, "faults": faults}, base


def spec_expected(n_layers):
    """Launches of one speculative drive, from the engine's round log: a
    prefill, then per round ``gamma`` single-token draft forwards and one
    verify forward (or one plain decode step when ``gamma`` is 0); the
    fused attention kernel reads for single-token forwards only (verify
    and prefill go through gather)."""
    def expect(res):
        log_ = res["round_log"]
        forwards = 1 + sum(r["gamma"] + 1 for r in log_)
        single = sum(max(r["gamma"], 1) for r in log_)
        return expected_launches(n_layers, forwards, single,
                                 "bitplane_matmul")
    return expect


def spec_drive(eng, tok, new):
    """One counted-ready speculative drive through the engine's own
    ``speculative_generate``: tokens, the full-precision logits of each
    emitted token, the round log and host-clock ms."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = eng.speculative_generate({"tokens": tok}, new,
                                            keep_logits=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    log_ = eng.round_log
    drafted = sum(r["drafted"] for r in log_)
    accepted = sum(r["accepted_drafts"] for r in log_)
    return dict(tokens=toks.cpu(), logits=logits.cpu(), round_log=log_,
                ms=ms, rounds=len(log_), drafted=drafted,
                accepted_drafts=accepted,
                acceptance=accepted / drafted if drafted else None)


def speculative_phase(bp, tok, base):
    """Self-speculative greedy decoding on the bit-plane tree for each
    (speculate_planes, draft_gamma) of ``SPEC``, quantizer-free and with
    the registered quantization (int8 KV), against the non-speculative
    bit-plane drive of the same configuration."""
    from repro_torch.serve.engine import ServeEngine
    L = api_for(8).cfg.n_layers
    out = []
    for kv, act in ((32, 32), (8, 8)):
        for k, gamma in SPEC:
            eng = ServeEngine(api_for(act), bp, kv_quant_bits=kv,
                              backend="bitplane", attn_backend="fused",
                              speculate_planes=k, draft_gamma=gamma,
                              device=DEV)
            r = counted(lambda: spec_drive(eng, tok, NEW), spec_expected(L))
            out.append(dict(kv=kv, act_bits=act, k=k, gamma=gamma,
                            rounds=r["rounds"], drafted=r["drafted"],
                            accepted_drafts=r["accepted_drafts"],
                            acceptance=r["acceptance"],
                            launches=r["launches"],
                            spec_vs_plain=compare(r, base[(kv, act)])))
            log(f"speculative k={k} gamma={gamma} kv{kv} act{act}: "
                f"{r['rounds']} rounds, {r['accepted_drafts']}/"
                f"{r['drafted']} drafts accepted; vs non-speculative err "
                f"{out[-1]['spec_vs_plain']['err']:.3g}")
            del eng
    return out


def check_bitplane(res, spec, timed):
    """Bit-plane drives and speculative drives held as :func:`check_path`
    holds the packed ones; every planted fault marked to be caught reads
    above the limit."""
    import torch
    from repro_torch.configs import REGISTRY
    for run in res["runs"]:
        tag = ("bitplane", run["kv"], run["act_bits"])
        toks = torch.tensor(run["tokens"])
        assert toks.shape == (B, NEW), tag
        assert 0 <= int(toks.min()) <= int(toks.max()) < REGISTRY[ARCH].vocab
        c = run["kernel_vs_plain"]
        assert c["finite"], tag
        if run["act_bits"] >= 32 and run["kv"] >= 32:
            assert c["err"] <= EXACT_TOL_REL and c["first_diff"] is None, \
                (tag, c)
        else:
            assert c["err"] <= QUANT_TOL_REL[run["kv"]], (tag, c)
    for f in res["faults"]:
        if f["must_catch"]:
            assert f["err"] > QUANT_TOL_REL[f["kv"]], ("fault not caught", f)
    for s in spec:
        c = s["spec_vs_plain"]
        assert c["finite"] and s["rounds"] > 0, s
        if s["act_bits"] >= 32 and s["kv"] >= 32:
            assert c["err"] <= EXACT_TOL_REL and c["first_diff"] is None, s
        else:
            assert c["err"] <= QUANT_TOL_REL[s["kv"]], s
    for t in timed:
        for key in ("kernel_vs_plain", "spec_vs_bitplane"):
            if key in t:
                assert t[key]["err"] <= QUANT_TOL_REL[t["kv"]], t


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

    ms, dev, host = cuda_times(lambda: packed_matmul(x, *nxt(ws), bits=bits))
    plain = cuda_ms(lambda: packed_matmul_ref(x, *nxt(ws), bits), iters=5)
    lib, lib_dev, lib_host = cuda_times(lambda: torch.matmul(x, nxt(dense)))
    nbytes = w.nbytes + s.nbytes + x.nbytes + m * n * 4
    flops = 2.0 * m * k * n
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    return dict(m=m, k=k, n=n, bits=bits, ms=ms, device_ms=dev, host_ms=host,
                plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                library_host_ms=lib_host, bound_ms=bound, bound_by=by,
                bytes=nbytes, flops=flops)


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
    ms, dev, host = cuda_times(lambda: paged_attention(q, *nxt()[0], ident,
                                                       kv_len))
    plain = cuda_ms(lambda: paged_attention_ref(q, *nxt()[0], ident, kv_len))
    lib, lib_dev, lib_host = cuda_times(
        lambda: F.scaled_dot_product_attention(qb, *nxt()[1], attn_mask=mask))
    nbytes = B * kv_len_val * 32 * (2 * 96 * bits / 8 + 8) \
        + 2 * q.nbytes + B * 32 * 4
    flops = 4.0 * B * 32 * kv_len_val * 96
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    return dict(bits=bits, b=B, kv=32, dh=96, t=t, page=page,
                kv_len=kv_len_val, ms=ms, device_ms=dev, host_ms=host,
                plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                library_host_ms=lib_host, bound_ms=bound, bound_by=by,
                bytes=nbytes, flops=flops)


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


def time_bitplane(bp, sub, name, m):
    """``bitplane_matmul`` on one leaf of the mixed bit-plane tree at M=m,
    bf16 x, cycling through the 32 layers' views so each call reads its
    weights cold.  Bound: the bytes ``bitplane_stream_bytes`` bills (live
    planes, the sign of live blocks, mask bits, scales) plus x and the
    output over HBM, or the operations of the live blocks over the bf16
    peak, whichever is larger."""
    import torch
    from repro_torch.kernels import bitplane_matmul
    from repro_torch.kernels.ref import bitplane_matmul_ref
    from repro_torch.serve.deploy import (bitplane_serving_compose,
                                          bitplane_stream_bytes)
    leaf = bp["layers"][sub][name]
    views = [leaf.layer(i) for i in range(leaf.planes.shape[0])]
    k, n = leaf.shape[-2:]
    wbr, wbc = leaf.spec.wb_rows, leaf.spec.wb_cols
    x = torch.randn((m, k), device=DEV, dtype=torch.bfloat16,
                    generator=torch.Generator(device=DEV).manual_seed(5))
    it = {"i": 0}

    def nxt(seq):
        it["i"] = (it["i"] + 1) % len(seq)
        return seq[it["i"]]

    def args(v):
        return v.planes, v.sign, v.mask, v.scale

    ms, dev, host = cuda_times(lambda: bitplane_matmul(
        x, *args(nxt(views)), wbr=wbr, wbc=wbc))
    plain = cuda_ms(lambda: bitplane_matmul_ref(x, *args(nxt(views)), wbr,
                                                wbc), iters=3, warmup=1)
    dense = rotating(lambda: bitplane_serving_compose(nxt(views),
                                                      torch.bfloat16),
                     2 * k * n)
    lib, lib_dev, lib_host = cuda_times(lambda: torch.matmul(x, nxt(dense)))
    del dense
    stream = sum(bitplane_stream_bytes(v) for v in views) / len(views)
    live = float((leaf.mask.sum(dim=-3) > 0).float().mean())
    nbytes = stream + x.nbytes + m * n * 4
    flops = 2.0 * m * k * n * live
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    return dict(leaf=name, m=m, k=k, n=n, ms=ms, device_ms=dev,
                host_ms=host, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, library_host_ms=lib_host,
                bound_ms=bound, bound_by=by, bytes=nbytes,
                stream_bytes=stream, live_block_share=live, flops=flops)


def time_pact():
    """``pact_quant`` at (B*P, D_MODEL) bf16, 8-bit: one read and one write
    of x bound it; the library call is PyTorch's fake quantizer with the
    same levels (scale b/L, zero point 0, range [-L, L])."""
    import torch
    from repro_torch.kernels import pact_quant
    from repro_torch.kernels.ref import pact_quant_ref
    x = (torch.randn((B * P, D_MODEL), device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(6))
         * 2).to(torch.bfloat16)
    b, levels = 1.5, 127
    beta = torch.tensor([b], device=DEV)
    ms, dev, host = cuda_times(lambda: pact_quant(x, beta, act_bits=8),
                               iters=50)
    plain = cuda_ms(lambda: pact_quant_ref(x, beta, 8), iters=50)
    lib, lib_dev, lib_host = cuda_times(
        lambda: torch.fake_quantize_per_tensor_affine(
            x, b / levels, 0, -levels, levels), iters=50)
    nbytes = 2 * x.nbytes + beta.nbytes
    ops = 6.0 * x.numel()        # clip (2), divide, scale, round, rescale
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS \
        else "operations"
    return dict(rows=B * P, cols=D_MODEL, dtype="bfloat16", act_bits=8, ms=ms,
                device_ms=dev, host_ms=host, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, library_host_ms=lib_host,
                bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)


def time_bitplane_path(bp, tok):
    """The registered bf16 path on the bit-plane tree, int8 KV: through
    ``bitplane``/``fused`` (counted) and the plain versions, then
    speculative decoding for each of ``SPEC`` (counted against its round
    log).  A speculative drive's decode time is its host-clock total less
    one separately timed prefill."""
    import torch
    from repro_torch.serve.engine import ServeEngine

    api = api_for(8, dtype="bfloat16")
    L = api.cfg.n_layers
    kv = 8
    out, runs = [], {}
    for be, ab in (("bitplane", "fused"), ("ref", "ref")):
        eng = ServeEngine(api, bp, kv_quant_bits=kv, backend=be,
                          attn_backend=ab, device=DEV)
        warm = eng.generate({"tokens": tok}, max_new=4).cpu()
        if be == "ref":
            r = greedy(eng, tok, NEW)
        else:
            r = counted(lambda: greedy(eng, tok, NEW),
                        expected_launches(L, NEW, NEW - 1,
                                          "bitplane_matmul"))
        assert torch.equal(warm, r["tokens"][:, :4]), ("generate vs loop",
                                                       be)
        runs[be] = r
        out.append(dict(bits=8, kv=kv, backend=be, attn_backend=ab,
                        leg="bitplane", dtype="bfloat16",
                        prefill_ms=r["prefill_ms"],
                        decode_ms_per_step=r["decode_ms_per_step"],
                        decode_tokens_per_s=B * 1e3 / r["decode_ms_per_step"],
                        launches=r.get("launches")))
        if be == "ref":
            out[-1]["kernel_vs_plain"] = compare(runs["bitplane"], r)
        del eng
    for k, gamma in SPEC:
        eng = ServeEngine(api, bp, kv_quant_bits=kv, backend="bitplane",
                          attn_backend="fused", speculate_planes=k,
                          draft_gamma=gamma, device=DEV)
        eng.generate({"tokens": tok}, max_new=4)                  # warm up
        r = counted(lambda: spec_drive(eng, tok, NEW), spec_expected(L))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill({"tokens": tok}, extra_slots=NEW + gamma + 1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        decode_ms = r["ms"] - prefill_ms
        out.append(dict(bits=8, kv=kv, backend="bitplane",
                        attn_backend="fused", leg=f"speculative k={k} "
                        f"gamma={gamma}", dtype="bfloat16", k=k,
                        gamma=gamma, prefill_ms=prefill_ms,
                        decode_ms_per_step=decode_ms / (NEW - 1),
                        decode_tokens_per_s=B * (NEW - 1) * 1e3 / decode_ms,
                        rounds=r["rounds"], drafted=r["drafted"],
                        accepted_drafts=r["accepted_drafts"],
                        acceptance=r["acceptance"], launches=r["launches"],
                        spec_vs_bitplane=compare(r, runs["bitplane"])))
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
    bp, detail["bitplane_deploy"] = deploy_bitplane(qat)
    del qat
    torch.cuda.empty_cache()
    tok = torch.randint(0, REGISTRY[ARCH].vocab, (B, P),
                        generator=torch.Generator(device=DEV)
                        .manual_seed(3), device=DEV, dtype=torch.int32)
    detail["init_deploy_s"] = time.perf_counter() - t0
    log(f"deployed (bit-plane compose check included) in "
        f"{detail['init_deploy_s']:.1f} s")

    t0 = time.perf_counter()
    detail["path_phase"] = path_phase(deployed, tok)
    detail["path_phase_s"] = time.perf_counter() - t0
    log(f"packed path phase ran in {detail['path_phase_s']:.1f} s")
    save_detail(detail)
    t0 = time.perf_counter()
    detail["bitplane_phase"], base = bitplane_path_phase(bp, tok)
    detail["bitplane_phase_s"] = time.perf_counter() - t0
    log(f"bit-plane path phase ran in {detail['bitplane_phase_s']:.1f} s")
    t0 = time.perf_counter()
    detail["speculative_phase"] = speculative_phase(bp, tok, base)
    detail["speculative_phase_s"] = time.perf_counter() - t0
    del base
    log(f"speculative phase ran in {detail['speculative_phase_s']:.1f} s")
    save_detail(detail)

    t0 = time.perf_counter()
    pm = [time_packed(m, k, n, bits) for bits in (8, 4) for m in (B, B * P)
          for k, n, _ in LAYER_SHAPES]
    pa = [time_attention(bits, P + NEW // 2) for bits in (8, 4)]
    bm = [time_bitplane(bp, sub, name, m) for m in (B, 4 * B, B * 5, B * P)
          for sub, name in LAYER_LEAVES]
    pq = time_pact()
    paths = time_path(deployed, tok)
    bp_paths = time_bitplane_path(bp, tok)
    detail["time_phase"] = {"packed_matmul": pm, "paged_attention": pa,
                            "bitplane_matmul": bm, "pact_quant": pq,
                            "path": paths, "bitplane_path": bp_paths}
    detail["time_phase_s"] = time.perf_counter() - t0
    detail["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for p in paths + bp_paths:
        log(f"path int{p['bits']} kv{p['kv']} {p['backend']}/"
            f"{p['attn_backend']} {p['leg']}: prefill "
            f"{p['prefill_ms']:.2f} ms, decode "
            f"{p['decode_ms_per_step']:.3f} ms/step, "
            f"{p['decode_tokens_per_s']:.1f} tok/s")

    # one kernels entry per kernel: the main path's decode workload
    # (int8 weights, int8 KV): a layer's 7 projections at M=B, and one
    # layer's attention read at mid-decode fill.  Launches: the counted
    # bf16 int8/int8-KV contiguous run of the registered configuration
    # (bit-plane run for bitplane_matmul; pact_quant is on no model path)
    per_layer = {(k, n): c for k, n, c in LAYER_SHAPES}
    dec8 = [r for r in pm if r["bits"] == 8 and r["m"] == B]
    dec_bp = [r for r in bm if r["m"] == B]

    def layer_sum(key):
        return sum(r[key] * per_layer[(r["k"], r["n"])] for r in dec8)

    def bp_sum(key):
        return sum(r[key] for r in dec_bp)

    a8 = next(r for r in pa if r["bits"] == 8)
    launches = next(p for p in paths if p["bits"] == 8 and
                    p["backend"] == "kernel" and
                    p["leg"] == "contiguous")["launches"]
    bp_launches = next(p for p in bp_paths
                       if p["backend"] == "bitplane" and "k" not in p
                       )["launches"]
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
         "device_ms": layer_sum("device_ms"),
         "library_device_ms": layer_sum("library_device_ms"),
         "workload": f"one decode layer's 7 projections, int8, M={B}, bf16 x"},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:117",
         "launches": launches["paged_attention"],
         "max_abs_err": max(c["err"] for c in errs["paged_attention"]),
         "ms": a8["ms"], "plain_ms": a8["plain_ms"],
         "bound_ms": a8["bound_ms"], "bound_by": a8["bound_by"],
         "library_ms": a8["library_ms"],
         "device_ms": a8["device_ms"],
         "library_device_ms": a8["library_device_ms"],
         "workload": f"one layer's decode read, int8 KV, B={B}, KV=32, "
                     f"dh=96, kv_len={a8['kv_len']}, page={a8['page']}"},
        {"name": "bitplane_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
         "replaces": "src/repro/kernels/bitplane_matmul.py:65",
         "launches": bp_launches["bitplane_matmul"],
         "max_abs_err": max(c["err"] for c in errs["bitplane_matmul"]),
         "ms": bp_sum("ms"), "plain_ms": bp_sum("plain_ms"),
         "bound_ms": bp_sum("bound_ms"),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in dec_bp) else "operations",
         "library_ms": bp_sum("library_ms"),
         "device_ms": bp_sum("device_ms"),
         "library_device_ms": bp_sum("library_device_ms"),
         "workload": f"one decode layer's 7 projections, mixed bit-plane "
                     f"(bits 8, per-block widths 0..8), M={B}, bf16 x"},
        {"name": "pact_quant", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pact_quant.cu",
         "replaces": "src/repro/kernels/pact_kernel.py:27",
         "launches": bp_launches["pact_quant"],
         "max_abs_err": max(c["err"] for c in errs["pact_quant"]),
         "ms": pq["ms"], "plain_ms": pq["plain_ms"],
         "bound_ms": pq["bound_ms"], "bound_by": pq["bound_by"],
         "library_ms": pq["library_ms"],
         "device_ms": pq["device_ms"],
         "library_device_ms": pq["library_device_ms"],
         "workload": f"({B * P}, {D_MODEL}) bf16, 8-bit; on no model path"},
    ]
    detail["kernels"] = kernels
    save_detail(detail)
    check_path(detail["path_phase"], paths)
    check_bitplane(detail["bitplane_phase"], detail["speculative_phase"],
                   bp_paths)
    return kernels


def save_detail(detail):
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(
        json.dumps(detail, indent=1, default=str))


if __name__ == "__main__":
    sys.exit(main())
