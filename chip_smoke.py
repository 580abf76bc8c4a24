#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel), then:

1. kernel phase — holds each kernel against its plain PyTorch version on
   the card at the serving path's shapes, f32 and bf16 activations, with
   stated tolerances: ``packed_matmul``, ``paged_attention`` (the decode
   cache; long context, ~4096 of 4224 positions, in the contiguous
   identity view and in a shuffled 16-token pool with trash-page tails,
   for int8, int4, bf16 and f32 pools; kv_len 1 and on split boundaries;
   windows that empty the leading splits; G=4 with softcap; G=12, two
   query-head groups, with softcap; the MoE heads, the enc-dec
   decoder's 16 KV heads at d_head 64, qwen2-vl's 2 KV heads at G=6
   and zamba2's 32 at d_head 64),
   ``bitplane_matmul`` (mixed, fully masked and truncated draft masks, both
   scale modes, 9x8 blocks with byte-pad rows, ragged N) and ``pact_quant``.
   The two matmuls run every edge case in both of their regimes (byte
   streaming at M <= ``kernels.tiling.STREAM_MAX_M``, tensor-core tiles
   above), the phi3 shapes at the switch point, one past it, the verify M
   and the scheduler's M (decode, chunk, narrowest prompt; the
   speculative drive's draft, verify and prompt M), the served
   families' new shapes (``FAMILY_SHAPES``: N = 64 and 256, K = 7168 and
   8960) and whole-layer blocks taller than the x stage (``WB_TALL``,
   wbr = 3072: the stream plan cuts a block); two launches on the same
   inputs must agree bit for bit (the matmuls, and ``paged_attention``
   at kv_len 144 and 4096);
2. path phase — serves full-width ``phi3-mini-3.8b`` (its first
   ``PHI3_DEPTH`` = 8 of 32 layers, as in every phase through the lint
   and time phases; random weights from seed 0) in float32.

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
   summation order; its first ``WITNESS_NEW`` tokens) and planted faults
   (rows read one block off, swapped nibbles, bit planes and sign planes
   read one position off), which must read above it.  With activation
   quantization off and a float32 KV cache nothing rounds to levels:
   logits within 1e-4 of the largest and greedy
   tokens identical, kernels vs plain versions, paged vs contiguous and
   speculative vs not;
3. time phase — in bfloat16 (the config's compute dtype): each kernel at
   the path's shapes (``bitplane_matmul`` also at the verify M;
   ``paged_attention`` also at kv_len 1040 and 4096, and in a 16-token
   pool at 4096; ``pact_quant`` also at 16384 rows, past L2) with CUDA
   events around back-to-back calls (``ms``: the host's cost a call shows
   where it exceeds the device's) and around the same calls queued behind
   a sleeping kernel (``device_ms``), with the host's enqueue time a call,
   beside its bound, its plain version and one PyTorch library call (both
   ways), the two matmuls also at the scheduler's M (packed: decode and
   chunk; bit-plane: draft and verify, f32 x); and each path's prefill
   ms, decode ms/step and
   tokens/s, each run counted, with the speculative runs' acceptance
   rate.

4. scheduler phase — request-level serving through the launcher's
   ``main`` (``python -m repro_torch.launch.serve``), in process, on
   full-width phi3 in bfloat16 with int8 weights, 8-bit activations and an
   int8 KV cache through the kernels: 24 requests (prompts 64-1920 wide,
   half behind a common 512-token system prompt, budgets 16-128, arriving
   every 2 ticks), 8 slots, 16-token pages, 256-token chunks, priorities
   {0, 1}, prefix cache, overcommit 1.5 over a pool that forces parking.
   Every request finishes with its budget; ``validate()`` is empty every
   16 ticks and at the end; the pool drains; preemptions, resumes and
   prefix hits occur; the launches equal those of the scheduler's tick
   log; in every drive the first weight-matmul call at each M is held
   against the plain version.  One decode tick's layer-0 attention state
   (ragged fill levels, free rows, shared pages, capacity past 1024) is
   captured and held against the plain version, twice bit for bit, and
   timed against the same tick with the free rows' kv_len at 0, the plain
   version and SDPA.  Ticks are timed from outside the scheduler, tokens/s
   over the whole run.  The same trace with
   quantizers off in float32 keeps the ledger and, against one-shot runs
   at B=1 of 8 of its requests, parts only at near-tied steps (a top-two
   gap under ``EXACT_TOL_REL``).  A speculative drive on the bit-plane
   tree (k=6, γ=3, quantizers off) gives the non-speculative drive's
   tokens.

5. lint phase — the serving-graph lint (``repro_torch.analysis.
   lint_engine``) on full-width phi3 over the trees the earlier phases
   built, nothing new deployed: packed int8 and int4 under ``kernel`` /
   ``fused`` with int8 and int4 KV, contiguous and paged (16-token
   pages, 256-token chunks), the bit-plane tree under ``bitplane`` and
   the int8 tree through the plain versions (``ref`` / ``ref``).  Each
   must pass with the rules the reference's lint reports on the same
   configuration (``LINT_RULES``), and each recorded call's kernel ops
   (the wrappers' boundary) must equal the launches its wrappers counted
   over that call.  Four planted faults must fail: one leaf dequantized
   in Python inside prefill, a decode forced to ``gather`` under
   ``fused``, a decode that clones its state, and the packed tree under
   ``bitplane`` through the lint launcher (exit 1).  The lint launcher
   (``repro_torch.launch.lint.main``) on the int8 tree exits 0 with
   ``"ok": true``.  The scheduler phase's 24-request drive runs with
   ``--lint`` (its lint's launches zeroed before the drive's,
   :class:`LintGuard`), and each later serving phase lints its int8
   engine (granite, seamless, qwen2-vl, rwkv6, zamba2) at its depth.
   Each lint's seconds and the phase's are logged and recorded.

6. MoE phase — with the phi3 trees freed, the MoE family at full width:
   granite-moe-3b-a800m (its first 4 of 32 layers, ``MOE_DEPTH``, 40
   experts top-8, random weights
   from seed 0, bf16) deployed packed int8 and int4 and as mixed-width bit
   planes (its composed weights equal the packed deploy's), served
   one-shot (B=4, 128-token prompts, 32 new, 16-token pages) through the
   kernels against the plain versions under the exact ``ragged``
   dispatch: quantizers off in f32 (tokens identical, logits within
   ``EXACT_TOL_REL``), 8-bit activations with int8 and int4 KV in bf16
   (``QUANT_TOL_REL``), and the bit-plane tree through ``bitplane_matmul``
   (its legs, and the ``capacity`` ones below, on the first 4 layers).
   The router's top-k is a discrete choice: where the two runs' sums put
   a token across a near-tie they would route it to other experts, so
   each plain run takes its kernel run's routing (:class:`RouteTrace`),
   and the choices its own router would have flipped are counted with
   their router gaps.  The
   ``capacity`` dispatch (8 new tokens, contiguous) runs every expert
   through ``packed_matmul`` (M=8 at decode, 208 at prefill).  Every
   drive is counted (:func:`layer_matmuls`).  The ragged grouped product
   is timed a layer and whether a row's bits depend on its group's size
   recorded; ``packed_matmul`` is timed at the expert shapes.  The
   scheduler trace runs through the launcher on the MoE tree (bf16 int8 /
   int8 KV, then quantizers off in f32 against one-shot runs).  Last,
   llama4-scout-17b-a16e at full width cut to 2 layers (top-1 routing, a
   shared expert, G=5 at d_head 128, a 202048-wide tied head), quantizers
   off and on.

7. enc-dec phase — with the MoE trees freed, seamless-m4t-large-v2 at
   full width, cut to its first 6 encoder and 6 decoder layers
   (``ENCDEC_DEPTH``; 24 + 24 registered; d_model 1024,
   vocab 256206, random weights from seed 0), deployed packed int8 and
   int4 and as mixed-width bit planes, each prompt 128 tokens over 256
   frames (0.1 x normal), one-shot B=4, 32 new, through the kernels
   against the plain versions: quantizers off in f32 (tokens identical,
   logits within ``EXACT_TOL_REL``; also through a 16-token page pool
   with a non-identity table, tokens equal), bf16 with int8 and int4 KV
   (``QUANT_TOL_REL``), the bit-plane tree in f32.  Every drive is
   counted (the encoder once a prompt row); its first matmul call at
   each shape (the cross K/V projections at M = 1024 among them) and its
   first attention read are held against the plain versions; a planted
   fault (two slots' encoder outputs swapped after the prefill) must
   read above the int8 limit.  One decode step is profiled and its
   device time split by kernel; ``packed_matmul`` is timed at M = 1024
   (1024->1024, 1024->8192), ``paged_attention`` at the decoder's head.
   The scheduler trace runs through the launcher with 256 frames a
   request (prefix cache warned off, parking), then quantizers off in
   f32 against one-shot reruns, every one identical.

8. families phase — with the enc-dec trees freed, the last three model
   families at full width and about a quarter of their depth
   (``FAMILY_DEPTH``), one at a time: qwen2-vl-2b (6 of 28 layers,
   M-RoPE, 256 random vision embeds a prompt, 2 KV heads at G=6),
   rwkv6-1.6b (6 of 24 layers, no KV cache) and zamba2-1.2b (8 of 38
   Mamba-2 layers, one shared attention + MLP block every 6, a 2-layer
   tail), random weights from seed
   0, deployed packed int8 and as mixed-width bit planes.  One-shot B=4 x
   128 tokens, 32 new, through the kernels against the plain versions:
   quantizers off in f32 (tokens identical, logits within
   ``EXACT_TOL_REL``; also through a 16-token pool where the family has
   KV), the registered bf16 config with int8 KV (8-bit PACT for
   qwen2-vl; ``QUANT_TOL_REL[8]``) and one planted fault a family (every
   layer's output projection read one WB row off) above that limit, the
   bit-plane tree in f32 (8 new).  Every drive counted
   (:func:`family_launches`), its first matmul at each shape and first
   attention read held against the plain versions; one decode step
   profiled (matmuls, attention, the scans and small ops, idle share).
   The scheduler trace (12 requests, prompts 64-1024 tokens, some off
   the scan chunks so the per-token scans run; qwen2-vl chunked at 256,
   rwkv6 unpaged, zamba2 paged with overcommit 1.5, parking its
   recurrent rows) through the launcher, then quantizers off in f32
   against one-shot reruns.  ``packed_matmul`` is timed at the families'
   new shapes, ``paged_attention`` at the two new heads.

9. CNN phase — the paper's own pipeline through the CIFAR launcher's
   ``main`` (``python -m repro_torch.launch.cifar``), in process:
   ResNet-20 and VGG-16-BN at full width on 32x32x3 images, bit-plane
   mode at the paper's 9x8 blocks (and BSQ, one block a layer), trained
   4 steps at B=64 with maintenance twice (every step finite; the frozen
   leaves moved by SGD's weight decay alone, bit for bit; each
   maintenance monotone with binary planes; the bit-width maps off 8).
   The BWQ tree deployed packed int8, int4 and as bit planes runs B=128
   images through the kernels (``packed_matmul``, ``bitplane_matmul``:
   M = B x H x W up to 131,072, K from 16 to 4,608, N from 16 to 512)
   against the plain versions: activations unquantized (logits within
   ``EXACT_TOL_REL``, argmax equal on every image whose plain top-two
   gap exceeds twice that limit; the near-tied images are counted) and
   with 8-bit PACT (within
   ``CNN_QUANT_TOL_REL``, set between a host-CPU witness and planted
   faults, one corrupted block in each layout); launches counted (21
   weight matmuls a ResNet-20 forward, 13 a VGG-16); each call's first
   shape held against the plain version and timed beside its bound and
   ``torch.matmul``; forwards timed against the plain versions and the
   cuDNN conv; one ResNet-20 step on the card against the host, in f32
   with the card's ReLU masks forced to the host's (the flips counted)
   and in float64 with its own, each held to ``GRAD_TOL_REL``; the
   BWQ-H simulator's speedup and energy against ISAAC (a ReRAM model's
   outputs, not measurements).

10. train phase — with every serving tree freed, BWQ-A training through
   the train launcher's ``main`` (``python -m repro_torch.launch.train``),
   in process: full-width phi3 (32 layers, bf16 compute, f32 master
   weights, 8x128 blocks, 8-bit PACT, remat) in fake mode, 8 steps of
   4 x 256 tokens, maintenance and an alpha round every 4.  Every step's
   loss and gradient norm finite, the frozen leaves (scale, bit-width)
   unchanged bit for bit across each step, each maintenance leaving no
   LUT larger and every weight on its grid.  The trained tree is deployed
   to int8 and served greedily through the kernels against the plain
   versions (launches counted, ``QUANT_TOL_REL``).  One f32 step (2
   layers, activations unquantized) on the card and on the host CPU from
   the same tree and batch: the loss within 1e-4 relative, every gradient
   leaf within ``GRAD_TOL_REL``.  Bit-plane mode at 2 layers: 2 steps, a
   maintenance (requantize + adjust_precision), a ``layout="bitplane"``
   deploy served through ``backend="bitplane"`` against the plain
   versions.  Step ms (median after the first), tokens/s, maintenance ms,
   deploy s, peak memory, bit-width and compression are reported.

11. train families phase — with the trained phi3 trees freed, BWQ-A
   training of the five other families at full width, bf16, fake mode,
   8-bit PACT, remat, depth cut (``TF_ARCHS``): granite-moe-3b-a800m at
   4 layers, seamless-m4t-large-v2 at 6 + 6, qwen2-vl-2b at 4, rwkv6-1.6b
   at 4, zamba2-1.2b at 12 (two shared calls).  3 steps of 4 x 256
   tokens (qwen2-vl: 256 vision embeds + 256 tokens; seamless: 256
   frames), maintenance and an alpha round at step 2, through the train
   launcher's ``main`` (seamless, which the launcher refuses for want of
   frames, through ``Trainer`` on ``lm_batch_for`` batches), checked as
   in the train phase (granite's aux term finite and positive).  Each
   trained tree deployed packed int8 and served greedily (B=4 x 64
   tokens, 8 new) through the kernels against the plain versions,
   launches counted (granite's plain run on the kernel run's routing;
   zamba2 in f32, ``FAMILY_F32_TOL``; the rest bf16,
   ``QUANT_TOL_REL[8]``).  granite also trains 2 bit-plane steps at 2
   layers, served through ``bitplane_matmul``, and ``kernels.ops``'
   ``bwq_dense_packed`` / ``bwq_dense_bitplane`` run on one trained
   matrix against the plain versions.  One f32 step (2 layers; zamba2 4
   at period 2; B=2 x 64) on the card and on the host CPU: the loss
   within 1e-5, each gradient leaf within ``GRAD_TOL_REL``, beside the
   card's own step on the batch's rows swapped (the witness).

12. deploy phase — from a trainer's checkpoint to budget-autotuned
   bit-plane serving, full-width phi3 cut to ``DEPLOY_LAYERS`` = 2 layers
   (a 2-layer TrainState is ~3.9 GB a save), under
   ``chiprun_out/deploy_ckpt`` (free space checked first, removed at the
   end).  The train launcher's trainer (``--ckpt-dir``: a save every
   step) crashed before data step 3 and restarted by
   ``run_with_restarts`` ends bit for bit as the uninterrupted launcher
   run (saves and the restore timed); ``validate_checkpoint`` clean on
   the save, CK2 / CK3 on a small save torn and with debris beside it.
   The serve launcher (its config cut to 2 layers) cold-starts the
   checkpoint to bit planes (bit for bit the live deploy of the restored
   params; peak host bytes below the dense tree's), autotunes per-block
   occupancies under a budget of the fixed bytes plus
   ``DEPLOY_BUDGET_SHARE`` of the plane bytes, calibrated on its prompt
   batch (AT1 and SW/BP clean; the sorted search's occupancies equal
   the heap's on the card's scores), and serves the tuned tree through
   the scheduler (4 requests of 256 tokens, 16 new, 16-token pages,
   256-token chunks) through ``bitplane_matmul`` and ``paged_attention``
   and through the plain versions: quantizers off in f32 (tokens
   identical; one-shot logits within ``EXACT_TOL_REL``) and 8-bit PACT
   with int8 KV in bf16 (one-shot within ``QUANT_TOL_REL``), launches
   against the tick logs.  The engine refuses a tree with one
   non-prefix mask (BP2); the packed cold start serves one decode step
   through ``packed_matmul``.  ``bitplane_matmul`` is timed over a
   layer at decode M on the tuned tree and the full one.

13. mesh phase — serving under a device mesh: two gloo ranks on the one
   card (``mesh_rank``, one process each; NCCL refuses two ranks on one
   device), meshes (1, 2) and (2, 1).  phi3 cut to ``MESH_DEPTH`` = 8
   layers, packed int8, 16-token pages, fused attention: one shot in f32
   without quantizers (tokens identical to the single-process engine)
   and in bf16 with 8-bit activations and int8 KV (logits within
   ``QUANT_TOL_REL``), on (2, 1) shorter (``MESH_DP_NEW`` new tokens,
   ``MESH_DP_DEPTH`` = 2 layers); the scheduler
   drive (on (2, 1) its first ``MESH_DP_REQUESTS`` requests at half their
   budgets); a bit-plane deploy's one shot and its speculative drive
   (``MESH_SPEC``, draft and verify through ``bitplane_matmul`` on the
   shards) on (1, 2); granite-moe cut to ``MESH_MOE_DEPTH`` = 2, expert
   parallel on (1, 2), on the single run's routing; qwen2-vl (4 layers,
   256 vision embeds a prompt), rwkv6 (4; also on (2, 1), its recurrent
   rows split over data), zamba2 (8: one shared-block call and the tail;
   its f32 one shot also paged on (2, 1)) and seamless (2 + 2, ``S_ENC``
   frames), one shot on (1, 2) in both configs (``MESH_FAMILY_DEPTH``),
   rwkv6's and zamba2's quantizer-free logits held to
   ``MESH_F32_TOL_REL``, which a planted fault (zamba2's shared block
   on whole heads) must fail.  Each rank's launches equal the single
   process's (a speculative drive's, its rounds'); every launch's
   (M, K, N) is its shard's (N/2 column-parallel, K/2 row-parallel on
   (1, 2)), and the first at each shape is held against the plain
   version on the same shard.  The collectives gloo takes on the card's
   tensors are probed and timed.

14. mesh train phase — BWQ-A training under a process mesh
   (``mesh_train_phase``): full-width phi3 cut to ``MT_LAYERS`` = 2, f32,
   fake quantization with PACT off, a global batch of 4 x 128 from the
   train launcher's stream, AdamW on a cosine schedule over 6 steps,
   maintenance and an alpha round every 2.  Here, the single-process
   baseline (6 steps; its params saved).  Then two gloo ranks on the card
   (``mesh_train_rank``) on (2, 1): ``compressed_all_reduce`` of layer
   0's ``wq`` gradient over ``data`` equals ``compressed_sum`` and sends
   int8; a batch with an uneven mask gives the single process's loss and
   gradient norm within ``MT_LOSS_TOL_REL``, and with the ranks' shares
   forced equal (a planted fault) reads above it; steps 1-4 with a
   checkpoint every 2 and a crash before data step 3
   (``run_with_restarts`` resumes from step 2).  Then two fresh ranks on
   (1, 2) restore step 4 (elastic restore) and train to 6.  Every step's
   loss within
   ``MT_LOSS_TOL_REL`` of the single run's, every rank's state one
   digest (all-gathered), the (1, 2) params and every step's gradient
   norm within ``MT_LEAF_TOL`` of the single run's or ``MT_WITNESS_X``
   times a witness's distance (the single run on reversed rows:
   ``mt_param_faults``), the saves one shard file a data (step 4) and a
   model coordinate (step 6), CK-clean.  The step-6 checkpoint is
   cold-started to packed int8 on each rank and served one shot (4 x 64,
   8 new, 16-token pages, fused attention) on (1, 2) through
   ``packed_matmul`` and ``paged_attention`` on each rank's shards:
   quantizers off in f32, tokens identical to the single process's cold
   start; bf16 with 8-bit activations and int8 KV, logits within
   ``QUANT_TOL_REL``; each rank's launches equal the single process's.
   Step ms, the gradient all-reduce's ms, save and restore seconds, the
   cold start's seconds and the phase's are recorded.  The (2, 1) ranks
   then train granite-moe (full width cut to ``MESH_MOE_DEPTH`` = 2, f32,
   ``ragged``; its load-balancing term takes the whole batch's means) and
   ResNet-20 (B = ``MT_CNN_B``; its BatchNorm the whole batch's moments)
   ``MT_SPLIT_STEPS`` steps each, held to the single process's losses
   within ``MT_LOSS_TOL_REL`` and params by ``mt_param_faults`` against
   ``mt_split_witness`` (the larger distance of the single run on
   reversed rows and the single run on the host CPU); with a planted
   fault each (per-rank means in the aux term, per-rank BatchNorm
   moments) they must fail.  Every rank
   process turns TF32 off for matmuls and cuDNN, as the single process
   does.
   The mesh phase's ranks also record one phi3 (1, 2) decode step's
   collectives (``mesh_decode_collectives``).
15. dry run phase — the meta-device dry run (``repro_torch.launch.dryrun``,
   on the host, no kernel launched): the train phase's phi3 step's
   predicted argument bytes and peak beside the measured peak (the
   argument bytes at most it, the peak within ``DRY_PEAK_RATIO``); the
   mesh phase's decode step's recorded collectives equal to the live
   ranks', op for op; the predicted FLOPs of a train step over the
   profiled step's device time, the achieved TFLOP/s against
   ``dist.cost_analysis.PEAK_FLOPS``.

Output: a ``{"train": {...}}`` line with the train phase's figures and
the card, a ``{"moe": {...}}`` line with the MoE phase's, an
``{"encdec": {...}}`` line with the enc-dec phase's, a
``{"families": {...}}`` line with the families phase's, a
``{"cnn": {...}}``
line with the CNN phase's, a ``{"train_families": {...}}`` line with the
train families phase's, a ``{"deploy": {...}}`` line with the deploy
phase's, a ``{"lint": {...}}`` line with
each linted engine's seconds and rules, the faults' and the launcher's,
a ``{"mesh": {...}}`` line with each mesh leg's decode ms/step beside the
single process's, a ``{"mesh_train": {...}}`` line with the mesh train
phase's figures, a ``{"dryrun": {...}}`` line with the dry run phase's,
a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Details go
to ``chiprun_out/chip_smoke_detail.json``.  Any failure exits non-zero; so
does a machine without CUDA, or a directory without the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# quantizer-free MoE runs: a plain run's router may choose other experts
# than the kernel run's only where its top-k boundary gap in router logits
# is below this (measured flips <= 1.05e-5; median gaps 0.049 granite,
# 0.51 llama4-scout)
ROUTE_TIE_GAP = 1e-3
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
# new tokens of the path phase's host-CPU witness: cut from NEW to keep
# the smoke's run time (the MoE phase came after it) within its budget
WITNESS_NEW = 8


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
# (K, N) the served families add: qwen2-vl's K/V projections (N = 256)
# and MLP down (K = 8960), rwkv6's channel-mix out (K = 7168), zamba2's
# B / C / dt projections (N = 64, half of one 128-column block)
FAMILY_SHAPES = ((1536, 256), (8960, 1536), (7168, 2048), (2048, 64))
# (M, K) at N = 3072 of whole-layer weight blocks (wbr = 3072) taller
# than the stream regime's x stage: the plan cuts a block on unit rows
WB_TALL = ((4, 3072), (8, 8192), (16, 3072))


def kernel_phase():
    import torch
    from repro_torch.kernels import packed_matmul
    from repro_torch.kernels.ref import packed_matmul_ref
    from repro_torch.kernels.tiling import STREAM_MAX_M as SWITCH_M

    out = {"packed_matmul": []}
    f32, bf16 = torch.float32, torch.bfloat16
    # f32 x at decode and prefill M; bf16 x (the bf16 path's operands) at
    # the one-shot path's M = B (decode), B*5 (verify) and B*P (prefill),
    # at the regime switch (STREAM_MAX_M streams, one more runs tensor
    # tiles) and at the scheduler's M: n_slots (decode), a chunk and the
    # narrowest prompt (the scheduler drives also hold every M they ran
    # against the plain version: MatmulCapture)
    cases = [(m, k, n, bits, 8, 128, None, f32)
             for bits in (8, 4) for m in (1, 16, B * P)
             for k, n in PHI3_SHAPES]
    cases += [(m, k, n, bits, 8, 128, None, bf16)
              for bits in (8, 4) for m in (B, SWITCH_M, SWITCH_M + 1, B * 5,
                                           B * P, SCHED_SLOTS, SCHED_CHUNK,
                                           min(SCHED_WIDTHS))
              for k, n in PHI3_SHAPES]
    # edge geometry, each at a stream M and a tensor M: 9x8 with odd Kp and
    # narrow x; 8x128 with narrow x and N padded from 200 to 256
    cases += [(m, 27, 44, b, 9, 8, 25, dt) for b in (8, 4)
              for m in (5, SWITCH_M + 5) for dt in (f32, bf16)]
    cases += [(m, 72, 200, b, 8, 128, 70, f32) for b in (8, 4)
              for m in (3, 40)]
    cases += [(m, k, n, bits, 8, 128, None, bf16) for bits in (8, 4)
              for m in (B, B * P) for k, n in FAMILY_SHAPES]
    cases += [(m, k, 3072, bits, 3072, 128, None, xdt) for bits in (8, 4)
              for m, k in WB_TALL for xdt in (f32, bf16)]
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

    out["paged_attention"] = attention_kernel_phase()
    out["bitplane_matmul"] = bitplane_kernel_phase()
    out["pact_quant"] = pact_kernel_phase()
    return out


T_LONG = 4224                   # a long context's cache width (page 128)
# (G, d_head) of the MoE models' attention, 8 KV heads each:
# granite-moe-3b-a800m, llama4-scout-17b-a16e
MOE_HEADS = ((3, 64), (5, 128))
# (KV heads, G, d_head) of seamless-m4t-large-v2's decoder self-attention
ENCDEC_HEAD = (16, 1, 64)
# (KV heads, G, d_head): qwen2-vl-2b's GQA, zamba2-1.2b's shared block
FAMILY_HEADS = ((2, 6, 128), (32, 1, 64))


def attention_pool(bits, kvh, t, page, *, g=1, paged=False, seed=1,
                   b=B, dh=96):
    """Random K/V for ``b`` slots of ``t`` positions (head width ``dh``),
    quantized as the
    cache stores them, as a page pool with its block table: the contiguous
    cache's identity view (``page`` = the cache's page), or ``paged``: the
    same pages shuffled behind a random table with the trash page 0 in
    front.  Returns (q, pool leaves, table)."""
    import torch
    from repro_torch.models.attention import _as_pool, quantize_kv
    gen = torch.Generator(device=DEV).manual_seed(seed)
    kf = torch.randn((b, t, kvh, dh), generator=gen, device=DEV)
    vf = torch.randn((b, t, kvh, dh), generator=gen, device=DEV)
    q = torch.randn((b, kvh, g, dh), generator=gen, device=DEV)
    if bits in (8, 4):
        (kq, ks), (vq, vs) = quantize_kv(kf, bits), quantize_kv(vf, bits)
        pool = [_as_pool(a, page) for a in (kq, vq, ks, vs)]
    else:
        dt = torch.bfloat16 if bits == 16 else torch.float32
        pool = [_as_pool(kf.to(dt), page), _as_pool(vf.to(dt), page), None,
                None]
    nb = t // page
    table = torch.arange(b * nb, dtype=torch.int32, device=DEV)
    if paged:
        perm = torch.randperm(b * nb, generator=gen, device=DEV) + 1
        shuffled = []
        for leaf in pool:
            if leaf is None:
                shuffled.append(None)
                continue
            s = torch.zeros((1 + b * nb, *leaf.shape[1:]), dtype=leaf.dtype,
                            device=DEV)
            s[perm] = leaf
            shuffled.append(s)
        pool, table = shuffled, perm.to(torch.int32)
    return q, pool, table.reshape(b, nb)


def trash_tails(table, kv_len, page):
    """Blocks past each slot's fill level route to the trash page 0."""
    import torch
    live = -(-kv_len.long() // page)
    blk = torch.arange(table.shape[1], device=table.device)[None, :]
    return torch.where(blk < live[:, None], table, torch.zeros_like(table))


def attention_kernel_phase():
    """``paged_attention`` against its plain version, |err| <= PA_TOL: the
    decode shape (t = 192, page 96, identity table) for int8, int4 and f32
    pools; GQA G=4 with window and softcap over 16-token pages; long
    context (t = 4224, kv_len ~4096) in the contiguous identity view (page
    128) and in a shuffled 16-token pool with trash-page tails, for int8,
    int4, bf16 and f32; the split edges (kv_len 1 and on split
    boundaries, a window that empties the leading splits or spans a
    boundary); G=4 with softcap at long context; G=12 (two query-head
    groups a launch) with softcap, int8 and f32 pools, at the decode
    shape and at long context paged; the MoE models' heads (granite's
    G=3 at d_head 64, llama4-scout's G=5 at 128, 8 KV heads) for int8,
    int4 and f32 pools at the decode shape and at long context paged;
    the same for the enc-dec decoder's head (16 KV heads, G=1, d_head
    64); the served families' heads (qwen2-vl's 2 KV heads, G=6, d_head
    128; zamba2's shared block, 32 KV heads, G=1, d_head 64) for int8,
    int4 and f32 pools at the decode shape and at long context,
    contiguous and paged."""
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.kernels.tiling import attention_plan, fit_block
    out = []
    t = P + 64                                  # generate's cache width
    page = fit_block(min(128, t), t, 1)         # contiguous page size: 96

    def case(name, bits, q, pool, table, kv_len, **kw):
        got = paged_attention(q, *pool, table, kv_len, **kw)
        torch.cuda.synchronize()
        want = paged_attention_ref(q, *pool, table, kv_len, **kw)
        err = float((got - want).abs().max())
        b, kvh, g, dh = q.shape
        plan = attention_plan(b, kvh, g, dh, pool[0].shape[1],
                              table.shape[1], {torch.int8: 8, torch.uint8: 4,
                                               torch.bfloat16: 16,
                                               torch.float32: 32}[
                                                   pool[0].dtype])
        out.append(dict(case=name, bits=bits, kv=kvh, g=g, dh=dh,
                        page=pool[0].shape[1], nb=table.shape[1],
                        kv_len=kv_len.tolist(), splits=plan.splits,
                        chunk=plan.chunk, err=err, tol=PA_TOL, **kw))
        if not (err <= PA_TOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"paged_attention case {out[-1]}")

    def lens(*v):
        return torch.tensor(v[:B], dtype=torch.int32, device=DEV)

    for bits in (8, 4, 32):
        q, pool, ident = attention_pool(bits, 32, t, page, seed=1 + bits)
        case("decode", bits, q, pool, ident, lens(P + 1, P + 17, P + 40, t))
    # split edges at the decode shape (4 splits of 48): kv_len 1, on a
    # boundary, one past it
    q, pool, ident = attention_pool(8, 32, t, page, seed=3)
    case("decode edges", 8, q, pool, ident, lens(1, 48, 96, 49))
    # GQA G=4 with window and softcap; blocks past kv_len route to page 0
    kvh, gq, nb = 8, 4, 6
    q, pool, table = attention_pool(8, kvh, PAGE * nb, PAGE, g=gq,
                                    paged=True, seed=4)
    kv_len = lens(5, 33, 60, 96)
    case("gqa window softcap", 8, q, pool,
         trash_tails(table, kv_len, PAGE), kv_len, window=40, softcap=30.0)
    long_page = fit_block(min(128, T_LONG), T_LONG, 1)    # 128
    long_lens = lens(4096, 4095, T_LONG, 3071)
    for bits in (8, 4, 16, 32):
        q, pool, ident = attention_pool(bits, 32, T_LONG, long_page,
                                        seed=5 + bits)
        case("long contiguous", bits, q, pool, ident, long_lens)
        q, pool, table = attention_pool(bits, 32, T_LONG, PAGE, paged=True,
                                        seed=6 + bits)
        kv_len = lens(4096, 4000, 2049, T_LONG)
        case("long paged", bits, q, pool, trash_tails(table, kv_len, PAGE),
             kv_len)
    # long split edges (4 splits of 1056) and windows that empty the
    # leading splits (4096 - 200) or span a split boundary (900..1099)
    q, pool, ident = attention_pool(8, 32, T_LONG, long_page, seed=7)
    case("long edges", 8, q, pool, ident, lens(1056, 2112, 1, 3168))
    case("long window", 8, q, pool, ident, lens(4096, 2200, 1100, 60),
         window=200)
    for bits in (8, 4):
        q, pool, ident = attention_pool(bits, 8, T_LONG, long_page, g=4,
                                        seed=8 + bits)
        case("long gqa softcap", bits, q, pool, ident, long_lens,
             softcap=30.0)
    # G = 12 (starcoder2-15b: 48 query heads over 4 KV heads): two groups
    # of 6 query heads in one launch, at the decode shape and at long
    # context in a shuffled pool
    for bits in (8, 32):
        q, pool, ident = attention_pool(bits, 4, t, page, g=12,
                                        seed=10 + bits)
        case("G=12 decode softcap", bits, q, pool, ident,
             lens(P + 1, P + 17, 1, t), softcap=30.0)
        q, pool, table = attention_pool(bits, 4, T_LONG, PAGE, g=12,
                                        paged=True, seed=11 + bits)
        case("G=12 long paged softcap", bits, q, pool,
             trash_tails(table, long_lens, PAGE), long_lens, softcap=30.0)
    for g, dh in MOE_HEADS:
        for bits in (8, 4, 32):
            q, pool, ident = attention_pool(bits, 8, t, page, g=g, dh=dh,
                                            seed=20 + g + bits)
            case(f"G={g} dh={dh} decode", bits, q, pool, ident,
                 lens(P + 1, P + 17, 1, t))
            q, pool, table = attention_pool(bits, 8, T_LONG, PAGE, g=g,
                                            dh=dh, paged=True,
                                            seed=21 + g + bits)
            kv_len = lens(4096, 2000, 1057, T_LONG)
            case(f"G={g} dh={dh} long paged", bits, q, pool,
                 trash_tails(table, kv_len, PAGE), kv_len)
    kvh, g, dh = ENCDEC_HEAD
    for bits in (8, 4, 32):
        q, pool, ident = attention_pool(bits, kvh, t, page, g=g, dh=dh,
                                        seed=60 + bits)
        case(f"KV={kvh} G={g} dh={dh} decode", bits, q, pool, ident,
             lens(P + 1, P + 17, 1, t))
        q, pool, table = attention_pool(bits, kvh, T_LONG, PAGE, g=g, dh=dh,
                                        paged=True, seed=61 + bits)
        kv_len = lens(4096, 2000, 1057, T_LONG)
        case(f"KV={kvh} G={g} dh={dh} long paged", bits, q, pool,
             trash_tails(table, kv_len, PAGE), kv_len)
    for kvh, g, dh in FAMILY_HEADS:
        for bits in (8, 4, 32):
            q, pool, ident = attention_pool(bits, kvh, t, page, g=g, dh=dh,
                                            seed=70 + g + bits)
            case(f"KV={kvh} G={g} dh={dh} decode", bits, q, pool, ident,
                 lens(P + 1, P + 17, 1, t))
            q, pool, ident = attention_pool(bits, kvh, T_LONG, long_page,
                                            g=g, dh=dh, seed=71 + g + bits)
            case(f"KV={kvh} G={g} dh={dh} long contiguous", bits, q, pool,
                 ident, long_lens)
            q, pool, table = attention_pool(bits, kvh, T_LONG, PAGE, g=g,
                                            dh=dh, paged=True,
                                            seed=72 + g + bits)
            kv_len = lens(4096, 2000, 1057, T_LONG)
            case(f"KV={kvh} G={g} dh={dh} long paged", bits, q, pool,
                 trash_tails(table, kv_len, PAGE), kv_len)
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
    # the scheduler's speculative drive, f32 x: drafts at M = n_slots
    # (top-k plane masks), verify at n_slots*(gamma+1), prompts at P
    k_spec, gamma = SCHED_SPEC
    cases += [(m, k, n, 8, 8, 128, dict(x_dtype=f32, draft=d))
              for m, d in ((SCHED_SLOTS, k_spec),
                           (SCHED_SLOTS * (gamma + 1), 0), (P, 0))
              for k, n in PHI3_SHAPES]
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
    # the families' new shapes; whole-layer blocks taller than the x stage
    cases += [(m, k, n, 8, 8, 128, dict(x_dtype=bf16))
              for m in (B, B * P) for k, n in FAMILY_SHAPES]
    cases += [(m, k, 3072, 8, 3072, 128, dict(x_dtype=dt))
              for m, k in WB_TALL for dt in (f32, bf16)]
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
    atomics); so do two launches of ``paged_attention`` at kv_len 144 and
    4096 (the KV split across CTAs, combined in split order)."""
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
    # paged_attention: the splits of a (slot, head group) are combined in
    # split order, at the decode fill and at a long context
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.tiling import attention_plan, fit_block
    for kv_len, t in ((P + NEW // 2, P + 64), (4096, T_LONG)):
        page = fit_block(min(128, t), t, 1)
        q, pool, ident = attention_pool(8, 32, t, page, seed=9)
        lens = torch.full((B,), kv_len, dtype=torch.int32, device=DEV)
        a = paged_attention(q, *pool, ident, lens)
        b = paged_attention(q, *pool, ident, lens)
        torch.cuda.synchronize()
        plan = attention_plan(B, 32, 1, 96, page, t // page, 8)
        out.append(dict(kernel="paged_attention", kv_len=kv_len, t=t,
                        splits=plan.splits,
                        identical=bool(torch.equal(a, b))))
        # the long context splits across CTAs (the decode fill walks its
        # short cache unsplit)
        if not (out[-1]["identical"] and (plan.splits > 1 or t <= 1024)):
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

def greedy(eng, tok, new, page=0, frames=None, after_prefill=None,
           extra=None):
    """Greedy decode as ``ServeEngine.generate`` runs it: a prefill, then
    ``new - 1`` decode steps, each taking the argmax.  With ``page`` the
    state is paged: a non-identity block table (page 0 reserved),
    ``prefill_at`` per slot and a per-slot (B,) decode index.  An
    encoder-decoder model takes ``frames`` (B, S_enc, d_model) beside the
    tokens, a vlm model its ``vision_embeds`` in ``extra`` (decode starts
    past the vision prefix); ``after_prefill`` (a planted fault) may
    rewrite the state between the prefill and the first decode step.

    Returns the tokens (B, new), every step's logits (new, B, V) in f32,
    and host-clock prefill ms and decode ms/step (synchronized)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import _roundup64
    b = tok.shape[0]
    inputs = {"tokens": tok} if frames is None else {"tokens": tok,
                                                     "frames": frames}
    inputs.update(extra or {})
    p = eng.prompt_width(inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if page:
        max_len = p + _roundup64(new)
        state = eng.init_decode_state({k: v[:1] for k, v in inputs.items()},
                                      n_slots=b, max_len=max_len,
                                      page_size=page)
        nb = -(-max_len // page)
        table = np.random.default_rng(5).permutation(
            np.arange(1, 1 + b * nb)).reshape(b, nb).astype(np.int32)
        state = eng.set_tables(state, table)
        rows = []
        for s in range(b):
            lg, state = eng.prefill_at({k: v[s:s + 1]
                                        for k, v in inputs.items()}, state, s)
            rows.append(lg)
        logits = torch.cat(rows)
        index = torch.full((b,), p, dtype=torch.int32, device=eng.device)
    else:
        logits, state = eng.prefill(inputs, extra_slots=_roundup64(new))
        index = p
    if after_prefill is not None:
        after_prefill(state)
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


def layer_matmuls(cfg, impl="ragged"):
    """Deployed 2-D weight matmuls a layer makes in one forward: a dense
    layer's 4 attention projections and its MLP's (3 SwiGLU, 2 GELU); an
    MoE layer's 4 projections, the shared expert's 3 and, under
    ``capacity`` dispatch only, 3 a routed expert (the ``ragged`` product
    multiplies the dequantized expert stack with plain torch); an
    enc-dec decoder layer's 4 self-attention and 4 cross-attention
    projections and its 2 MLP matmuls (an encoder layer's are
    ``ENC_LAYER_MATMULS``, made once a prompt)."""
    if cfg.is_encdec:
        return 10
    if not cfg.n_experts:
        return 4 + (3 if cfg.mlp_kind == "swiglu" else 2)
    return 4 + 3 * bool(cfg.n_shared_experts) \
        + (3 * cfg.n_experts if impl == "capacity" else 0)


def expected_launches(n_layers, forwards, decode_steps,
                      matmul="packed_matmul", per_layer=7):
    """``per_layer`` projections a layer a forward through ``matmul`` (7
    for phi3; :func:`layer_matmuls`); one fused attention read a layer a
    single-token forward; nothing else."""
    out = {"packed_matmul": 0, "paged_attention": n_layers * decode_steps,
           "bitplane_matmul": 0, "pact_quant": 0}
    out[matmul] = per_layer * n_layers * forwards
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
                max_logit=float(b["logits"].abs().max()),
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


# phi3's depth in the path, bit-plane, speculative, scheduler, lint and
# time phases (32 layers registered; full width): the kernels' per-call
# timings are at the full-width shapes whatever the depth
PHI3_DEPTH = 8


@contextlib.contextmanager
def phi3_depth(n_layers=PHI3_DEPTH):
    """The registered phi3 cut to ``n_layers`` for the calls inside: the
    trees, ``api_for`` and the serve and lint launchers all read
    ``REGISTRY[ARCH]``."""
    from repro_torch.configs import REGISTRY
    full = REGISTRY[ARCH]
    REGISTRY[ARCH] = dataclasses.replace(full, n_layers=n_layers)
    try:
        yield
    finally:
        REGISTRY[ARCH] = full


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
            run["witness_vs_plain"] = compare(
                greedy(host, tok.cpu(), WITNESS_NEW), plain)
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
    training leaves a tree), deployed to ``layout="bitplane"``, bits 8.
    Every quantized leaf of the layer stacks is drawn, in tree order
    (phi3's ``LAYER_LEAVES``; an MoE tree's attention projections and
    expert stacks; an enc-dec tree's encoder, then decoder stack).  Leaf by
    leaf and layer by layer, its composed weights must equal those of the
    packed deploy of the same tree, element for element.  Returns the
    tree and a record."""
    import torch
    from repro_torch.core.fakequant import FakeQuantTensor
    from repro_torch.serve.deploy import (bitplane_serving_compose,
                                          bitplane_stream_bytes,
                                          serving_compose, to_serving_params)
    g = torch.Generator(device=DEV).manual_seed(7)
    odds = torch.tensor(BW_PROB, dtype=torch.float32, device=DEV)
    mixed, leaves = dict(qat), []
    for stack in ("layers", "enc_layers", "dec_layers"):
        if stack not in qat:
            continue
        layers = mixed[stack] = dict(qat[stack])
        for sub, tree in layers.items():
            if isinstance(tree, FakeQuantTensor):
                leaves.append((stack, (sub,)))
            elif isinstance(tree, dict):
                layers[sub] = dict(tree)
                leaves += [(stack, (sub, name)) for name, leaf in tree.items()
                           if isinstance(leaf, FakeQuantTensor)]
    assert leaves and all(n in mixed["layers"][s] for s, n in LAYER_LEAVES
                          if s in mixed.get("layers", {})), leaves

    def at(tree, stack, path):
        node = tree[stack]
        for key in path[:-1]:
            node = node[key]
        return node, path[-1]

    for stack, path in leaves:
        node, name = at(mixed, stack, path)
        fq = node[name]
        bw = torch.multinomial(odds, fq.bitwidth.numel(), replacement=True,
                               generator=g).reshape(fq.bitwidth.shape)
        node[name] = dataclasses.replace(fq, bitwidth=bw.to(
            fq.bitwidth.dtype))
    bp = to_serving_params(mixed, 8, layout="bitplane", device=DEV)
    rec = {"compose_equal_layers": 0, "leaves": {}}
    for stack, path in leaves:
        node, name = at(mixed, stack, path)
        packed = to_serving_params({"w": node[name]}, 8, device=DEV)["w"]
        node, name = at(bp, stack, path)
        leaf = node[name]
        for i in range(leaf.planes.shape[0]):
            a = bitplane_serving_compose(leaf.layer(i), torch.float32)
            b = serving_compose(packed.layer(i), torch.float32)
            if not torch.equal(a, b):
                raise AssertionError(f"bit-plane compose != packed compose: "
                                     f"{stack}/{'/'.join(path)} layer {i}")
            rec["compose_equal_layers"] += 1
        del packed
        occ = leaf.mask.sum(dim=-3)
        rec["leaves"]["/".join((stack, *path))] = dict(
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
            # a fault may break the wire contract (the truncated masks are
            # not prefix-monotone): the engine's check is off, so the
            # output check must catch it
            eng = ServeEngine(api_for(8), tree, kv_quant_bits=kv,
                              backend="bitplane", attn_backend="fused",
                              device=DEV, validate=False)
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
# scheduler phase: request-level serving through the launcher
# ---------------------------------------------------------------------------

# 24 prompt widths (64..1920), budgets cycled {16, 32, 64, 128}; the even
# uids start with a common 512-token system prompt.  The page schedule
# depends only on widths, budgets, arrivals and prompt content (no EOS):
# unconstrained, this trace peaks at 297 live pages; a pool of 240 pages
# (239 live) under overcommit 1.5 parks 4 requests (a tiny-width CPU replay
# of the same trace through the launcher).
SCHED_WIDTHS = (1920, 64, 640, 128, 768, 256, 1024, 96, 576, 300, 896, 200,
                1536, 160, 700, 450, 600, 80, 1100, 1000, 800, 72, 530, 384)
SCHED_BUDGETS = (16, 32, 64, 128)
SCHED_PAGES = 240
SCHED_CHUNK = 256
SCHED_SHARED = 512
SCHED_SLOTS = 8
SCHED_VALIDATE_EVERY = 16
SCHED_ONESHOT = 8               # quantizer-free requests rerun one-shot
# the speculative drive: 8 requests of 128 tokens, 32 new each, paged
SCHED_SPEC = (6, 3)             # (speculate_planes, draft_gamma)


def sched_argv(size=("--no-tiny",), extra=(), arch=ARCH):
    """The scheduler phase's launcher flags: full-width ``arch`` (phi3
    unless named; ``size``) through the kernels, 8 slots, 16-token pages,
    256-token chunks, overcommit 1.5 over ``SCHED_PAGES`` pages, prefix
    cache, priorities cycling {0, 1}, 24 requests from seed 0 arriving
    every 2 ticks."""
    return ["--arch", arch, *size, "--device", DEV, "--requests",
            "--backend", "kernel", "--attn-backend", "fused",
            "--batch", str(len(SCHED_WIDTHS)), "--n-slots", str(SCHED_SLOTS),
            "--arrival-gap", "2", "--page-size", str(PAGE),
            "--prefill-chunk", str(SCHED_CHUNK),
            "--n-pages", str(SCHED_PAGES), "--overcommit", "1.5",
            "--prefix-cache", "--priority", "0,1",
            "--prompt-lens", ",".join(map(str, SCHED_WIDTHS)),
            "--max-news", ",".join(map(str, SCHED_BUDGETS)),
            "--shared-prefix", str(SCHED_SHARED), "--shared-every", "2",
            "--validate-every", str(SCHED_VALIDATE_EVERY), "--seed", "0",
            *extra]


class TickTimer:
    """Observer around ``Scheduler.step`` and ``Scheduler.run``: each
    tick's host-clock ms, the card synchronized at its end (the scheduler
    itself never waits for the card), and the wall time of the whole
    ``run``, its contract checks included, from a synchronized start to a
    synchronized end."""

    def __init__(self):
        from repro_torch.serve.scheduler import Scheduler
        self.cls = Scheduler
        self.orig = (Scheduler.step, Scheduler.run)
        self.ms, self.run_s = [], None

    def __enter__(self):
        import torch
        step, run = self.orig

        def timed_step(sched):
            t0 = time.perf_counter()
            step(sched)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)

        def timed_run(sched, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(sched, *a, **kw)
            torch.cuda.synchronize()
            self.run_s = time.perf_counter() - t0
            return res
        self.cls.step, self.cls.run = timed_step, timed_run
        return self

    def __exit__(self, *exc):
        self.cls.step, self.cls.run = self.orig


class MatmulCapture:
    """Observer around the model's two weight-matmul wrappers
    (``models.common.packed_matmul`` and ``bitplane_matmul``): the first
    call of a drive at each (kernel, M, K, N, x dtype) whose x has a
    nonzero row is kept (x and the output copied, the weight operands
    referenced; a ``capacity`` window past an expert's rows is all zero,
    so each call at a shape is read on the host until one is live) and,
    after the drive, held against the plain version within
    ``PM_TOL_REL`` / ``BM_TOL_REL`` of its largest |value|.  Every call
    still goes to the wrapper."""

    NAMES = ("packed_matmul", "bitplane_matmul")

    def __init__(self):
        from repro_torch.models import common
        self.mod = common
        self.orig = {n: getattr(common, n) for n in self.NAMES}
        self.calls, self.live = {}, set()
        self.counts = {}                 # calls a drive made at each key

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.mod, name, self.observer(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)

    def observer(self, name, fn):
        def call(x, *ops, **kw):
            y = fn(x, *ops, **kw)
            key = (name, x.shape[0], x.shape[1], y.shape[1], str(x.dtype))
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.live:
                live = int(x.abs().amax(-1).gt(0).sum())
                if live or key not in self.calls:
                    self.calls[key] = (x.clone(), ops, kw, y.clone(), live)
                if live:
                    self.live.add(key)
            return y
        return call

    def check(self):
        from repro_torch.kernels.ref import (bitplane_matmul_ref,
                                             packed_matmul_ref)
        rows = []
        for key in sorted(self.calls):
            name, m, k, n, dt = key
            x, ops, kw, got, live = self.calls[key]
            if name == "packed_matmul":
                want = packed_matmul_ref(x, *ops, kw["bits"], kw["wbr"],
                                         kw["wbc"])
                rel = PM_TOL_REL
            else:
                want = bitplane_matmul_ref(x, *ops, kw["wbr"], kw["wbc"])
                rel = BM_TOL_REL
            err = float((got.float() - want.float()).abs().max())
            tol = rel * float(want.abs().max())
            rows.append(dict(kernel=name, case="captured drive call", m=m,
                             k=k, n=n, x=dt, live_rows=live, err=err,
                             tol=tol))
            if not (live and err <= tol and got.shape == want.shape and
                    bool(got.isfinite().all())):
                raise AssertionError(f"{name} on a drive's call: {rows[-1]}")
        self.calls.clear()
        self.live.clear()
        return rows


def launch(argv, params=None):
    """``repro_torch.launch.serve.main(argv)`` in this process, its
    printout kept, with the launch counters zeroed just before and read
    just after, each tick timed (:class:`TickTimer`) and the first
    weight-matmul call at each shape held against the plain version
    (:class:`MatmulCapture`) after the counts are read.  A drive given
    ``--lint`` lints first, its launches zeroed after (:class:`LintGuard`):
    the lint's record is ``out["lint"]``."""
    import contextlib
    import io
    import torch
    from repro_torch import kernels as tk
    from repro_torch.launch.serve import main as serve_main
    buf = io.StringIO()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), TickTimer() as timer, \
            MatmulCapture() as mm, LintGuard() as lint:
        out = serve_main(argv, params=params, record_ticks=True)
    torch.cuda.synchronize()
    if lint.record is not None:
        out["lint"] = lint.record
    out["launches"] = tk.launch_counts()
    out["main_s"] = time.perf_counter() - t0
    out["tick_ms"], out["run_s"] = timer.ms, timer.run_s
    out["stdout"] = buf.getvalue()
    out["matmul_calls"] = mm.check()
    return out


def tick_launches(sched, matmul):
    """Launches a drive makes, from the scheduler's own tick log: the
    model's :func:`layer_matmuls` per layer for every forward (a prompt
    insert or chunk, a decode step, a draft step, a verify), one
    ``paged_attention`` per layer for every single-token forward (decode,
    draft, a 1-token chunk); an enc-dec model's encoder once a request."""
    from repro_torch.models.moe import GROUPED_IMPL
    log = sched.tick_log
    cfg = sched.engine.api.cfg
    fwd = sum(len(r["inserts"]) + r["decode"] + r["draft"]
              + (r["verify"] > 0) for r in log)
    single = sum(r["decode"] + r["draft"]
                 + sum(w == 1 for w in r["inserts"]) for r in log)
    if cfg.is_encdec:       # the encoder runs once a request (first chunk)
        return encdec_launches(cfg, fwd, single, len(sched.results), matmul)
    if cfg.family in ("vlm", "ssm", "hybrid"):
        # a vlm request's first chunk projects its vision prefix once
        return family_launches(cfg, fwd, single, len(sched.results), matmul)
    return expected_launches(cfg.n_layers, fwd, single, matmul,
                             layer_matmuls(cfg, GROUPED_IMPL["impl"]))


class TickCapture:
    """Observer around ``models.attention.paged_attention`` (the fused
    read every decode step makes): the first layer-0 call whose state has
    ragged fill levels, a free row, two slots aliasing one page (unless
    ``aliased`` is False: a drive without a prefix cache has none) and a
    capacity past 1024 (with ``first``, the first layer-0 call) is copied
    out (query, layer-0 pool, table, kv_len).  Copies only; every call
    still goes to the wrapper."""

    def __init__(self, first=False, aliased=True):
        from repro_torch.models import attention
        self.mod, self.orig = attention, attention.paged_attention
        self.case, self.layer0_calls, self.first = None, 0, first
        self.need_alias = aliased

    def __enter__(self):
        self.mod.paged_attention = self
        return self

    def __exit__(self, *exc):
        self.mod.paged_attention = self.orig

    def __call__(self, q, k, v, ks, vs, table, kv_len, **kw):
        out = self.orig(q, k, v, ks, vs, table, kv_len, **kw)
        if self.case is None and k.storage_offset() == 0:
            self.layer0_calls += 1
            tab, lens = table.cpu(), kv_len.cpu()
            cap = tab.shape[1] * k.shape[1]
            live = (tab != 0).any(1)
            pages = [set(r[r != 0].tolist()) for r in tab]
            aliased = any(pages[a] & pages[b]
                          for a in range(len(pages))
                          for b in range(a + 1, len(pages)))
            if self.first or cap > 1024 and bool((~live).any()) and \
                    (aliased or not self.need_alias) and \
                    len(set(lens[live].tolist())) >= 2:
                self.case = dict(
                    q=q.clone(), pool=[None if x is None else x.clone()
                                        for x in (k, v, ks, vs)],
                    table=table.clone(), kv_len=kv_len.clone(),
                    window=kw.get("window"), softcap=kw.get("softcap", 0.0),
                    call=self.layer0_calls)
        return out


def attention_check(case, name):
    """``paged_attention`` on a captured call (:class:`TickCapture`)
    against its plain version, within ``PA_TOL``, launched twice bit for
    bit.  Returns the record, the kernel's output and the plain one."""
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    q, pool, table, kv_len = (case["q"], case["pool"], case["table"],
                              case["kv_len"])
    kw = dict(window=case["window"], softcap=case["softcap"])
    a = paged_attention(q, *pool, table, kv_len, **kw)
    b = paged_attention(q, *pool, table, kv_len, **kw)
    torch.cuda.synchronize()
    want = paged_attention_ref(q, *pool, table, kv_len, **kw)
    bsz, kvh, g, dh = q.shape
    rec = dict(case=name, kv_dtype=str(pool[0].dtype), b=bsz, kv=kvh, g=g,
               dh=dh, page=pool[0].shape[1], nb=table.shape[1],
               kv_len=kv_len.tolist(), err=float((a - want).abs().max()),
               tol=PA_TOL, identical=bool(torch.equal(a, b)),
               finite=bool(torch.isfinite(a).all()))
    if not (rec["err"] <= PA_TOL and rec["identical"] and rec["finite"]):
        raise AssertionError(f"paged_attention on a captured call: {rec}")
    return rec, a, want


def captured_tick_case(case):
    """``paged_attention`` on the captured decode tick against its plain
    version (:func:`attention_check`); then timed, the pool
    rotated through copies past the 50 MB L2 (each layer's pool is read
    once a tick, behind the other layers' weights), beside the same tick
    with the free rows' kv_len set to 0 (what decoding the trash rows
    costs; the semantics stay the reference's), the plain version, SDPA
    on the slots' K/V gathered and dequantized to bf16 under each row's
    mask, and the bound: every pool position the rows read, read once
    (aliased and trash positions counted once), q, the table, kv_len and
    the f32 output over HBM, or each row's dot products over the bf16
    peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.kernels.tiling import attention_plan
    from repro_torch.models.attention import dequantize_kv
    q, pool, table, kv_len = (case["q"], case["pool"], case["table"],
                              case["kv_len"])
    kw = dict(window=case["window"], softcap=case["softcap"])
    chk, a, want = attention_check(case, "captured scheduler tick")
    err = chk["err"]
    row_err = (a - want).abs().amax(dim=(1, 2, 3)).tolist()
    free = ~(table != 0).any(1)
    kv0 = torch.where(free, torch.zeros_like(kv_len), kv_len)

    bsz, kvh, g, dh = q.shape
    page, nb = pool[0].shape[1], table.shape[1]
    cap = page * nb
    pos = torch.arange(cap, device=q.device)
    valid = pos[None] < kv_len[:, None].long()
    if kw["window"]:
        valid &= pos[None] >= kv_len[:, None].long() - int(kw["window"])
    phys = table.long()[:, pos // page] * page + pos % page
    read = int(torch.unique(phys[valid]).numel())
    pos_bytes = sum(t[0, 0].numel() * t.element_size() for t in pool)
    nbytes = read * pos_bytes + q.nbytes + a.nbytes + table.nbytes \
        + kv_len.nbytes
    flops = 4.0 * g * dh * kvh * int(valid.sum())
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"

    def gathered(p):
        order = table.reshape(-1).long()
        kd = dequantize_kv(p[0][order].reshape(bsz, cap, kvh, -1),
                           p[2][order].reshape(bsz, cap, kvh), torch.bfloat16)
        vd = dequantize_kv(p[1][order].reshape(bsz, cap, kvh, -1),
                           p[3][order].reshape(bsz, cap, kvh), torch.bfloat16)
        return kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()

    pools = rotating(lambda: [t.clone() for t in pool],
                     sum(t.nbytes for t in pool))
    dense = rotating(lambda: gathered(pool), 4 * bsz * cap * kvh * dh)
    it = {"i": 0}

    def nxt(seq):
        it["i"] = (it["i"] + 1) % len(seq)
        return seq[it["i"]]

    ms, dev, host = cuda_times(lambda: paged_attention(q, *nxt(pools), table,
                                                       kv_len, **kw))
    ms0, dev0, host0 = cuda_times(lambda: paged_attention(q, *nxt(pools),
                                                          table, kv0, **kw))
    plain = cuda_ms(lambda: paged_attention_ref(q, *nxt(pools), table, kv_len,
                                                **kw), iters=5)
    qb = q.reshape(bsz, kvh * g, 1, dh).to(torch.bfloat16)
    mask = valid[:, None, None]
    lib, lib_dev, lib_host = cuda_times(lambda: F.scaled_dot_product_attention(
        qb, *nxt(dense), attn_mask=mask, enable_gqa=g > 1))
    del pools, dense
    plan = attention_plan(bsz, kvh, g, dh, page, nb,
                          8 if pool[0].dtype == torch.int8 else 4)
    shared = torch.unique(table[table != 0], return_counts=True)[1]
    rec = dict(case="captured scheduler tick", bits=8, b=bsz, kv=kvh, g=g,
               dh=dh, page=page, nb=nb, kv_len=kv_len.tolist(),
               free_rows=int(free.sum()),
               aliased_pages=int((shared > 1).sum()),
               splits=plan.splits, chunk=plan.chunk, err=err, tol=PA_TOL,
               row_err=row_err, ref_max=float(want.abs().max()),
               identical=chk["identical"], finite=chk["finite"],
               ms=ms, device_ms=dev, host_ms=host,
               free_rows_zero_ms=ms0, free_rows_zero_device_ms=dev0,
               free_rows_zero_host_ms=host0, plain_ms=plain, library_ms=lib,
               library_device_ms=lib_dev, library_host_ms=lib_host,
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
               positions_read=read, layer0_call=case["call"])
    return rec


def drive_record(out, matmul):
    """Checks every drive of the phase passes, and the readings: every
    request finishes ``length`` with its budget; ``validate()`` empty (the
    launcher checked it every ``SCHED_VALIDATE_EVERY`` ticks and at the
    end); the pool drained (nothing in use or reserved, no refcount, every
    table row trash); launches equal those of the tick log.  Timing (host
    clock, :class:`TickTimer`): tokens/s over the whole ``run`` window,
    tick ms each ending synchronized."""
    sched, reqs = out["scheduler"], out["requests"]
    rep = sched.cache_report()
    for r, q in zip(out["results"], reqs):
        assert r.finish_reason == "length" and \
            len(r.tokens) == q.sampling.max_new_tokens, (r.uid, r)
    assert not sched.validate(), sched.validate()
    al = sched.allocator
    if sched.paged:                 # an unpaged drive (rwkv6) has no pool
        assert al.in_use == 0 and al.reserved == 0 and \
            al.free_count == al.n_pages - 1, rep
        assert not sched.tables.any()
    if sched.prefix_cache is not None:
        assert sched.prefix_cache.outstanding_refs == 0 and \
            len(sched.prefix_cache) == 0, rep
    want = tick_launches(sched, matmul) if matmul else \
        dict.fromkeys(out["launches"], 0)
    assert out["launches"] == want, (out["launches"], want)
    log, ms = sched.tick_log, out["tick_ms"]
    assert len(ms) == len(log) == sched.tick, (len(ms), len(log))
    total_ms = sum(ms)
    first = {u: r["tick"] for r in log for u in r["first"]}
    ttft_ticks = [first[q.uid] - q.arrival for q in reqs]
    ttft_ms = [sum(ms[q.arrival:first[q.uid] + 1]) for q in reqs]
    dec = [t for r, t in zip(log, ms) if r["decode"] and not r["inserts"]]
    chunk = [t for r, t in zip(log, ms) if r["inserts"]]
    spec = [t for r, t in zip(log, ms) if r["verify"]]
    gen = sum(len(r.tokens) for r in out["results"])
    return dict(
        ticks=sched.tick, launches=out["launches"], cache_report=rep,
        spec_stats=dict(sched.spec_stats), max_len=sched.max_len,
        capacity=sched.total_len,
        admitted=[r.admitted_tick for r in out["results"]],
        finished=[r.finished_tick for r in out["results"]],
        parked=[u for r in log for u in r["parked"]],
        generated_tokens=gen, run_s=out["run_s"],
        tokens_per_s=gen / out["run_s"], tick_ms_total=total_ms,
        tick_tokens_per_s=gen * 1e3 / total_ms,
        matmul_calls=out["matmul_calls"],
        decode_ticks=len(dec), decode_tick_ms=sum(dec) / max(len(dec), 1),
        chunk_ticks=len(chunk), chunk_tick_ms=sum(chunk) / max(len(chunk), 1),
        spec_ticks=len(spec), spec_tick_ms=sum(spec) / max(len(spec), 1),
        inserts=sum(len(r["inserts"]) for r in log),
        ttft_ticks=ttft_ticks, ttft_ms=ttft_ms,
        ttft_ms_mean=sum(ttft_ms) / len(ttft_ms), ttft_ms_max=max(ttft_ms),
        main_s=out["main_s"])


def oneshot_rule(out, n=SCHED_ONESHOT):
    """The quantizer-free trace's tokens against one-shot greedy runs at
    B=1 of ``n`` of its requests (the longest, two prefix sharers, a parked
    one, then the cheapest).  A request may part from its one-shot tokens
    only at a step where the one-shot run's top-two logit gap is below
    ``EXACT_TOL_REL`` of that step's largest |logit| (the kernels' plans
    differ with the batch shape, so sums run in another order); every part
    is recorded with its gap, and any other fails."""
    import torch
    eng, reqs = out["engine"], out["requests"]
    res = {r.uid: r for r in out["results"]}
    ticks = out["scheduler"].tick_log
    width = {q.uid: q.inputs["tokens"].shape[1] for q in reqs}
    budget = {q.uid: q.sampling.max_new_tokens for q in reqs}
    pick = [max(width, key=lambda u: (width[u], -u))]
    sharers = sorted((u for u in width if u % 2 == 0 and u not in pick
                      and width[u] > SCHED_SHARED),
                     key=lambda u: (budget[u], u))
    pick += sharers[:2]
    parked = [u for r in ticks for u in r["parked"] if u not in pick]
    pick += parked[:1]
    rest = sorted((u for u in width if u not in pick),
                  key=lambda u: (budget[u] + width[u] / SCHED_CHUNK, u))
    pick += rest[:n - len(pick)]
    rows = []
    for uid in pick:
        inputs = {k: torch.from_numpy(v).to(DEV)
                  for k, v in reqs[uid].inputs.items()}
        one = greedy(eng, inputs["tokens"], budget[uid],
                     frames=inputs.get("frames"),
                     extra={k: v for k, v in inputs.items()
                            if k == "vision_embeds"})
        got = res[uid].tokens
        want = one["tokens"][0].tolist()
        part = next((j for j in range(len(want)) if got[j] != want[j]), None)
        row = dict(uid=uid, width=width[uid], budget=budget[uid],
                   parted_at=part, parked=uid in parked)
        if part is not None:
            lg = one["logits"][part, 0]
            top2 = lg.topk(2).values
            row["gap"] = float(top2[0] - top2[1])
            row["gap_rel"] = row["gap"] / float(lg.abs().max())
            row["allowed"] = row["gap_rel"] < EXACT_TOL_REL
        rows.append(row)
        log(f"one-shot uid {uid} (w {width[uid]}, {budget[uid]} new): " +
            ("identical" if part is None else
             f"parts at {part}, gap {row['gap_rel']:.3g}"))
    return rows


def scheduler_phase(bp, size=("--no-tiny",)):
    """Request-level serving through ``python -m repro_torch.launch.serve``
    (its ``main``, in process): the registered bf16 phi3 with int8 weights,
    8-bit activations and an int8 KV cache, every drive counted against
    its tick log and checked by :func:`drive_record`; the captured decode
    tick; the same trace with quantizers off in f32, its ledger equal to
    the quantized one's, against one-shot runs (:func:`oneshot_rule`); and
    a speculative drive on the bit-plane tree against the same drive
    without speculation (quantizers off, f32)."""
    import torch
    out = {}
    with TickCapture() as cap:
        main = launch(sched_argv(size, ["--kv-bits", "8", "--lint"]))
    rec = out["main"] = drive_record(main, "packed_matmul")
    # the launcher's --lint ran before serving: ok, the reference's rules
    rec["lint"] = main["lint"]
    assert rec["lint"]["ok"] and \
        rec["lint"]["rules"] == sorted(LINT_RULES["paged"]), rec["lint"]
    rep = rec["cache_report"]
    assert rep["preemptions"] >= 1 and \
        rep["resumes"] == rep["preemptions"], rep
    assert rep["prefix_hits"] >= 1, rep
    assert rec["capacity"] > 1024 and max(SCHED_WIDTHS) >= 1536, rec
    assert main["engine"].api.cfg.dtype == "bfloat16" or size != (
        "--no-tiny",)
    assert cap.case is not None, "no decode tick met the capture rule"
    assert {SCHED_SLOTS, SCHED_CHUNK} <= {r["m"] for r in rec["matmul_calls"]}
    out["captured_tick"] = captured_tick_case(cap.case)
    del main, cap
    torch.cuda.empty_cache()
    log(f"scheduler drive: {rec['ticks']} ticks, {rec['generated_tokens']} "
        f"tokens, {rec['tokens_per_s']:.1f} tok/s, preemptions "
        f"{rep['preemptions']}, prefix hits {rep['prefix_hits']}, captured "
        f"tick err {out['captured_tick']['err']:.3g}")

    off = launch(sched_argv(size, ["--kv-bits", "32", "--act-bits", "32",
                                   "--dtype", "float32"]))
    rec_off = out["quantizers_off"] = drive_record(off, "packed_matmul")
    for key in ("ticks", "admitted", "finished", "parked"):
        assert rec_off[key] == rec[key], (key, rec_off[key], rec[key])
    out["oneshot"] = oneshot_rule(off)
    del off
    torch.cuda.empty_cache()
    bad = [r for r in out["oneshot"]
           if r["parted_at"] is not None and not r["allowed"]]
    assert not bad, ("scheduler tokens part from one-shot", bad)

    spec_argv = ["--arch", ARCH, *size, "--device", DEV, "--requests",
                 "--backend", "bitplane", "--attn-backend", "fused",
                 "--batch", "8", "--n-slots", "8", "--prompt-len", str(P),
                 "--max-new", str(NEW), "--arrival-gap", "1",
                 "--page-size", str(PAGE), "--kv-bits", "32",
                 "--act-bits", "32", "--dtype", "float32",
                 "--validate-every", str(SCHED_VALIDATE_EVERY)]
    k, gamma = SCHED_SPEC
    spec = launch(spec_argv + ["--speculate-planes", str(k),
                               "--draft-gamma", str(gamma)], params=bp)
    plain = launch(spec_argv, params=bp)
    out["speculative"] = drive_record(spec, "bitplane_matmul")
    out["speculative_plain"] = drive_record(plain, "bitplane_matmul")
    st = out["speculative"]["spec_stats"]
    assert {SCHED_SLOTS, SCHED_SLOTS * (gamma + 1), P} <= {
        r["m"] for r in out["speculative"]["matmul_calls"]}
    out["speculative"]["acceptance"] = st["accepted_drafts"] / max(
        st["drafted"], 1)
    same = [a.tokens == b.tokens for a, b in zip(spec["results"],
                                                 plain["results"])]
    out["speculative"]["tokens_equal"] = all(same)
    assert st["rounds"] > 0 and all(same), (st, same)
    del spec, plain
    torch.cuda.empty_cache()
    log(f"scheduler speculative k={k} gamma={gamma}: {st['rounds']} rounds, "
        f"acceptance {out['speculative']['acceptance']:.3f}; tokens equal "
        f"the non-speculative drive's")
    return out


# ---------------------------------------------------------------------------
# lint phase
# ---------------------------------------------------------------------------

# the lint launcher's default sizes: a 16-token prompt, 4 slots, 16 new
LINT_SIZES = dict(prompt_len=16, n_slots=4, max_new=16)
# The rules the reference's lint reports on the same configurations
# (``repro.analysis.lint_engine`` on the tiny configs; the port's CPU
# tests, tests/test_torch_lint*.py, hold the two equal finding for
# finding): a chunked paged engine's chunk reads its pool through the
# sanctioned gather; the ragged MoE product's dequantized expert stacks
# are a warning and leave no ``clean``.
_LINT_CLEAN = {"info:census", "info:clean", "info:donation-ok",
               "info:kv-clean"}
_LINT_CHUNK = {"info:PX-smoke", "info:sanctioned-kv-dequant",
               "info:sanctioned-kv-gather"}
LINT_RULES = {
    "contiguous": _LINT_CLEAN,
    "paged": _LINT_CLEAN | _LINT_CHUNK,
    "ref": {"info:PX-smoke", "info:census", "info:donation-ok",
            "info:sanctioned-dequant", "info:sanctioned-kv-dequant",
            "info:sanctioned-kv-gather"},
    "moe": (_LINT_CLEAN - {"info:clean"}) | _LINT_CHUNK
    | {"warning:sanctioned-moe-dequant"},
    "ssm": {"info:census", "info:clean", "info:donation-ok"},
    "hybrid": _LINT_CLEAN | {"info:PX-smoke"},
}
# phi3's int8 / int8-KV kernel decode ms/step (time phase, contiguous,
# bf16, 32 layers) in the smoke's run before the kernel boundary existed
# (PERF.md §5); printed beside this run's, which is at PHI3_DEPTH layers
BASELINE_DECODE_MS = 83.53


def lint_record(label, rep, s, launches):
    """A lint report's record: its rules, findings and seconds, and each
    recorded call's kernel-boundary ops, which must equal the launches
    its wrappers counted over that call; the calls' ops summed must
    equal the counters over the whole lint (``launches``)."""
    ops = {}
    for c in rep.calls:
        got = {k: v for k, v in c["launches"].items() if v}
        if c["kernel_ops"] != got:
            raise AssertionError(f"lint {label}: {c['fn']} recorded kernel "
                                 f"ops {c['kernel_ops']}, launches {got}")
        for k, v in got.items():
            ops[k] = ops.get(k, 0) + v
    total = {k: v for k, v in launches.items() if v}
    if ops != total:
        raise AssertionError(f"lint {label}: recorded ops {ops} over the "
                             f"calls, launches {total} over the lint")
    rules = sorted({f"{f.severity}:{f.rule}" for f in rep.findings})
    log(f"lint {label}: {s:.2f} s, {rep.summary()}, launches {total}")
    return {"label": label, "ok": rep.ok, "s": s, "rules": rules,
            "findings": [f.format() for f in rep.findings],
            "calls": rep.calls, "launches": total,
            "context": rep.context}


def timed_lint(label, fn):
    """``fn()`` (a lint giving a report) with the launch counters zeroed
    just before and just after, so no lint launch leaks into a drive's
    counts; returns (report, record)."""
    import torch
    from repro_torch import kernels as tk
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = tk.launch_counts()
    tk.reset_launch_counts()
    return rep, lint_record(label, rep, s, launches)


def lint_case(label, cfg, tree, expect, backend="kernel", attn="fused",
              kv=8, page=PAGE, chunk=SCHED_CHUNK):
    """``lint_engine`` on an engine over ``tree`` (an existing deployed
    tree: nothing new is built): it must pass and report exactly the
    reference's rules for the configuration (``LINT_RULES[expect]``)."""
    import warnings
    from repro_torch.analysis import lint_engine
    from repro_torch.models.api import build
    from repro_torch.serve.engine import ServeEngine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the ssm family's KV-bits note
        eng = ServeEngine(build(cfg), tree, kv_quant_bits=kv,
                          backend=backend, attn_backend=attn,
                          page_size=page, prefill_chunk=chunk, device=DEV)
    rep, rec = timed_lint(label, lambda: lint_engine(eng, **LINT_SIZES))
    want = sorted(LINT_RULES[expect])
    if not rep.ok or rec["rules"] != want:
        raise AssertionError(f"lint {label}: {rec['rules']} != {want}:\n"
                             + rep.format())
    return rec


def planted_lint_faults(cfg, tree, size=("--no-tiny",)):
    """The graph lint's planted faults on the card, each of which must
    fail: a prefill that dequantizes one deployed leaf (``mlp.w_down``)
    in Python under ``kernel`` (``dequant-materialization`` and
    ``payload-convert``); a decode forced to ``gather`` under ``fused``
    (``kv-full-width-gather`` and ``kv-dequant-materialization``); a
    decode that clones its state (``missing-donation``); the packed tree
    under ``bitplane`` through the lint launcher (exit 1,
    ``bitplane-dense-fallback``)."""
    import torch
    from repro_torch.analysis import check_decode_donation, lint_traced_fn
    from repro_torch.analysis.report import LintReport
    from repro_torch.core.state import tree_map
    from repro_torch.models.api import build
    from repro_torch.models.common import qdense
    from repro_torch.serve.engine import ServeEngine
    out = {}
    eng = ServeEngine(build(cfg), tree, kv_quant_bits=8, backend="kernel",
                      attn_backend="fused", page_size=PAGE,
                      prefill_chunk=SCHED_CHUNK, device=DEV)
    api, params = eng.api, eng.params
    leaf = ("layers", "mlp", "w_down")
    path = "".join(f"[{k!r}]" for k in leaf)

    def dequant_prefill(p, b):
        mlp = dict(p["layers"]["mlp"],
                   w_down=qdense(p["layers"]["mlp"]["w_down"],
                                 torch.bfloat16))
        p = dict(p, layers=dict(p["layers"], mlp=mlp))
        return api.prefill(p, b, extra_slots=64, backend="kernel",
                           attn_backend="fused")

    def report(run):
        rep = LintReport()
        rep.extend(run(rep.calls))
        return rep

    batch = {"tokens": torch.zeros((1, LINT_SIZES["prompt_len"]),
                                   dtype=torch.int32, device=DEV)}
    rep, out["dequant"] = timed_lint(
        "fault: one leaf dequantized in prefill", lambda: report(
            lambda calls: lint_traced_fn(
                dequant_prefill, (params, batch), fn_name="prefill",
                backend="kernel", calls=calls)))
    errs = {(f.rule, f.path) for f in rep.errors}
    assert errs == {("dequant-materialization", f"prefill:{path}"),
                    ("payload-convert", f"prefill:{path}")}, errs

    n = LINT_SIZES["n_slots"]
    state = eng.init_decode_state(batch, n, 128, page_size=PAGE)
    tokens = torch.zeros((n, 1), dtype=torch.int32, device=DEV)
    index = torch.zeros((n,), dtype=torch.int32, device=DEV)
    rep, out["gather"] = timed_lint(
        "fault: gather decode under fused", lambda: report(
            lambda calls: lint_traced_fn(
                lambda p, t, s, i: api.decode_step(
                    p, t, s, i, backend="kernel", attn_backend="gather"),
                (params, tokens, state, index), fn_name="decode",
                backend="kernel", attn_backend="fused", calls=calls)))
    assert {"kv-full-width-gather", "kv-dequant-materialization"} <= {
        f.rule for f in rep.errors}, rep.format()

    def cloning_decode(t, s, i):
        s = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                     else x, s)
        return ServeEngine.decode(eng, t, s, i)
    eng.decode = cloning_decode
    rep, out["clone"] = timed_lint(
        "fault: decode clones its state", lambda: report(
            lambda calls: check_decode_donation(eng, tokens, state, index,
                                                calls=calls)))
    assert [f.rule for f in rep.errors] == ["missing-donation"], \
        rep.format()
    del eng, state

    argv = ["--arch", ARCH, *size, "--device", DEV, "--backend", "bitplane",
            "--json"]
    res, out["bitplane_fallback"] = lint_launch(argv, tree, "fault: packed "
                                                "tree under bitplane")
    assert res["rc"] == 1 and not res["json"]["ok"], res["rc"]
    assert {f["rule"] for f in res["json"]["findings"]
            if f["severity"] == "error"} == {"bitplane-dense-fallback"}
    return out


def lint_launch(argv, params, label):
    """``repro_torch.launch.lint.main(argv, params=...)`` in this process
    (the launcher on an existing tree), its printout parsed, the
    counters zeroed around it: (exit code and JSON, record)."""
    import contextlib
    import io
    import warnings
    import torch
    from repro_torch import kernels as tk
    from repro_torch.launch.lint import main as lint_main
    buf = io.StringIO()
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the engine's fallback note
        rc = lint_main(argv, params=params)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    tk.reset_launch_counts()
    got = json.loads(buf.getvalue())
    rules = sorted({f"{f['severity']}:{f['rule']}" for f in got["findings"]})
    log(f"lint {label}: {s:.2f} s, exit {rc}, ok {got['ok']}")
    return {"rc": rc, "json": got}, {"label": label, "rc": rc,
                                     "ok": got["ok"], "s": s, "rules": rules}


def lint_phase(deployed, bp, size=("--no-tiny",)):
    """The serving-graph lint on full-width phi3 (``size``), over the trees
    the earlier phases built: the int8 and int4 packed trees under
    ``kernel`` / ``fused`` with int8 and int4 KV, contiguous and paged
    (16-token pages, 256-token chunks), the bit-plane tree under
    ``bitplane``, the int8 tree through the plain versions (``ref`` /
    ``ref``); each must pass with the reference's rules, and each
    recorded call's kernel ops equal its launches.  Then the planted
    faults (:func:`planted_lint_faults`) and the lint launcher on the int8
    tree (``--no-tiny --kv-bits 8 --attn-backend fused --page-size 16
    --prefill-chunk 256 --json``: exit 0, ``"ok": true``)."""
    t0 = time.perf_counter()
    cfg = served_config(ARCH, 8, "bfloat16", size)
    out = {"cases": []}
    for bits in (8, 4):
        for kv in (8, 4):
            for page, chunk in ((0, 0), (PAGE, SCHED_CHUNK)):
                leg = "paged" if page else "contiguous"
                out["cases"].append(lint_case(
                    f"phi3 int{bits} kv{kv} {leg}", cfg, deployed[bits], leg,
                    kv=kv, page=page, chunk=chunk))
    out["cases"].append(lint_case("phi3 bit-plane", cfg, bp, "paged",
                                  backend="bitplane"))
    out["cases"].append(lint_case("phi3 ref/ref", cfg, deployed[8], "ref",
                                  backend="ref", attn="ref"))
    out["faults"] = planted_lint_faults(cfg, deployed[8], size)
    argv = ["--arch", ARCH, "--backend", "kernel", *size, "--kv-bits", "8",
            "--attn-backend", "fused", "--page-size", str(PAGE),
            "--prefill-chunk", str(SCHED_CHUNK), "--json", "--device", DEV]
    res, out["launcher"] = lint_launch(argv, deployed[8], "launcher, int8")
    assert res["rc"] == 0 and res["json"]["ok"] is True, res
    assert out["launcher"]["rules"] == sorted(LINT_RULES["paged"]), \
        out["launcher"]
    out["phase_s"] = time.perf_counter() - t0
    return out


class LintGuard:
    """Observer around ``repro_torch.analysis.lint_engine`` for a launcher
    drive given ``--lint``: the lint runs with the drive's observers
    (:class:`MatmulCapture`, :class:`TickCapture`) swapped out for the
    wrappers they wrap, its record kept (:func:`lint_record`: its seconds,
    its calls' kernel ops against the launch counters), and the counters
    zeroed after it, so the drive that follows counts, captures and
    times only its own calls."""

    NAMES = (("common", "packed_matmul"), ("common", "bitplane_matmul"),
             ("attention", "paged_attention"))

    def __init__(self):
        from repro_torch import analysis
        self.mod, self.orig = analysis, analysis.lint_engine
        self.record = None

    def __enter__(self):
        self.mod.lint_engine = self.lint
        return self

    def __exit__(self, *exc):
        self.mod.lint_engine = self.orig

    def lint(self, engine, **kw):
        from repro_torch import kernels
        from repro_torch.models import attention, common
        mods = {"common": common, "attention": attention}
        seen = {k: getattr(mods[m], k) for m, k in self.NAMES}
        for m, k in self.NAMES:
            setattr(mods[m], k, getattr(kernels, k))
        try:
            rep, self.record = timed_lint("scheduler drive --lint",
                                          lambda: self.orig(engine, **kw))
        finally:
            for m, k in self.NAMES:
                setattr(mods[m], k, seen[k])
        return rep


# ---------------------------------------------------------------------------
# MoE phase
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
SCOUT_ARCH = "llama4-scout-17b-a16e"
# llama4-scout at full width holds ~2.2 B weights a layer: 48 layers do
# not fit one card in int8 (and its f32 QAT tree not at all), so its leg
# is cut to 2 layers
SCOUT_LAYERS = 2
# (weights, KV bits, activation bits, dtype) of the one-shot MoE drives:
# quantizer-free in f32, then the registered quantization in bf16 with
# int8 and int4 caches
MOE_RUNS = ((8, 32, 32, "float32"), (8, 8, 8, "bfloat16"),
            (4, 4, 8, "bfloat16"))
MOE_BP_RUNS = ((32, 32, "float32"), (8, 8, "bfloat16"))
MOE_CAP_NEW = 8                 # the capacity-dispatch one-shot's tokens
# granite serves the first 4 of its 32 layers (the full-width tree, cut
# in depth): its bit-plane and capacity legs since PR 17 (host-bound
# decode steps of 0.4-0.7 s at full depth), every leg since PR 20 (with
# the deploy phase, ~97 s, the smoke ran 921.8 s with the rest at 16
# layers; at 32 the MoE phase was the largest, 217 s), 4 beside the
# families phase (with it a smoke on a slow host ran 1003 s at 8)
MOE_DEPTH = 4
MOE_ONESHOT = 4                 # quantizer-free requests rerun one-shot
# (K, N) of a routed expert's projections: gate and up, then down
MOE_EXPERT_SHAPES = ((1536, 512), (512, 1536))


def served_config(arch, act_bits, dtype, size=("--no-tiny",), n_layers=0,
                  enc_layers=0):
    """The registered ``arch`` at ``dtype`` with ``act_bits`` PACT
    activations (its 8x128 blocks; with ``size`` ``--tiny`` the launcher's
    tiny config and 9x8 blocks), cut to ``n_layers`` (and an enc-dec
    config's encoder to ``enc_layers``) when given."""
    from repro_torch.configs import REGISTRY, QuantConfig
    base = REGISTRY[arch]
    if size == ("--tiny",):
        base = base.tiny(dtype=dtype).with_quant(
            QuantConfig(mode="fake", n_bits=8, act_bits=act_bits))
    else:
        base = dataclasses.replace(base, dtype=dtype)
        base = base.with_quant(dataclasses.replace(base.quant,
                                                   act_bits=act_bits))
    if n_layers:
        base = dataclasses.replace(base, n_layers=n_layers)
    if enc_layers:
        base = dataclasses.replace(base, enc_layers=enc_layers)
    return base


class RouteTrace:
    """Observer around ``models.moe._route``, the router's top-k choice:
    each call's experts (T, k), the experts this run's own router chose
    and the top-k boundary's gap in its router logits (the k-th largest
    less the (k+1)-th) are kept on the host.  With ``replay`` (another
    run's trace) each call takes that run's experts instead of its own,
    its gates renormalized from this run's probabilities: the same drive
    with its routing forced to the other run's."""

    def __init__(self, replay=None):
        from repro_torch.models import moe
        self.mod, self.orig = moe, moe._route
        self.replay, self.calls = replay, []

    def __enter__(self):
        self.mod._route = self
        return self

    def __exit__(self, *exc):
        self.mod._route = self.orig

    def __call__(self, xt, router_w, top_k):
        import torch
        probs, gates, idx = self.orig(xt, router_w, top_k)
        own = idx
        if self.replay is not None:
            idx = self.replay.calls[len(self.calls)]["idx"].to(idx.device)
            gates = torch.gather(probs, 1, idx)
            gates = gates / torch.sum(gates, -1, keepdim=True)
        srt = torch.sort(probs, dim=-1, descending=True).values
        gap = torch.log(srt[:, top_k - 1]) - torch.log(srt[:, top_k]) \
            if top_k < probs.shape[-1] else torch.full_like(srt[:, 0],
                                                             math.inf)
        self.calls.append({"idx": idx.cpu(), "own": own.cpu(),
                           "gap": gap.detach().cpu()})
        return probs, gates, idx


def route_flips(trace, n_calls):
    """Where a forced run's own router would have chosen other experts
    than the ones it was given (token-layer choices, each on the same
    routing history), over its first ``n_calls`` router calls (those fed
    the tokens the kernel run was fed): the count of all choices and this
    run's top-k boundary gaps in router logits there, against the median
    gap."""
    import torch
    gaps, total = [], 0
    calls = trace.calls[:n_calls]
    for call in calls:
        forced = torch.sort(call["idx"], dim=1).values
        own = torch.sort(call["own"], dim=1).values
        diff = (forced != own).any(1)
        total += int(diff.numel())
        gaps += call["gap"][diff].tolist()
    return dict(choices=total, flipped=len(gaps),
                max_gap=max(gaps) if gaps else None,
                gaps=sorted(gaps)[:16],
                median_gap=float(torch.cat([c["gap"] for c in calls])
                                 .median()) if calls else None)


def moe_pair(cfg, tree, tok, kv, backend="kernel", new=None, page=None,
             impl="ragged"):
    """One configuration through the kernels (``backend``, ``fused``
    attention; warmed up with ``generate``, then counted) and through the
    plain versions, under the ``impl`` dispatch.  The router is a
    discrete choice: where the two runs' sums, in another order, put a
    token on the other side of a near-tie at the top-k boundary, they
    would route it to other experts, and from there the runs part by far
    more than float noise.  So the plain run takes the kernel run's
    routing (:class:`RouteTrace`), and the choices its own router would
    have made otherwise are counted with their gaps
    (:func:`route_flips`); :func:`check_moe` allows a flip only at a
    near-tie.  The kernel run's first weight-matmul call at each shape
    (:class:`MatmulCapture`) and its first layer-0 attention read
    (:class:`TickCapture`) are held against the plain versions after its
    counts are read."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.models.moe import GROUPED_IMPL
    from repro_torch.serve.engine import ServeEngine
    new = NEW if new is None else new
    page = PAGE if page is None else page
    api = build(cfg)
    matmul = "bitplane_matmul" if backend == "bitplane" else "packed_matmul"
    fwd = (tok.shape[0] if page else 1) + new - 1
    want = expected_launches(cfg.n_layers, fwd, new - 1, matmul,
                             layer_matmuls(cfg, impl))
    GROUPED_IMPL["impl"] = impl
    try:
        ker = ServeEngine(api, tree, kv_quant_bits=kv, backend=backend,
                          attn_backend="fused", device=DEV)
        warm = ker.generate({"tokens": tok}, max_new=2).cpu()
        with RouteTrace() as k_routes, MatmulCapture() as mm, \
                TickCapture(first=True) as cap:
            k = counted(lambda: greedy(ker, tok, new, page=page), want)
        matmul_calls = mm.check()
        attention, _, _ = attention_check(cap.case, "first decode read")
        del ker, mm, cap
        ref = ServeEngine(api, tree, kv_quant_bits=kv, backend="ref",
                          attn_backend="ref", device=DEV)
        with RouteTrace(replay=k_routes) as p_routes:
            p = greedy(ref, tok, new, page=page)
        del ref
    finally:
        GROUPED_IMPL["impl"] = "ragged"
    c = compare(k, p)
    # forwards fed the same tokens: the prompt's, then the decode steps
    # before the first step whose tokens part
    same = (tok.shape[0] if page else 1) + (
        c["first_diff"][1] if c["first_diff"] else new)
    return dict(arch=cfg.name, layers=cfg.n_layers, backend=backend,
                impl=impl, kv=kv, act_bits=cfg.quant.act_bits,
                dtype=cfg.dtype, page=page, new=new,
                tokens=k["tokens"].tolist(), launches=k["launches"],
                generate_prefix_equal=None if page else torch.equal(
                    warm, k["tokens"][:, :2]),
                prefill_ms=k["prefill_ms"],
                decode_ms_per_step=k["decode_ms_per_step"],
                plain_decode_ms_per_step=p["decode_ms_per_step"],
                routes=route_flips(p_routes, same * cfg.n_layers),
                matmul_calls=matmul_calls, attention=attention,
                kernel_vs_plain=c)


def moe_log(r):
    c, rt = r["kernel_vs_plain"], r["routes"]
    log(f"{r['arch']} ({r['layers']} layers) {r['backend']} {r['impl']} "
        f"w{r['bits']} kv{r['kv']} act{r['act_bits']} {r['dtype']}: kernel "
        f"vs plain err {c['err']:.3g} tokens {c['token_agreement']:.3f} "
        f"first diff {c['first_diff']}; plain router would flip "
        f"{rt['flipped']}/{rt['choices']} choices, largest gap "
        f"{rt['max_gap']}; decode {r['decode_ms_per_step']:.2f} ms/step")


def grouped_case(tree, cfg, tokens, seed=11):
    """Layer 0's three ragged grouped products (dequantize the expert
    stack, one batched product of the row groups) at ``tokens`` routed
    tokens: timed (``cuda_ms``, bf16 x), the rows the product pads to
    against the real ones (E x the largest group over T x k), and each
    group's first and last row (of a group of two or more) multiplied
    again alone, their bits against the group's: whether a row's result
    depends on how many rows share its expert."""
    import torch
    from repro_torch.models.common import qdense
    from repro_torch.models.moe import _grouped, grouped_matmul
    moe = {n: w.layer(0) if hasattr(w, "layer") else w[0]
           for n, w in tree["layers"]["moe"].items()}
    e, k = cfg.n_experts, cfg.top_k
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = tokens * k
    experts = torch.randint(0, e, (rows,), generator=g, device=DEV)
    sizes = torch.bincount(experts, minlength=e).tolist()
    x = torch.randn((rows, cfg.d_model), generator=g, device=DEV,
                    dtype=torch.bfloat16)

    def layer():
        gate = _grouped(x, moe["expert_gate"], sizes)
        up = _grouped(x, moe["expert_up"], sizes)
        return _grouped(torch.nn.functional.silu(gate) * up,
                        moe["expert_down"], sizes)

    ms = cuda_ms(layer, iters=5, warmup=2)
    w = qdense(moe["expert_gate"], torch.bfloat16)
    y = grouped_matmul(x, w, sizes)
    start, checked, equal, diff = 0, 0, 0, 0.0
    for grp, size in enumerate(sizes):
        for row in ((start, start + size - 1) if size >= 2 else ()):
            alone = grouped_matmul(x[row:row + 1], w[grp:grp + 1], [1])
            checked += 1
            equal += bool(torch.equal(alone[0], y[row]))
            diff = max(diff, float((alone[0].float()
                                    - y[row].float()).abs().max()))
        start += size
    padded = e * max(max(sizes), 2)
    return dict(tokens=tokens, rows=rows, groups=sum(s > 0 for s in sizes),
                padded_rows=padded, padding_ratio=padded / rows,
                ms=ms, rows_checked=checked, rows_equal=equal,
                row_independent=checked == equal, max_abs_diff=diff)


def moe_scheduler(tree, size=("--no-tiny",)):
    """The scheduler trace (``SCHED_*``) through the launcher on the MoE
    tree (``ragged``): bf16 with int8 weights, activations and KV (its
    captured decode tick held against the plain version and timed,
    :func:`captured_tick_case`), then
    quantizers off in f32, whose requests are held against one-shot runs
    (:func:`oneshot_rule`).  Both drives are counted against their tick
    logs and checked by :func:`drive_record`."""
    import torch
    out = {}
    with TickCapture() as cap:
        main = launch(sched_argv(size, ["--kv-bits", "8"], arch=MOE_ARCH),
                      params=tree)
    rec = out["main"] = drive_record(main, "packed_matmul")
    rep = rec["cache_report"]
    assert rep["preemptions"] >= 1 and \
        rep["resumes"] == rep["preemptions"], rep
    assert rep["prefix_hits"] >= 1, rep
    assert {SCHED_SLOTS, SCHED_CHUNK} <= {r["m"] for r in rec["matmul_calls"]}
    assert cap.case is not None, "no decode tick met the capture rule"
    out["captured_tick"] = captured_tick_case(cap.case)
    del main, cap
    log(f"{MOE_ARCH} scheduler drive: {rec['ticks']} ticks, "
        f"{rec['generated_tokens']} tokens, {rec['tokens_per_s']:.1f} tok/s, "
        f"decode tick {rec['decode_tick_ms']:.1f} ms, chunk tick "
        f"{rec['chunk_tick_ms']:.1f} ms")
    off = launch(sched_argv(size, ["--kv-bits", "32", "--act-bits", "32",
                                   "--dtype", "float32"], arch=MOE_ARCH),
                 params=tree)
    rec_off = out["quantizers_off"] = drive_record(off, "packed_matmul")
    for key in ("ticks", "admitted", "finished", "parked"):
        assert rec_off[key] == rec[key], (key, rec_off[key], rec[key])
    out["oneshot"] = oneshot_rule(off, MOE_ONESHOT)
    del off
    torch.cuda.empty_cache()
    return out


def moe_phase(size=("--no-tiny",)):
    """The MoE family at full width (``size``): granite-moe-3b-a800m, its
    first ``MOE_DEPTH`` layers, deployed packed int8 and int4 and
    bit-plane (mixed
    widths), one-shot through the kernels against the plain versions
    (paged, ``ragged``; then ``capacity``, contiguous), the grouped
    product timed and its row independence recorded, ``packed_matmul``
    timed at the expert shapes, the scheduler drive; then
    llama4-scout-17b-a16e at full width cut to ``SCOUT_LAYERS`` layers.
    Returns the readings; :func:`check_moe` judges them."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    out = {"runs": []}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depth = min(MOE_DEPTH, served_config(MOE_ARCH, 8, "bfloat16",
                                         size).n_layers)
    cfg = served_config(MOE_ARCH, 8, "bfloat16", size, depth)
    qat = build(cfg).init(seed=0, device=DEV)
    packed = {b: to_serving_params(qat, b, device=DEV) for b in (8, 4)}
    bp, out["bitplane_deploy"] = deploy_bitplane(qat)
    del qat
    torch.cuda.empty_cache()
    out["deploy_s"] = time.perf_counter() - t0
    tok = torch.randint(0, cfg.vocab, (B, P), device=DEV, dtype=torch.int32,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    log(f"{MOE_ARCH}: init and three deploys in {out['deploy_s']:.1f} s")

    for bits, kv, act, dt in MOE_RUNS:
        r = dict(moe_pair(served_config(MOE_ARCH, act, dt, size, depth),
                          packed[bits], tok, kv), bits=bits)
        out["runs"].append(r)
        moe_log(r)
    for kv, act, dt in MOE_BP_RUNS:
        r = dict(moe_pair(served_config(MOE_ARCH, act, dt, size, depth), bp,
                          tok, kv, backend="bitplane"), bits="bitplane")
        out["runs"].append(r)
        moe_log(r)
    del bp
    for kv, act, dt in ((32, 32, "float32"), (8, 8, "bfloat16")):
        r = dict(moe_pair(served_config(MOE_ARCH, act, dt, size, depth),
                          packed[8], tok, kv, new=MOE_CAP_NEW, page=0,
                          impl="capacity"), bits=8)
        out["runs"].append(r)
        moe_log(r)
    out["phase1_s"] = time.perf_counter() - t0
    out["lint"] = lint_case(f"{MOE_ARCH} int8 kv8 paged", cfg, packed[8],
                            "moe")

    t1 = time.perf_counter()
    out["grouped"] = [grouped_case(packed[8], cfg, t)
                      for t in (B, SCHED_SLOTS, SCHED_CHUNK, B * P)]
    out["expert_matmul"] = [time_packed(m, k, n, 8)
                            for m in (SCHED_SLOTS, 208)
                            for k, n in MOE_EXPERT_SHAPES]
    out["time_s"] = time.perf_counter() - t1
    for gcase in out["grouped"]:
        log(f"ragged grouped product, layer 0, {gcase['tokens']} tokens: "
            f"{gcase['ms']:.3f} ms, padded to {gcase['padding_ratio']:.2f}x "
            f"the rows; rows alone = in group: "
            f"{gcase['rows_equal']}/{gcase['rows_checked']}")

    t1 = time.perf_counter()
    del packed[4]
    with cut_serve_config(depth):
        out["scheduler"] = moe_scheduler(packed[8], size)
    out["scheduler_s"] = time.perf_counter() - t1
    del packed
    torch.cuda.empty_cache()
    out["granite_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    scfg = served_config(SCOUT_ARCH, 8, "bfloat16", size, SCOUT_LAYERS)
    qat = build(scfg).init(seed=0, device=DEV)
    scout = to_serving_params(qat, 8, device=DEV)
    del qat
    torch.cuda.empty_cache()
    stok = torch.randint(0, scfg.vocab, (B, P), device=DEV,
                         dtype=torch.int32,
                         generator=torch.Generator(device=DEV).manual_seed(3))
    for kv, act, dt in ((32, 32, "float32"), (8, 8, "bfloat16")):
        r = dict(moe_pair(served_config(SCOUT_ARCH, act, dt, size,
                                     SCOUT_LAYERS), scout, stok, kv), bits=8)
        out["runs"].append(r)
        moe_log(r)
    del scout
    torch.cuda.empty_cache()
    out["scout_s"] = time.perf_counter() - t1
    out["scout_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t0
    return out


def check_moe(res):
    """Every MoE drive finite, its tokens of the right shape and
    vocabulary and, contiguous, its ``generate`` warm-up the loop's first
    tokens; kernels vs plain (on the kernel run's routing): quantizer-free,
    tokens identical, logits within ``EXACT_TOL_REL`` of the largest and
    every choice the plain run's own router would have flipped at a
    near-tie (gap below ``ROUTE_TIE_GAP``); quantized, within
    ``QUANT_TOL_REL`` for its KV width while prefixes agree.  The
    captured calls (matmuls, attention) were held in :func:`moe_pair`,
    the scheduler drives' checks in :func:`moe_scheduler`; no one-shot
    rerun may part from its request but at a near-tied step."""
    import torch
    from repro_torch.configs import REGISTRY
    for r in res["runs"]:
        tag = (r["arch"], r["backend"], r["impl"], r["kv"], r["act_bits"])
        toks = torch.tensor(r["tokens"])
        assert toks.shape == (B, r["new"]), tag
        assert 0 <= int(toks.min()) <= int(toks.max()) < \
            REGISTRY[r["arch"]].vocab, tag
        assert r["generate_prefix_equal"] is not False, \
            ("generate vs loop", tag)
        c = r["kernel_vs_plain"]
        assert c["finite"], tag
        if r["act_bits"] >= 32 and r["kv"] >= 32:
            assert c["err"] <= EXACT_TOL_REL and c["first_diff"] is None, \
                (tag, c)
            gap = r["routes"]["max_gap"]
            assert gap is None or gap < ROUTE_TIE_GAP, (tag, r["routes"])
        else:
            assert c["err"] <= QUANT_TOL_REL[r["kv"]], (tag, c)
    bad = [r for r in res["scheduler"]["oneshot"]
           if r["parted_at"] is not None and not r["allowed"]]
    assert not bad, ("MoE scheduler tokens part from one-shot", bad)
    assert {(r["arch"], r["impl"]) for r in res["runs"]} == {
        (MOE_ARCH, "ragged"), (MOE_ARCH, "capacity"), (SCOUT_ARCH, "ragged")}


def moe_summary(res) -> dict:
    """The MoE phase's figures for the printout."""
    def run(arch, backend, impl, kv):
        r = next(r for r in res["runs"] if (r["arch"], r["backend"],
                                             r["impl"], r["kv"]) ==
                 (arch, backend, impl, kv))
        return {"decode_ms_per_step": r["decode_ms_per_step"],
                "prefill_ms": r["prefill_ms"],
                "err": r["kernel_vs_plain"]["err"],
                "launches": r["launches"]}
    sm, so = res["scheduler"]["main"], res["scheduler"]["quantizers_off"]
    return {
        "arch": MOE_ARCH, "phase_s": res["phase_s"],
        "ragged_int8_kv8_bf16": run(MOE_ARCH, "kernel", "ragged", 8),
        "capacity_int8_kv8_bf16": run(MOE_ARCH, "kernel", "capacity", 8),
        "bitplane_kv8_bf16": run(MOE_ARCH, "bitplane", "ragged", 8),
        "scout_2_layers_kv8_bf16": run(SCOUT_ARCH, "kernel", "ragged", 8),
        "scheduler": {k: sm[k] for k in (
            "ticks", "tokens_per_s", "decode_tick_ms", "chunk_tick_ms",
            "launches")},
        "scheduler_f32_tokens_per_s": so["tokens_per_s"],
        "oneshot_parts": [r["parted_at"] for r in
                          res["scheduler"]["oneshot"]],
        "grouped_ms": {g["tokens"]: g["ms"] for g in res["grouped"]},
        "grouped_padding": {g["tokens"]: g["padding_ratio"]
                            for g in res["grouped"]},
        "route_max_gap_f32": max((r["routes"]["max_gap"] or 0.0)
                                 for r in res["runs"]
                                 if r["dtype"] == "float32"),
        "captured_tick_err": res["scheduler"]["captured_tick"]["err"],
        "row_independent": all(g["row_independent"]
                               for g in res["grouped"]),
        "expert_matmul": [{k: r[k] for k in ("m", "k", "n", "ms",
                                             "device_ms", "bound_ms",
                                             "library_device_ms")}
                          for r in res["expert_matmul"]],
        "peak_mem_gb": max(res["granite_peak_mem_gb"],
                           res["scout_peak_mem_gb"])}


# ---------------------------------------------------------------------------
# enc-dec phase
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
# layers of each stack in the smoke (24 + 24 registered): cut to keep the
# smoke under ~900 s with the families phase (at 12 + 12 a smoke on a
# slow host ran 1003 s)
ENCDEC_DEPTH = 6
S_ENC = 256                     # frames a prompt: cross K/V at M = B*S_ENC
# (weights, KV bits, activation bits, dtype) of the one-shot enc-dec legs:
# quantizer-free in f32, then the registered quantization in bf16 with
# int8 and int4 caches (the family has no PACT leaves, in the reference
# as here: its activations are never rounded to levels)
ENCDEC_RUNS = ((8, 32, 32, "float32"), (8, 8, 8, "bfloat16"),
               (4, 4, 8, "bfloat16"))
ENC_LAYER_MATMULS = 8           # 4 attention, 2 conformer pointwise, 2 MLP
# (M, K, N) of packed_matmul at the family's new shapes, M = B*S_ENC: the
# cross K/V projection (and every square projection of the encoder), and
# the encoder MLP's input
ENCDEC_TIMED = ((B * S_ENC, 1024, 1024), (B * S_ENC, 1024, 8192))


def encdec_frames(d_model, b, seed=4):
    """(b, S_ENC, d_model) f32 frames, 0.1 x standard normal, seeded."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((b, S_ENC, d_model), generator=g, device=DEV) * 0.1


def encdec_launches(cfg, forwards, decode_steps, encoder_runs,
                    matmul="packed_matmul"):
    """:func:`expected_launches` of an enc-dec drive: the decoder's
    :func:`layer_matmuls` a layer a forward, one ``paged_attention`` a
    layer a single-token forward, and ``ENC_LAYER_MATMULS`` an encoder
    layer for each of ``encoder_runs`` prompt rows' encoder passes."""
    out = expected_launches(cfg.n_layers, forwards, decode_steps, matmul,
                            layer_matmuls(cfg))
    out[matmul] += encoder_runs * cfg.enc_layers * ENC_LAYER_MATMULS
    return out


def swap_enc_out(state):
    """The planted enc-dec fault: slots 0 and 1 read each other's encoder
    output from the first decode step on."""
    e = state["enc_out"]
    e[[0, 1]] = e[[1, 0]]


def encoder_ms(eng, frames):
    """Host-clock ms of ``eng``'s encoder alone over ``frames``
    (synchronized; the second of two runs)."""
    import torch
    from repro_torch.models.common import prepare_params
    from repro_torch.models.encdec import encode
    from repro_torch.models.transformer import _cdtype
    cfg = eng.api.cfg
    mp = prepare_params(eng.params, _cdtype(cfg))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(mp, cfg, frames, eng.backend)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def encdec_pair(cfg, tree, tok, frames, kv, backend="kernel", paged=False,
                fault=False):
    """One enc-dec configuration, contiguous, through the kernels
    (``backend``, ``fused`` attention; warmed up with ``generate``, then
    counted, its first weight-matmul call at each shape and its first
    layer-0 attention read held against the plain versions) and through
    the plain versions.  ``paged`` adds a counted kernel run through a
    16-token page pool with a non-identity table (``prefill_at`` a slot,
    so the encoder runs a row at a time); ``fault`` a kernel run with two
    slots' ``enc_out`` rows swapped after the prefill
    (:func:`swap_enc_out`), held against the plain run."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.serve.engine import ServeEngine
    api = build(cfg)
    matmul = "bitplane_matmul" if backend == "bitplane" else "packed_matmul"
    b = tok.shape[0]
    ker = ServeEngine(api, tree, kv_quant_bits=kv, backend=backend,
                      attn_backend="fused", device=DEV)
    warm = ker.generate({"tokens": tok, "frames": frames}, max_new=2).cpu()
    with MatmulCapture() as mm, TickCapture(first=True) as cap:
        k = counted(lambda: greedy(ker, tok, NEW, frames=frames),
                    encdec_launches(cfg, NEW, NEW - 1, 1, matmul))
    rec = dict(arch=cfg.name, layers=cfg.n_layers,
               enc_layers=cfg.enc_layers, backend=backend, kv=kv,
               act_bits=cfg.quant.act_bits, dtype=cfg.dtype, new=NEW,
               s_enc=frames.shape[1], tokens=k["tokens"].tolist(),
               launches=k["launches"],
               generate_prefix_equal=torch.equal(warm, k["tokens"][:, :2]),
               prefill_ms=k["prefill_ms"],
               decode_ms_per_step=k["decode_ms_per_step"],
               matmul_calls=mm.check())
    rec["attention"], _, _ = attention_check(cap.case, "first decode read")
    rec["encoder_ms"] = encoder_ms(ker, frames)
    rec["decoder_prompt_ms"] = rec["prefill_ms"] - rec["encoder_ms"]
    if paged:
        pg = counted(lambda: greedy(ker, tok, NEW, page=PAGE, frames=frames),
                     encdec_launches(cfg, b + NEW - 1, NEW - 1, b, matmul))
        rec["paged"] = dict(launches=pg["launches"],
                            tokens_equal=torch.equal(pg["tokens"],
                                                     k["tokens"]),
                            vs_contiguous=compare(pg, k))
    f = greedy(ker, tok, NEW, frames=frames, after_prefill=swap_enc_out) \
        if fault else None
    del ker, mm, cap
    ref = ServeEngine(api, tree, kv_quant_bits=kv, backend="ref",
                      attn_backend="ref", device=DEV)
    p = greedy(ref, tok, NEW, frames=frames)
    del ref
    rec["plain_decode_ms_per_step"] = p["decode_ms_per_step"]
    rec["plain_prefill_ms"] = p["prefill_ms"]
    rec["kernel_vs_plain"] = compare(k, p)
    if f is not None:
        rec["fault_swapped_enc_out"] = compare(f, p)
    return rec


def encdec_log(r):
    c = r["kernel_vs_plain"]
    log(f"{r['arch']} ({r['enc_layers']}+{r['layers']} layers) "
        f"{r['backend']} w{r['bits']} kv{r['kv']} {r['dtype']}: kernel vs "
        f"plain err {c['err']:.3g} tokens {c['token_agreement']:.3f}; "
        f"prefill {r['prefill_ms']:.1f} ms (encoder {r['encoder_ms']:.1f}), "
        f"decode {r['decode_ms_per_step']:.2f} ms/step (plain "
        f"{r['plain_decode_ms_per_step']:.2f})" +
        (f"; paged tokens equal {r['paged']['tokens_equal']}"
         if "paged" in r else "") +
        (f"; swapped enc_out err {r['fault_swapped_enc_out']['err']:.3g}"
         if "fault_swapped_enc_out" in r else ""))


def encdec_profile(eng, tok, frames):
    """One decode step of ``eng`` (B rows after their prompts, contiguous)
    under ``torch.profiler``: the wall time and the device time of its
    CUDA kernels, split into ``packed_matmul``'s byte-streaming regime
    (M <= 16: the decoder's projections at M = B), its tensor regime (M =
    B*S_ENC: the cross K/V projections), ``paged_attention``,
    ``attention_core`` (the cross-attention, through a
    ``record_function`` around each call) and the rest (the tied head,
    norms, the MLP's activation, casts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention
    p = tok.shape[1]
    logits, state = eng.prefill({"tokens": tok, "frames": frames},
                                extra_slots=64)
    cur = logits.argmax(-1)[:, None].to(torch.int32)
    logits, state = eng.decode(cur, state, p)          # warm
    cur = logits.argmax(-1)[:, None].to(torch.int32)
    core = attention.attention_core

    def annotated(*a, **kw):
        with record_function("encdec.attention_core"):
            return core(*a, **kw)

    attention.attention_core = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.decode(cur, state, p + 1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        attention.attention_core = core
    parts = {"packed_matmul_stream": 0.0, "packed_matmul_tensor": 0.0,
             "paged_attention": 0.0, "attention_core": 0.0, "rest": 0.0}
    calls = dict.fromkeys(parts, 0)
    top = []
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for e in prof.key_averages():
        # the annotation's own device-side range spans the gaps between
        # its kernels (the card waits for the host): not a kernel
        if e.device_type != cuda or e.key == "encdec.attention_core":
            continue
        ms = e.self_device_time_total / 1e3
        kind = "paged_attention" if "paged_attention_kernel" in e.key else \
            "packed_matmul_tensor" if "wmm::tensor_kernel" in e.key else \
            "packed_matmul_stream" if "wmm::stream_kernel" in e.key else \
            "rest"
        parts[kind] += ms
        calls[kind] += e.count
        top.append((ms, e.key[:100], e.count))
    # attention_core's kernels: those of the ops inside each annotation
    core_ev = [e for e in prof.events()
               if e.name == "encdec.attention_core" and e.device_type == cpu]
    parts["attention_core"] = sum(ch.device_time_total for e in core_ev
                                  for ch in e.cpu_children) / 1e3
    parts["rest"] -= parts["attention_core"]
    calls["attention_core"] = len(core_ev)
    device_ms = sum(parts.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1 - device_ms / wall_ms),
                device_ms_by_part=parts, calls=calls,
                share=({k: v / device_ms for k, v in parts.items()}
                       if device_ms else None),
                top_kernels=[dict(ms=m, kernel=k, calls=c)
                             for m, k, c in sorted(top, reverse=True)[:12]])


def encdec_scheduler(tree, size=("--no-tiny",), depth=0):
    """The scheduler trace (``SCHED_*``) through the launcher on the
    enc-dec tree, every request's frames ``S_ENC`` wide (the launcher's
    ``--prompt-len``): bf16 with int8 weights and KV, then quantizers off
    in f32, whose requests are held against one-shot runs
    (:func:`oneshot_rule`, every rerun identical).  The prefix cache the
    trace asks for is turned off with the reference's warning (no page is
    looked up); parked requests take their ``enc_out`` rows with them.
    Both drives are counted against their tick logs (the encoder once a
    request) and checked by :func:`drive_record`; the bf16 drive's
    captured decode tick (no aliased pages here) is held against the
    plain version and timed."""
    import torch
    import warnings
    out = {}
    extra = ["--prompt-len", str(S_ENC)]
    cut = cut_serve_config(depth, depth) if depth else \
        contextlib.nullcontext()
    with warnings.catch_warnings(record=True) as caught, \
            TickCapture(aliased=False) as cap, cut:
        warnings.simplefilter("always")
        main = launch(sched_argv(size, ["--kv-bits", "8", *extra],
                                 arch=ENCDEC_ARCH), params=tree)
    rec = out["main"] = drive_record(main, "packed_matmul")
    rep, stats = rec["cache_report"], main["scheduler"].sched_stats
    rec["prefix_cache_warned"] = any(
        "prefix_cache needs" in str(w.message) for w in caught)
    assert rec["prefix_cache_warned"] and \
        main["scheduler"].prefix_cache is None, caught
    assert stats["prefix_lookups"] == 0 and stats["prefix_hits"] == 0, stats
    assert rep["preemptions"] >= 1 and \
        rep["resumes"] == rep["preemptions"], rep
    assert all(q.inputs["frames"].shape[1] == S_ENC
               for q in main["requests"])
    assert {SCHED_SLOTS, SCHED_CHUNK, SCHED_SLOTS * S_ENC} <= {
        r["m"] for r in rec["matmul_calls"]}, rec["matmul_calls"]
    assert cap.case is not None, "no decode tick met the capture rule"
    out["captured_tick"] = captured_tick_case(cap.case)
    del main, cap
    log(f"{ENCDEC_ARCH} scheduler drive: {rec['ticks']} ticks, "
        f"{rec['generated_tokens']} tokens, {rec['tokens_per_s']:.1f} tok/s, "
        f"decode tick {rec['decode_tick_ms']:.1f} ms, chunk tick "
        f"{rec['chunk_tick_ms']:.1f} ms, parks {rep['preemptions']}")
    with cut_serve_config(depth, depth) if depth else \
            contextlib.nullcontext():
        off = launch(sched_argv(size, ["--kv-bits", "32", "--act-bits",
                                       "32", "--dtype", "float32", *extra],
                                arch=ENCDEC_ARCH), params=tree)
    rec_off = out["quantizers_off"] = drive_record(off, "packed_matmul")
    for key in ("ticks", "admitted", "finished", "parked"):
        assert rec_off[key] == rec[key], (key, rec_off[key], rec[key])
    out["oneshot"] = oneshot_rule(off)
    del off
    torch.cuda.empty_cache()
    return out


def encdec_phase(size=("--no-tiny",)):
    """The enc-dec family at full width (``size``): seamless-m4t-large-v2,
    its first ``ENCDEC_DEPTH`` = 6 of 24 encoder and decoder layers,
    random weights from seed 0, deployed packed int8 and int4 and as
    mixed-width bit planes; one-shot legs (B=4 x 128 tokens over 256
    frames each, 32 new) through the kernels
    against the plain versions (:func:`encdec_pair`); one decode step
    profiled; ``packed_matmul`` timed at its new shapes and
    ``paged_attention`` at its head; the scheduler drive.  Returns the
    readings; :func:`check_encdec` judges them."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine
    out = {"runs": []}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = served_config(ENCDEC_ARCH, 8, "bfloat16", size)
    depth = min(ENCDEC_DEPTH, full.n_layers, full.enc_layers)
    cut = dict(n_layers=depth, enc_layers=depth)
    cfg = served_config(ENCDEC_ARCH, 8, "bfloat16", size, **cut)
    out["layers"] = f"{depth}+{depth}"
    qat = build(cfg).init(seed=0, device=DEV)
    packed = {b: to_serving_params(qat, b, device=DEV) for b in (8, 4)}
    bp, out["bitplane_deploy"] = deploy_bitplane(qat)
    del qat
    torch.cuda.empty_cache()
    out["deploy_s"] = time.perf_counter() - t0
    tok = torch.randint(0, cfg.vocab, (B, P), device=DEV, dtype=torch.int32,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    frames = encdec_frames(cfg.d_model, B)
    log(f"{ENCDEC_ARCH}: init and three deploys in {out['deploy_s']:.1f} s")

    for bits, kv, act, dt in ENCDEC_RUNS:
        r = dict(encdec_pair(served_config(ENCDEC_ARCH, act, dt, size,
                                           **cut),
                             packed[bits], tok, frames, kv, paged=kv == 32,
                             fault=(bits, kv) == (8, 8)), bits=bits)
        out["runs"].append(r)
        encdec_log(r)
    r = dict(encdec_pair(served_config(ENCDEC_ARCH, 32, "float32", size,
                                       **cut),
                         bp, tok, frames, 32, backend="bitplane"),
             bits="bitplane")
    out["runs"].append(r)
    encdec_log(r)
    del bp, packed[4]
    torch.cuda.empty_cache()
    out["oneshot_s"] = time.perf_counter() - t0
    out["lint"] = lint_case(f"{ENCDEC_ARCH} int8 kv8 paged", cfg,
                            packed[8], "paged")

    t1 = time.perf_counter()
    eng = ServeEngine(build(cfg), packed[8], kv_quant_bits=8,
                      backend="kernel", attn_backend="fused", device=DEV)
    out["profile"] = encdec_profile(eng, tok, frames)
    del eng
    out["packed_matmul"] = [time_packed(m, k, n, 8)
                            for m, k, n in ENCDEC_TIMED]
    kvh, _, dh = ENCDEC_HEAD
    out["attention"] = time_attention(8, P + NEW // 2, P + 64, kvh=kvh,
                                      dh=dh)
    out["time_s"] = time.perf_counter() - t1
    prof = out["profile"]
    log(f"{ENCDEC_ARCH} profiled decode step: wall {prof['wall_ms']:.2f} "
        f"ms, device {prof['device_ms']:.3f} ms, by part "
        f"{ {k: round(v, 4) for k, v in prof['device_ms_by_part'].items()} }")

    t1 = time.perf_counter()
    out["scheduler"] = encdec_scheduler(packed[8], size, depth)
    out["scheduler_s"] = time.perf_counter() - t1
    del packed
    torch.cuda.empty_cache()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t0
    return out


def check_encdec(res):
    """Every enc-dec drive finite, its tokens of the right shape and
    vocabulary, its ``generate`` warm-up the loop's first tokens; kernels
    vs plain: quantizer-free, tokens identical and logits within
    ``EXACT_TOL_REL`` of the largest (and the paged run's tokens the
    contiguous run's); quantized, within ``QUANT_TOL_REL`` for its KV
    width while prefixes agree; the swapped ``enc_out`` fault above
    ``QUANT_TOL_REL[8]``.  The launches were counted and the captured
    calls held in :func:`encdec_pair`, the scheduler drives' checks made
    in :func:`encdec_scheduler`; every one-shot rerun of the scheduler's
    requests gives the drive's tokens."""
    import torch
    from repro_torch.configs import REGISTRY
    vocab = REGISTRY[ENCDEC_ARCH].vocab
    for r in res["runs"]:
        tag = (r["backend"], r["bits"], r["kv"], r["dtype"])
        toks = torch.tensor(r["tokens"])
        assert toks.shape == (B, r["new"]), tag
        assert 0 <= int(toks.min()) <= int(toks.max()) < vocab, tag
        assert r["generate_prefix_equal"], ("generate vs loop", tag)
        c = r["kernel_vs_plain"]
        assert c["finite"], tag
        if r["act_bits"] >= 32 and r["kv"] >= 32:
            assert c["err"] <= EXACT_TOL_REL and c["first_diff"] is None, \
                (tag, c)
        else:
            assert c["err"] <= QUANT_TOL_REL[r["kv"]], (tag, c)
        if "paged" in r:
            assert r["paged"]["tokens_equal"], (tag, r["paged"])
        if "fault_swapped_enc_out" in r:
            assert r["fault_swapped_enc_out"]["err"] > QUANT_TOL_REL[8], \
                (tag, r["fault_swapped_enc_out"])
    assert {(r["backend"], r["kv"]) for r in res["runs"]} == {
        ("kernel", 32), ("kernel", 8), ("kernel", 4), ("bitplane", 32)}
    assert any("paged" in r for r in res["runs"]) and \
        any("fault_swapped_enc_out" in r for r in res["runs"])
    parts = [r for r in res["scheduler"]["oneshot"]
             if r["parted_at"] is not None]
    assert not parts, ("enc-dec scheduler tokens part from one-shot", parts)


def encdec_summary(res) -> dict:
    """The enc-dec phase's figures for the printout."""
    def run(backend, bits, kv):
        r = next(r for r in res["runs"]
                 if (r["backend"], r["bits"], r["kv"]) == (backend, bits,
                                                           kv))
        return {"prefill_ms": r["prefill_ms"],
                "encoder_ms": r["encoder_ms"],
                "decode_ms_per_step": r["decode_ms_per_step"],
                "plain_decode_ms_per_step": r["plain_decode_ms_per_step"],
                "err": r["kernel_vs_plain"]["err"],
                "launches": r["launches"]}
    sm, so = res["scheduler"]["main"], res["scheduler"]["quantizers_off"]
    prof = res["profile"]
    return {
        "arch": ENCDEC_ARCH, "layers": res["layers"], "s_enc": S_ENC,
        "phase_s": res["phase_s"],
        "int8_kv32_f32": run("kernel", 8, 32),
        "int8_kv8_bf16": run("kernel", 8, 8),
        "int4_kv4_bf16": run("kernel", 4, 4),
        "bitplane_kv32_f32": run("bitplane", "bitplane", 32),
        "paged_tokens_equal": all(r["paged"]["tokens_equal"]
                                  for r in res["runs"] if "paged" in r),
        "fault_swapped_enc_out_err": next(
            r["fault_swapped_enc_out"]["err"] for r in res["runs"]
            if "fault_swapped_enc_out" in r),
        "scheduler": {k: sm[k] for k in (
            "ticks", "tokens_per_s", "decode_tick_ms", "chunk_tick_ms",
            "ttft_ms_mean", "parked", "launches")},
        "scheduler_f32_tokens_per_s": so["tokens_per_s"],
        "oneshot_parts": [r["parted_at"] for r in
                          res["scheduler"]["oneshot"]],
        "captured_tick_err": res["scheduler"]["captured_tick"]["err"],
        "decode_step_profile": {k: prof[k] for k in (
            "wall_ms", "device_ms", "idle_share", "device_ms_by_part",
            "calls")},
        "packed_matmul": [{k: r[k] for k in ("m", "k", "n", "ms",
                                             "device_ms", "bound_ms",
                                             "plain_ms",
                                             "library_device_ms")}
                          for r in res["packed_matmul"]],
        "attention": {k: res["attention"][k] for k in (
            "kv", "dh", "kv_len", "device_ms", "bound_ms",
            "library_device_ms")},
        "peak_mem_gb": res["peak_mem_gb"]}


# ---------------------------------------------------------------------------
# families phase
# ---------------------------------------------------------------------------

# The last three model families at full width and depth: qwen2-vl-2b (vlm:
# M-RoPE, a 256-token vision prefix a prompt, GQA 12 over 2 KV heads),
# rwkv6-1.6b (ssm: no KV cache, a recurrent state a layer) and zamba2-1.2b
# (hybrid: 38 Mamba-2 layers and one shared attention + MLP block called
# every 6).  Random weights from seed 0, bf16 unless a leg says f32.
FAMILY_ARCHS = ("qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b")
# layers each family serves in the families phase: about a quarter of
# the registered depth (28, 24, 38), to keep the smoke within its time
# (at full depth the phase took 199 s of a 871.6 s smoke, at 14 / 12 / 20
# layers 92.8 s of 964.0); zamba2 keeps one shared-block call and its
# 2-layer tail past it (8 = 6 + 2)
FAMILY_DEPTH = {"qwen2-vl-2b": 6, "rwkv6-1.6b": 6, "zamba2-1.2b": 8}
FAMILY_BP_NEW = 8               # the bit-plane leg's new tokens
# one fault a family, every layer's leaf at once: its K rows read one WB
# row (8 rows) off
FAMILY_FAULT = {"vlm": ("mlp", "w_down"), "ssm": ("cm_wv",),
                "hybrid": ("out_proj",)}
# the scheduler trace: 12 requests every 2 ticks, prompts 64-1024 tokens
# (200, 300 and 450 are multiples of neither scan chunk, 32 and 128, so
# the per-token scans run), budgets 16 / 32, 8 slots; qwen2-vl paged and
# chunked at 256 (its vision prefix rides the first chunk), rwkv6 unpaged,
# zamba2 paged with overcommit 1.5 over FAMILY_PAGES pages (parks)
FAMILY_WIDTHS = (1024, 64, 200, 512, 128, 300, 768, 96, 450, 256, 640, 160)
FAMILY_BUDGETS = (16, 32)
FAMILY_PAGES = 120
FAMILY_ONESHOT = 4              # quantizer-free requests rerun one-shot
# The tensor regime's rounding a call: with f32 x, its bf16 hi/lo split
# drops the x_lo * w_lo term, ~2^-16 of the output's rms (the stream
# regime's products are exact).  The noise witness adds that much to
# every deployed-weight matmul of a plain run (:class:`MatmulNoise`).
WITNESS_SIGMA = 2.0 ** -16
# Quantizer-free limits by family: the kernels' logits against the plain
# versions', relative to the largest, while token prefixes agree; a
# greedy token may part only where the plain run's top-two gap is below
# the limit.  Set between each family's noise witness and its planted
# fault.  Random rwkv6 and, far more, Mamba-2 layers carry a matmul's
# rounding along the sequence into the logits: the witness reads 9.78e-5
# (qwen2-vl), 3.35e-4 (rwkv6) and 0.102 (zamba2, its tokens parting at
# step 11), the kernels 2.31e-5, 9.68e-5 and 5.84e-3, the planted faults
# 1.13-1.22 (H100, scripts/families_probe.py).  qwen2-vl keeps
# EXACT_TOL_REL (its witness is recorded); the other two limits hold the
# witness.
FAMILY_F32_TOL = {"vlm": EXACT_TOL_REL, "ssm": 1e-3, "hybrid": 0.3}


def family_matmuls(cfg):
    """(weight matmuls a forward, fused attention reads a single-token
    forward) of a family's model: qwen2-vl 7 a layer and a read a layer;
    rwkv6 8 a layer (5 time-mix, 3 channel-mix projections) and none;
    zamba2 6 a Mamba-2 layer (x, z, B, C, dt, out) and 7 a shared-block
    call (4 attention, 3 MLP) with a read each."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return 8 * L, 0
    if cfg.family == "hybrid":
        calls = L // cfg.hybrid_attn_every
        return 6 * L + 7 * calls, calls
    return 7 * L, L


def family_launches(cfg, forwards, decode_steps, vision=0,
                    matmul="packed_matmul"):
    """Launches of a family drive: :func:`family_matmuls` for every
    forward, and ``vision`` vision-prefix projections (a vlm prefill's
    ``vision_proj``, once a call that carries a prefix)."""
    per, reads = family_matmuls(cfg)
    out = {"packed_matmul": 0, "paged_attention": reads * decode_steps,
           "bitplane_matmul": 0, "pact_quant": 0}
    out[matmul] = per * forwards + (vision if cfg.family == "vlm" else 0)
    return out


def family_inputs(cfg, tok, seed=4):
    """The prompt batch: ``tok``, and for a vlm its (B, vision_tokens,
    d_model) vision prefix, 0.1 x standard normal, seeded."""
    import torch
    out = {"tokens": tok}
    if cfg.family == "vlm":
        g = torch.Generator(device=DEV).manual_seed(seed)
        out["vision_embeds"] = torch.randn(
            (tok.shape[0], cfg.vision_tokens, cfg.d_model), generator=g,
            device=DEV) * 0.1
    return out


def family_fault(tree, cfg):
    """The planted fault (``FAMILY_FAULT``): every layer's leaf with its
    K rows rolled by one WB row, as a wrong row offset would read it."""
    import torch
    path = FAMILY_FAULT[cfg.family]
    out = dict(tree)
    node = out["layers"] = dict(tree["layers"])
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    sw = node[path[-1]]
    node[path[-1]] = dataclasses.replace(
        sw, w_int=torch.roll(sw.w_int, 8, dims=1))
    return out


class MatmulNoise:
    """Observer around the deployed-weight matmuls
    (``models.common._qmatmul_packed`` / ``_qmatmul_bitplane``): each
    output gets seeded Gaussian noise of ``WITNESS_SIGMA`` times its rms
    added, the size of the tensor regime's rounding.  A plain run inside
    it is the noise witness: how far the model carries a kernel's
    rounding to its logits."""

    NAMES = ("_qmatmul_packed", "_qmatmul_bitplane")

    def __init__(self, seed=9):
        import torch
        from repro_torch.models import common
        self.mod = common
        self.orig = {n: getattr(common, n) for n in self.NAMES}
        self.gen = torch.Generator(device=DEV).manual_seed(seed)

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.mod, name, self.noisy(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)

    def noisy(self, fn):
        import torch

        def call(x, w, backend):
            y = fn(x, w, backend).float()
            rms = y.square().mean().sqrt()
            n = torch.randn(y.shape, generator=self.gen, device=y.device)
            return (y + WITNESS_SIGMA * rms * n).to(x.dtype)
        return call


def family_pair(cfg, tree, inputs, kv, backend="kernel", new=NEW,
                paged=False, fault=None, witness=False):
    """One configuration of a family, contiguous, through the kernels
    (``backend``, ``fused`` attention; warmed up with ``generate``, then
    counted, its first weight-matmul call at each shape and, where the
    family has KV, its first layer-0 attention read held against the
    plain versions) and through the plain versions.  ``paged`` adds a
    counted kernel run through a 16-token pool with a non-identity table
    (``prefill_at`` a slot: a fresh slot's recurrent rows zeroed);
    ``fault`` a kernel run on that tree for one token, held against the
    plain run; ``witness`` a plain run under :class:`MatmulNoise`, held
    against the plain run."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.serve.engine import ServeEngine
    api = build(cfg)
    matmul = "bitplane_matmul" if backend == "bitplane" else "packed_matmul"
    tok = inputs["tokens"]
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    b = tok.shape[0]
    ker = ServeEngine(api, tree, kv_quant_bits=kv, backend=backend,
                      attn_backend="fused", device=DEV)
    warm = ker.generate(inputs, max_new=2).cpu()
    with MatmulCapture() as mm, TickCapture(first=True) as cap:
        k = counted(lambda: greedy(ker, tok, new, extra=extra),
                    family_launches(cfg, new, new - 1, 1, matmul))
    rec = dict(arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
               backend=backend, kv=kv, act_bits=cfg.quant.act_bits,
               dtype=cfg.dtype, new=new, tokens=k["tokens"].tolist(),
               launches=k["launches"],
               generate_prefix_equal=torch.equal(warm, k["tokens"][:, :2]),
               prefill_ms=k["prefill_ms"],
               decode_ms_per_step=k["decode_ms_per_step"],
               decode_tokens_per_s=b * 1e3 / k["decode_ms_per_step"],
               matmul_calls=mm.check())
    if cfg.family != "ssm":
        rec["attention"], _, _ = attention_check(cap.case,
                                                 "first decode read")
    if paged:
        pg = counted(lambda: greedy(ker, tok, new, page=PAGE, extra=extra),
                     family_launches(cfg, b + new - 1, new - 1, b, matmul))
        rec["paged"] = dict(launches=pg["launches"],
                            tokens_equal=torch.equal(pg["tokens"],
                                                     k["tokens"]),
                            vs_contiguous=compare(pg, k))
    del ker, mm, cap
    f = None
    if fault is not None:
        eng = ServeEngine(api, fault, kv_quant_bits=kv, backend=backend,
                          attn_backend="fused", device=DEV)
        f = greedy(eng, tok, 1, extra=extra)
        del eng
    ref = ServeEngine(api, tree, kv_quant_bits=kv, backend="ref",
                      attn_backend="ref", device=DEV)
    p = greedy(ref, tok, new, extra=extra)
    if witness:
        with MatmulNoise():
            rec["noise_witness"] = compare(greedy(ref, tok, new,
                                                  extra=extra), p)
    del ref
    rec["plain_decode_ms_per_step"] = p["decode_ms_per_step"]
    rec["plain_prefill_ms"] = p["prefill_ms"]
    rec["kernel_vs_plain"] = compare(k, p)
    if f is not None:
        path = "/".join(FAMILY_FAULT[cfg.family])
        rec["fault"] = dict(compare(f, p), name=f"every layer's {path}: K "
                            f"rows read one WB row off")
    return rec


def family_log(r):
    c = r["kernel_vs_plain"]
    log(f"{r['arch']} ({r['layers']} layers) {r['backend']} w{r['bits']} "
        f"kv{r['kv']} act{r['act_bits']} {r['dtype']}: kernel vs plain err "
        f"{c['err']:.3g} tokens {c['token_agreement']:.3f}; prefill "
        f"{r['prefill_ms']:.1f} ms, decode {r['decode_ms_per_step']:.2f} "
        f"ms/step (plain {r['plain_decode_ms_per_step']:.2f})" +
        (f"; paged tokens equal {r['paged']['tokens_equal']}"
         if "paged" in r else "") +
        (f"; noise witness err {r['noise_witness']['err']:.3g} tokens "
         f"{r['noise_witness']['token_agreement']:.3f}"
         if "noise_witness" in r else "") +
        (f"; fault err {r['fault']['err']:.3g}" if "fault" in r else ""))


def family_profile(eng, inputs):
    """One decode step of ``eng`` (B rows after their prompts, contiguous)
    under ``torch.profiler``: its wall time, and the device time of its
    CUDA kernels split into the weight matmuls (``wmm::`` stream and
    tensor kernels), ``paged_attention`` and the rest (the rwkv / mamba
    scans' einsums and the small elementwise ops, norms, the tied head),
    with the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    p = eng.prompt_width(inputs)
    logits, state = eng.prefill(inputs, extra_slots=64)
    cur = logits.argmax(-1)[:, None].to(torch.int32)
    logits, state = eng.decode(cur, state, p)          # warm
    cur = logits.argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode(cur, state, p + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {"matmuls": 0.0, "attention": 0.0, "rest": 0.0}
    calls = dict.fromkeys(parts, 0)
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kind = "attention" if "paged_attention_kernel" in e.key else \
            "matmuls" if "wmm::" in e.key else "rest"
        parts[kind] += ms
        calls[kind] += e.count
        top.append((ms, e.key[:100], e.count))
    device_ms = sum(parts.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1 - device_ms / wall_ms),
                device_ms_by_part=parts, calls=calls,
                top_kernels=[dict(ms=m, kernel=k, calls=c)
                             for m, k, c in sorted(top, reverse=True)[:10]])


def family_argv(arch, size=("--no-tiny",), extra=()):
    """The families phase's scheduler flags (``FAMILY_*``): ``arch`` at
    full width (``size``) through the kernels; qwen2-vl paged and chunked,
    rwkv6 unpaged, zamba2 paged and overcommitted."""
    from repro_torch.configs import REGISTRY
    family = REGISTRY[arch].family
    argv = ["--arch", arch, *size, "--device", DEV, "--requests",
            "--backend", "kernel", "--attn-backend", "fused",
            "--batch", str(len(FAMILY_WIDTHS)),
            "--n-slots", str(SCHED_SLOTS), "--arrival-gap", "2",
            "--prompt-lens", ",".join(map(str, FAMILY_WIDTHS)),
            "--max-news", ",".join(map(str, FAMILY_BUDGETS)),
            "--validate-every", str(SCHED_VALIDATE_EVERY), "--seed", "0"]
    if family == "vlm":
        argv += ["--page-size", str(PAGE), "--prefill-chunk",
                 str(SCHED_CHUNK)]
    elif family == "hybrid":
        argv += ["--page-size", str(PAGE), "--n-pages", str(FAMILY_PAGES),
                 "--overcommit", "1.5"]
    return argv + list(extra)


def family_scheduler(arch, tree, size=("--no-tiny",)):
    """The scheduler trace (``FAMILY_*``) through the launcher on the
    family's int8 tree: bf16 (int8 KV where the family has KV), then
    quantizers off in f32, whose requests are held against one-shot runs
    (:func:`oneshot_rule`).  Both drives counted against their tick logs
    and checked by :func:`drive_record`; the recurrent families insert
    every prompt whole, zamba2 parks and restores; the bf16 drive's
    captured decode tick (qwen2-vl, zamba2) is held against the plain
    version."""
    import torch
    from repro_torch.configs import REGISTRY
    family = REGISTRY[arch].family
    kv = "32" if family == "ssm" else "8"
    out = {}
    with TickCapture(aliased=False) as cap:
        main = launch(family_argv(arch, size, ["--kv-bits", kv]),
                      params=tree)
    rec = out["main"] = drive_record(main, "packed_matmul")
    rep = rec["cache_report"]
    sched = main["scheduler"]
    widths = [w + (REGISTRY[arch].vision_tokens if family == "vlm" else 0)
              for w in FAMILY_WIDTHS]
    inserts = sorted(w for r in sched.tick_log for w in r["inserts"])
    if family == "vlm":
        assert max(inserts) == REGISTRY[arch].vision_tokens + SCHED_CHUNK \
            or size != ("--no-tiny",), inserts
        assert SCHED_SLOTS in {r["m"] for r in rec["matmul_calls"]}
    else:
        assert inserts == sorted(widths), ("whole insertions", inserts)
    if family == "ssm":
        assert not sched.paged, rep
    if family == "hybrid":
        assert rep["preemptions"] >= 1 and \
            rep["resumes"] == rep["preemptions"], rep
    if family != "ssm":
        assert cap.case is not None, "no decode tick met the capture rule"
        out["captured_tick"] = attention_check(cap.case,
                                               "captured decode tick")[0]
    del main, cap
    log(f"{arch} scheduler drive: {rec['ticks']} ticks, "
        f"{rec['generated_tokens']} tokens, {rec['tokens_per_s']:.1f} tok/s,"
        f" decode tick {rec['decode_tick_ms']:.1f} ms, insert tick "
        f"{rec['chunk_tick_ms']:.1f} ms, parks {len(rec['parked'])}")
    off = launch(family_argv(arch, size, ["--kv-bits", "32", "--act-bits",
                                          "32", "--dtype", "float32"]),
                 params=tree)
    rec_off = out["quantizers_off"] = drive_record(off, "packed_matmul")
    for key in ("ticks", "admitted", "finished", "parked"):
        assert rec_off[key] == rec[key], (key, rec_off[key], rec[key])
    out["oneshot"] = oneshot_rule(off, FAMILY_ONESHOT)
    del off
    torch.cuda.empty_cache()
    return out


def family_phase(arch, size=("--no-tiny",)):
    """One family at full width (``size``), its first ``FAMILY_DEPTH``
    layers: random weights from seed 0, deployed packed int8 and as mixed-width bit planes; one-shot
    legs (B=4 x 128 tokens, a qwen2-vl prompt also 256 vision embeds; 32
    new) through the kernels against the plain versions: quantizers off
    in f32 (also paged, where the family has KV) with the noise witness
    and the planted fault, the registered bf16 config with int8 KV
    (8-bit PACT for qwen2-vl), and the bit-plane tree in f32 (8 new); one
    decode step profiled;
    ``packed_matmul`` timed at the family's new shapes; the scheduler
    drives."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine
    out = {"arch": arch, "runs": []}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depth = min(FAMILY_DEPTH[arch],
                served_config(arch, 8, "bfloat16", size).n_layers)
    cfg = served_config(arch, 8, "bfloat16", size, depth)
    qat = build(cfg).init(seed=0, device=DEV)
    packed = to_serving_params(qat, 8, device=DEV)
    bp, out["bitplane_deploy"] = deploy_bitplane(qat)
    del qat
    torch.cuda.empty_cache()
    out["deploy_s"] = time.perf_counter() - t0
    out["layers"] = cfg.n_layers
    tok = torch.randint(0, cfg.vocab, (B, P), device=DEV, dtype=torch.int32,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    inputs = family_inputs(cfg, tok)
    kv = 32 if cfg.family == "ssm" else 8
    log(f"{arch}: init and two deploys in {out['deploy_s']:.1f} s")

    f32 = served_config(arch, 32, "float32", size, depth)
    legs = ((f32, packed, 32, "kernel", NEW, cfg.family != "ssm",
             family_fault(packed, cfg), True, 8),
            (cfg, packed, kv, "kernel", NEW, False, None, False, 8),
            (f32, bp, 32, "bitplane", FAMILY_BP_NEW, False, None, False,
             "bitplane"))
    for c, tree, k, be, new, paged, fault, witness, bits in legs:
        r = dict(family_pair(c, tree, inputs, k, be, new, paged, fault,
                             witness), bits=bits)
        out["runs"].append(r)
        family_log(r)
        del fault
    del bp
    torch.cuda.empty_cache()
    out["oneshot_s"] = time.perf_counter() - t0
    out["lint"] = lint_case(f"{arch} int8 kv8 paged", cfg, packed,
                            {"vlm": "paged", "ssm": "ssm",
                             "hybrid": "hybrid"}[cfg.family])

    t1 = time.perf_counter()
    eng = ServeEngine(build(cfg), packed, kv_quant_bits=kv,
                      backend="kernel", attn_backend="fused", device=DEV)
    out["profile"] = prof = family_profile(eng, inputs)
    del eng
    out["time_s"] = time.perf_counter() - t1
    log(f"{arch} profiled decode step: wall {prof['wall_ms']:.2f} ms, "
        f"device {prof['device_ms']:.3f} ms, by part "
        f"{ {k: round(v, 4) for k, v in prof['device_ms_by_part'].items()} }")

    t1 = time.perf_counter()
    with cut_serve_config(depth):
        out["scheduler"] = family_scheduler(arch, packed, size)
    out["scheduler_s"] = time.perf_counter() - t1
    del packed
    torch.cuda.empty_cache()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t0
    return out


def families_phase(size=("--no-tiny",)):
    """:func:`family_phase` for each of ``FAMILY_ARCHS``, one at a time
    (each tree freed before the next), then ``packed_matmul`` timed at
    ``FAMILY_SHAPES`` (decode M), ``paged_attention`` at the two new
    heads and the stream regime at ``WB_TALL`` with 3072- and 8-row
    blocks; :func:`check_families` judges the readings."""
    t0 = time.perf_counter()
    out = {"families": [family_phase(a, size) for a in FAMILY_ARCHS]}
    t1 = time.perf_counter()
    out["packed_matmul"] = [time_packed(B, k, n, 8)
                            for k, n in FAMILY_SHAPES]
    out["attention"] = [time_attention(8, P + NEW // 2, P + 64, kvh=kvh,
                                       dh=dh, g=g)
                        for kvh, g, dh in FAMILY_HEADS]
    # the stream regime at whole-layer blocks against 8-row blocks, the
    # same bytes: the plan's cut block against its usual slices
    out["wb_tall"] = [time_packed(m, k, 3072, 8, wbr=w)
                      for m, k in WB_TALL[:2] for w in (8, 3072)]
    out["time_s"] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t0
    return out


def check_families(res):
    """Every family drive finite, its tokens of the right shape and
    vocabulary, its ``generate`` warm-up the loop's first tokens; kernels
    vs plain: quantizer-free, logits within the family's
    ``FAMILY_F32_TOL`` of the largest and tokens identical but at a
    near-tie (a top-two gap below that limit), the paged run's tokens the
    contiguous run's, the noise witness within a limit set from it
    (rwkv6, zamba2) and the planted fault above it; the bf16 config within ``QUANT_TOL_REL[8]`` while
    prefixes agree for qwen2-vl (8-bit PACT) and rwkv6, recorded for
    zamba2 (its Mamba-2 layers carry bf16's rounding, 2^-9 a value, to
    logits of the fault's size).  Launches were counted and captured
    calls held in :func:`family_pair`, the scheduler drives checked in
    :func:`family_scheduler`; a scheduler request may part from its
    one-shot rerun only at a near-tie (``EXACT_TOL_REL``)."""
    import torch
    from repro_torch.configs import REGISTRY
    assert [f["arch"] for f in res["families"]] == list(FAMILY_ARCHS)
    for fam in res["families"]:
        vocab = REGISTRY[fam["arch"]].vocab
        assert {(r["backend"], r["dtype"]) for r in fam["runs"]} == {
            ("kernel", "float32"), ("kernel", "bfloat16"),
            ("bitplane", "float32")}, fam["arch"]
        for r in fam["runs"]:
            tag = (r["arch"], r["backend"], r["kv"], r["dtype"])
            toks = torch.tensor(r["tokens"])
            assert toks.shape == (B, r["new"]), tag
            assert 0 <= int(toks.min()) <= int(toks.max()) < vocab, tag
            assert r["generate_prefix_equal"], ("generate vs loop", tag)
            c = r["kernel_vs_plain"]
            assert c["finite"], tag
            if r["dtype"] == "float32":
                tol = FAMILY_F32_TOL[r["family"]]
                assert c["err"] <= tol, (tag, c)
                assert c["first_diff"] is None or \
                    c["top2_gap_at_first_diff"] < tol * c["max_logit"], \
                    (tag, c)
                if "noise_witness" in r and tol > EXACT_TOL_REL:
                    assert r["noise_witness"]["err"] <= tol, \
                        (tag, r["noise_witness"])
                if "fault" in r:
                    assert r["fault"]["err"] > tol, (tag, r["fault"])
            elif r["family"] != "hybrid":
                assert c["err"] <= QUANT_TOL_REL[8], (tag, c)
            if "paged" in r:
                assert r["paged"]["tokens_equal"], (tag, r["paged"])
        assert any("fault" in r for r in fam["runs"]) and \
            any("noise_witness" in r for r in fam["runs"]), fam["arch"]
        bad = [r for r in fam["scheduler"]["oneshot"]
               if r["parted_at"] is not None and not r["allowed"]]
        assert not bad, (fam["arch"], "scheduler parts from one-shot", bad)


def families_summary(res) -> dict:
    """The families phase's figures for the printout."""
    from repro_torch.configs import REGISTRY

    def fam_row(fam):
        def leg(backend, dtype):
            r = next(r for r in fam["runs"]
                     if (r["backend"], r["dtype"]) == (backend, dtype))
            return {"prefill_ms": r["prefill_ms"],
                    "decode_ms_per_step": r["decode_ms_per_step"],
                    "decode_tokens_per_s": r["decode_tokens_per_s"],
                    "plain_decode_ms_per_step":
                        r["plain_decode_ms_per_step"],
                    "err": r["kernel_vs_plain"]["err"],
                    "launches": r["launches"]}
        sm = fam["scheduler"]["main"]
        prof = fam["profile"]
        return {
            "layers": fam["layers"], "phase_s": fam["phase_s"],
            "int8_bf16": leg("kernel", "bfloat16"),
            "int8_kv32_f32": leg("kernel", "float32"),
            "bitplane_f32": leg("bitplane", "float32"),
            "fault_err": next(r["fault"]["err"] for r in fam["runs"]
                              if "fault" in r),
            "noise_witness_err": next(r["noise_witness"]["err"]
                                      for r in fam["runs"]
                                      if "noise_witness" in r),
            "f32_tol": FAMILY_F32_TOL[REGISTRY[fam["arch"]].family],
            "scheduler": {k: sm[k] for k in (
                "ticks", "tokens_per_s", "decode_tick_ms", "chunk_tick_ms",
                "ttft_ms_mean", "parked", "launches")},
            "scheduler_f32_tokens_per_s":
                fam["scheduler"]["quantizers_off"]["tokens_per_s"],
            "oneshot_parts": [r["parted_at"]
                              for r in fam["scheduler"]["oneshot"]],
            "decode_step_profile": {k: prof[k] for k in (
                "wall_ms", "device_ms", "idle_share", "device_ms_by_part")},
            "peak_mem_gb": fam["peak_mem_gb"]}
    return {
        "phase_s": res["phase_s"],
        **{fam["arch"]: fam_row(fam) for fam in res["families"]},
        "packed_matmul": [{k: r[k] for k in (
            "m", "k", "n", "ms", "device_ms", "bound_ms", "plain_ms",
            "library_device_ms")} for r in res["packed_matmul"]],
        "attention": [{k: r[k] for k in (
            "kv", "g", "dh", "kv_len", "device_ms", "bound_ms", "plain_ms",
            "library_device_ms")} for r in res["attention"]],
        "wb_tall": [{k: r[k] for k in ("m", "k", "n", "wbr", "device_ms",
                                       "bound_ms")}
                    for r in res["wb_tall"]]}


# ---------------------------------------------------------------------------
# CNN phase
# ---------------------------------------------------------------------------

# The paper's own pipeline through ``python -m repro_torch.launch.cifar``
# (its ``main``, in process): ResNet-20 and VGG-16-BN at full width on
# 32x32x3 CIFAR-like images, 10 classes, BWQ-A bit-plane mode at the
# paper's 9x8 blocks (BSQ, one block a layer, beside it for the
# simulator); SGD under a cosine schedule from 0.05, maintenance and an
# alpha round every CNN_EVERY steps.
CNN_MODELS = (("resnet", 20), ("vgg", 16))
CNN_TRAIN_B = 64                # benchmarks/common.py's trainer batch
CNN_EVAL_B = 128                # cnn_accuracy's batch
CNN_STEPS, CNN_EVERY = 4, 2
# Deployed CNN with 8-bit PACT activations, logits of the B=128 batch,
# kernels against the plain versions, relative to the largest logit.  A
# PACT level (beta / 255) can flip where two summation orders straddle a
# rounding tie, and BatchNorm over the batch spreads a flip to every row.
# Set between that noise and planted faults (H100, four runs of the
# phase, each tree trained 4 steps):
#   kernel vs plain: ResNet-20 1.51e-3 (int8, bit-plane) / 1.62e-3 to
#     1.65e-3 (int4), VGG-16 1.44e-2 to 1.70e-2 / 1.07e-2 to 1.55e-2;
#     host-CPU witness vs plain 9.8e-4 to 1.12e-3 / 1.00e-2 to 1.13e-2;
#   one block's scale negated (either layout) in the first conv: ResNet-20
#     0.102, VGG-16 0.130 to 0.136.
# Unquantized, the same paths agree within 1.8e-5 (EXACT_TOL_REL).
CNN_QUANT_TOL_REL = 0.04


def cnn_decayed(steps):
    """``checked_trainer``'s ``decayed`` for the CIFAR launcher's SGD: the
    frozen leaves after a step with zero gradient, replayed through the
    same optimizer and learning rate from copies of the leaves and their
    momentum (the weight decay reaches them, as the reference's)."""
    import torch
    from repro_torch.core.state import tensor_leaves
    from repro_torch.launch.cifar import lr_schedule, optimizer

    def decayed(frozen, state):
        mu = dict(tensor_leaves(state.opt_state["mu"]))
        keys = sorted(frozen)
        p = [frozen[k] for k in keys]
        optimizer().update([torch.zeros_like(t) for t in p],
                           {"mu": [mu[k].clone() for k in keys]}, p,
                           lr_schedule(steps)(state.step))
        return dict(zip(keys, p))
    return decayed


def run_cifar(argv):
    """``repro_torch.launch.cifar.main(argv)`` with the port's Trainer
    replaced by :func:`checked_trainer`'s (frozen leaves moved by the
    weight decay alone) for the call; its printout kept."""
    import contextlib
    import io
    import torch
    import repro_torch.train as rt
    from repro_torch.launch.cifar import main as cifar_main
    buf = io.StringIO()
    base = rt.Trainer
    rt.Trainer = checked_trainer(base, cnn_decayed(
        int(argv[argv.index("--steps") + 1])))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = cifar_main(argv)
    finally:
        rt.Trainer = base
    out["run_s"] = time.perf_counter() - t0
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["stdout"] = buf.getvalue()
    return out


def logits_compare(a, b):
    """``a`` against ``b`` (B, classes): the largest |difference| relative
    to b's largest |logit|, and the share of rows whose argmax agrees.
    ``near_ties`` counts the rows of ``b`` whose top-two gap is at most
    2 x ``EXACT_TOL_REL`` x b's largest |logit|, and ``near_tie_flips``
    those whose argmax differs: an ``a`` within ``EXACT_TOL_REL`` of ``b``
    cannot flip any other row's argmax."""
    import torch
    a, b = a.float().cpu(), b.float().cpu()
    same = a.argmax(-1) == b.argmax(-1)
    top2 = b.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * EXACT_TOL_REL * b.abs().max()
    return dict(err=float((a - b).abs().max() / b.abs().max()),
                top1_agreement=float(same.float().mean()),
                near_ties=int((~decided).sum()),
                near_tie_flips=int((~decided & ~same).sum()),
                finite=bool(torch.isfinite(a).all()))


def cnn_fault(dep, path):
    """``dep`` with one weight block of the conv leaf at ``path`` (keys
    into the tree) corrupted: block (0, 0)'s scale negated, so its 72
    weights change sign (either layout).  The rest is shared."""
    def put(node, keys):
        node = list(node) if isinstance(node, list) else dict(node)
        if len(keys) == 1:
            sw = node[keys[0]]
            scale = sw.scale.clone()
            scale[0, 0] = -scale[0, 0]
            node[keys[0]] = dataclasses.replace(sw, scale=scale)
        else:
            node[keys[0]] = put(node[keys[0]], keys[1:])
        return node
    return put(dep, path)


def time_cnn_call(name, x, ops, kw, n):
    """One captured CNN weight-matmul call timed as the forward makes it
    (x f32 as the model's, far past L2 at the large M; the weights, at most
    2.4 MB, stay in L2): the kernel (ms, device ms), its plain version and
    ``torch.matmul`` on the weight dequantized to f32, beside the bound:
    x, the weight's bytes (``bitplane_stream_bytes`` for bit planes) and
    the output over HBM, or the live blocks' operations over the f32
    peak, whichever is larger."""
    import torch
    from repro_torch.core.blocking import BlockingSpec
    from repro_torch.kernels import bitplane_matmul, packed_matmul
    from repro_torch.kernels.ref import bitplane_matmul_ref, packed_matmul_ref
    from repro_torch.serve.deploy import (BitplaneServingWeight,
                                          ServingWeight,
                                          bitplane_serving_compose,
                                          bitplane_stream_bytes,
                                          serving_compose)
    m, k = x.shape
    spec = BlockingSpec(kw["wbr"], kw["wbc"])
    if name == "packed_matmul":
        w_int, scale = ops
        sw = ServingWeight(w_int, scale, (k, n), spec, kw["bits"])
        dense = serving_compose(sw, torch.float32)
        wbytes, live = w_int.nbytes + scale.nbytes, 1.0

        def kern():
            return packed_matmul(x, *ops, **kw)

        def plain():
            return packed_matmul_ref(x, *ops, kw["bits"], kw["wbr"],
                                     kw["wbc"])
    else:
        sw = BitplaneServingWeight(*ops, (k, n), spec, ops[0].shape[0])
        dense = bitplane_serving_compose(sw, torch.float32)
        wbytes = bitplane_stream_bytes(sw)
        live = float((ops[2].sum(dim=-3) > 0).float().mean())

        def kern():
            return bitplane_matmul(x, *ops, **kw)

        def plain():
            return bitplane_matmul_ref(x, *ops, kw["wbr"], kw["wbc"])
    ms, dev, host = cuda_times(kern, iters=10, warmup=2)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    lib, lib_dev, lib_host = cuda_times(lambda: torch.matmul(x, dense),
                                        iters=10, warmup=2)
    nbytes = x.nbytes + wbytes + m * n * 4
    flops = 2.0 * m * k * n * live
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS \
        else "operations"
    return dict(kernel=name, m=m, k=k, n=n, x=str(x.dtype), ms=ms,
                device_ms=dev, host_ms=host, plain_ms=plain_ms,
                library_ms=lib, library_device_ms=lib_dev,
                library_host_ms=lib_host, bound_ms=bound, bound_by=by,
                bytes=nbytes, flops=flops, live_block_share=live)


def cnn_forward_legs(model, apply_fn, deps, x, n_mm, qcs, time_shapes):
    """Every deploy of one model (``deps``: name -> tree) through the
    kernels against the plain versions on the same B=128 batch, with
    activations unquantized and with 8-bit PACT (``qcs``): launches
    counted (``n_mm`` weight matmuls a forward), the first call at each
    shape held against the plain version (``MatmulCapture``) and, for
    ``time_shapes``, timed; forwards timed (kernels, plain)."""
    import torch
    legs, shapes = [], []
    for name, dep in deps.items():
        be = "bitplane" if name == "bitplane" else "kernel"
        matmul = "bitplane_matmul" if name == "bitplane" else "packed_matmul"
        want = {"packed_matmul": 0, "paged_attention": 0,
                "bitplane_matmul": 0, "pact_quant": 0}
        want[matmul] = n_mm
        for act, qc in qcs.items():
            def fwd(dep=dep, qc=qc, be=be):
                return apply_fn(dep, x, qc, be)

            def plain(dep=dep, qc=qc):
                return apply_fn(dep, x, qc, "ref")
            fwd()
            with MatmulCapture() as mm:
                k = counted(lambda: {"logits": fwd()}, want)
            calls = dict(mm.calls)
            rows = mm.check()
            for r in rows:
                r["calls_a_forward"] = mm.counts[(r["kernel"], r["m"], r["k"],
                                                  r["n"], r["x"])]
            p = plain()
            leg = dict(model=model, deploy=name, backend=be, act_bits=act,
                       launches=k["launches"], matmul_calls=rows,
                       kernel_vs_plain=logits_compare(k["logits"], p))
            if act >= 32:
                leg["ms"] = cuda_ms(fwd, iters=5, warmup=1)
                leg["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
                leg["profile"] = cnn_profile(fwd)
                if name in time_shapes:
                    for key, (cx, ops, kw, y, _) in sorted(calls.items()):
                        t = time_cnn_call(key[0], cx, ops, kw, key[3])
                        t.update(model=model, deploy=name,
                                 calls_a_forward=mm.counts[key],
                                 err=next(r["err"] for r in rows
                                          if (r["kernel"], r["m"], r["k"],
                                              r["n"]) == key[:4]))
                        shapes.append(t)
            legs.append(leg)
            del k, p, calls, mm
            torch.cuda.empty_cache()
    return legs, shapes


def cnn_model_case(model, depth, size=()):
    """One CNN through the pipeline: trained (BSQ and BWQ, checked
    trainer), its BWQ tree deployed packed int8, int4 and bit-plane and
    run on B=128 images through the kernels against the plain versions
    (:func:`cnn_forward_legs`), a host-CPU witness of the quantized
    path's noise, a planted fault in each layout, the forwards and the
    library conv timed, the simulator's figures."""
    import torch
    from repro_torch.core.bitrep import bitwidths
    from repro_torch.core.state import quantized_leaves
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.launch import cifar
    from repro_torch.models.cnn import MODELS, conv_matmuls
    from repro_torch.models.common import prepare_params
    from repro_torch.serve.deploy import to_serving_params, tree_to
    t0 = time.perf_counter()
    argv = ["--model", model, *(size or ("--depth", str(depth))),
            "--steps", str(CNN_STEPS), "--requant-every", str(CNN_EVERY),
            "--batch", str(CNN_TRAIN_B), "--scheme", "bsq", "bwq",
            "--backend", "kernel", "--eval-batches", "1", "--device", DEV]
    run = run_cifar(argv)
    out = dict(model=model, depth=run["geometry"]["depth"],
               image=run["geometry"]["image"], argv=argv,
               train_s=run["run_s"], peak_mem_gb=run["peak_mem_gb"],
               sim=run["sim"], stdout=run["stdout"], schemes={})
    for scheme, tr in run["trainers"].items():
        res = run["results"][scheme]
        steady = sorted(tr.step_ms[1:]) or tr.step_ms
        out["schemes"][scheme] = dict(
            step_ms=tr.step_ms, step_ms_median_after_first=steady[
                len(steady) // 2], maintenance_ms=tr.maint_ms,
            loss=res["loss"], acc=res["acc"],
            acc_deployed=res.get("acc_deployed"),
            avg_bitwidth=res["avg_bitwidth"],
            compression_x=res["compression_x"])
        assert all(math.isfinite(v) for h in tr.history
                   for v in h.values()), (model, scheme)
        assert len(tr.maint_ms) == CNN_STEPS // CNN_EVERY, tr.maint_ms
    qat = run["trainers"]["bwq"].state.params
    # the weight decay leaves an 8-bit block's mask sum at 7.9999: count
    # the blocks whose width dropped by a plane
    maps = [bitwidths(q) for q in quantized_leaves(qat).values()]
    out["blocks_below_8_share"] = float(
        sum(int((m < 7.5).sum()) for m in maps) / sum(m.numel()
                                                     for m in maps))
    assert out["blocks_below_8_share"] > 0, "bit-width maps never moved"
    del run
    torch.cuda.empty_cache()

    _, apply_fn = MODELS[model]
    x = SyntheticCIFAR(image=out["image"], batch=CNN_EVAL_B, noise=0.5,
                       seed=0).batch_at(cifar.EVAL_STEP)["images"].to(DEV)
    n_mm = conv_matmuls(qat)
    deps = {"int8": to_serving_params(qat, 8, device=DEV),
            "int4": to_serving_params(qat, 4, device=DEV),
            "bitplane": to_serving_params(qat, 8, layout="bitplane",
                                          device=DEV)}
    qcs = {32: cifar.quant_config("bwq", 32), 8: cifar.quant_config("bwq",
                                                                     8)}
    out["legs"], out["shapes"] = cnn_forward_legs(
        model, apply_fn, deps, x, n_mm, qcs, ("int8", "bitplane"))
    out["conv_matmuls"] = n_mm

    # the library's conv (cuDNN, f32) on the same weights, composed once
    composed = prepare_params(qat)
    out["library_conv_ms"] = cuda_ms(lambda: apply_fn(composed, x, qcs[32]),
                                     iters=5, warmup=1)
    del composed

    # noise witness: the plain path on the host CPU against the card's
    q8 = qcs[8]
    plain8 = apply_fn(deps["int8"], x, q8, "ref")
    host = apply_fn(tree_to(deps["int8"], "cpu"), x.cpu(), q8, "ref")
    out["host_witness_int8_act8"] = logits_compare(host, plain8)
    # planted faults: one WB of the first conv's leaf, each layout
    first = ["layers", 0, "conv", "qt"] if model == "vgg" else \
        ["stem", "qt"]
    out["faults"] = {}
    for name, be in (("int8", "kernel"), ("bitplane", "bitplane")):
        bad = cnn_fault(deps[name], first)
        clean = apply_fn(deps[name], x, q8, "ref")
        out["faults"][name] = dict(
            fault="first conv block (0, 0) scale negated",
            **logits_compare(apply_fn(bad, x, q8, be), clean))
        del bad
    del deps, qat, x
    torch.cuda.empty_cache()
    out["case_s"] = time.perf_counter() - t0
    return out


class ReluTrace:
    """Observer around the ReLU of ``models.cnn`` (its ``F.relu``; every
    other op of ``F`` passes through): each call's keep mask (x > 0) is
    kept on the host.  With ``replay`` (another run's trace) each call
    keeps that run's elements instead of its own, and records where its
    own mask differs and the largest |x| there relative to the call's
    largest: the same step with its ReLU decisions forced to the other
    run's."""

    def __init__(self, replay=None):
        import torch.nn.functional as F
        from repro_torch.models import cnn
        self.mod, self.orig = cnn, F
        self.replay, self.calls = replay, []

    def __enter__(self):
        self.mod.F = self
        return self

    def __exit__(self, *exc):
        self.mod.F = self.orig

    def __getattr__(self, name):
        return getattr(self.orig, name)

    def relu(self, x):
        import torch
        own = x > 0
        if self.replay is None:
            self.calls.append({"keep": own.cpu()})
            return self.orig.relu(x)
        keep = self.replay.calls[len(self.calls)]["keep"].to(x.device)
        diff, mag = own != keep, x.detach().abs()
        self.calls.append({"keep": keep.cpu(), "flips": int(diff.sum()),
                           "elements": diff.numel(),
                           "gap": float(mag[diff].max() / mag.max())
                           if diff.any() else 0.0})
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def cnn_card_vs_host(size=()):
    """One step of ResNet-20 (bit-plane mode at 9x8 blocks, activations
    unquantized, alpha 1e-3, B=64 from the CIFAR stream) on the card and
    on the host CPU from the same tree and batch, held by
    :func:`compare_steps` in f32 and in float64.  ReLU keeps or drops an
    element by its sign, and a weight gradient sums ~65,536 positions'
    terms, so an element within f32 noise of zero that the card and the
    host put on other sides moves a leaf by ~65,536^-1/2 of its largest
    magnitude.  The card's f32 step therefore takes the host's ReLU masks
    (:class:`ReluTrace`); the flips it was spared are counted, with the
    card's error unforced beside them.  Witness of the host's own f32
    noise: its gradients against its float64 ones.  The float64 step
    keeps its own masks."""
    import torch
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.launch import cifar
    from repro_torch.models.cnn import cnn_loss, resnet_apply, resnet_init
    from repro_torch.train.step import quant_reg_loss
    depth, image = (8, 8) if size else (20, 32)
    qc = cifar.quant_config("bwq", 32)
    alpha = torch.tensor(1e-3, dtype=torch.float32)

    def total(p, b):
        reg = quant_reg_loss(p, alpha)
        loss, m = cnn_loss(resnet_apply, p, b, qc)
        return loss + reg, (m, reg)

    batch = SyntheticCIFAR(image=image, batch=CNN_TRAIN_B, noise=0.5,
                           seed=2).batch_at(0)
    params = resnet_init(qc, depth=depth, seed=1, device=DEV)
    f32, f64 = torch.float32, torch.float64
    with ReluTrace() as host_relu:
        host = step_grads(total, params, batch, "cpu", f32)
    unforced = step_grads(total, params, batch, DEV, f32)
    with ReluTrace(replay=host_relu) as card_relu:
        card = step_grads(total, params, batch, DEV, f32)
    card64 = step_grads(total, params, batch, DEV, f64)
    host64 = step_grads(total, params, batch, "cpu", f64)
    del params
    torch.cuda.empty_cache()
    err = compare_steps(card, host)
    err64 = compare_steps(card64, host64)
    free = grad_errs(unforced["grads"], host["grads"])
    witness = grad_errs(host["grads"], host64["grads"])
    calls = card_relu.calls
    return dict(
        model=f"resnet{depth}", image=image, batch=CNN_TRAIN_B,
        loss_card=card["loss"], loss_host=host["loss"],
        loss_card_f64=card64["loss"], loss_host_f64=host64["loss"],
        reg_card=card["reg"], reg_host=host["reg"],
        loss_err=err["loss_err"], grad_err_max=err["grad_err_max"],
        grad_err_f64_max=err64["grad_err_max"],
        grad_err_unforced_max=max(free.values()),
        grad_witness_max=max(witness.values()),
        relu_flips=sum(c["flips"] for c in calls),
        relu_elements=sum(c["elements"] for c in calls),
        relu_flip_gap_max=max(c["gap"] for c in calls),
        grad_tol=GRAD_TOL_REL, loss_tol=HOST_LOSS_TOL_REL,
        card_s=card["s"], host_s=host["s"],
        leaves=[dict(leaf=k, max_abs=float(host["grads"][k].abs().max()),
                     err=v, err_f64=err64["err"][k], unforced=free[k],
                     witness=witness[k]) for k, v in err["err"].items()])


def cnn_profile(fwd):
    """One forward ``fwd()`` under ``torch.profiler``: its wall time and
    the device time of its CUDA kernels, split into the weight matmuls
    (``packed_matmul`` / ``bitplane_matmul``), im2col (the kernels of the
    ops inside each ``models.cnn.im2col`` call), BatchNorm (those inside
    each ``_bn_apply``) and the rest (PACT, ReLU, pads, the head)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import cnn
    orig = {n: getattr(cnn, n) for n in ("im2col", "_bn_apply")}

    def annotated(name, fn):
        def call(*a, **kw):
            with record_function(f"cnn.{name}"):
                return fn(*a, **kw)
        return call
    for n, fn in orig.items():
        setattr(cnn, n, annotated(n, fn))
    try:
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in orig.items():
            setattr(cnn, n, fn)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    parts = {"weight_matmul": 0.0, "im2col": 0.0, "batchnorm": 0.0,
             "rest": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != cuda or e.key.startswith("cnn."):
            continue
        ms = e.self_device_time_total / 1e3
        parts["weight_matmul" if "wmm::" in e.key else "rest"] += ms
        top.append((ms, e.key[:100], e.count))
    for n, part in (("im2col", "im2col"), ("_bn_apply", "batchnorm")):
        ev = [e for e in prof.events()
              if e.name == f"cnn.{n}" and e.device_type == cpu]
        parts[part] = sum(ch.device_time_total for e in ev
                          for ch in e.cpu_children) / 1e3
        parts["rest"] -= parts[part]
    device_ms = sum(parts.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1 - device_ms / wall_ms),
                device_ms_by_part=parts,
                share=({k: v / device_ms for k, v in parts.items()}
                       if device_ms else None),
                top_kernels=[dict(ms=m, kernel=k, calls=c)
                             for m, k, c in sorted(top, reverse=True)[:12]])


def cnn_phase(size=()):
    """The paper's CNN pipeline on the card (``size`` ``("--tiny",)`` for a
    CPU rehearsal): :func:`cnn_model_case` for ResNet-20 and VGG-16-BN,
    then :func:`cnn_card_vs_host`.  Returns the readings; :func:`check_cnn`
    judges the forwards."""
    t0 = time.perf_counter()
    out = {"models": [cnn_model_case(m, d, size) for m, d in CNN_MODELS]}
    out["card_vs_host"] = cnn_card_vs_host(size)
    out["phase_s"] = time.perf_counter() - t0
    return out


def check_cnn(res):
    """Each model's deployed forwards: finite; unquantized, within
    ``EXACT_TOL_REL`` of the largest logit, which decides the argmax of
    every image whose plain top-two gap exceeds twice that limit (the
    phase's few training steps are not bit-reproducible on the card, and
    a barely trained VGG has near-tied images whose argmax such
    run-to-run noise may flip; :func:`logits_compare` counts them and
    their flips, logged);
    8-bit PACT within ``CNN_QUANT_TOL_REL``; launches counted (in
    :func:`cnn_forward_legs`); every planted fault above
    ``CNN_QUANT_TOL_REL``; the simulator's BWQ-H and BSQ ahead of ISAAC."""
    for m in res["models"]:
        for leg in m["legs"]:
            tag = (m["model"], leg["deploy"], leg["act_bits"])
            c = leg["kernel_vs_plain"]
            assert c["finite"], tag
            if leg["act_bits"] >= 32:
                assert c["err"] <= EXACT_TOL_REL, (tag, c)
                log(f"cnn {tag}: {c['near_ties']} near-tied images "
                    f"(top-two gap <= 2 x EXACT_TOL_REL), "
                    f"{c['near_tie_flips']} flipped")
            else:
                assert c["err"] <= CNN_QUANT_TOL_REL, (tag, c)
        assert {(leg["deploy"], leg["act_bits"]) for leg in m["legs"]} == {
            (d, a) for d in ("int8", "int4", "bitplane") for a in (32, 8)}
        for name, f in m["faults"].items():
            assert f["err"] > CNN_QUANT_TOL_REL, (m["model"], name, f)
        for key in ("bwq_vs_isaac", "bsq_vs_isaac"):
            s = m["sim"][key]
            assert s["speedup_x"] > 1 and s["energy_saving_x"] > 1, (key, s)


def cnn_summary(res) -> dict:
    """The CNN phase's figures for the printout."""
    out = {"phase_s": res["phase_s"], "models": []}
    for m in res["models"]:
        bwq = m["schemes"]["bwq"]
        out["models"].append({
            "model": f"{m['model']}{m['depth']}", "image": m["image"],
            "conv_matmuls": m["conv_matmuls"],
            "train_step_ms": bwq["step_ms_median_after_first"],
            "train_peak_mem_gb": m["peak_mem_gb"],
            "avg_bitwidth": bwq["avg_bitwidth"],
            "compression_x": bwq["compression_x"],
            "blocks_below_8_share": m["blocks_below_8_share"],
            "forward_ms": {f"{leg['deploy']}": leg["ms"] for leg in
                           m["legs"] if "ms" in leg},
            "forward_plain_ms": {f"{leg['deploy']}": leg["plain_ms"] for leg
                                 in m["legs"] if "plain_ms" in leg},
            "library_conv_ms": m["library_conv_ms"],
            "forward_profile": {
                leg["deploy"]: {k: leg["profile"][k] for k in (
                    "wall_ms", "device_ms", "idle_share",
                    "device_ms_by_part")}
                for leg in m["legs"] if "profile" in leg},
            "err": {f"{leg['deploy']}_act{leg['act_bits']}":
                    leg["kernel_vs_plain"]["err"] for leg in m["legs"]},
            "near_ties_act32": {leg["deploy"]: (
                leg["kernel_vs_plain"]["near_ties"],
                leg["kernel_vs_plain"]["near_tie_flips"])
                for leg in m["legs"] if leg["act_bits"] >= 32},
            "host_witness_err": m["host_witness_int8_act8"]["err"],
            "fault_err": {k: v["err"] for k, v in m["faults"].items()},
            "simulator": m["sim"]})
    cvh = res["card_vs_host"]
    out["card_vs_host"] = {k: cvh[k] for k in (
        "model", "loss_err", "grad_err_max", "grad_err_unforced_max",
        "relu_flips", "relu_elements", "grad_witness_max", "grad_tol",
        "grad_err_f64_max")}
    return out


def cnn_kernel_rows(res, kernel):
    """The CNN's timed calls of ``kernel`` for its kernels entry."""
    return [{k: r[k] for k in ("model", "m", "k", "n", "calls_a_forward",
                               "err", "ms", "device_ms", "bound_ms",
                               "bound_by", "plain_ms", "library_ms",
                               "library_device_ms")}
            for m in res["models"] for r in m["shapes"]
            if r["kernel"] == kernel]


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

# BWQ-A training through ``python -m repro_torch.launch.train`` (its
# ``main``, in process): the registered phi3 (bf16 compute, f32 master
# weights, 8x128 blocks, 8-bit PACT, remat), fake mode at full depth;
# maintenance and an alpha round every 4 steps.  Alpha rises from 0 to
# TRAIN_DELTA_ALPHA at step 4: a group-Lasso term of order 1 beside a
# cross entropy of ~10 at full width.
TRAIN_STEPS, TRAIN_EVERY, TRAIN_SEQ, TRAIN_BATCH = 8, 4, 256, 4
TRAIN_DELTA_ALPHA = 1e-7
TRAIN_DEPTH_CUT = 2             # layers of the bit-plane and host legs
HOST_B, HOST_SEQ = 2, 128       # the card-against-host step's batch
# Card against host, one f32 step without activation quantization: the
# loss within 1e-4 relative; each gradient leaf within GRAD_TOL_REL of its
# largest magnitude.  Set from the noise of two summation orders (H100,
# f32): the card alone, the same step as two microbatches, parts by up to
# 3.40e-6 of a leaf's largest magnitude, and the host by 3.43e-6 (losses
# equal); 1e-4 leaves ~30x for other batches and seeds.  A fault in a
# gradient path (a term lost, a layer's gradient misplaced) moves a leaf
# by the order of its own magnitude.
HOST_LOSS_TOL_REL = 1e-4
GRAD_TOL_REL = 1e-4


def train_argv(size=("--no-tiny",), extra=()):
    return ["--arch", ARCH, *size, "--device", DEV, "--steps",
            str(TRAIN_STEPS), "--requant-every", str(TRAIN_EVERY), "--seq",
            str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--delta-alpha",
            str(TRAIN_DELTA_ALPHA), *extra]


def _frozen_leaves(params):
    from repro_torch.core.state import tensor_leaves
    from repro_torch.train.step import FROZEN_FIELDS
    return {p: t.clone() for p, t in tensor_leaves(params)
            if p.endswith(FROZEN_FIELDS)}


def checked_trainer(base, decayed=None):
    """``base`` (the port's Trainer) with each train step timed
    (synchronized) and its frozen leaves held unchanged bit for bit, and
    each maintenance timed and held: no LUT grows, and every weight is on
    its grid (fake mode: maintenance again changes no ``w``; bit-plane
    mode: every plane is 0 or 1).  Under an optimizer whose weight decay
    reaches every leaf (the CNN's SGD, as the reference's), ``decayed(
    frozen, state)`` gives what the decay alone makes of the frozen leaves
    in the coming step (their gradient zero), and they must equal that
    bit for bit."""
    import torch
    from repro_torch.core.bitrep import QuantizedTensor, bitwidths
    from repro_torch.core.fakequant import fq_maintenance
    from repro_torch.core.state import quant_nodes
    from repro_torch.train.step import _layers

    def luts(params):
        return {k: (bitwidths(q) if isinstance(q, QuantizedTensor)
                    else q.bitwidth).clone()
                for k, q in quant_nodes(params).items()}

    class Checked(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.step_ms, self.maint_ms = [], []
            step, maint = self.train_step, self.maintenance

            def timed_step(state, batch):
                frozen = _frozen_leaves(state.params)
                if decayed is not None:
                    frozen = decayed(frozen, state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                now = _frozen_leaves(out[0].params)
                bad = [p for p in frozen if not torch.equal(frozen[p],
                                                            now[p])]
                assert not bad, ("frozen leaves changed in a step", bad)
                return out

            def checked_maint(state):
                before = luts(state.params)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = maint(state)
                torch.cuda.synchronize()
                self.maint_ms.append((time.perf_counter() - t0) * 1e3)
                after = luts(out.params)
                for k in before:
                    assert bool((after[k] <= before[k]).all()), \
                        ("a LUT grew", k)
                for k, q in quant_nodes(out.params).items():
                    if isinstance(q, QuantizedTensor):
                        assert bool(((q.planes == 0) | (q.planes == 1))
                                    .all()), ("planes off binary", k)
                        continue
                    for i, lay in enumerate(_layers(q)):
                        assert torch.equal(fq_maintenance(lay).w, lay.w), \
                            ("w off its grid", k, i)
                return out

            self.train_step, self.maintenance = timed_step, checked_maint

    return Checked


def run_trainer(argv, drive=None):
    """``repro_torch.launch.train.main(argv)`` (or ``drive()``, which
    builds and runs its own ``repro_torch.train.Trainer`` as ``argv``
    says) with the port's Trainer replaced by :func:`checked_trainer`'s
    for the call; its printout kept.  Returns the trainer and the run's
    summary."""
    import io
    import torch
    import repro_torch.train as rt
    from repro_torch.launch.train import main as train_main
    buf = io.StringIO()
    base = rt.Trainer
    rt.Trainer = checked_trainer(base)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            trainer = train_main(argv) if drive is None else drive()
    finally:
        rt.Trainer = base
    run_s = time.perf_counter() - t0
    hist = trainer.history
    for h in hist:
        assert all(math.isfinite(v) for v in h.values()), h
    steady = sorted(trainer.step_ms[1:]) or trainer.step_ms
    step_ms = steady[len(steady) // 2]
    def arg(flag):
        return int(argv[argv.index(flag) + 1])
    assert [h["step"] for h in hist] == list(range(1, arg("--steps") + 1))
    return trainer, dict(
        argv=list(argv), run_s=run_s, step_ms=trainer.step_ms,
        step_ms_median_after_first=step_ms,
        tokens_per_s=arg("--batch") * arg("--seq") / (step_ms / 1e3),
        maintenance_ms=trainer.maint_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        stdout=buf.getvalue(), **{k: [h[k] for h in hist] for k in (
            "loss", "ce", "aux", "reg", "grad_norm", "lr", "avg_bitwidth")},
        compression_x=hist[-1]["compression_x"],
        alpha=float(trainer.state.alpha))


def profile_step(trainer, cfg):
    """One more train step of ``trainer`` (the next batch of its stream)
    under ``torch.profiler``: its wall time, the device time of its
    kernels by kind (matmuls, elementwise, reductions, the rest; summed
    self device time of the CUDA kernel events, one stream) and the
    device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticLM
    batch = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH).batch_at(
        trainer.state.step)
    batch = {k: v.to(DEV) for k, v in batch.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"matmul": 0.0, "elementwise": 0.0, "reduction": 0.0,
             "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = "matmul" if any(t in name for t in (
            "gemm", "nvjet", "cutlass", "xmma", "sm90")) else \
            "elementwise" if "elementwise" in name else \
            "reduction" if "reduce" in name else "other"
        kinds[kind] += ms
        top.append((ms, e.key[:100], e.count))
    device_ms = sum(kinds.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1 - device_ms / wall_ms),
                device_ms_by_kind=kinds,
                top_kernels=[dict(ms=m, kernel=k, calls=c)
                             for m, k, c in sorted(top, reverse=True)[:12]])


def trained_launches(cfg, new, matmul):
    """Launches of a contiguous greedy drive of ``new`` tokens (a prefill
    and ``new - 1`` decode steps) on ``cfg``'s family: one encoder pass a
    row for an enc-dec model, one vision projection for a vlm one."""
    if cfg.is_encdec:
        return encdec_launches(cfg, new, new - 1, 1, matmul)
    if cfg.family in ("vlm", "ssm", "hybrid"):
        return family_launches(cfg, new, new - 1, 1, matmul)
    return expected_launches(cfg.n_layers, new, new - 1, matmul,
                             layer_matmuls(cfg))


def serve_trained(trainer, cfg, layout, backend, b=B, p=P, new=NEW,
                  serve_cfg=None, tol=QUANT_TOL_REL[8]):
    """Deploy the trained tree (int8, ``layout``) after freeing the
    optimizer state, then serve it greedily (``b`` prompts of ``p``
    tokens, ``new`` new; int8 KV where the family has KV) through the
    kernels (``backend``, ``attn_backend="fused"``; launches counted) and
    through the plain versions, at ``serve_cfg`` (default ``cfg``); the
    logit error while token prefixes agree must be within ``tol``.  A vlm
    prompt carries its vision prefix, an enc-dec prompt ``S_ENC`` frames;
    an MoE plain run takes the kernel run's routing (:class:`RouteTrace`)
    and the choices its own router would have made otherwise are
    recorded."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine
    serve_cfg = serve_cfg or cfg
    params = trainer.state.params
    trainer.state = None
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dep = to_serving_params(params, 8, layout=layout, device=DEV)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    api = build(serve_cfg)
    tok = torch.randint(0, cfg.vocab, (b, p),
                        generator=torch.Generator(device=DEV).manual_seed(4),
                        device=DEV, dtype=torch.int32)
    frames = encdec_frames(cfg.d_model, b) if cfg.is_encdec else None
    extra = {k: v for k, v in family_inputs(cfg, tok).items()
             if k != "tokens"}
    kv = 32 if cfg.family == "ssm" else 8
    ker = ServeEngine(api, dep, kv_quant_bits=kv, backend=backend,
                      attn_backend="fused", device=DEV)
    ref = ServeEngine(api, dep, kv_quant_bits=kv, backend="ref",
                      attn_backend="ref", device=DEV)
    matmul = "bitplane_matmul" if layout == "bitplane" else "packed_matmul"
    moe = bool(cfg.n_experts)
    with (RouteTrace() if moe else contextlib.nullcontext()) as k_routes:
        run = counted(lambda: greedy(ker, tok, new, frames=frames,
                                     extra=extra),
                      trained_launches(serve_cfg, new, matmul))
    with (RouteTrace(replay=k_routes) if moe else contextlib.nullcontext()
          ) as p_routes:
        plain = greedy(ref, tok, new, frames=frames, extra=extra)
    res = compare(run, plain)
    out = dict(layout=layout, backend=backend, deploy_s=deploy_s,
               dtype=serve_cfg.dtype, tol=tol,
               launches=run["launches"], kernel_vs_plain=res,
               tokens=run["tokens"].tolist(),
               prefill_ms=run["prefill_ms"],
               decode_ms_per_step=run["decode_ms_per_step"])
    if moe:
        out["routes"] = route_flips(p_routes, len(p_routes.calls))
    toks = run["tokens"]
    assert toks.shape == (b, new) and 0 <= int(toks.min()) and \
        int(toks.max()) < cfg.vocab, out
    assert res["finite"] and res["err"] <= tol, out
    del ker, ref, dep
    torch.cuda.empty_cache()
    return out


def step_grads(total, params, batch, dev, dtype=None, num_mb=1):
    """One ``microbatched_value_and_grad(total, num_mb)`` step on ``dev``
    (the float tensors of ``params`` and ``batch`` cast to ``dtype`` when
    it is given; ``total``'s aux is ``(metrics, reg)``): the loss, the
    regularizer, the seconds and each gradient leaf on the host."""
    import torch
    from repro_torch.core.state import map_tensors, tensor_leaves
    from repro_torch.train.step import microbatched_value_and_grad

    def to(t):
        return t.to(dev, dtype) if dtype is not None and \
            t.is_floating_point() else t.to(dev)
    p = map_tensors(to, params)
    b = {k: to(v) for k, v in batch.items()}
    t0 = time.perf_counter()
    (loss, (_, reg)), g = microbatched_value_and_grad(total, num_mb)(p, b)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return dict(loss=float(loss), reg=float(reg), s=s,
                grads={k: v.cpu() for k, v in tensor_leaves(g)})


def grad_errs(got, ref):
    """Each gradient leaf of ``got`` against ``ref`` (dicts on the host):
    the largest |difference| relative to ``ref``'s largest magnitude; a
    leaf that ``ref`` holds at zero must be zero in ``got``."""
    out = {}
    for k, r in ref.items():
        scale = float(r.abs().max())
        if scale == 0.0:
            assert not got[k].any(), ("a gradient where the other has none",
                                      k)
            out[k] = 0.0
        else:
            out[k] = float((got[k].double() - r.double()).abs().max()) \
                / scale
    return out


def compare_steps(card, host):
    """Two :func:`step_grads` results, ``card`` against ``host``: the
    regularizer live, the loss within HOST_LOSS_TOL_REL and each gradient
    leaf within GRAD_TOL_REL of its largest magnitude."""
    err = grad_errs(card["grads"], host["grads"])
    out = dict(loss_err=abs(card["loss"] - host["loss"]) / abs(host["loss"]),
               grad_err_max=max(err.values()), err=err)
    worst = max(err, key=err.get)
    assert card["reg"] > 0 and out["loss_err"] <= HOST_LOSS_TOL_REL, (
        card["loss"], host["loss"], card["reg"])
    assert out["grad_err_max"] <= GRAD_TOL_REL, (worst, out["grad_err_max"])
    return out


def card_vs_host(size=("--no-tiny",)):
    """One f32 train step without activation quantization (fake mode,
    depth cut to TRAIN_DEPTH_CUT, remat on as registered, alpha at
    TRAIN_DELTA_ALPHA) on the card and on the host CPU, from the same
    tree and batch, held by :func:`compare_steps`.  The witness of the
    card's own summation noise is the same step run as two
    microbatches."""
    import dataclasses as dc
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as tl
    from repro_torch.models.api import build
    from repro_torch.train.step import quant_reg_loss
    args = tl.build_parser().parse_args(
        ["--arch", ARCH, *size, "--act-bits", "32", "--layers",
         str(TRAIN_DEPTH_CUT)])
    cfg = dc.replace(tl.config(args), dtype="float32")
    api = build(cfg)
    alpha = torch.tensor(TRAIN_DELTA_ALPHA, dtype=torch.float32)

    def total(p, b):
        reg = quant_reg_loss(p, alpha)
        loss, m = api.loss(p, b)
        return loss + reg, (m, reg)

    batch = SyntheticLM(cfg.vocab, HOST_SEQ, HOST_B, seed=2).batch_at(0)
    params = api.init(seed=1, device=DEV)
    card = step_grads(total, params, batch, DEV)
    wit = step_grads(total, params, batch, DEV, num_mb=2)
    host = step_grads(total, params, batch, "cpu")
    del params
    torch.cuda.empty_cache()
    err = compare_steps(card, host)
    witness = grad_errs(card["grads"], wit["grads"])
    return dict(layers=cfg.n_layers, dtype=cfg.dtype, batch=HOST_B,
                seq=HOST_SEQ, loss_card=card["loss"], loss_host=host["loss"],
                loss_witness=wit["loss"], reg_card=card["reg"],
                reg_host=host["reg"], loss_err=err["loss_err"],
                grad_err_max=err["grad_err_max"],
                grad_witness_max=max(witness.values()),
                grad_tol=GRAD_TOL_REL, loss_tol=HOST_LOSS_TOL_REL,
                card_s=card["s"], host_s=host["s"],
                leaves=[dict(leaf=k, max_abs=float(
                    host["grads"][k].abs().max()), err=v,
                    witness=witness[k]) for k, v in err["err"].items()])


def train_phase(size=("--no-tiny",)):
    """Training through the port's launcher on the card, its trained trees
    served through the kernels, and one step held against the host.

    * fake mode at full depth (:data:`TRAIN_STEPS` steps of
      ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens), every step finite, frozen
      leaves unchanged, maintenance monotone and on the grid; one more
      step profiled (:func:`profile_step`); the trained tree deployed to
      packed int8 and served through ``backend="kernel"`` against the
      plain versions;
    * the card-against-host step (:func:`card_vs_host`);
    * bit-plane mode at ``TRAIN_DEPTH_CUT`` layers: 2 steps and a
      maintenance (requantize + adjust_precision), deployed to
      ``layout="bitplane"`` and served through ``backend="bitplane"``."""
    import torch
    from repro_torch.launch import train as tl
    out = {"mem_before_gb": torch.cuda.memory_allocated() / 1e9}
    argv = train_argv(size)
    trainer, out["fake"] = run_trainer(argv)
    f = out["fake"]
    assert f["reg"][0] == 0.0 and f["reg"][-1] > 0, f["reg"]
    log(f"train fake full depth: step {f['step_ms_median_after_first']:.1f}"
        f" ms (median after the first), {f['tokens_per_s']:.0f} tok/s, "
        f"maintenance {[round(m) for m in f['maintenance_ms']]} ms, peak "
        f"{f['peak_mem_gb']:.1f} GB, loss {f['loss'][0]:.3f} -> "
        f"{f['loss'][-1]:.3f}, bits {f['avg_bitwidth'][-1]:.3f}, "
        f"{f['compression_x']:.2f}x")
    cfg = tl.config(tl.build_parser().parse_args(argv))
    out["fake_profile"] = fp = profile_step(trainer, cfg)
    log(f"profiled step: {fp['wall_ms']:.1f} ms wall, device "
        f"{fp['device_ms']:.1f} ms (" + ", ".join(
            f"{k} {v:.1f}" for k, v in fp["device_ms_by_kind"].items())
        + f"), idle {fp['idle_share']:.3f}")
    out["fake_serve"] = serve_trained(trainer, cfg, "packed", "kernel")
    del trainer
    fs = out["fake_serve"]
    log(f"trained tree deployed in {fs['deploy_s']:.1f} s, served through "
        f"the kernels: err {fs['kernel_vs_plain']['err']:.3g}, tokens "
        f"{fs['kernel_vs_plain']['token_agreement']:.3f}")

    out["card_vs_host"] = cvh = card_vs_host(size)
    log(f"card vs host step: loss err {cvh['loss_err']:.3g}, grad err "
        f"{cvh['grad_err_max']:.3g} (witness {cvh['grad_witness_max']:.3g},"
        f" limit {GRAD_TOL_REL})")

    bp_argv = train_argv(size, ["--quant-mode", "bitplane", "--layers",
                                str(TRAIN_DEPTH_CUT)])
    bp_argv[bp_argv.index("--steps") + 1] = "2"
    bp_argv[bp_argv.index("--requant-every") + 1] = "2"
    trainer, out["bitplane"] = run_trainer(bp_argv)
    b = out["bitplane"]
    assert len(trainer.maint_ms) == 1, trainer.maint_ms
    cfg = tl.config(tl.build_parser().parse_args(bp_argv))
    out["bitplane_serve"] = serve_trained(trainer, cfg, "bitplane",
                                          "bitplane")
    del trainer
    bs = out["bitplane_serve"]
    log(f"train bit-plane {TRAIN_DEPTH_CUT} layers: step "
        f"{b['step_ms_median_after_first']:.1f} ms, peak "
        f"{b['peak_mem_gb']:.1f} GB, bits {b['avg_bitwidth'][-1]:.3f}; served "
        f"through bitplane_matmul: err {bs['kernel_vs_plain']['err']:.3g}")
    return out


# ---------------------------------------------------------------------------
# train families phase: BWQ-A training of the MoE, enc-dec, vlm, ssm and
# hybrid families at full width, each trained tree served through the
# kernels
# ---------------------------------------------------------------------------

# (arch, layers) each family trains at full width: granite and seamless
# at the serving phases' cuts (seamless 6 + 6), qwen2-vl and rwkv6 at 4,
# zamba2 at 12 (two calls of its shared block)
TF_ARCHS = ((MOE_ARCH, MOE_DEPTH), (ENCDEC_ARCH, ENCDEC_DEPTH),
            ("qwen2-vl-2b", 4), ("rwkv6-1.6b", 4), ("zamba2-1.2b", 12))
TF_STEPS, TF_EVERY = 3, 2       # steps; maintenance and alpha round every 2
TF_P, TF_NEW = 64, 8            # serving legs: B prompts of 64 tokens, 8 new
TF_BP_STEPS = 2                 # granite's bit-plane leg (TRAIN_DEPTH_CUT)
TF_HOST_B, TF_HOST_SEQ = 2, 64  # the card-against-host step's batch
TF_HOST_LOSS_TOL = 1e-5
# M of the ops.py dense calls on a trained leaf: both matmul regimes
TF_OPS_M = (B, 64)
# The card-against-host step's witness is the card's own step on the
# batch with its two rows swapped: the same loss and gradients, other
# summation orders (two microbatches, the train phase's witness, would
# change the MoE aux term, a product of batch means).  A
# float64 host step, tried first (H100), read 2.2e-4 to
# 4.2e-2 of a leaf's largest gradient against f32 (it rounds the
# fake-quantized weights to other levels at ties, so it bounds nothing)
# and took 84 s of the phase's 176; the card against the host read
# 3.1e-6 to 4.9e-5 (zamba2's a_log the largest).  Every leaf is held to
# GRAD_TOL_REL, zamba2's too: it needs no witness-set limit.


def tf_config(arch, depth, size=("--no-tiny",), **over):
    """The train launcher's config of ``arch`` (``size``: full width, its
    registered blocks, bf16, fake mode, 8-bit PACT, remat) cut to
    ``depth`` layers (an enc-dec model's encoder too), with ``over``."""
    from repro_torch.launch import train as tl
    cfg = tl.config(tl.build_parser().parse_args(["--arch", arch, *size]))
    cut = {"n_layers": min(depth, cfg.n_layers)}
    if cfg.is_encdec:
        cut["enc_layers"] = min(depth, cfg.enc_layers)
    return dataclasses.replace(cfg, **cut, **over)


def tf_argv(arch, depth, size=("--no-tiny",), extra=()):
    return ["--arch", arch, *size, "--device", DEV, "--steps", str(TF_STEPS),
            "--requant-every", str(TF_EVERY), "--seq", str(TRAIN_SEQ),
            "--batch", str(TRAIN_BATCH), "--delta-alpha",
            str(TRAIN_DELTA_ALPHA), "--layers", str(depth), *extra]


@contextlib.contextmanager
def vision_pipeline():
    """``repro_torch.data.make_lm_pipeline`` swapped for the calls inside:
    a vlm config's batches put ``vision_tokens`` vision embeddings
    (``lm_batch_for``'s, 0.1 x normal) in front of the stream's
    ``seq_len`` tokens; other configs get the stream's."""
    import repro_torch.data as rd
    from repro_torch.configs import ShapeCell
    base = rd.make_lm_pipeline

    def pipeline(cfg, seq_len, batch, seed=0, start_step=0):
        if cfg.family != "vlm":
            yield from base(cfg, seq_len, batch, seed, start_step)
            return
        cell = ShapeCell("train", seq_len + cfg.vision_tokens, batch,
                         "train")
        step = start_step
        while True:
            yield step, rd.lm_batch_for(cfg, cell, step, seed)
            step += 1
    rd.make_lm_pipeline = pipeline
    try:
        yield
    finally:
        rd.make_lm_pipeline = base


def encdec_drive(cfg):
    """What the launcher does for the other families, for an enc-dec
    ``cfg`` it refuses: a seed-0 model trained by ``repro_torch.train.
    Trainer`` (the smoke's checking one, as :func:`run_trainer` installs
    it) on ``lm_batch_for`` batches of ``TRAIN_SEQ`` tokens over as many
    frames."""
    def drive():
        import repro_torch.train as rt
        from repro_torch.configs import ShapeCell
        from repro_torch.data import lm_batch_for
        from repro_torch.models.api import build
        from repro_torch.optim import adamw, cosine_schedule
        api = build(cfg)
        trainer = rt.Trainer(
            api.loss, adamw(weight_decay=0.0),
            cosine_schedule(2e-3, TF_STEPS), api.init(seed=0, device=DEV),
            rt.TrainerConfig(total_steps=TF_STEPS, log_every=1,
                             requant_interval=TF_EVERY,
                             alpha_round_steps=TF_EVERY,
                             delta_alpha=TRAIN_DELTA_ALPHA))
        cell = ShapeCell("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        step = {"i": -1}

        def data():
            while True:
                step["i"] += 1
                yield step["i"], lm_batch_for(cfg, cell, step["i"])
        trainer.run(data(), steps=TF_STEPS)
        return trainer
    return drive


def ops_leaf_case(q):
    """``kernels.ops`` on one trained bit-plane matrix ``q`` (a layer of
    a ``QuantizedTensor`` stack, after maintenance): ``bwq_dense_packed``
    and ``bwq_dense_bitplane`` (the kernels) against the plain versions on
    the same layouts, at each M of ``TF_OPS_M``, f32 x; errors relative to
    the plain result's largest magnitude."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import bitplane_matmul_ref, packed_matmul_ref
    if q.planes.shape[-2] % 8:
        return []       # 9x8 blocks (the tiny rehearsal): K not byte-aligned
    bp, pk = ops.to_bitplane_layout(q), ops.to_packed_layout(q, 8)
    k = q.shape[-2]
    out = []
    for m in TF_OPS_M:
        x = torch.randn((m, k), generator=torch.Generator(device=DEV)
                        .manual_seed(m), device=DEV)
        for name, got, want in (
                ("bwq_dense_packed", ops.bwq_dense_packed(x, pk),
                 packed_matmul_ref(x, pk.w_int, pk.scale, pk.bits, pk.wbr,
                                   pk.wbc)),
                ("bwq_dense_bitplane", ops.bwq_dense_bitplane(x, bp),
                 bitplane_matmul_ref(x, bp.planes_packed, bp.sign_packed,
                                     bp.mask, bp.scale, bp.wbr, bp.wbc))):
            err = float((got - want).abs().max() / want.abs().max())
            out.append(dict(call=name, m=m, k=k, n=q.shape[-1], err=err))
            assert err <= PM_TOL_REL, out[-1]
    return out


def family_card_vs_host(arch, size=("--no-tiny",)):
    """One f32 train step without activation quantization (fake mode,
    ``TRAIN_DEPTH_CUT`` layers; zamba2 4 at period 2, two shared calls;
    remat on as registered, alpha ``TRAIN_DELTA_ALPHA``) of ``arch`` on the
    card and on the host CPU, from the same tree and a ``TF_HOST_B`` x
    ``TF_HOST_SEQ`` batch (a vlm batch's vision prefix in front, an
    enc-dec batch's as many frames): the loss within ``TF_HOST_LOSS_TOL``
    relative, each gradient leaf within ``GRAD_TOL_REL`` of its largest
    magnitude; the witness, recorded beside, is the card's step with the
    batch's rows swapped (see the note above ``tf_config``).  An MoE host run
    takes the card's routing (:class:`RouteTrace`); a choice its own router
    would have made otherwise must sit at a near-tie (``ROUTE_TIE_GAP``);
    the witness routes on its own."""
    import torch
    from repro_torch.configs import ShapeCell
    from repro_torch.data import lm_batch_for
    from repro_torch.models.api import build
    from repro_torch.train.step import quant_reg_loss
    probe = tf_config(arch, 1, size)
    over = dict(dtype="float32", quant=dataclasses.replace(
        probe.quant, act_bits=32))
    layers = TRAIN_DEPTH_CUT
    if probe.family == "hybrid":
        layers, over["hybrid_attn_every"] = 4, 2
    cfg = tf_config(arch, layers, size, **over)
    alpha = torch.tensor(TRAIN_DELTA_ALPHA, dtype=torch.float32)

    def total_of(api):
        def total(p, b):
            reg = quant_reg_loss(p, alpha)
            loss, m = api.loss(p, b)
            return loss + reg, (m, reg)
        return total

    seq = TF_HOST_SEQ + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    batch = lm_batch_for(cfg, ShapeCell("host", seq, TF_HOST_B, "train"),
                         seed=2)
    api = build(cfg)
    params = api.init(seed=1, device=DEV)
    moe = bool(cfg.n_experts)
    with (RouteTrace() if moe else contextlib.nullcontext()) as routes:
        card = step_grads(total_of(api), params, batch, DEV)

    def forced():
        return RouteTrace(replay=routes) if moe else \
            contextlib.nullcontext()
    with forced() as host_routes:
        host = step_grads(total_of(api), params, batch, "cpu")
    wit = step_grads(total_of(api), params,
                     {k: v.flip(0) for k, v in batch.items()}, DEV)
    del params
    torch.cuda.empty_cache()
    err = grad_errs(card["grads"], host["grads"])
    witness = grad_errs(card["grads"], wit["grads"])
    loss_err = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    out = dict(arch=arch, layers=cfg.n_layers, batch=TF_HOST_B, seq=seq,
               loss_card=card["loss"], loss_host=host["loss"],
               loss_witness=wit["loss"], loss_err=loss_err,
               grad_err_max=max(err.values()),
               grad_witness_max=max(witness.values()),
               worst=max(err, key=err.get),
               card_s=card["s"], host_s=host["s"], witness_s=wit["s"],
               leaves=[dict(leaf=k, err=v, witness=witness[k])
                       for k, v in err.items()])
    if moe:
        out["routes"] = route_flips(host_routes, len(host_routes.calls))
        gap = out["routes"]["max_gap"]
        assert gap is None or gap < ROUTE_TIE_GAP, out["routes"]
    assert card["reg"] > 0 and loss_err <= TF_HOST_LOSS_TOL, out
    assert out["grad_err_max"] <= GRAD_TOL_REL, (out["worst"],
                                                 out["grad_err_max"])
    return out


def train_family(arch, depth, size=("--no-tiny",)):
    """One family: ``TF_STEPS`` fake-mode steps of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens at full width and ``depth`` layers (a qwen2-vl
    batch also ``vision_tokens`` vision embeddings, a seamless batch as
    many frames as tokens), through the launcher (seamless, which the
    launcher refuses, through ``Trainer`` on ``lm_batch_for`` batches),
    checked by :func:`checked_trainer`; the trained tree deployed packed
    int8 and served (B x ``TF_P``, ``TF_NEW`` new) through the kernels
    against the plain versions; granite also 2 bit-plane steps at
    ``TRAIN_DEPTH_CUT`` layers served through ``bitplane_matmul``, with
    ``kernels.ops`` on one of its trained matrices; the card-against-host
    step."""
    import torch
    t0 = time.perf_counter()
    cfg = tf_config(arch, depth, size)
    argv = tf_argv(arch, cfg.n_layers, size)
    with vision_pipeline():
        trainer, run = run_trainer(
            argv, encdec_drive(cfg) if cfg.is_encdec else None)
    out = {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "train": run,
           "vision_tokens": cfg.vision_tokens if cfg.family == "vlm" else 0}
    assert run["reg"][0] == 0.0 and run["reg"][-1] > 0, run["reg"]
    assert len(trainer.maint_ms) == 1, trainer.maint_ms
    if cfg.n_experts:
        assert all(math.isfinite(a) and a > 0 for a in run["aux"]), run["aux"]
    log(f"train {arch} ({cfg.n_layers} layers): step "
        f"{run['step_ms_median_after_first']:.1f} ms (median after the "
        f"first; first {run['step_ms'][0]:.0f}), maintenance "
        f"{[round(m) for m in run['maintenance_ms']]} ms, peak "
        f"{run['peak_mem_gb']:.1f} GB, loss {run['loss'][0]:.3f} -> "
        f"{run['loss'][-1]:.3f}, aux {run['aux'][-1]:.3f}")
    # zamba2 serves in f32: the serving phase holds its bf16 legs to no
    # limit (Mamba-2 layers carry bf16 rounding to logits of a fault's
    # size); its quantizer-free limit is FAMILY_F32_TOL (no PACT leaves)
    serve_cfg, tol = cfg, QUANT_TOL_REL[8]
    if cfg.family == "hybrid":
        serve_cfg = dataclasses.replace(cfg, dtype="float32")
        tol = FAMILY_F32_TOL["hybrid"]
    out["serve"] = sv = serve_trained(trainer, cfg, "packed", "kernel",
                                      p=TF_P, new=TF_NEW,
                                      serve_cfg=serve_cfg, tol=tol)
    del trainer
    torch.cuda.empty_cache()
    log(f"  served trained tree ({sv['dtype']}): err "
        f"{sv['kernel_vs_plain']['err']:.3g} (limit {tol}), tokens "
        f"{sv['kernel_vs_plain']['token_agreement']:.3f}, launches "
        f"{ {k: v for k, v in sv['launches'].items() if v} }")
    if cfg.n_experts:
        bp_argv = tf_argv(arch, TRAIN_DEPTH_CUT, size,
                          ["--quant-mode", "bitplane"])
        bp_argv[bp_argv.index("--steps") + 1] = str(TF_BP_STEPS)
        trainer, out["bitplane"] = run_trainer(bp_argv)
        assert len(trainer.maint_ms) == 1, trainer.maint_ms
        q = trainer.state.params["layers"]["attn"]["wq"].layer(0)
        out["ops"] = ops_leaf_case(q)
        assert out["ops"] or size == ("--tiny",), "no ops.py leaf case"
        bcfg = tf_config(arch, TRAIN_DEPTH_CUT, size, quant=dataclasses
                         .replace(cfg.quant, mode="bitplane"))
        out["bitplane_serve"] = bs = serve_trained(
            trainer, bcfg, "bitplane", "bitplane", p=TF_P, new=TF_NEW)
        del trainer
        torch.cuda.empty_cache()
        log(f"  bit-plane {TRAIN_DEPTH_CUT} layers: step "
            f"{out['bitplane']['step_ms_median_after_first']:.1f} ms, "
            f"served through bitplane_matmul: err "
            f"{bs['kernel_vs_plain']['err']:.3g}; ops.py calls err max "
            f"{max([c['err'] for c in out['ops']], default=None)}")
    out["card_vs_host"] = cvh = family_card_vs_host(arch, size)
    log(f"  card vs host ({cvh['layers']} layers): loss err "
        f"{cvh['loss_err']:.3g}, grad err {cvh['grad_err_max']:.3g} "
        f"(witness {cvh['grad_witness_max']:.3g}), host "
        f"{cvh['host_s']:.1f} s")
    out["phase_s"] = time.perf_counter() - t0
    return out


def train_families_phase(size=("--no-tiny",)):
    """:func:`train_family` for each of ``TF_ARCHS``, one at a time (each
    freed before the next)."""
    t0 = time.perf_counter()
    out = {"families": [train_family(a, d, size) for a, d in TF_ARCHS]}
    out["phase_s"] = time.perf_counter() - t0
    return out


def train_families_summary(res) -> dict:
    """The train families phase's figures for the printout."""
    def fam(r):
        t = r["train"]
        row = {"layers": r["layers"],
               "step_ms_median_after_first": t["step_ms_median_after_first"],
               "first_step_ms": t["step_ms"][0],
               "maintenance_ms": t["maintenance_ms"],
               "peak_mem_gb": t["peak_mem_gb"], "loss": t["loss"],
               "serve_err": r["serve"]["kernel_vs_plain"]["err"],
               "serve_launches": r["serve"]["launches"],
               "card_vs_host_loss_err": r["card_vs_host"]["loss_err"],
               "card_vs_host_grad_err": r["card_vs_host"]["grad_err_max"],
               "card_vs_host_witness":
                   r["card_vs_host"]["grad_witness_max"],
               "phase_s": r["phase_s"]}
        if "bitplane_serve" in r:
            row["bitplane_serve_err"] = \
                r["bitplane_serve"]["kernel_vs_plain"]["err"]
            row["ops_err_max"] = max([c["err"] for c in r["ops"]],
                                     default=None)
        return row
    return {"phase_s": res["phase_s"],
            **{r["arch"]: fam(r) for r in res["families"]}}


# ---------------------------------------------------------------------------
# deploy phase: checkpoint -> cold start -> contracts -> autotune -> serve
# ---------------------------------------------------------------------------

# full-width phi3 cut to 2 layers: a 2-layer TrainState (f32 params with
# the tied embedding, AdamW m and v) is ~3.9 GB a save; at 32 layers ~45 GB
DEPLOY_LAYERS = 2
DEPLOY_STEPS, DEPLOY_EVERY, DEPLOY_FAULT = 4, 2, 3  # steps, requant, crash
DEPLOY_DISK_GB = 24             # free space the checkpoints need, checked
# the autotune budget: the fixed bytes (LUTs and the non-bit-plane
# leaves) plus this share of the bit-plane leaves' plane and sign bytes.
# 0.6 of the whole stream would not be feasible at 2 layers: the tied
# 32064 x 3072 f32 embedding alone is ~3/4 of it
DEPLOY_BUDGET_SHARE = 0.6
DEPLOY_B, DEPLOY_P, DEPLOY_NEW = 4, 256, 16


def cut_serve_config(n_layers, enc_layers=0):
    """``repro_torch.launch.serve._config`` cut to ``n_layers`` (and an
    enc-dec config's encoder to ``enc_layers``) for the calls inside the
    context: the serve launcher serves the registered depth."""
    import contextlib
    import repro_torch.launch.serve as ls
    cut = {"n_layers": n_layers, **({"enc_layers": enc_layers}
                                    if enc_layers else {})}

    @contextlib.contextmanager
    def ctx():
        base = ls._config
        ls._config = lambda args: dataclasses.replace(base(args), **cut)
        try:
            yield
        finally:
            ls._config = base
    return ctx()


class CkptClock:
    """Observer around the checkpoint module's ``save_tree`` (run by the
    manager's writer thread) and ``restore_tree``: seconds and bytes on
    disk of each call."""

    def __init__(self):
        import repro_torch.ckpt.checkpoint as ck
        self.mod, self.orig = ck, (ck.save_tree, ck.restore_tree)
        self.saves, self.restores = [], []

    def __enter__(self):
        save, restore = self.orig

        def timed_save(tree, path, *a, **k):
            t0 = time.perf_counter()
            save(tree, path, *a, **k)
            self.saves.append(dict(path=str(path), s=time.perf_counter() - t0,
                                   bytes=dir_bytes(path)))

        def timed_restore(template, path, *a, **k):
            import torch
            t0 = time.perf_counter()
            out = restore(template, path, *a, **k)
            torch.cuda.synchronize()
            self.restores.append(dict(path=str(path),
                                      s=time.perf_counter() - t0,
                                      bytes=dir_bytes(path)))
            return out
        self.mod.save_tree, self.mod.restore_tree = timed_save, timed_restore
        return self

    def __exit__(self, *exc):
        self.mod.save_tree, self.mod.restore_tree = self.orig


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def deploy_train_argv(ckpt=None, size=("--no-tiny",)):
    return ["--arch", ARCH, *size, "--device", DEV, "--layers",
            str(DEPLOY_LAYERS), "--steps", str(DEPLOY_STEPS),
            "--requant-every", str(DEPLOY_EVERY), "--seq", str(TRAIN_SEQ),
            "--batch", str(TRAIN_BATCH), "--delta-alpha",
            str(TRAIN_DELTA_ALPHA),
            *(["--ckpt-dir", str(ckpt)] if ckpt else [])]


def trees_equal(a, b):
    """(leaves equal bit for bit, largest |difference|, leaf count, the
    paths that differ) over the array leaves of two trees of one
    structure (checkpoint paths)."""
    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import iter_leaves
    la, lb = dict(iter_leaves(a)), dict(iter_leaves(b))
    assert la.keys() == lb.keys(), sorted(set(la) ^ set(lb))[:4]
    differ, worst = [], 0.0
    for k, x in la.items():
        y = lb[k]
        if not isinstance(x, torch.Tensor):
            ok = np.array_equal(np.asarray(x), np.asarray(y))
        else:
            y = y.to(x.device)
            ok = x.dtype == y.dtype and x.shape == y.shape and \
                bool(torch.equal(x, y))
            if not ok and x.is_floating_point() and x.shape == y.shape:
                worst = max(worst, float((x.double() - y.double())
                                         .abs().max()))
        if not ok:
            differ.append(k)
    return not differ, worst, len(la), differ


def restart_leg(ck, size):
    """Leg 1: the launcher's trainer with checkpoints every
    ``DEPLOY_EVERY`` steps, crashed before data step ``DEPLOY_FAULT`` and
    restarted by ``run_with_restarts``, against the uninterrupted
    launcher run: last loss and every leaf of params and optimizer state
    bit for bit."""
    import torch
    from repro_torch.data import make_lm_pipeline
    from repro_torch.launch import train as tl
    from repro_torch.train import run_with_restarts
    argv = deploy_train_argv(ck, size)
    args = tl.build_parser().parse_args(argv)
    cfg = tl.config(args)
    attempts = []

    def make():
        attempts.append(time.perf_counter())
        return tl.make_trainer(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CkptClock() as clock:
        restarted = run_with_restarts(
            make, lambda s: make_lm_pipeline(cfg, args.seq, args.batch,
                                             start_step=s),
            DEPLOY_STEPS, fault_at=DEPLOY_FAULT)
    run_s = time.perf_counter() - t0
    straight = tl.main(deploy_train_argv(None, size))
    same, worst, n, differ = trees_equal(restarted.state, straight.state)
    out = dict(attempts=len(attempts), run_s=run_s, saves=clock.saves,
               restores=clock.restores, leaves=n, bit_exact=same,
               max_abs_diff=worst, differ=differ[:8],
               loss_restarted=restarted.history[-1]["loss"],
               loss_straight=straight.history[-1]["loss"],
               history_steps=[h["step"] for h in restarted.history],
               steps=sorted(p.name for p in Path(ck).iterdir()))
    sv = clock.saves
    out["save_s_each"] = [s["s"] for s in sv]
    out["save_bytes"] = sv[-1]["bytes"]
    out["save_gb_per_s"] = sum(s["bytes"] for s in sv) / sum(
        s["s"] for s in sv) / 1e9
    out["restore_s"] = clock.restores[0]["s"]
    out["restore_gb_per_s"] = clock.restores[0]["bytes"] / \
        clock.restores[0]["s"] / 1e9
    assert len(attempts) == 2 and restarted.state.step == DEPLOY_STEPS, out
    # the launcher saves every max(steps // 4, 1) = 1 step, asynchronously:
    # the restart resumes from the last save committed at the crash (the
    # crashed run's save of the step before it may still be in flight)
    out["resumed_at"] = int(Path(clock.restores[0]["path"]).name[5:])
    assert out["resumed_at"] in (DEPLOY_FAULT - 1, DEPLOY_FAULT), out
    assert out["history_steps"] == list(range(out["resumed_at"] + 1,
                                              DEPLOY_STEPS + 1)), out
    assert same and out["loss_restarted"] == out["loss_straight"], out
    del restarted, straight
    torch.cuda.empty_cache()
    return out


def contracts_leg(step_dir):
    """Leg 2: CK findings on the real checkpoint (clean), and on a small
    save with its shard removed (CK2) and with ``.tmp.`` debris beside it
    (CK3)."""
    import shutil
    import torch
    from repro_torch.analysis.contracts import validate_checkpoint
    from repro_torch.ckpt import save_tree
    t0 = time.perf_counter()
    real = validate_checkpoint(str(step_dir))
    out = dict(real=[f.format() for f in real],
               real_s=time.perf_counter() - t0)
    assert [f.rule for f in real] == ["CK0"], out
    small = step_dir.parent.parent / "small"
    save_tree({"w": torch.arange(12.0).reshape(3, 4),
               "q": torch.arange(6, dtype=torch.int8)}, str(small))
    shutil.copytree(small, str(small) + ".tmp.deadbeef")
    debris = validate_checkpoint(str(small))
    (small / "shard_00000-of-00001.npz").unlink()
    torn = validate_checkpoint(str(small))
    out["debris"] = sorted({(f.rule, f.severity) for f in debris})
    out["torn"] = sorted({(f.rule, f.severity) for f in torn})
    assert out["debris"] == [("CK3", "warning")], out
    assert ("CK2", "error") in out["torn"], out
    return out


def deploy_drive(ck, extra, size, params=None, matmul="bitplane_matmul"):
    """The serve launcher over the checkpoint (depth cut), counted and
    checked by :func:`drive_record`: ``DEPLOY_B`` requests of
    ``DEPLOY_P`` tokens, ``DEPLOY_NEW`` new, 16-token pages, 256-token
    chunks; ``params`` (a tuned tree) replaces the cold start; a plain
    drive (``matmul`` None) launches nothing."""
    argv = ["--arch", ARCH, *size, "--device", DEV, "--requests",
            "--ckpt", str(ck), "--batch", str(DEPLOY_B), "--prompt-len",
            str(DEPLOY_P), "--max-new", str(DEPLOY_NEW), "--page-size",
            str(PAGE), "--prefill-chunk", str(SCHED_CHUNK), "--seed", "0",
            *extra]
    with cut_serve_config(DEPLOY_LAYERS):
        out = launch(argv, params=params)
    out["record"] = drive_record(out, matmul)
    return out


def bp2_refused(tree, api):
    """A copy of ``tree`` with one block of one mask made non-prefix
    (plane 0 cleared where the block keeps more than one plane): the
    engine must refuse it, naming BP2."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    leaf = tree["layers"]["mlp"]["w_up"]
    mask = leaf.mask.clone()
    occ = mask.sum(dim=-3)
    idx = (occ[0] > 1).nonzero()[0]
    mask[0, 0, idx[0], idx[1]] = 0.0
    bad = dict(tree, layers=dict(tree["layers"], mlp=dict(
        tree["layers"]["mlp"], w_up=dataclasses.replace(leaf, mask=mask))))
    try:
        ServeEngine(api, bad, backend="bitplane", device=DEV)
    except ValueError as e:
        assert "BP2" in str(e), e
        return str(e).splitlines()[1]
    raise AssertionError("the engine served a non-prefix mask")


def time_leaf_matmuls(tree, m):
    """``bitplane_matmul`` over one layer's 7 projections of ``tree`` at
    M=m, bf16 x, each call on a rotating copy so weights are read cold:
    (device ms summed over the layer, ms summed)."""
    import torch
    from repro_torch.kernels import bitplane_matmul
    dev_ms = ms = 0.0
    for sub, name in LAYER_LEAVES:
        leaf = tree["layers"][sub][name]
        k = leaf.shape[-2]
        x = torch.randn((m, k), device=DEV, dtype=torch.bfloat16,
                        generator=torch.Generator(device=DEV).manual_seed(6))
        layer = leaf.layer(0)
        copies = rotating(lambda: dataclasses.replace(
            layer, planes=layer.planes.clone(), sign=layer.sign.clone(),
            mask=layer.mask.clone(), scale=layer.scale.clone()),
            layer.planes.nbytes)
        it = {"i": 0}

        def call():
            it["i"] = (it["i"] + 1) % len(copies)
            v = copies[it["i"]]
            return bitplane_matmul(x, v.planes, v.sign, v.mask, v.scale,
                                   wbr=v.spec.wb_rows, wbc=v.spec.wb_cols)
        a, d, _ = cuda_times(call)
        ms += a
        dev_ms += d
        del copies
    return dev_ms, ms


def oneshot_pair(api, tree, tok, kv, backend, new=DEPLOY_NEW):
    """Greedy one-shot of ``tree`` through ``backend`` and fused
    attention, launches counted, against the plain versions."""
    from repro_torch.serve.engine import ServeEngine
    n = api.cfg.n_layers
    matmul = "bitplane_matmul" if backend == "bitplane" else "packed_matmul"
    ker = ServeEngine(api, tree, kv_quant_bits=kv, backend=backend,
                      attn_backend="fused", device=DEV)
    run = counted(lambda: greedy(ker, tok, new),
                  expected_launches(n, new, new - 1, matmul))
    del ker
    ref = ServeEngine(api, tree, kv_quant_bits=kv, backend="ref",
                      attn_backend="ref", device=DEV)
    plain = greedy(ref, tok, new)
    del ref
    return run, plain


def deploy_phase(size=("--no-tiny",)):
    """Checkpoint to budget-autotuned bit-plane serving at full phi3 width
    cut to ``DEPLOY_LAYERS`` layers (legs 1-6: restart, CK contracts, the
    bit-plane cold start through the launcher, the packed cold start,
    autotune, serving the tuned tree).  Writes under
    ``chiprun_out/deploy_ckpt`` (free space checked first) and removes it
    at the end, pass or fail."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.analysis.contracts import (validate_allocation,
                                                validate_serving_tree)
    from repro_torch.ckpt import restore_tree
    from repro_torch.launch.serve import resolve_ckpt_dir
    from repro_torch.serve.autotune import (calibrate_activations,
                                            greedy_allocate,
                                            sensitivity_tree)
    from repro_torch.core.state import quant_nodes
    from repro_torch.serve.deploy import (BitplaneServingWeight,
                                          bitplane_stream_bytes,
                                          to_serving_params,
                                          weight_stream_bytes)
    from repro_torch.train import TrainState
    root = ROOT / "chiprun_out" / "deploy_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    if free_gb < DEPLOY_DISK_GB:
        raise AssertionError(f"deploy phase: {free_gb:.1f} GB free under "
                             f"{root}, needs {DEPLOY_DISK_GB}")
    out = {"free_gb": free_gb, "layers": DEPLOY_LAYERS}
    t_phase = time.perf_counter()
    try:
        ck = root / "run"
        out["restart"] = r = restart_leg(ck, size)
        log(f"deploy restart: {r['attempts']} attempts, bit exact "
            f"{r['bit_exact']} over {r['leaves']} leaves, save "
            f"{r['save_bytes'] / 1e9:.2f} GB at {r['save_gb_per_s']:.2f} "
            f"GB/s, restore {r['restore_s']:.2f} s")
        step_dir = Path(resolve_ckpt_dir(str(ck)))
        out["contracts"] = contracts_leg(step_dir)

        # leg 3: the bit-plane cold start through the launcher, with the
        # tuned tree served (legs 5, 6); quantizers off in f32 first
        exact = ["--backend", "bitplane", "--attn-backend", "fused",
                 "--act-bits", "32", "--dtype", "float32", "--kv-bits", "32"]
        quant = ["--backend", "bitplane", "--attn-backend", "fused",
                 "--act-bits", "8", "--kv-bits", "8"]
        out["budget"] = probe = deploy_drive_budget(ck, exact, size)
        budget = probe["budget"]
        drives = {}
        for name, flags in (("exact", exact), ("quant", quant)):
            kern = deploy_drive(ck, flags + ["--autotune-budget-bytes",
                                             str(budget)], size)
            alloc = kern["allocation"]
            plain_flags = [f if f not in ("bitplane", "fused") else "ref"
                           for f in flags]
            plain = deploy_drive(ck, plain_flags, size, params=alloc.params,
                                 matmul=None)
            drives[name] = (kern, plain)
        kern, plain = drives["exact"]
        dep, alloc = kern["deployed"], kern["allocation"]
        api = kern["engine"].api
        stats = kern["stats"]
        out["cold_start"] = dict(stats, s=probe["cold_start_s"],
                                 launcher_main_s=kern["main_s"])
        assert 0 < stats["peak_host_bytes"] < stats["dense_tree_bytes"], \
            stats

        # the cold-start tree against the live deploy of the restored
        # params, bit for bit; then the BP2 refusal
        tmpl = api.abstract_params()
        t0 = time.perf_counter()
        restored = restore_tree(TrainState(step=0, params=tmpl,
                                           alpha=torch.empty(
                                               (), device="meta")),
                                str(step_dir), partial=True, device=DEV)
        torch.cuda.synchronize()
        out["restore_params_s"] = time.perf_counter() - t0
        live = to_serving_params(restored.params, 8, layout="bitplane",
                                 device=DEV)
        same, _, n, _ = trees_equal(live, dep)
        out["cold_vs_live_bitplane"] = dict(bit_exact=same, leaves=n)
        assert same, out["cold_vs_live_bitplane"]
        out["bp2_refusal"] = bp2_refused(dep, api)

        # leg 4: the packed cold start, one decode step through the kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pstats = {}
        packed = to_serving_params(str(step_dir), 8, layout="packed",
                                   device=DEV, template=tmpl, stats=pstats)
        torch.cuda.synchronize()
        pk_s = time.perf_counter() - t0
        same, _, n, _ = trees_equal(packed, to_serving_params(
            restored.params, 8, layout="packed", device=DEV))
        assert same
        del restored, live
        tok = torch.randint(0, api.cfg.vocab, (DEPLOY_B, DEPLOY_P),
                            generator=torch.Generator(device=DEV)
                            .manual_seed(8), device=DEV, dtype=torch.int32)
        run, ref = oneshot_pair(api, packed, tok, 32, "kernel", new=2)
        c = compare(run, ref)
        out["packed_cold_start"] = dict(stats=pstats, s=pk_s, leaves=n,
                                        launches=run["launches"], **c)
        assert c["err"] <= EXACT_TOL_REL and c["token_agreement"] == 1.0, c
        del packed, run, ref

        # leg 5: the allocation's contracts, and the sorted search against
        # the heap on the card's own scores
        at = dict(budget=budget, before=weight_stream_bytes(dep),
                  after=alloc.total_bytes, steps=alloc.steps_taken,
                  steps_available=alloc.steps_available,
                  gate=alloc.gate, timings=kern["autotune_timings"])
        assert not validate_allocation(alloc.params, budget)
        assert not [f for f in validate_serving_tree(alloc.params)
                    if f.severity == "error"]
        batch = {"tokens": np.concatenate([r.inputs["tokens"]
                                           for r in kern["requests"]])}
        scores = sensitivity_tree(dep, calibrate_activations(api, dep,
                                                             batch))
        fast = greedy_allocate(dep, scores, budget)
        t0 = time.perf_counter()
        heap = greedy_allocate(dep, scores, budget, search="heap")
        at["heap_s"] = time.perf_counter() - t0
        at["sorted_equals_heap"] = all(
            np.array_equal(fast.occupancies[p], heap.occupancies[p])
            for p in heap.occupancies) and \
            fast.steps_taken == heap.steps_taken and \
            fast.predicted_error == heap.predicted_error
        at["launcher_equals_sorted"] = all(
            np.array_equal(fast.occupancies[p], alloc.occupancies[p])
            for p in fast.occupancies)
        at["occupancy_hist"] = np.bincount(np.concatenate(
            [o.ravel() for o in alloc.occupancies.values()]),
            minlength=9).tolist()
        out["autotune"] = at
        assert at["sorted_equals_heap"], at
        del fast, heap, scores

        # leg 6: the tuned tree served through the kernels against the
        # plain versions: scheduler drives and one-shot logits
        serve = {}
        for name, (kern_d, plain_d) in drives.items():
            kt = [r.tokens for r in kern_d["results"]]
            pt = [r.tokens for r in plain_d["results"]]
            serve[name] = dict(
                kernel=kern_d["record"], plain=plain_d["record"],
                tokens_equal=kt == pt,
                token_agreement=float(np.mean([a == b for x, y in
                                               zip(kt, pt)
                                               for a, b in zip(x, y)])))
        assert serve["exact"]["tokens_equal"], serve["exact"]
        kq = drives["quant"][0]
        tuned_q, dep_q = kq["allocation"].params, kq["deployed"]
        api_q = kq["engine"].api
        api_x = api
        for name, api_, tree, kv, tol in (
                ("exact", api_x, alloc.params, 32, EXACT_TOL_REL),
                ("quant", api_q, tuned_q, 8, QUANT_TOL_REL[8])):
            run, ref = oneshot_pair(api_, tree, tok, kv, "bitplane")
            c = compare(run, ref)
            serve[name]["oneshot"] = dict(c, launches=run["launches"],
                                          decode_ms_per_step=run[
                                              "decode_ms_per_step"])
            assert c["finite"] and c["err"] <= tol, (name, c)
            if name == "exact":
                assert c["token_agreement"] == 1.0, c
        full = oneshot_pair(api_q, dep_q, tok, 8, "bitplane")[0]
        serve["quant"]["full_tree_decode_ms_per_step"] = \
            full["decode_ms_per_step"]
        del full
        t_dev, t_ms = time_leaf_matmuls(tuned_q, DEPLOY_B)
        f_dev, f_ms = time_leaf_matmuls(dep_q, DEPLOY_B)
        serve["bitplane_matmul_layer_at_decode"] = dict(
            m=DEPLOY_B, tuned_device_ms=t_dev, tuned_ms=t_ms,
            full_device_ms=f_dev, full_ms=f_ms,
            tuned_stream_bytes=sum(bitplane_stream_bytes(x.layer(0)) for x in
                                   quant_nodes(tuned_q, BitplaneServingWeight)
                                   .values()),
            full_stream_bytes=sum(bitplane_stream_bytes(x.layer(0)) for x in
                                  quant_nodes(dep_q, BitplaneServingWeight)
                                  .values()))
        out["serve"] = serve
        out["matmul_calls"] = [row for d in drives.values()
                               for row in d[0]["record"]["matmul_calls"]]
        out["launches"] = {
            k: sum(d[0]["launches"][k] for d in drives.values())
            for k in ("bitplane_matmul", "paged_attention", "packed_matmul",
                      "pact_quant")}
        out["launches"]["packed_matmul"] += \
            out["packed_cold_start"]["launches"]["packed_matmul"]
        out["launches"]["paged_attention"] += \
            out["packed_cold_start"]["launches"]["paged_attention"]
        del drives, kern, plain, dep, alloc, kq, tuned_q, dep_q
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def deploy_drive_budget(ck, flags, size):
    """The autotune budget of the bit-plane cold start (timed: the
    launcher's own call): the fixed bytes plus ``DEPLOY_BUDGET_SHARE`` of
    the bit-plane leaves' plane and sign bytes."""
    import torch
    import repro_torch.launch.serve as ls
    from repro_torch.models.api import build
    from repro_torch.core.state import quant_nodes
    from repro_torch.serve.autotune.allocate import _leaf_bytes
    from repro_torch.serve.deploy import (BitplaneServingWeight,
                                          bitplane_stream_bytes,
                                          to_serving_params,
                                          weight_stream_bytes)
    args = ls.build_parser().parse_args(["--arch", ARCH, *size, *flags])
    with cut_serve_config(DEPLOY_LAYERS):
        api = build(ls._config(args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dep = to_serving_params(ls.resolve_ckpt_dir(str(ck)), 8,
                            layout="bitplane", device=DEV,
                            template=api.abstract_params())
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    leaves = quant_nodes(dep, BitplaneServingWeight)
    total = weight_stream_bytes(dep)
    planes = sum(bitplane_stream_bytes(l) - _leaf_bytes(l, 0, 0)
                 for l in leaves.values())
    fixed = total - planes
    budget = int(fixed + DEPLOY_BUDGET_SHARE * planes)
    del dep
    torch.cuda.empty_cache()
    return dict(budget=budget, stream_bytes=total, fixed_bytes=fixed,
                plane_bytes=planes, budget_share_of_total=budget / total,
                cold_start_s=cold_s)


def check_deploy(res):
    """The deploy phase's judgments that :func:`deploy_phase` does not
    assert inline (the quantized drive's tokens are recorded)."""
    for name in ("exact", "quant"):
        for drive in ("kernel", "plain"):
            rec = res["serve"][name][drive]
            assert rec["generated_tokens"] == DEPLOY_B * DEPLOY_NEW, rec
    assert res["launches"]["bitplane_matmul"] > 0 and \
        res["launches"]["paged_attention"] > 0 and \
        res["launches"]["packed_matmul"] > 0, res["launches"]


def deploy_summary(res) -> dict:
    r, at, s = res["restart"], res["autotune"], res["serve"]
    lm = s["bitplane_matmul_layer_at_decode"]
    return {
        "phase_s": res["phase_s"], "layers": res["layers"],
        "restart_bit_exact": r["bit_exact"],
        "save_gb": r["save_bytes"] / 1e9,
        "save_s_each": r["save_s_each"],
        "save_gb_per_s": r["save_gb_per_s"],
        "restore_s": r["restore_s"],
        "restore_gb_per_s": r["restore_gb_per_s"],
        "cold_start_s": res["cold_start"]["s"],
        "peak_host_bytes": res["cold_start"]["peak_host_bytes"],
        "dense_tree_bytes": res["cold_start"]["dense_tree_bytes"],
        "packed_cold_start_s": res["packed_cold_start"]["s"],
        "stream_bytes_before": at["before"],
        "stream_bytes_after": at["after"], "budget": at["budget"],
        "autotune_s": at["timings"], "heap_s": at["heap_s"],
        "sorted_equals_heap": at["sorted_equals_heap"],
        "gate": at["gate"],
        "exact_oneshot_err": s["exact"]["oneshot"]["err"],
        "quant_oneshot_err": s["quant"]["oneshot"]["err"],
        "quant_scheduler_token_agreement": s["quant"]["token_agreement"],
        "decode_ms_per_step_tuned": s["quant"]["oneshot"][
            "decode_ms_per_step"],
        "decode_ms_per_step_full": s["quant"]["full_tree_decode_ms_per_step"],
        "bitplane_matmul_layer_device_ms_tuned": lm["tuned_device_ms"],
        "bitplane_matmul_layer_device_ms_full": lm["full_device_ms"],
        "launches": res["launches"]}


# ---------------------------------------------------------------------------
# time phase
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# mesh phase
# ---------------------------------------------------------------------------

MESH_SHAPES = ((1, 2), (2, 1))  # (data, model)
# full-width phi3 and granite cut to these layers (of 32), for time
MESH_DEPTH = 8
MESH_MOE_DEPTH = 2
# (label, act bits, dtype, KV bits): quantizers off in f32 (tokens
# identical to the single-process engine), then the registered 8-bit PACT
# activations in bf16 with int8 KV (logits within QUANT_TOL_REL[8])
MESH_RUNS = (("f32", 32, "float32", 32), ("bf16_act8", 8, "bfloat16", 8))
# the scheduler drive: 8 requests, one arriving every 2 ticks, 4 slots
MESH_SCHED_WIDTHS = (64, 300, 128, 512, 96, 256, 200, 448)
MESH_SCHED_BUDGETS = (16, 32, 24, 16, 32, 16, 24, 32)
MESH_SCHED_SLOTS = 4
# (2, 1) gathers every FSDP-split weight over the host a layer a forward
# (~1.8 s a phi3 decode step at 8 layers on the H100), so its legs
# are shorter: one-shot new tokens, and the scheduler drive's first
# requests at half their budgets
MESH_DP_NEW = 8
MESH_DP_REQUESTS = 4
# and phi3's (2, 1) legs run on a tree of their own, cut to these layers
MESH_DP_DEPTH = 2
# The other families under a mesh (full width, depth cut for time; one
# shot, contiguous, each MESH_RUNS config): qwen2-vl 4 of 28 layers (256
# vision embeds a prompt), rwkv6 4 of 24, zamba2 8 of 38 (one shared-block
# call and the 2-layer tail), seamless 2 + 2 of 24 + 24 (S_ENC frames).
# All run on (1, 2); rwkv6 also on (2, 1), its recurrent rows split over
# data, and zamba2's f32 one shot also paged on (2, 1) (MESH_DP_NEW).
MESH_FAMILY_DEPTH = {"qwen2-vl-2b": 4, "rwkv6-1.6b": 4, "zamba2-1.2b": 8,
                     "seamless-m4t-large-v2": 2}
MESH_FAMILY_NEW = 8
# rwkv6's and zamba2's quantizer-free sharded logits against the single
# process's, relative to the largest (and the top-two gap below which a
# token may part): the only new rounding is the order of the all-reduce
# sums, which read 9.41e-6 and 1.02e-5 (rwkv6 on (1, 2) and (2, 1)) and
# 4.09e-6 (zamba2) on the H100; a planted fault (zamba2's shared block
# on whole heads, ``shared_block_whole_heads``) must read above it (0.144
# on the H100, scripts/mesh_probe.py)
MESH_F32_TOL_REL = EXACT_TOL_REL
MESH_DP_FAMILIES = ("rwkv6-1.6b",)
# phi3's bit-plane speculative leg, f32 without quantizers, on (1, 2)
MESH_SPEC = SPEC[1]
MESH_TIMEOUT_S = 600
# collectives probed on the ranks' tensors, and the payloads timed
MESH_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single",
                    "broadcast")
MESH_PROBE_BYTES = (48 << 10, 6 << 20, 48 << 20)


def mesh_phase(size=("--no-tiny",)):
    """Serving under a device mesh: two ranks on the one card (gloo; NCCL
    refuses two ranks on one device), each running :func:`mesh_rank`,
    the parent's cached blocks freed first.  Returns both ranks' records
    and the phase's seconds; a rank's failure raises."""
    import socket
    import tempfile
    import torch
    t0 = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="mesh_", dir=str(ROOT / "chiprun_out"))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(port), work, DEV, *size],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                10.0, MESH_TIMEOUT_S - (time.perf_counter() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        log(f"--- mesh rank {r} (exit {p.returncode})\n{text[-4000:]}")
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a mesh rank failed: " + "; ".join(
            f"rank {r} exit {p.returncode}" for r, p in enumerate(procs)))
    ranks = [json.loads((Path(work) / f"rank{r}.json").read_text())
             for r in range(2)]
    return {"ranks": ranks, "phase_s": time.perf_counter() - t0,
            "size": list(size)}


class ShapeLog:
    """Observer of the two matmul wrappers as the model calls them
    (``models.common``'s names): each launch's (M, K, N), K and N the
    weight's local shard (a ``grid`` sub-grid's), counted by kernel; the
    first launch at each shape is also held against the plain version on
    the same inputs and sub-grid (``errs``: |err| / max |plain|)."""

    def __init__(self):
        from repro_torch.models import common
        self.mod = common
        self.orig = {n: getattr(common, n)
                     for n in ("packed_matmul", "bitplane_matmul")}
        self.shapes, self.errs = {}, {}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)

    def _wrap(self, name, fn):
        from repro_torch.kernels import ref as kref

        def call(x, *args, **kw):
            grid = kw.get("grid")
            wbr, wbc = kw.get("wbr", 8), kw.get("wbc", 128)
            if name == "packed_matmul":
                gr, gc = grid[2:] if grid else args[1].shape[-2:]
                n = gc * wbc
            else:
                gr = grid[2] if grid else args[2].shape[-2]
                n = args[0].shape[-1]
            key = f"{name} {x.shape[0]}x{gr * wbr}x{n}"
            self.shapes[key] = self.shapes.get(key, 0) + 1
            y = fn(x, *args, **kw)
            if key not in self.errs:
                if name == "packed_matmul":
                    want = kref.packed_matmul_ref(
                        x, *args, kw.get("bits", 8), wbr, wbc, grid)
                else:
                    want = kref.bitplane_matmul_ref(x, *args, wbr, wbc,
                                                    grid)
                self.errs[key] = float((y - want).abs().max() /
                                       want.abs().max().clamp(min=1e-30))
            return y
        return call


def mesh_collectives(dev):
    """Which collectives gloo takes on this rank's tensors, and all-reduce
    / all-gather ms at ``MESH_PROBE_BYTES`` (host clock, synchronized)."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    out = {"ops": {}, "ms": []}

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()
    for op in MESH_COLLECTIVES:
        x = torch.arange(8, dtype=torch.float32, device=dev) + dist.get_rank()
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
            elif op == "all_gather":
                dist.all_gather([torch.empty_like(x) for _ in range(world)],
                                x)
            elif op == "all_gather_into_tensor":
                dist.all_gather_into_tensor(
                    torch.empty(8 * world, device=dev), x)
            elif op == "reduce_scatter_tensor":
                dist.reduce_scatter_tensor(
                    torch.empty(8 // world, device=dev), x)
            elif op == "all_to_all_single":
                dist.all_to_all_single(torch.empty_like(x), x)
            else:
                dist.broadcast(x, src=0)
            sync()
            out["ops"][op] = "ok"
        except Exception as e:              # noqa: BLE001 - recorded
            out["ops"][op] = f"{type(e).__name__}: {str(e)[:160]}"
    for nbytes in MESH_PROBE_BYTES:
        x = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
        row = {"bytes": nbytes}
        for op in ("all_reduce", "all_gather", "all_gather_into_tensor"):
            if out["ops"][op] != "ok":
                continue
            bufs = [torch.empty_like(x) for _ in range(world)]
            flat = torch.empty(world * x.numel(), device=dev)
            for i in range(4):
                if i == 1:
                    sync()
                    t = time.perf_counter()
                if op == "all_reduce":
                    dist.all_reduce(x)
                elif op == "all_gather":
                    dist.all_gather(bufs, x)
                else:
                    dist.all_gather_into_tensor(flat, x)
            sync()
            row[f"{op}_ms"] = (time.perf_counter() - t) * 1e3 / 3
        out["ms"].append(row)
    return out


def mesh_dims(size):
    """The phase's sizes: the smoke's at full width; a rehearsal's at
    tiny width (``--tiny``)."""
    if size == ("--no-tiny",):
        return dict(b=B, p=P, new=NEW, dp_new=MESH_DP_NEW,
                    fam_new=MESH_FAMILY_NEW, page=PAGE, chunk=SCHED_CHUNK,
                    frames=S_ENC, widths=MESH_SCHED_WIDTHS,
                    budgets=MESH_SCHED_BUDGETS)
    return dict(b=4, p=16, new=4, dp_new=3, fam_new=4, page=4, chunk=8,
                frames=8,
                widths=tuple(max(2, w // 16) for w in MESH_SCHED_WIDTHS),
                budgets=tuple(max(2, m // 8) for m in MESH_SCHED_BUDGETS))


def mesh_prompts(vocab, dev, dims):
    """The one-shot prompts (b x p) and the scheduler drive's requests."""
    import torch
    from repro_torch.serve import Request, SamplingParams
    g = torch.Generator(device="cpu").manual_seed(3)
    tok = torch.randint(0, vocab, (dims["b"], dims["p"]), generator=g,
                        dtype=torch.int32).to(dev)
    reqs = [Request(uid=i, inputs={"tokens": torch.randint(
        0, vocab, (1, w), generator=g, dtype=torch.int32).numpy()},
        sampling=SamplingParams(max_new_tokens=m), arrival=2 * i)
        for i, (w, m) in enumerate(zip(dims["widths"], dims["budgets"]))]
    return tok, reqs


def mesh_family_inputs(cfg, tok, dev, dims, seed=4):
    """A family's one-shot prompt batch: ``tok``, and a vlm's (B,
    vision_tokens, d_model) vision prefix or an enc-dec prompt's (B,
    frames, d_model) frames, 0.1 x standard normal, seeded."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = {"tokens": tok}
    if cfg.family == "vlm":
        out["vision_embeds"] = (torch.randn(
            (tok.shape[0], cfg.vision_tokens, cfg.d_model), generator=g)
            * 0.1).to(dev)
    if cfg.is_encdec:
        out["frames"] = (torch.randn((tok.shape[0], dims["frames"],
                                      cfg.d_model), generator=g)
                         * 0.1).to(dev)
    return out


def mesh_decode_collectives(cfg, tree, mesh, tok, kv, dev):
    """The collectives of one decode step of ``tree`` placed on ``mesh``
    (a contiguous cache after a prefill of ``tok``, one free position;
    the kernels and fused attention), as the dry run records them
    (``dryrun_phase`` holds them to its prediction)."""
    from repro_torch.dist.parallel import collective_log
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import collective_records
    from repro_torch.models.api import build
    from repro_torch.serve.engine import ServeEngine
    with use_mesh(mesh):
        eng = ServeEngine(build(cfg), tree, kv_quant_bits=kv,
                          backend="kernel", attn_backend="fused", device=dev)
    _, state = eng.prefill({"tokens": tok}, extra_slots=1)
    with collective_log(mesh) as log:
        eng.decode(tok[:, -1:], state, tok.shape[1])
    return {"b": int(tok.shape[0]), "s": int(tok.shape[1]) + 1,
            "log": collective_records(log)}


def mesh_rank(rank, port, work, dev, size):
    """One rank of the mesh phase.  Every rank builds the same seeded
    trees; rank 0 alone (the other waiting at a barrier) runs each leg on
    the single-process engine, then both run it under each of its meshes,
    launches counted around the sharded drive alone and every weight
    launch's (M, K, N) logged.  Legs, on (1, 2) unless named: phi3 packed
    int8 one shot (``MESH_RUNS``, 16-token pages, fused attention; also
    on (2, 1), shorter and at ``MESH_DP_DEPTH``), the scheduler drive
    (f32, quantizers off, paged and chunked; also on (2, 1), shorter and
    at ``MESH_DP_DEPTH``), a bit-plane deploy's one shot
    and its speculative drive (``MESH_SPEC``), granite-moe's int8 one
    shot on the single-process run's routing, and each other family's
    int8 one shot in each ``MESH_RUNS`` config (``MESH_FAMILY_DEPTH``;
    rwkv6 also on (2, 1); zamba2's f32 also paged on (2, 1), and with a
    planted fault, :func:`shared_block_whole_heads`)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        mesh_host_rehearsal()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    from repro_torch import kernels as tk
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine, _roundup64
    rec = {"rank": rank, "collectives": mesh_collectives(dev), "legs": []}
    meshes = {shape: make_mesh(shape, ("data", "model"), dev)
              for shape in MESH_SHAPES}
    dims = mesh_dims(size)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def drive(eng, kind, inputs, reqs, new):
        if kind == "spec":
            out = spec_drive(eng, inputs["tokens"], new)
            return {k: out[k] for k in ("tokens", "logits", "round_log",
                                        "ms", "rounds", "acceptance")}
        if kind != "scheduler":
            out = greedy(eng, inputs["tokens"], new,
                         page=dims["page"] if kind == "oneshot" else 0,
                         frames=inputs.get("frames"),
                         extra={k: v for k, v in inputs.items()
                                if k == "vision_embeds"})
            return {"tokens": out["tokens"], "logits": out["logits"],
                    "prefill_ms": out["prefill_ms"],
                    "decode_ms_per_step": out["decode_ms_per_step"]}
        max_len = max(eng.prompt_width(r.inputs) +
                      _roundup64(r.sampling.max_new_tokens) for r in reqs)
        sched = eng.make_scheduler(reqs, n_slots=MESH_SCHED_SLOTS,
                                   max_len=max_len, page_size=dims["page"],
                                   prefill_chunk=dims["chunk"])
        sync()
        t = time.perf_counter()
        res = sched.run(reqs)
        sync()
        return {"tokens": [res[i].tokens for i in range(len(reqs))],
                "s": time.perf_counter() - t, "ticks": sched.tick}

    def leg(label, cfg, tree, kind, shapes, kv, inputs, reqs=None,
            route=False, backend="kernel", spec=None, new=None, fault=None):
        """``kind``: ``oneshot`` (paged), ``family`` (contiguous), ``spec``
        (speculative, ``spec`` its (planes, gamma)) or ``scheduler``; the
        single-process run and each of ``shapes`` take ``new`` tokens.
        ``fault``: a context that plants a fault around the sharded drives
        (:func:`check_mesh` requires them to fail)."""
        api = build(cfg)
        new = new or dims["new"]
        kw = dict(kv_quant_bits=kv, backend=backend, attn_backend="fused",
                  device=dev)
        if spec:
            kw.update(speculate_planes=spec[0], draft_gamma=spec[1])
        row = {"label": label, "kind": kind, "kv": kv,
               "family": cfg.family, "arch": cfg.name,
               "layers": cfg.n_layers, "runs": {},
               "act_bits": cfg.quant.act_bits,
               "fault": fault.__name__ if fault else None}
        trace_file = Path(work) / f"route_{label}.pt"
        if rank == 0:
            eng = ServeEngine(api, tree, **kw)
            tk.reset_launch_counts()
            ctx = RouteTrace() if route else contextlib.nullcontext()
            with ctx as tr:
                out = drive(eng, kind, inputs, reqs, new)
            sync()
            out["launches"] = tk.launch_counts()
            if route:
                torch.save([c["idx"] for c in tr.calls], trace_file)
            row["single"] = out
            del eng
        dist.barrier()
        replay = None
        if route:
            replay = RouteTrace()
            replay.calls = [{"idx": i} for i in torch.load(trace_file)]
        for shape in shapes:
            with use_mesh(meshes[shape]):
                eng = ServeEngine(api, tree, **kw)
            sync()
            tk.reset_launch_counts()
            ctx = RouteTrace(replay) if route else contextlib.nullcontext()
            with ShapeLog() as sl, ctx, (fault or contextlib.nullcontext)():
                out = drive(eng, kind, inputs, reqs, new)
            sync()
            out["launches"] = tk.launch_counts()
            out["shapes"], out["matmul_errs"] = sl.shapes, sl.errs
            # what every rank's launches are held to (check_mesh): a
            # speculative drive's from its own rounds (the same on every
            # rank: each reads the same gathered logits), else the single
            # process's
            if kind == "spec":
                out["launches_want"] = spec_expected(cfg.n_layers)(out)
            elif rank == 0:
                out["launches_want"] = row["single"]["launches"]
            if rank == 0 and kind != "scheduler":
                out["vs_single"] = compare(out, row["single"])
            if rank == 0:
                out["tokens_equal"] = (
                    bool((out["tokens"] == row["single"]["tokens"]).all())
                    if kind != "scheduler"
                    else out["tokens"] == row["single"]["tokens"])
            row["runs"][f"{shape[0]}x{shape[1]}"] = out
            del eng
            dist.barrier()
        for out in [row.get("single", {})] + list(row["runs"].values()):
            out.pop("logits", None)
            out.pop("round_log", None)
            if isinstance(out.get("tokens"), torch.Tensor):
                out["tokens"] = out["tokens"].tolist()
        rec["legs"].append(row)
        (Path(work) / f"rank{rank}.json").write_text(json.dumps(rec))
        if dev == "cuda":
            torch.cuda.empty_cache()

    # phi3, packed int8, one shot in each MESH_RUNS config (on (2, 1)
    # shorter: the pool held whole on each data rank, its block tables
    # narrowed to the rank's rows); the scheduler (on (2, 1) its first
    # requests at half their budgets); bit planes, plain and speculative
    tp, dp = ((1, 2),), ((2, 1),)
    for label, act, dtype, kv in MESH_RUNS:
        cfg = served_config(ARCH, act, dtype, size, n_layers=MESH_DEPTH)
        qat = build(cfg).init(seed=0, device=dev)
        dep = to_serving_params(qat, 8, device=dev)
        tok, reqs = mesh_prompts(cfg.vocab, dev, dims)
        leg(f"phi3_int8_{label}", cfg, dep, "oneshot", tp, kv,
            {"tokens": tok})
        if act == 32:
            rec["decode_collectives"] = mesh_decode_collectives(
                cfg, dep, meshes[1, 2], tok, kv, dev)
        cfg_dp = served_config(ARCH, act, dtype, size,
                               n_layers=MESH_DP_DEPTH)
        dep_dp = to_serving_params(build(cfg_dp).init(seed=0, device=dev),
                                   8, device=dev)
        leg(f"phi3_int8_{label}_dp", cfg_dp, dep_dp, "oneshot", dp, kv,
            {"tokens": tok}, new=dims["dp_new"])
        if act == 32:
            short = [dataclasses.replace(r, sampling=dataclasses.replace(
                r.sampling, max_new_tokens=r.sampling.max_new_tokens // 2))
                for r in reqs[:MESH_DP_REQUESTS]]
            leg("phi3_int8_scheduler_f32_short", cfg_dp, dep_dp,
                "scheduler", dp, kv, {"tokens": tok}, short)
        del dep_dp
        if act == 32:
            leg("phi3_int8_scheduler_f32", cfg, dep, "scheduler", tp, kv,
                {"tokens": tok}, reqs)
            bp = to_serving_params(qat, 8, layout="bitplane", device=dev)
            leg("phi3_bitplane_f32", cfg, bp, "oneshot", tp, kv,
                {"tokens": tok})
            leg(f"phi3_bitplane_spec{MESH_SPEC[0]}x{MESH_SPEC[1]}_f32",
                cfg, bp, "spec", tp, kv, {"tokens": tok},
                backend="bitplane", spec=MESH_SPEC)
            del bp
        del qat, dep
    # granite-moe, int8, expert parallel over 2 model ranks
    cfg = served_config(MOE_ARCH, 32, "float32", size,
                        n_layers=MESH_MOE_DEPTH)
    dep = to_serving_params(build(cfg).init(seed=0, device=dev), 8,
                            device=dev)
    tok, reqs = mesh_prompts(cfg.vocab, dev, dims)
    leg("granite_int8_f32", cfg, dep, "oneshot", tp, 32, {"tokens": tok},
        route=True)
    del dep
    # the other families, int8, contiguous, each MESH_RUNS config
    for arch, depth in MESH_FAMILY_DEPTH.items():
        shapes = tp + (((2, 1),) if arch in MESH_DP_FAMILIES else ())
        for label, act, dtype, kv in MESH_RUNS:
            cfg = served_config(arch, act, dtype, size, n_layers=depth,
                                enc_layers=depth if "seamless" in arch
                                else 0)
            dep = to_serving_params(build(cfg).init(seed=0, device=dev), 8,
                                    device=dev)
            tok, _ = mesh_prompts(cfg.vocab, dev, dims)
            inputs = mesh_family_inputs(cfg, tok, dev, dims)
            leg(f"{arch.split('-')[0]}_int8_{label}", cfg, dep, "family",
                shapes, kv if cfg.family != "ssm" else 32, inputs,
                new=dims["fam_new"])
            if cfg.family == "hybrid" and act == 32:
                # paged on (2, 1): the pool whole on each data rank beside
                # the rank's recurrent rows
                leg("zamba2_int8_f32_paged_dp", cfg, dep, "oneshot", dp,
                    kv, inputs, new=dims["dp_new"])
                leg("zamba2_int8_f32_fault", cfg, dep, "family", tp, kv,
                    inputs, new=dims["fam_new"],
                    fault=shared_block_whole_heads)
            del dep
    dist.barrier()
    dist.destroy_process_group()
    return 0


@contextlib.contextmanager
def shared_block_whole_heads():
    """A planted sharding fault: zamba2's shared attention block reads its
    projections as if unsharded (``head_shards`` 1), so every model rank
    computes rank 0's heads and the row-parallel output sums the wrong
    heads."""
    from repro_torch.models import transformer
    orig = transformer.attn_forward
    transformer.attn_forward = lambda *a, **k: orig(
        *a, **dict(k, head_shards=1))
    try:
        yield
    finally:
        transformer.attn_forward = orig


def mesh_host_rehearsal():
    """A rank rehearsing on the host CPU (``DEV = "cpu"`` in the parent):
    the card's synchronize is a no-op and each wrapper's plain version
    counts as its kernel's launch, so the phase's checks run as on the
    card."""
    import torch
    from repro_torch import kernels as tk
    torch.cuda.synchronize = lambda *a, **k: None
    for fn in tk.KERNELS:
        mod = sys.modules[fn.__module__]
        ref = getattr(mod, f"{fn.__name__}_ref")

        def counted_ref(*a, _ref=ref, _fn=fn, **k):
            _fn.launches += 1
            return _ref(*a, **k)
        setattr(mod, f"{fn.__name__}_ref", counted_ref)


def mesh_verdict(row, out, out0, one):
    """Why a sharded run's tokens or logits fail against the single
    process's ``one`` (None where they pass; ``out0`` is rank 0's run,
    which holds the logit comparison).  Quantizer-free: tokens identical,
    but for rwkv6 and zamba2, held to ``MESH_F32_TOL_REL`` (logits within
    it of the largest, a token parting only where the single process's
    top-two gap is below it); with 8-bit activations, logits within
    ``QUANT_TOL_REL`` while the prefixes agree."""
    cmp = out0.get("vs_single")
    if row["act_bits"] < 32:
        tol = QUANT_TOL_REL[row["kv"] if row["kv"] < 32 else 8]
        if not (cmp["finite"] and cmp["err"] <= tol):
            return f"logits {cmp}"
    elif row["family"] in ("ssm", "hybrid"):
        tol = MESH_F32_TOL_REL
        if not (cmp["finite"] and cmp["err"] <= tol and (
                cmp["first_diff"] is None or
                cmp["top2_gap_at_first_diff"] < tol * cmp["max_logit"])):
            return f"logits {cmp}"
    elif out["tokens"] != one["tokens"]:
        return f"tokens differ from the single process's ({cmp})"
    return None


def check_mesh(res):
    """Every sharded leg on every rank against the single-process engine
    (rank 0 runs it): launches equal (a speculative drive's to its own
    rounds); tokens and logits by :func:`mesh_verdict`, which a leg with
    a planted fault must fail; every rank's tokens rank 0's (each reads
    the same gathered logits); every launch's local shard shape logged,
    and the kernel against its plain version on the shards."""
    r0 = res["ranks"][0]
    for rank in res["ranks"]:
        assert [row["label"] for row in rank["legs"]] == \
            [row["label"] for row in r0["legs"]], "ranks ran other legs"
        for row, row0 in zip(rank["legs"], r0["legs"]):
            for key, out in row["runs"].items():
                out0 = row0["runs"][key]
                where = f"mesh rank {rank['rank']} {row['label']} {key}"
                want = out.get("launches_want", out0["launches_want"])
                if out["launches"] != want:
                    raise AssertionError(f"{where}: launches "
                                         f"{out['launches']} vs {want}")
                why = mesh_verdict(row, out, out0, row0["single"])
                if row["fault"] is None and why is not None:
                    raise AssertionError(f"{where}: {why}")
                if row["fault"] is not None and why is None:
                    raise AssertionError(f"{where}: the planted fault "
                                         f"{row['fault']} passed "
                                         f"({out0.get('vs_single')})")
                if out["tokens"] != out0["tokens"]:
                    raise AssertionError(f"{where}: tokens differ from "
                                         f"rank 0's")
                if out["launches"]["packed_matmul"] + \
                        out["launches"]["bitplane_matmul"] != \
                        sum(out["shapes"].values()):
                    raise AssertionError(f"{where}: logged shapes miss "
                                         f"launches")
                bad = {k: e for k, e in out["matmul_errs"].items()
                       if not e <= PM_TOL_REL}
                if bad:
                    raise AssertionError(f"{where}: kernel vs plain on "
                                         f"shards {bad}")


def mesh_summary(res) -> dict:
    """The mesh phase's figures: each leg's decode ms/step (a speculative
    drive's ms and acceptance) beside the single-process engine's, the
    launches, the local shapes, the collectives gloo took and their
    times, the phase's seconds."""
    r0 = res["ranks"][0]
    keys = ("decode_ms_per_step", "prefill_ms", "s", "ms", "acceptance",
            "launches")
    legs = {}
    for row in r0["legs"]:
        one = row["single"]
        legs[row["label"]] = {
            "layers": row["layers"],
            **({"fault": row["fault"]} if row["fault"] else {}),
            "single": {k: one[k] for k in keys if k in one},
            **{key: {k: out[k] for k in keys + ("tokens_equal", "shapes")
                     if k in out} | {
                "matmul_err_max": max(out["matmul_errs"].values(),
                                      default=0.0)} | (
                {"err": out["vs_single"]["err"]} if "vs_single" in out
                else {}) for key, out in row["runs"].items()}}
    return {"phase_s": res["phase_s"], "legs": legs,
            "collectives": r0["collectives"],
            "transport": "gloo, two ranks on one card (host-staged, not "
                         "NVLink)"}


# ---------------------------------------------------------------------------
# mesh train phase: BWQ-A training under a process mesh, its checkpoints
# restored across meshes, the trained tree served under the mesh
# ---------------------------------------------------------------------------

# full-width phi3 cut to 2 layers, f32, fake quantization, PACT off; a
# global batch of 4 x 128; maintenance and an alpha round every 2 steps
MT_LAYERS = 2
MT_B, MT_SEQ = 4, 128
MT_STEPS, MT_EVERY, MT_FAULT, MT_SPLIT = 6, 2, 3, 4  # (2,1) trains to 4
MT_LR, MT_DELTA = 2e-3, 1e-7
MT_LOSS_TOL_REL = 1e-5          # each step's loss against the single run's
# A param leaf against the single run's: within MT_LEAF_TOL of its largest
# magnitude, or within MT_WITNESS_X times the witness's distance, the
# single run again on each batch's rows reversed (the same means, another
# summation order); a step's gradient norm within MT_WITNESS_X times the
# witness's largest relative distance over the run.  AdamW moves an
# element whose gradient is near zero by about the learning rate whatever
# the gradient's size, so rounding alone parts such elements (the norm
# scales, the embedding) by up to lr a step, and maintenance snaps a
# master weight near a level boundary one level apart (H100 80GB HBM3,
# 700 W: the witness 1.0e-3-1.2e-2 of a leaf's largest after 6 steps, the
# mesh run 1.0-1.7x the witness; gradient norms 2.1e-5 and 4.3e-5 at most)
MT_LEAF_TOL, MT_WITNESS_X = 1e-4, 4.0
MT_KEEP = (0.9, 0.3, 0.6, 1.0)  # the uneven batch: each row's labels kept
MT_SERVE_B, MT_SERVE_P, MT_SERVE_NEW = 4, 64, 8
# (label, activation bits, dtype, KV bits) of the cold-started serving legs
MT_SERVE_RUNS = (("f32", 32, "float32", 32), ("bf16_act8", 8, "bfloat16", 8))
MT_DISK_GB = 24                 # three 3.9 GB steps, tmp dirs, the baseline
MT_TIMEOUT_S = 600
# The losses that hold a statistic of the whole batch, on (2, 1) against
# the single process, after MT_SPLIT_STEPS steps each: granite-moe at full
# width cut to MESH_MOE_DEPTH layers (f32, fake mode, PACT off, the
# ``ragged`` dispatch; its load-balancing term) on the phase's 4 x 128
# batches, and ResNet-20 (the CIFAR launcher's bit-plane 9x8 blocks, PACT
# off, its SGD and schedule; its BatchNorm) on MT_CNN_B 32x32 images.
# Losses within MT_LOSS_TOL_REL, params by ``mt_param_faults`` against
# ``mt_split_witness``: each leaf's larger distance of two single runs,
# on reversed rows and on the host CPU from the card's init.  Reversed
# rows keep every row's forward values bit for bit (each product keeps
# its M) and change only the sums over rows; the split halves every
# product's M, so its forward rounds as another arithmetic does (H100
# 80GB HBM3, 700 W: granite's embedding 2.44e-4 of its largest, 21x the
# reversed witness, 1.5x the host's; ResNet-20 4.50e-3, 1.8x / 1.07x).
# Each with a planted fault (per-rank means in the aux term; per-rank
# BatchNorm moments) that must fail.
MT_SPLIT_STEPS = 2
MT_CNN_B, MT_CNN_DEPTH = 64, 20


def mt_dims(size):
    """The phase's sizes: full width, or a rehearsal's tiny ones."""
    if size == ("--no-tiny",):
        return dict(b=MT_B, seq=MT_SEQ, sb=MT_SERVE_B, sp=MT_SERVE_P,
                    new=MT_SERVE_NEW, page=PAGE)
    return dict(b=MT_B, seq=16, sb=4, sp=8, new=4, page=4)


def mt_config(size, act_bits=32, dtype="float32"):
    """The train launcher's phi3 config (``--layers 2``, fake mode) at
    ``dtype`` with ``act_bits`` activations."""
    from repro_torch.launch import train as tl
    cfg = tl.config(tl.build_parser().parse_args(
        ["--arch", ARCH, *size, "--layers", str(MT_LAYERS), "--act-bits",
         str(act_bits)]))
    return dataclasses.replace(cfg, dtype=dtype)


def mt_batch(cfg, step, dims):
    """Data step ``step`` of the phase's stream (the train launcher's
    synthetic bigram stream, seed 0)."""
    from repro_torch.data.synthetic import SyntheticLM
    return SyntheticLM(cfg.vocab, dims["seq"], dims["b"]).batch_at(step)


def mt_uneven(cfg, dims):
    """A batch whose rows keep ``MT_KEEP`` of their labels (a ``mask``):
    the data ranks' label counts differ."""
    import numpy as np
    import torch
    b = mt_batch(cfg, 100, dims)
    rng = np.random.default_rng(5)
    keep = np.asarray(MT_KEEP)[:, None]
    b["mask"] = torch.from_numpy(
        (rng.random((dims["b"], dims["seq"])) < keep).astype(np.float32))
    return b


def mt_trainer(cfg, ck, sink):
    """The phase's trainer over the seed-0 init, each step timed into
    ``sink`` (synchronized)."""
    import torch
    from repro_torch.models.api import build
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig
    api = build(cfg)
    tr = Trainer(api.loss, adamw(weight_decay=0.0),
                 cosine_schedule(MT_LR, MT_STEPS),
                 api.init(seed=0, device=DEV),
                 TrainerConfig(total_steps=MT_STEPS,
                               ckpt_every=MT_EVERY if ck else 0,
                               ckpt_dir=ck, log_every=1,
                               requant_interval=MT_EVERY,
                               alpha_round_steps=MT_EVERY,
                               delta_alpha=MT_DELTA))
    step = tr.train_step

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    tr.train_step = timed
    return tr


def mt_data(cfg, dims, reverse=False):
    """The stream from a start step; ``reverse`` flips each batch's rows
    (the witness)."""
    def make(start):
        s = start
        while True:
            b = mt_batch(cfg, s, dims)
            yield s, {k: v.flip(0) for k, v in b.items()} if reverse else b
            s += 1
    return make


def mt_history(trainers):
    """Each step's (loss, ce, reg, grad_norm) over trainers run in turn
    (a restarted step: the last run's)."""
    out = {}
    for tr in trainers:
        for h in tr.history:
            out[h["step"]] = {k: h[k] for k in ("loss", "ce", "reg",
                                                "grad_norm")}
    return [out[s] for s in sorted(out)], sorted(out)


def mt_vg_loss(api, params, batch, mesh):
    """The loss and gradient norm of one data-parallel value-and-gradient
    on ``batch`` (the train step's reduction, no update).  A random
    model's per-row losses all sit near ln(vocab), so a misweighted sum
    shows in the gradient, whose ranks' parts differ."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.optim import global_norm
    from repro_torch.train.step import (data_parallel,
                                        microbatched_value_and_grad)
    with use_mesh(mesh):
        (loss, _), g = data_parallel(microbatched_value_and_grad(api.loss))(
            params, batch)
    return {"loss": float(loss), "grad_norm": float(global_norm(g))}


def mt_split_trainer(model, size, dev=None):
    """A fresh trainer of ``model`` (``granite`` / ``resnet``, see
    ``MT_SPLIT_STEPS``) over its seed-0 init (drawn on the card, then
    moved to ``dev``), and its data stream."""
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.launch import cifar
    from repro_torch.launch import train as tl
    from repro_torch.models import cnn
    from repro_torch.models.api import build
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.serve.deploy import tree_to
    from repro_torch.train import Trainer, TrainerConfig
    tcfg = TrainerConfig(total_steps=MT_SPLIT_STEPS, log_every=1,
                         requant_interval=0)
    dev = dev or DEV
    if model == "granite":
        cfg = dataclasses.replace(tl.config(tl.build_parser().parse_args(
            ["--arch", MOE_ARCH, *size, "--layers", str(MESH_MOE_DEPTH),
             "--act-bits", "32"])), dtype="float32")
        api = build(cfg)
        dims = mt_dims(size)
        tr = Trainer(api.loss, adamw(weight_decay=0.0),
                     cosine_schedule(MT_LR, MT_SPLIT_STEPS),
                     tree_to(api.init(seed=0, device=DEV), dev), tcfg)
        return tr, lambda s: mt_batch(cfg, s, dims)
    qc = cifar.quant_config("bwq", act_bits=32)
    image = 32 if size == ("--no-tiny",) else 8
    depth = MT_CNN_DEPTH if size == ("--no-tiny",) else 8
    tr = Trainer(lambda p, b: cnn.cnn_loss(cnn.resnet_apply, p, b, qc),
                 cifar.optimizer(), cifar.lr_schedule(MT_SPLIT_STEPS),
                 tree_to(cnn.resnet_init(qc, depth=depth, seed=0,
                                         device=DEV), dev), tcfg)
    gen = SyntheticCIFAR(image=image, batch=MT_CNN_B, noise=0.5, seed=0)
    return tr, gen.batch_at


def mt_split_run(model, size, rows=None, sink=None, dev=None):
    """``model``'s trainer after ``MT_SPLIT_STEPS`` steps under the active
    mesh, on ``dev`` (default the card), and its losses; each step's ms
    (synchronized) into ``sink``.  ``rows="reversed"``: a witness's
    batches, each batch's rows reversed."""
    import torch
    dev = dev or DEV
    tr, batch_at = mt_split_trainer(model, size, dev)
    if sink is not None:
        step = tr.train_step

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        tr.train_step = timed

    def data():
        for s in range(MT_SPLIT_STEPS):
            b = {k: v.to(dev) for k, v in batch_at(s).items()}
            if rows == "reversed":
                b = {k: v.flip(0) for k, v in b.items()}
            yield s, b
    tr.run(data(), steps=MT_SPLIT_STEPS)
    return tr, [h["loss"] for h in tr.history]


def mt_split_single(model, root, size):
    """The single process's run of ``model`` (its params saved under
    ``root``), and two witnesses' distances from it: the single run on
    reversed rows and the single run on the host CPU (every op in
    another f32 arithmetic): ``mt_split_witness``."""
    from repro_torch.ckpt import save_tree
    tr, losses = mt_split_run(model, size)
    path = root / f"split_{model}"
    save_tree(tr.state.params, str(path))
    del tr
    wit, wlosses = mt_split_run(model, size, rows="reversed")
    rev = mt_leaf_diffs(wit.state.params, path)
    del wit
    t0 = time.perf_counter()
    host, hlosses = mt_split_run(model, size, dev="cpu")
    return {"losses": losses, "reversed_losses": wlosses,
            "reversed_diffs": rev, "host_losses": hlosses,
            "host_diffs": mt_leaf_diffs(host.state.params, path),
            "host_s": time.perf_counter() - t0}


def mt_split_witness(one):
    """Each leaf's witness distance from the single run: the larger of
    the single run's on reversed rows and on the host CPU (neither runs
    the split)."""
    host = one["host_diffs"]
    return {k: [max(d, host[k][0]), m]
            for k, (d, m) in one["reversed_diffs"].items()}


@contextlib.contextmanager
def mt_split_fault(model):
    """The planted fault of ``model``'s leg: each rank's aux term from its
    own rows' means (granite), or its BatchNorm from its own rows'
    moments (resnet)."""
    if model == "granite":
        from repro_torch.models import moe as mod
        name, fake = "batch_sum", (lambda t: t)
    else:
        from repro_torch.models import cnn as mod
        name, fake = "split_mesh", (lambda: None)
    real = getattr(mod, name)
    setattr(mod, name, fake)
    try:
        yield
    finally:
        setattr(mod, name, real)


def mt_split_rank(mesh, root, size):
    """This rank's runs of each model on ``mesh``: plain and with the
    planted fault; losses, step times and the params' distance from the
    single run's."""
    import torch
    from repro_torch.dist.sharding import use_mesh
    out = {}
    for model in ("granite", "resnet"):
        for leg, planted in (("", False), ("_planted", True)):
            t0 = time.perf_counter()
            ms = []
            with use_mesh(mesh), (mt_split_fault(model) if planted
                                  else contextlib.nullcontext()), \
                    GradReduceClock() as gr:
                tr, losses = mt_split_run(model, size, sink=ms)
            torch.cuda.synchronize()
            out[model + leg] = {
                "losses": losses, "s": time.perf_counter() - t0,
                "step_ms": ms,
                "grad_reduce": [c for c in gr.calls
                                if c["bytes"] > 1 << 20],
                "leaf_diffs": mt_leaf_diffs(tr.state.params,
                                            root / f"split_{model}")}
            del tr
            torch.cuda.empty_cache()
    return out


def mesh_train_phase(size=("--no-tiny",)):
    """BWQ-A training under a process mesh (see the module docstring, 14):
    the single-process baseline here, then two gloo ranks on the card on
    (2, 1) (:func:`mesh_train_rank`, leg ``dp``), then two fresh ranks on
    (1, 2) (leg ``tp``).  Writes under ``chiprun_out/mesh_train`` (free
    space checked first) and removes it at the end, pass or fail."""
    import shutil
    import socket
    import torch
    from repro_torch.ckpt import save_tree
    from repro_torch.models.api import build
    t_phase = time.perf_counter()
    dims = mt_dims(size)
    root = ROOT / "chiprun_out" / "mesh_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    if free_gb < MT_DISK_GB and size == ("--no-tiny",):
        raise AssertionError(f"mesh train phase: {free_gb:.1f} GB free under "
                             f"{root}, needs {MT_DISK_GB}")
    out = {"free_gb": free_gb, "layers": MT_LAYERS, "size": list(size)}
    try:
        cfg = mt_config(size)
        # the single-process baseline: 6 steps, then the uneven batch's
        # loss and gradient norm from the seed-0 init
        ms = []
        tr = mt_trainer(cfg, None, ms)
        tr.run(mt_data(cfg, dims)(0), steps=MT_STEPS)
        hist, steps = mt_history([tr])
        single = tr.state.params
        save_tree(single, str(root / "single_params"))
        del tr
        # the witness: the same 6 steps on each batch's rows reversed
        wit = mt_trainer(cfg, None, [])
        wit.run(mt_data(cfg, dims, reverse=True)(0), steps=MT_STEPS)
        out["witness"] = {"history": mt_history([wit])[0],
                          "leaf_diffs": mt_leaf_diffs(wit.state.params,
                                                      single)}
        del wit, single
        api = build(cfg)
        params = api.init(seed=0, device=DEV)
        batch = {k: v.to(DEV) for k, v in mt_uneven(cfg, dims).items()}
        uneven = mt_vg_loss(api, params, batch, None)
        del params, batch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["single"] = {"history": hist, "steps": steps, "step_ms": ms,
                         "uneven": uneven}
        out["split_single"] = {m: mt_split_single(m, root, size)
                               for m in ("granite", "resnet")}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for leg in ("dp", "tp"):
            with socket.socket() as sk:
                sk.bind(("localhost", 0))
                port = sk.getsockname()[1]
            out[leg] = mt_spawn(leg, port, root, size, t_phase)
        out["phase_s"] = time.perf_counter() - t_phase
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def mt_spawn(leg, port, root, size, t_phase):
    """Two rank processes of ``leg``; both ranks' records."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-train-rank",
         str(r), str(port), str(root), DEV, leg, *size],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                10.0, MT_TIMEOUT_S - (time.perf_counter() - t_phase)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        log(f"--- mesh train {leg} rank {r} (exit {p.returncode})\n"
            f"{text[-4000:]}")
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"a mesh train rank ({leg}) failed: " + "; ".join(
            f"rank {r} exit {p.returncode}" for r, p in enumerate(procs)))
    return [json.loads((root / f"{leg}{r}.json").read_text())
            for r in range(2)]


class GradReduceClock:
    """Observer of the train step's flat all-reduce
    (``train.step.all_reduce_tensors``): each call's ms (synchronized)
    and bytes."""

    def __init__(self):
        import repro_torch.train.step as st
        self.mod, self.orig, self.calls = st, st.all_reduce_tensors, []

    def __enter__(self):
        import torch

        def timed(ts, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.orig(ts, *a, **k)
            torch.cuda.synchronize()
            self.calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                               "bytes": sum(t.numel() * t.element_size()
                                            for t in ts)})
        self.mod.all_reduce_tensors = timed
        return self

    def __exit__(self, *exc):
        self.mod.all_reduce_tensors = self.orig


def mt_checksum(state):
    """One digest of every leaf of a state, bit for bit: each leaf's bytes
    as int32 words (bytes for an odd size), their sum and their
    position-weighted sum (int64, on the leaf's device), hashed."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import iter_leaves
    h = hashlib.sha256()
    for k, v in iter_leaves(state):
        h.update(k.encode())
        if isinstance(v, (np.ndarray, int)):
            h.update(np.asarray(v).tobytes())
            continue
        b = v.detach().contiguous().reshape(-1).view(torch.uint8)
        w = (b.view(torch.int32) if b.numel() % 4 == 0 else b).long()
        pos = torch.arange(1, w.numel() + 1, device=w.device)
        h.update(np.array([int(w.sum()), int((w * pos).sum())],
                          np.int64).tobytes())
    return h.hexdigest()


def mt_replicas(state):
    """Every rank's digest of ``state`` (all-gathered)."""
    import torch.distributed as dist
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, mt_checksum(state))
    return digests


def mt_ckpt(path, mesh):
    """A save's shard files, the bytes this rank wrote (the shard files
    whose host it owns) and its CK findings."""
    from repro_torch.analysis.contracts import validate_checkpoint
    from repro_torch.ckpt.checkpoint import _writes
    meta = json.loads((Path(path) / "META").read_text())
    hosts = [dict(zip(meta["shard_axes"], c)) for c in meta["hosts"]]
    n = meta["n_shards"]
    mine = sum((Path(path) / f"shard_{h:05d}-of-{n:05d}.npz").stat().st_size
               for h, c in enumerate(hosts) if _writes(mesh, c))
    return {"shards": sorted(p.name for p in Path(path).iterdir()
                             if p.name.startswith("shard_")),
            "mesh_axes": meta["mesh_axes"], "rank_bytes": mine,
            "findings": sorted({f"{f.severity}:{f.rule}"
                                for f in validate_checkpoint(str(path))})}


def mt_leaf_diffs(params, ref):
    """Each float param leaf's (largest |difference|, largest |ref|)
    against ``ref``: a tree of one structure, or a checkpoint's path."""
    from repro_torch.ckpt import CheckpointReader
    from repro_torch.ckpt.checkpoint import iter_leaves
    reader = CheckpointReader(str(ref)) if isinstance(ref, (str, Path)) \
        else None
    want = None if reader else dict(iter_leaves(ref))
    out = {}
    try:
        for k, v in iter_leaves(params):
            if not v.is_floating_point():
                continue
            w = reader.read_tensor(k, v.device) if reader else want[k]
            w = w.double()
            out[k] = [float((v.double() - w).abs().max()),
                      float(w.abs().max())]
    finally:
        if reader:
            reader.close()
    return out


def mt_param_faults(diffs, witness):
    """(path, |difference| / largest, witness's) of every leaf off by more
    than ``MT_LEAF_TOL`` of its largest magnitude and ``MT_WITNESS_X``
    times the witness's difference."""
    return [(k, d / max(mag, 1e-30), witness[k][0] / max(mag, 1e-30))
            for k, (d, mag) in diffs.items()
            if d > max(MT_LEAF_TOL * mag, MT_WITNESS_X * witness[k][0])]


def mesh_train_rank(rank, port, root, dev, leg, size):
    """One rank of the mesh train phase.  ``dp``: on (2, 1), one layer's
    gradient through ``compressed_all_reduce``; the uneven batch's loss
    with the ranks' shares and with the shares forced equal (the planted
    fault); steps 1-4 through a crash before data step 3
    (``run_with_restarts``).  ``tp``: on (1, 2), fresh ranks restore step
    4 and train to 6; the params against the single run's; the step-6
    checkpoint cold-started to packed int8 and served one shot (rank 0
    also on the single-process engine first) in each ``MT_SERVE_RUNS``
    config."""
    import torch
    import torch.distributed as dist
    global DEV
    DEV = dev
    sys.path.insert(0, str(ROOT / "src"))
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        mesh_host_rehearsal()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import run_with_restarts
    if size != ("--no-tiny",):
        # a rehearsal's leaves are below the FSDP threshold: shard them on
        # data anyway, so that its saves have the card's file layout
        sharding.FSDP["min_bytes"] = 0
    if dev == "cpu":
        torch.set_num_threads(2)
    root = Path(root)
    dims = mt_dims(size)
    cfg = mt_config(size)
    shape = (2, 1) if leg == "dp" else (1, 2)
    mesh = make_mesh(shape, ("data", "model"), dev)
    data = mt_data(cfg, dims)
    ck = str(root / "ck")
    rec = {"rank": rank, "leg": leg, "shape": list(shape)}
    trainers, ms = [], []

    def make():
        trainers.append(mt_trainer(cfg, ck, ms))
        return trainers[-1]
    with CkptClock() as clock, GradReduceClock() as gr:
        if leg == "dp":
            rec.update(mt_dp_checks(cfg, mesh, dims))
            with use_mesh(mesh):
                run_with_restarts(make, data, total_steps=MT_SPLIT,
                                  fault_at=MT_FAULT)
            rec["attempts"] = len(trainers)
        else:
            with use_mesh(mesh):
                make()
                rec["resumed"] = trainers[-1].try_restore()
                trainers[-1].run(data(rec["resumed"]), steps=MT_STEPS)
    state = trainers[-1].state
    rec["history"], rec["steps"] = mt_history(trainers)
    rec["first_attempt_steps"] = [h["step"] for h in trainers[0].history]
    rec["step_ms"] = ms
    rec["grad_reduce"] = [c for c in gr.calls if c["bytes"] > 1 << 20]
    rec["saves"] = clock.saves
    rec["restores"] = clock.restores
    rec["replicas"] = mt_replicas(state)
    last = Path(ck) / f"step_{state.step}"
    rec["ckpt"] = mt_ckpt(last, mesh)
    rec["ckpt_steps"] = sorted(p.name for p in Path(ck).iterdir())
    if leg == "tp":
        rec["leaf_diffs"] = mt_leaf_diffs(state.params,
                                          root / "single_params")
    del trainers, state
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if leg == "dp":
        rec["split"] = mt_split_rank(mesh, root, size)
    if leg == "tp":
        rec["serve"] = mt_serve(last, mesh, dims, size)
    (root / f"{leg}{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mt_dp_checks(cfg, mesh, dims):
    """(2, 1): ``compressed_all_reduce`` of layer 0's ``wq`` gradient on
    this rank's rows against ``compressed_sum`` of every rank's, and what
    it sent; the uneven batch's loss, then again with the ranks' shares
    forced equal (loss and gradient norm)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.parallel import all_gather, batch_coord, batch_rows
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.api import build
    from repro_torch.optim import compressed_all_reduce, compressed_sum
    from repro_torch.train import step as st
    api = build(cfg)
    params = api.init(seed=0, device=DEV)
    batch = {k: v.to(DEV) for k, v in mt_batch(cfg, 0, dims).items()}
    lo, hi = batch_rows(dims["b"], mesh)[batch_coord(mesh)]
    with use_mesh(None):
        _, g = st.microbatched_value_and_grad(api.loss)(
            params, {k: v[lo:hi] for k, v in batch.items()})
    x = g["layers"]["attn"]["wq"].w[0].contiguous()
    del g
    sent, orig = [], dist.all_gather_into_tensor

    def spy(o, t, *a, **k):
        sent.append(str(t.dtype))
        return orig(o, t, *a, **k)
    dist.all_gather_into_tensor = spy
    try:
        with use_mesh(mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = compressed_all_reduce(x, "data")
            torch.cuda.synchronize()
            c_ms = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_gather_into_tensor = orig
    with use_mesh(mesh):
        xs = all_gather(x, "data")
    want = compressed_sum(xs)
    out = {"compressed": {
        "shape": list(x.shape), "equal": bool(torch.equal(y, want)),
        "sent": sent, "ms": c_ms,
        "err_vs_sum": float((y - sum(xs)).abs().max()
                            / sum(xs).abs().max())}}
    uneven = {k: v.to(DEV) for k, v in mt_uneven(cfg, dims).items()}
    out["uneven"] = mt_vg_loss(api, params, uneven, mesh)
    real = st.rank_share
    st.rank_share = lambda b, m: (real(b, m)[0], 1.0 / 2)
    try:
        out["planted"] = mt_vg_loss(api, params, uneven, mesh)
    finally:
        st.rank_share = real
    return out


def mt_serve(step_dir, mesh, dims, size):
    """The step-6 checkpoint cold-started to packed int8 on this rank and
    served one shot (paged, fused attention) in each ``MT_SERVE_RUNS``
    config: rank 0 first on the single-process engine (the other rank
    waiting), then both placed on ``mesh``, launches counted around each
    drive."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as tk
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine
    rank = dist.get_rank()
    out = {}
    for label, act, dtype, kv in MT_SERVE_RUNS:
        cfg = mt_config(size, act, dtype)
        api = build(cfg)
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the checkpoint's structure is the PACT-off config's
        dep = to_serving_params(
            str(step_dir), 8, device=DEV, stats=stats,
            template=build(mt_config(size, 32, dtype)).abstract_params())
        torch.cuda.synchronize()
        if act < 32:
            # PACT was off in training: the clip values are the init's
            dep["layers"] = dict(dep["layers"], **{
                k: torch.full((cfg.n_layers,), cfg.quant.pact_init,
                              dtype=torch.float32, device=DEV)
                for k in ("beta_attn", "beta_mlp")})
        rec = {"cold_start_s": time.perf_counter() - t0,
               "peak_host_bytes": stats["peak_host_bytes"],
               "dense_tree_bytes": stats["dense_tree_bytes"]}
        g = torch.Generator(device="cpu").manual_seed(3)
        tok = torch.randint(0, cfg.vocab, (dims["sb"], dims["sp"]),
                            generator=g, dtype=torch.int32).to(DEV)
        kw = dict(kv_quant_bits=kv, backend="kernel", attn_backend="fused",
                  device=DEV)
        if rank == 0:
            eng = ServeEngine(api, dep, **kw)
            tk.reset_launch_counts()
            single = greedy(eng, tok, dims["new"], page=dims["page"])
            torch.cuda.synchronize()
            single["launches"] = tk.launch_counts()
            del eng
        dist.barrier()
        with use_mesh(mesh):
            eng = ServeEngine(api, dep, **kw)
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        run = greedy(eng, tok, dims["new"], page=dims["page"])
        torch.cuda.synchronize()
        rec["launches"] = tk.launch_counts()
        rec["tokens"] = run["tokens"].tolist()
        rec["decode_ms_per_step"] = run["decode_ms_per_step"]
        if rank == 0:
            rec["single_launches"] = single["launches"]
            rec["single_tokens"] = single["tokens"].tolist()
            rec["single_decode_ms_per_step"] = single["decode_ms_per_step"]
            rec["vs_single"] = compare(run, single)
            del single
        out[label] = rec
        del eng, dep, run
        dist.barrier()
    return out


def check_mesh_train(res):
    """The phase's rules: every step's loss within ``MT_LOSS_TOL_REL`` of
    the single run's; both ranks' states one digest; the restart resumed
    from step 2 and the elastic restore from step 4; the saves one shard
    file a data (step 4) and a model coordinate (step 6), CK-clean; the
    (1, 2) params and the gradient norms against the single run's by
    :func:`mt_param_faults`' rule; ``compressed_all_reduce`` its
    formula, sending int8; the uneven batch's loss and gradient norm
    within the limit, and the planted fault's above it; the cold-started
    tree served on (1, 2):
    launches equal the single process's on every rank, tokens identical
    with the quantizers off, logits within ``QUANT_TOL_REL`` with them."""
    one = res["single"]
    want = dict(zip(one["steps"], one["history"]))
    for leg, steps in (("dp", list(range(1, MT_SPLIT + 1))),
                       ("tp", list(range(MT_SPLIT + 1, MT_STEPS + 1)))):
        r0 = res[leg][0]
        for rank in res[leg]:
            where = f"mesh train {leg} rank {rank['rank']}"
            assert rank["history"] == r0["history"], where
            assert rank["replicas"][0] == rank["replicas"][1], \
                f"{where}: replicas differ"
            assert rank["steps"] == (list(range(1, MT_SPLIT + 1))
                                     if leg == "dp" else steps), where
            assert rank["ckpt"]["findings"] == ["info:CK0"], \
                (where, rank["ckpt"]["findings"])
            assert len(rank["ckpt"]["shards"]) == 2, (where, rank["ckpt"])
        for s, h in zip(r0["steps"], r0["history"]):
            err = abs(h["loss"] - want[s]["loss"]) / abs(want[s]["loss"])
            assert err <= MT_LOSS_TOL_REL, (leg, s, h, want[s])
    dp, tp = res["dp"][0], res["tp"][0]
    assert dp["attempts"] == 2 and dp["first_attempt_steps"] == [1, 2, 3], dp
    assert dp["restores"] and dp["restores"][0]["path"].endswith("step_2")
    assert dp["ckpt"]["mesh_axes"] == {"data": 2, "model": 1}, dp["ckpt"]
    assert tp["resumed"] == MT_SPLIT and \
        tp["ckpt"]["mesh_axes"] == {"data": 1, "model": 2}, tp
    bad = mt_param_faults(tp["leaf_diffs"], res["witness"]["leaf_diffs"])
    assert not bad, ("params off the single run's", bad)
    # a gradient norm's noise moves from step to step: the limit is the
    # witness's largest relative distance over the run
    wit = max(abs(w["grad_norm"] - want[s]["grad_norm"])
              / abs(want[s]["grad_norm"])
              for s, w in zip(one["steps"], res["witness"]["history"]))
    lim = max(MT_LOSS_TOL_REL, MT_WITNESS_X * wit)
    for r0 in (dp, tp):
        for s, h in zip(r0["steps"], r0["history"]):
            g, w = h["grad_norm"], want[s]["grad_norm"]
            assert abs(g - w) <= lim * abs(w), ("grad norm", s, g, w, lim)
    c = dp["compressed"]
    assert c["equal"] and c["sent"] == ["torch.int8"], c
    u = one["uneven"]
    ok, bad = mt_rel(dp["uneven"], u), mt_rel(dp["planted"], u)
    assert max(ok.values()) <= MT_LOSS_TOL_REL, (ok, dp["uneven"], u)
    assert max(bad.values()) > MT_LOSS_TOL_REL, \
        ("the planted fault (equal shares) passed", bad)
    for model, one in res["split_single"].items():
        for rank in res["dp"]:
            got = rank["split"][model]
            where = f"mesh train split {model} rank {rank['rank']}"
            errs = mt_loss_errs(got["losses"], one["losses"])
            assert max(errs) <= MT_LOSS_TOL_REL, (where, errs)
            bad = mt_param_faults(got["leaf_diffs"], mt_split_witness(one))
            assert not bad, (where, "params off the single run's", bad)
            assert got["losses"] == res["dp"][0]["split"][model]["losses"]
        planted = res["dp"][0]["split"][model + "_planted"]
        errs = mt_loss_errs(planted["losses"], one["losses"])
        bad = mt_param_faults(planted["leaf_diffs"], mt_split_witness(one))
        assert max(errs) > MT_LOSS_TOL_REL or bad, \
            (f"the planted fault of {model} passed", errs)
    t0 = res["tp"][0]["serve"]
    for rank in res["tp"]:
        for label, act, _, kv in MT_SERVE_RUNS:
            got, ref = rank["serve"][label], t0[label]
            where = f"mesh train serve {label} rank {rank['rank']}"
            assert got["launches"] == ref["single_launches"], \
                (where, got["launches"], ref["single_launches"])
            assert got["launches"]["packed_matmul"] > 0 and \
                got["launches"]["paged_attention"] > 0, where
            assert got["tokens"] == ref["tokens"], where
            assert 0 < got["peak_host_bytes"] < got["dense_tree_bytes"], \
                where
            cmp = ref["vs_single"]
            if act == 32:
                assert ref["tokens"] == ref["single_tokens"], (where, cmp)
            else:
                assert cmp["finite"] and cmp["err"] <= QUANT_TOL_REL[kv], \
                    (where, cmp)


def mt_split_summary(res) -> dict:
    """The (2, 1) granite and ResNet legs' figures: loss and param errors
    beside the witness's, the planted faults', and step and gradient
    all-reduce times (the last step's: the first pays the lazy starts)."""
    out = {}
    for model, one in res["split_single"].items():
        split = res["dp"][0]["split"]
        got, planted = split[model], split[model + "_planted"]

        def worst(diffs):
            return max(d / max(m, 1e-30) for d, m in diffs.values())
        out[model] = {
            "loss_err_max": max(mt_loss_errs(got["losses"], one["losses"])),
            "witness_loss_err_max": {
                "reversed": max(mt_loss_errs(one["reversed_losses"],
                                             one["losses"])),
                "host": max(mt_loss_errs(one["host_losses"],
                                         one["losses"]))},
            "param_err_max": worst(got["leaf_diffs"]),
            "witness_param_err_max": {
                "reversed": worst(one["reversed_diffs"]),
                "host": worst(one["host_diffs"])},
            # the 5 leaves nearest the check's limit: (leaf, the split's,
            # the reversed witness's, the host witness's distance)
            "worst_leaves": sorted(
                ([k, d / max(m, 1e-30),
                  one["reversed_diffs"][k][0] / max(m, 1e-30),
                  one["host_diffs"][k][0] / max(m, 1e-30)]
                 for k, (d, m) in got["leaf_diffs"].items()),
                key=lambda r: -r[1] / max(MT_WITNESS_X * max(r[2], r[3]),
                                          MT_LEAF_TOL))[:5],
            "host_s": one["host_s"],
            "planted_loss_err_max": max(mt_loss_errs(planted["losses"],
                                                     one["losses"])),
            "planted_param_faults": len(mt_param_faults(
                planted["leaf_diffs"], mt_split_witness(one))),
            "step_ms": got["step_ms"],
            "grad_all_reduce_ms": [c["ms"] for c in got["grad_reduce"]],
            "grad_all_reduce_bytes": [c["bytes"]
                                      for c in got["grad_reduce"]]}
    return out


def mt_loss_errs(got, want):
    """Each step's relative loss error."""
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def mt_rel(got, want):
    """Relative error of each of a value-and-gradient's figures."""
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}


def mesh_train_summary(res) -> dict:
    """The phase's figures for the printout."""
    import statistics
    one, dp, tp = res["single"], res["dp"][0], res["tp"][0]

    def med(xs):
        return statistics.median(xs[1:] or xs) if xs else None
    saves = [s for r in (dp, tp) for s in r["saves"]]
    rank_bytes = {dp["ckpt"]["rank_bytes"], tp["ckpt"]["rank_bytes"]}
    return {
        "phase_s": res["phase_s"], "layers": res["layers"],
        "step_ms_median_after_first": {
            "single": med(one["step_ms"]), "2x1": med(dp["step_ms"]),
            "1x2": med(tp["step_ms"])},
        "grad_all_reduce_ms_a_step": {
            "2x1": med([c["ms"] for c in dp["grad_reduce"]]),
            "1x2": med([c["ms"] for c in tp["grad_reduce"]])},
        "grad_all_reduce_bytes": dp["grad_reduce"][0]["bytes"]
        if dp["grad_reduce"] else None,
        "save_s": [round(s["s"], 3) for s in saves],
        "save_gb_per_s_a_rank": {
            "2x1": dp["ckpt"]["rank_bytes"] / med(
                [s["s"] for s in dp["saves"]]) / 1e9,
            "1x2": tp["ckpt"]["rank_bytes"] / med(
                [s["s"] for s in tp["saves"]]) / 1e9},
        "save_rank_bytes": sorted(rank_bytes),
        "restore_s": {"2x1": [r["s"] for r in dp["restores"]],
                      "1x2": [r["s"] for r in tp["restores"]]},
        "cold_start_s": {k: v["cold_start_s"]
                         for k, v in tp["serve"].items()},
        "serve_decode_ms_per_step": {
            k: {"single": v["single_decode_ms_per_step"],
                "1x2": v["decode_ms_per_step"]}
            for k, v in tp["serve"].items()},
        "loss_err_max": max(
            abs(h["loss"] - w["loss"]) / abs(w["loss"])
            for r in (dp, tp) for s, h in zip(r["steps"], r["history"])
            for w in [dict(zip(one["steps"], one["history"]))[s]]),
        "param_err_max": max(d / max(m, 1e-30)
                             for d, m in tp["leaf_diffs"].values()),
        "witness_param_err_max": max(
            d / max(m, 1e-30)
            for d, m in res["witness"]["leaf_diffs"].values()),
        "params_over_leaf_tol": sorted(
            k for k, (d, m) in tp["leaf_diffs"].items()
            if d > MT_LEAF_TOL * m),
        "split": mt_split_summary(res),
        "uneven_err": mt_rel(dp["uneven"], one["uneven"]),
        "planted_err": mt_rel(dp["planted"], one["uneven"]),
        "compressed_all_reduce": dp["compressed"],
        "transport": "gloo, two ranks on one card (host-staged)"}


def time_packed(m, k, n, bits, wbr=8):
    import torch
    from repro_torch.kernels import packed_matmul
    from repro_torch.kernels.ref import packed_matmul_ref
    from repro_torch.serve.deploy import ServingWeight, serving_compose
    from repro_torch.core.blocking import BlockingSpec

    x, w, s = packed_case(m, k, n, bits, wbr, 128, x_dtype=torch.bfloat16)
    ws = rotating(lambda: packed_case(1, k, n, bits, wbr, 128)[1:],
                  w.nbytes)
    spec = BlockingSpec(wbr, 128)
    dense = rotating(lambda: serving_compose(
        ServingWeight(w, s, (k, n), spec, bits), torch.bfloat16), 2 * k * n)
    it = {"i": 0}

    def nxt(seq):
        it["i"] = (it["i"] + 1) % len(seq)
        return seq[it["i"]]

    ms, dev, host = cuda_times(lambda: packed_matmul(x, *nxt(ws), bits=bits,
                                                     wbr=wbr))
    plain = cuda_ms(lambda: packed_matmul_ref(x, *nxt(ws), bits, wbr),
                    iters=5)
    lib, lib_dev, lib_host = cuda_times(lambda: torch.matmul(x, nxt(dense)))
    nbytes = w.nbytes + s.nbytes + x.nbytes + m * n * 4
    flops = 2.0 * m * k * n
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    return dict(m=m, k=k, n=n, bits=bits, wbr=wbr, ms=ms, device_ms=dev,
                host_ms=host,
                plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                library_host_ms=lib_host, bound_ms=bound, bound_by=by,
                bytes=nbytes, flops=flops)


def time_attention(bits, kv_len_val, t=P + 64, paged=0, kvh=32, dh=96,
                   g=1):
    """One layer's decode read at B=4, ``kvh`` KV heads of width ``dh``
    (phi3's 32 x 96 unless named), ``g`` query heads a KV head (1 unless
    named; SDPA then runs with ``enable_gqa``), every slot filled to
    ``kv_len_val`` of a ``t``-position cache: the contiguous cache's
    identity view (page ``fit_block(min(128, t), t, 1)``), or ``paged``
    positions a page behind a shuffled table.  KV cold (rotated past the
    50 MB L2).  Library: SDPA on the same K/V dequantized to bf16, (B,
    kvh, t, dh), masked to the fill.  Bound: the KV bytes and scales the
    slots fill, q and the output, over HBM."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.kernels.tiling import attention_plan, fit_block
    from repro_torch.models.attention import dequantize_kv

    page = paged or fit_block(min(128, t), t, 1)
    kv_len = torch.full((B,), kv_len_val, dtype=torch.int32, device=DEV)
    seeds = iter(range(100, 1000))

    def make():
        q, pool, table = attention_pool(bits, kvh, t, page,
                                        paged=bool(paged), seed=next(seeds),
                                        dh=dh, g=g)
        kq, vq, ks, vs = pool
        order = table.reshape(-1).long()       # slot-major pages
        kd = dequantize_kv(kq[order].reshape(B, t, kvh, -1),
                           ks[order].reshape(B, t, kvh), torch.bfloat16)
        vd = dequantize_kv(vq[order].reshape(B, t, kvh, -1),
                           vs[order].reshape(B, t, kvh), torch.bfloat16)
        return (q, pool, table), (kd.transpose(1, 2).contiguous(),
                                  vd.transpose(1, 2).contiguous())

    sets = rotating(make, 2 * B * t * kvh * (dh * bits // 8 + 4))
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    def kern():
        q, pool, table = nxt()[0]
        return paged_attention(q, *pool, table, kv_len)

    def plain():
        q, pool, table = nxt()[0]
        return paged_attention_ref(q, *pool, table, kv_len)

    mask = (torch.arange(t, device=DEV) < kv_len_val)[None, None, None]
    qb = sets[0][0][0].reshape(B, kvh * g, 1, dh).to(torch.bfloat16)
    gqa = {"enable_gqa": True} if g > 1 else {}
    ms, dev, host = cuda_times(kern)
    plain_ms = cuda_ms(plain, iters=5 if t > 2048 else 20)
    lib, lib_dev, lib_host = cuda_times(
        lambda: F.scaled_dot_product_attention(qb, *nxt()[1], attn_mask=mask,
                                               **gqa))
    nbytes = B * kv_len_val * kvh * (2 * dh * bits / 8 + 8) \
        + 2 * B * kvh * g * dh * 4 + B * 4
    flops = 4.0 * B * kvh * g * kv_len_val * dh
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    plan = attention_plan(B, kvh, g, dh, page, t // page, bits)
    return dict(bits=bits, b=B, kv=kvh, g=g, dh=dh, t=t, page=page,
                leg="paged" if paged else "contiguous",
                kv_len=kv_len_val, splits=plan.splits, chunk=plan.chunk,
                ms=ms, device_ms=dev, host_ms=host,
                plain_ms=plain_ms, library_ms=lib, library_device_ms=lib_dev,
                library_host_ms=lib_host, bound_ms=bound, bound_by=by,
                bytes=nbytes, flops=flops)


# (kv_len, cache width t): the smoke's decode fill, then longer contexts
ATTN_TIMED = ((P + NEW // 2, P + 64), (1040, 1152), (4096, T_LONG))


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


def time_bitplane(bp, sub, name, m, x_dtype=None):
    """``bitplane_matmul`` on one leaf of a bit-plane tree (the mixed tree,
    or its speculative draft) at M=m, bf16 x unless ``x_dtype``, cycling
    through the layers' views so each call reads its weights cold.
    Library: ``torch.matmul`` on the weight composed to x's dtype.  Bound:
    the bytes ``bitplane_stream_bytes`` bills (live planes, the sign of
    live blocks, mask bits, scales) plus x and the output over HBM, or the
    operations of the live blocks over x's type's peak (bf16 tensor cores,
    f32 outside them), whichever is larger."""
    import torch
    from repro_torch.kernels import bitplane_matmul
    from repro_torch.kernels.ref import bitplane_matmul_ref
    from repro_torch.serve.deploy import (bitplane_serving_compose,
                                          bitplane_stream_bytes)
    leaf = bp["layers"][sub][name]
    views = [leaf.layer(i) for i in range(leaf.planes.shape[0])]
    k, n = leaf.shape[-2:]
    wbr, wbc = leaf.spec.wb_rows, leaf.spec.wb_cols
    dt = x_dtype or torch.bfloat16
    peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
    x = torch.randn((m, k), device=DEV, dtype=dt,
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
    dense = rotating(lambda: bitplane_serving_compose(nxt(views), dt),
                     x.element_size() * k * n)
    lib, lib_dev, lib_host = cuda_times(lambda: torch.matmul(x, nxt(dense)))
    del dense
    stream = sum(bitplane_stream_bytes(v) for v in views) / len(views)
    live = float((leaf.mask.sum(dim=-3) > 0).float().mean())
    nbytes = stream + x.nbytes + m * n * 4
    flops = 2.0 * m * k * n * live
    bound = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak \
        else "operations"
    return dict(leaf=name, m=m, k=k, n=n, x=str(dt), ms=ms, device_ms=dev,
                host_ms=host, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, library_host_ms=lib_host,
                bound_ms=bound, bound_by=by, bytes=nbytes,
                stream_bytes=stream, live_block_share=live, flops=flops)


def time_pact(rows=B * P):
    """``pact_quant`` at (rows, D_MODEL) bf16, 8-bit: one read and one
    write of x bound it; the library call is PyTorch's fake quantizer with
    the same levels (scale b/L, zero point 0, range [-L, L]).  At B*P rows
    x is 3 MB and stays in L2; 16384 rows (100 MB) stream from HBM."""
    import torch
    from repro_torch.kernels import pact_quant
    from repro_torch.kernels.ref import pact_quant_ref
    x = (torch.randn((rows, D_MODEL), device=DEV,
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
    return dict(rows=rows, cols=D_MODEL, dtype="bfloat16", act_bits=8, ms=ms,
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
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        # one rank of the mesh phase, started by mesh_phase
        _, _, rank, port, work, dev, *size = sys.argv
        return mesh_rank(int(rank), int(port), work, dev, tuple(size))
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-train-rank":
        # one rank of the mesh train phase, started by mesh_train_phase
        _, _, rank, port, work, dev, leg, *size = sys.argv
        return mesh_train_rank(int(rank), int(port), work, dev, leg,
                               tuple(size))
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
    print(json.dumps({"train": train_summary(detail)}))
    print(json.dumps({"moe": dict(moe_summary(detail["moe_phase"]),
                                  card=smi)}))
    print(json.dumps({"encdec": dict(encdec_summary(detail["encdec_phase"]),
                                     card=smi)}))
    print(json.dumps({"families": dict(
        families_summary(detail["families_phase"]), card=smi)}))
    print(json.dumps({"cnn": dict(cnn_summary(detail["cnn_phase"]),
                                  card=smi)}))
    print(json.dumps({"train_families": dict(
        train_families_summary(detail["train_families_phase"]), card=smi)}))
    print(json.dumps({"deploy": dict(deploy_summary(detail["deploy_phase"]),
                                     card=smi)}))
    print(json.dumps({"lint": dict(lint_summary(detail), card=smi)}))
    print(json.dumps({"mesh": dict(mesh_summary(detail["mesh_phase"]),
                                   card=smi)}))
    print(json.dumps({"mesh_train": dict(
        mesh_train_summary(detail["mesh_train_phase"]), card=smi)}))
    print(json.dumps({"dryrun": dict(
        dryrun_summary(detail["dryrun_phase"]), card=smi)}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(detail) -> list:
    """The phases; fills ``detail`` and returns the kernels entries."""
    import torch
    t0 = time.perf_counter()
    detail["kernel_phase"] = kernel_phase()
    detail["kernel_phase_s"] = time.perf_counter() - t0
    log(f"kernel phase ok in {detail['kernel_phase_s']:.1f} s")

    from repro_torch.configs import REGISTRY
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    # phi3 at PHI3_DEPTH layers through the time phase and its checks
    depth = contextlib.ExitStack()
    depth.enter_context(phi3_depth())
    detail["phi3_layers"] = PHI3_DEPTH
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
    sched = detail["scheduler_phase"] = scheduler_phase(bp)
    detail["scheduler_phase_s"] = time.perf_counter() - t0
    kp = detail["kernel_phase"]
    kp["paged_attention"].append(sched["captured_tick"])
    for drive in ("main", "quantizers_off", "speculative",
                  "speculative_plain"):
        for row in sched[drive]["matmul_calls"]:
            kp[row["kernel"]].append(dict(row, drive=drive))
    log(f"scheduler phase ran in {detail['scheduler_phase_s']:.1f} s")
    save_detail(detail)

    detail["lint_phase"] = lint_phase(deployed, bp)
    log(f"lint phase (phi3) ran in {detail['lint_phase']['phase_s']:.1f} s")
    save_detail(detail)

    t0 = time.perf_counter()
    pm = [time_packed(m, k, n, bits) for bits in (8, 4) for m in (B, B * P)
          for k, n, _ in LAYER_SHAPES]
    # the scheduler drive's decode and chunk M
    pm += [time_packed(m, k, n, 8) for m in (SCHED_SLOTS, SCHED_CHUNK)
           for k, n, _ in LAYER_SHAPES]
    pa = [time_attention(bits, kv_len, t) for kv_len, t in ATTN_TIMED
          for bits in (8, 4)]
    pa.append(time_attention(8, 4096, T_LONG, paged=PAGE))
    bm = [time_bitplane(bp, sub, name, m) for m in (B, 4 * B, B * 5, B * P)
          for sub, name in LAYER_LEAVES]
    # the scheduler's speculative drive, f32 x: a draft step (the top
    # planes' masks) at M = n_slots and a verify at n_slots*(gamma+1)
    from repro_torch.serve.autotune.speculative import make_draft_params
    k_spec, gamma = SCHED_SPEC
    draft = make_draft_params(bp, k_spec)
    bm_sched = [time_bitplane(draft, sub, name, SCHED_SLOTS, torch.float32)
                for sub, name in LAYER_LEAVES]
    bm_sched += [time_bitplane(bp, sub, name, SCHED_SLOTS * (gamma + 1),
                               torch.float32) for sub, name in LAYER_LEAVES]
    for r in bm_sched:
        r["tree"] = f"draft k={k_spec}" if r["m"] == SCHED_SLOTS else "full"
    del draft
    pq = time_pact()
    pq_hbm = time_pact(16384)
    paths = time_path(deployed, tok)
    bp_paths = time_bitplane_path(bp, tok)
    detail["time_phase"] = {"packed_matmul": pm, "paged_attention": pa,
                            "bitplane_matmul": bm,
                            "bitplane_matmul_scheduler": bm_sched,
                            "pact_quant": [pq, pq_hbm],
                            "path": paths, "bitplane_path": bp_paths}
    detail["time_phase_s"] = time.perf_counter() - t0
    detail["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for p in paths + bp_paths:
        log(f"path int{p['bits']} kv{p['kv']} {p['backend']}/"
            f"{p['attn_backend']} {p['leg']}: prefill "
            f"{p['prefill_ms']:.2f} ms, decode "
            f"{p['decode_ms_per_step']:.3f} ms/step, "
            f"{p['decode_tokens_per_s']:.1f} tok/s")
    dec = next(p for p in paths if (p["bits"], p["kv"], p["backend"],
                                    p["leg"]) == (8, 8, "kernel",
                                                  "contiguous"))
    detail["decode_vs_baseline"] = {"ms_per_step": dec["decode_ms_per_step"],
                                    "layers": PHI3_DEPTH,
                                    "baseline_ms": BASELINE_DECODE_MS,
                                    "baseline_layers": 32}
    log(f"phi3 int8 kernel decode {dec['decode_ms_per_step']:.2f} ms/step "
        f"at {PHI3_DEPTH} layers (the run before the kernel boundary, 32 "
        f"layers: {BASELINE_DECODE_MS} ms/step)")

    # one kernels entry per kernel, timed at the shapes of the run its
    # launches come from: this slice's main path, the counted scheduler
    # drive (bf16, int8 weights and KV): a decode tick's layer (7
    # projections at M = n_slots, the captured tick's attention read); its
    # speculative drive for bitplane_matmul (f32, quantizers off): a draft
    # step's layer at M = n_slots.  pact_quant is on no model path.
    per_layer = {(k, n): c for k, n, c in LAYER_SHAPES}
    dec8 = [r for r in pm if r["bits"] == 8 and r["m"] == SCHED_SLOTS]
    dec_bp = [r for r in bm_sched if r["m"] == SCHED_SLOTS]

    def layer_sum(key):
        return sum(r[key] * per_layer[(r["k"], r["n"])] for r in dec8)

    def bp_sum(key):
        return sum(r[key] for r in dec_bp)

    a8 = sched["captured_tick"]
    launches = sched["main"]["launches"]
    bp_launches = sched["speculative"]["launches"]
    sched_run = "scheduler drive (chip_smoke.scheduler_phase)"
    spec_run = "scheduler speculative drive (chip_smoke.scheduler_phase)"
    errs = detail["kernel_phase"]
    kernels = [
        {"name": "packed_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/packed_matmul.cu",
         "replaces": "src/repro/kernels/packed_matmul.py:61",
         "launches": launches["packed_matmul"], "launches_run": sched_run,
         "max_abs_err": max(c["err"] for c in errs["packed_matmul"]),
         "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
         "bound_ms": layer_sum("bound_ms"), "bound_by": "bytes",
         "library_ms": layer_sum("library_ms"),
         "device_ms": layer_sum("device_ms"),
         "library_device_ms": layer_sum("library_device_ms"),
         "workload": f"a scheduler decode tick's layer: 7 projections, "
                     f"int8, M={SCHED_SLOTS}, bf16 x"},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:117",
         "launches": launches["paged_attention"],
         "launches_run": sched_run,
         "max_abs_err": max(c["err"] for c in errs["paged_attention"]),
         "ms": a8["ms"], "plain_ms": a8["plain_ms"],
         "bound_ms": a8["bound_ms"], "bound_by": a8["bound_by"],
         "library_ms": a8["library_ms"],
         "device_ms": a8["device_ms"],
         "library_device_ms": a8["library_device_ms"],
         "workload": f"the captured scheduler tick's layer-0 decode read, "
                     f"int8 KV, B={a8['b']}, KV={a8['kv']}, dh={a8['dh']}, "
                     f"{a8['nb']} pages of {a8['page']}, kv_len "
                     f"{min(a8['kv_len'])}-{max(a8['kv_len'])}, "
                     f"{a8['free_rows']} free rows"},
        {"name": "bitplane_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
         "replaces": "src/repro/kernels/bitplane_matmul.py:65",
         "launches": bp_launches["bitplane_matmul"],
         "launches_run": spec_run,
         "max_abs_err": max(c["err"] for c in errs["bitplane_matmul"]),
         "ms": bp_sum("ms"), "plain_ms": bp_sum("plain_ms"),
         "bound_ms": bp_sum("bound_ms"),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in dec_bp) else "operations",
         "library_ms": bp_sum("library_ms"),
         "device_ms": bp_sum("device_ms"),
         "library_device_ms": bp_sum("library_device_ms"),
         "workload": f"a scheduler draft step's layer: 7 projections, mixed "
                     f"bit-plane tree's top-{SCHED_SPEC[0]} plane masks, "
                     f"M={SCHED_SLOTS}, f32 x"},
        {"name": "pact_quant", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pact_quant.cu",
         "replaces": "src/repro/kernels/pact_kernel.py:27",
         "launches": launches["pact_quant"], "launches_run": sched_run,
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

    depth.close()
    del deployed, bp, tok
    torch.cuda.empty_cache()
    detail["moe_phase"] = moe_phase()
    log(f"MoE phase ran in {detail['moe_phase']['phase_s']:.1f} s")
    save_detail(detail)
    check_moe(detail["moe_phase"])

    detail["encdec_phase"] = encdec_phase()
    log(f"enc-dec phase ran in {detail['encdec_phase']['phase_s']:.1f} s")
    save_detail(detail)
    check_encdec(detail["encdec_phase"])

    detail["families_phase"] = fp = families_phase()
    log(f"families phase ran in {fp['phase_s']:.1f} s")
    save_detail(detail)
    check_families(fp)
    lp = detail["lint_phase"]
    lp["scheduler_drive"] = sched["main"]["lint"]
    lp["families"] = [detail["moe_phase"]["lint"],
                      detail["encdec_phase"]["lint"]] + [
        fam["lint"] for fam in fp["families"]]
    lp["all_s"] = lp["phase_s"] + lp["scheduler_drive"]["s"] + sum(
        r["s"] for r in lp["families"])
    log(f"lint: phi3 phase {lp['phase_s']:.1f} s, the scheduler drive's "
        f"{lp['scheduler_drive']['s']:.2f} s, the families' "
        f"{sum(r['s'] for r in lp['families']):.2f} s; all "
        f"{lp['all_s']:.1f} s")
    for k in kernels:
        k["families_launches"] = {
            fam["arch"]: {
                **{f"one_shot_{r['backend']}_{r['dtype']}":
                   r["launches"][k["name"]] for r in fam["runs"]},
                "scheduler": fam["scheduler"]["main"]["launches"][
                    k["name"]]}
            for fam in fp["families"]}
        errs = [c["err"] for fam in fp["families"] for r in fam["runs"]
                for c in r["matmul_calls"] if c["kernel"] == k["name"]]
        errs += [c["err"] for fam in fp["families"]
                 for d in ("main", "quantizers_off")
                 for c in fam["scheduler"][d]["matmul_calls"]
                 if c["kernel"] == k["name"]]
        if k["name"] == "paged_attention":
            errs += [r["attention"]["err"] for fam in fp["families"]
                     for r in fam["runs"] if "attention" in r]
            errs += [fam["scheduler"]["captured_tick"]["err"]
                     for fam in fp["families"]
                     if "captured_tick" in fam["scheduler"]]
        k["max_abs_err"] = max([k["max_abs_err"]] + errs)

    detail["cnn_phase"] = cnn = cnn_phase()
    log(f"CNN phase ran in {cnn['phase_s']:.1f} s")
    save_detail(detail)
    check_cnn(cnn)
    for k in kernels:
        if k["name"] in ("packed_matmul", "bitplane_matmul"):
            k["cnn_calls"] = rows = cnn_kernel_rows(cnn, k["name"])
            k["cnn_launches_a_forward"] = {
                f"{m['model']}{m['depth']}": leg["launches"][k["name"]]
                for m in cnn["models"] for leg in m["legs"]
                if leg["act_bits"] == 32 and leg["launches"][k["name"]]
                and leg["deploy"] != "int4"}
            k["max_abs_err"] = max([k["max_abs_err"]] +
                                   [r["err"] for r in rows])

    t0 = time.perf_counter()
    detail["train_phase"] = train_phase()
    detail["train_phase_s"] = time.perf_counter() - t0
    log(f"train phase ran in {detail['train_phase_s']:.1f} s")
    save_detail(detail)

    detail["train_families_phase"] = tf = train_families_phase()
    log(f"train families phase ran in {tf['phase_s']:.1f} s")
    save_detail(detail)
    for k in kernels:
        k["train_families_launches"] = {
            r["arch"]: {leg: r[leg]["launches"][k["name"]]
                        for leg in ("serve", "bitplane_serve") if leg in r}
            for r in tf["families"]}

    detail["deploy_phase"] = dp = deploy_phase()
    log(f"deploy phase ran in {dp['phase_s']:.1f} s")
    save_detail(detail)
    check_deploy(dp)
    for k in kernels:
        k["deploy_launches"] = dp["launches"][k["name"]]
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["err"] for r in dp["matmul_calls"] if r["kernel"] == k["name"]])

    detail["mesh_phase"] = mp = mesh_phase()
    log(f"mesh phase ran in {mp['phase_s']:.1f} s")
    save_detail(detail)
    check_mesh(mp)
    for k in kernels:
        k["mesh_launches_a_rank"] = {
            f"{row['label']} {key}": out["launches"][k["name"]]
            for row in mp["ranks"][0]["legs"]
            for key, out in row["runs"].items()}
    save_detail(detail)

    detail["mesh_train_phase"] = mt = mesh_train_phase()
    log(f"mesh train phase ran in {mt['phase_s']:.1f} s")
    save_detail(detail)
    check_mesh_train(mt)
    for k in kernels:
        k["mesh_train_launches_a_rank"] = {
            f"{label} 1x2": rec["launches"][k["name"]]
            for label, rec in mt["tp"][0]["serve"].items()}
    save_detail(detail)

    detail["dryrun_phase"] = dr = dryrun_phase(detail)
    m, r = dr["memory"], dr["rate"]
    log(f"dry run phase ran in {dr['phase_s']:.1f} s: train step predicted "
        f"argument {m['argument_bytes'] / 1e9:.2f} GB, peak "
        f"{m['peak_bytes'] / 1e9:.2f} GB against the measured "
        f"{m['measured_peak_bytes'] / 1e9:.2f} GB (ratio "
        f"{m['peak_ratio']:.3f}); achieved {r['achieved_tflops']:.2f} "
        f"TFLOP/s, {r['peak_share']:.4f} of the peak; decode collectives "
        f"{dr['collectives']['counts']}")
    save_detail(detail)
    check_dryrun(dr)
    return kernels


# ---------------------------------------------------------------------------
# dry run phase: the meta-device dry run (``launch.dryrun``) against this
# run's measurements
# ---------------------------------------------------------------------------

# The predicted peak (the train state the rank holds and the step's live
# new storages, ``per_device.peak_bytes``) against the train phase's
# ``torch.cuda.max_memory_allocated``: within this ratio
DRY_PEAK_RATIO = (0.5, 1.5)


def dryrun_phase(detail, size=("--no-tiny",)):
    """The dry run's predictions against what this run measured, each cell
    run on ``meta`` on one rank of a ``RecordingMesh``:

    * memory: the train phase's phi3 step (the launcher's config, 32
      layers, ``TRAIN_BATCH`` x ``TRAIN_SEQ``, bf16, a 1-rank mesh, one
      microbatch): its argument bytes and peak beside the train phase's
      measured peak;
    * collectives: the mesh phase's phi3 (1, 2) decode step (int8 deploy,
      ``MESH_DEPTH`` layers, f32) recorded, against the live ranks' log
      (:func:`mesh_decode_collectives`);
    * achieved rate: the predicted FLOPs of a train step over the profiled
      step's device time, against ``cost_analysis.PEAK_FLOPS``."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist.cost_analysis import PEAK_FLOPS
    from repro_torch.dist.parallel import RecordingMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as tl
    t_phase = time.perf_counter()
    cfg = tl.config(tl.build_parser().parse_args(train_argv(size)))
    rec = dryrun.lower_cell(cfg, ShapeCell("train_smoke", TRAIN_SEQ,
                                           TRAIN_BATCH, "train"),
                            RecordingMesh({"data": 1, "model": 1}),
                            microbatches=1)
    pd = rec["per_device"]
    tp = detail["train_phase"]
    measured = tp["fake"]["peak_mem_gb"] * 1e9
    out = {"memory": {
        "layers": cfg.n_layers, "argument_bytes": pd["argument_bytes"],
        "peak_bytes": pd["peak_bytes"], "temp_bytes": pd["temp_bytes"],
        "measured_peak_bytes": measured,
        "peak_ratio": pd["peak_bytes"] / measured,
        "meta_run_s": rec["lower_s"]}}
    prof = tp["fake_profile"]
    achieved = pd["flops"] / (prof["device_ms"] / 1e3)
    out["rate"] = {"flops": pd["flops"], "device_ms": prof["device_ms"],
                   "wall_ms": prof["wall_ms"],
                   "achieved_tflops": achieved / 1e12,
                   "peak_flops": PEAK_FLOPS,
                   "peak_share": achieved / PEAK_FLOPS}
    live = [r["decode_collectives"] for r in detail["mesh_phase"]["ranks"]]
    dcfg = served_config(ARCH, 32, "float32", size, n_layers=MESH_DEPTH)
    drec = dryrun.lower_cell(
        dcfg, ShapeCell("decode_mesh", live[0]["s"], live[0]["b"],
                        "decode"),
        RecordingMesh({"data": 1, "model": 2}), deploy_bits=8,
        include_text=True)
    out["collectives"] = {"predicted": drec["collective_log"],
                          "live": [r["log"] for r in live],
                          "counts": drec["collectives"]["counts"],
                          "bytes": drec["collectives"]["bytes"],
                          "meta_run_s": drec["lower_s"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def check_dryrun(res):
    """The predicted argument bytes at most the measured peak, the
    predicted peak within ``DRY_PEAK_RATIO`` of it; the recorded decode
    collectives the live ranks', op for op."""
    m = res["memory"]
    assert m["argument_bytes"] <= m["measured_peak_bytes"], m
    lo, hi = DRY_PEAK_RATIO
    assert lo <= m["peak_ratio"] <= hi, m
    c = res["collectives"]
    assert c["predicted"], c
    for r, log in enumerate(c["live"]):
        assert log == c["predicted"], (f"rank {r}'s decode collectives",
                                       log, c["predicted"])


def dryrun_summary(res) -> dict:
    return {"phase_s": res["phase_s"], "memory": res["memory"],
            "rate": res["rate"],
            "collectives": {k: res["collectives"][k] for k in
                            ("counts", "bytes", "meta_run_s")},
            "collectives_equal_live": True}


def train_summary(detail) -> dict:
    """The train phase's figures for the printout, beside the card."""
    tp = detail["train_phase"]
    f, b = tp["fake"], tp["bitplane"]
    return {"card": detail["card"], "phase_s": detail["train_phase_s"],
            "fake_full_depth": {
                "step_ms_median_after_first": f["step_ms_median_after_first"],
                "tokens_per_s": f["tokens_per_s"],
                "maintenance_ms": f["maintenance_ms"],
                "peak_mem_gb": f["peak_mem_gb"],
                "deploy_s": tp["fake_serve"]["deploy_s"],
                "avg_bitwidth": f["avg_bitwidth"][-1],
                "compression_x": f["compression_x"],
                "profiled_step_idle_share": tp["fake_profile"]["idle_share"],
                "serve_err": tp["fake_serve"]["kernel_vs_plain"]["err"]},
            "bitplane_depth_cut": {
                "step_ms_median_after_first": b["step_ms_median_after_first"],
                "maintenance_ms": b["maintenance_ms"],
                "peak_mem_gb": b["peak_mem_gb"],
                "deploy_s": tp["bitplane_serve"]["deploy_s"],
                "serve_err":
                    tp["bitplane_serve"]["kernel_vs_plain"]["err"]},
            "card_vs_host": {k: tp["card_vs_host"][k] for k in (
                "loss_err", "grad_err_max", "grad_witness_max",
                "grad_tol")}}


def lint_summary(detail) -> dict:
    """The lint's figures for the printout: each linted engine's seconds
    and rules, the faults' and launchers' seconds and exit codes, and the
    phase's seconds."""
    lp = detail["lint_phase"]

    def short(r):
        return {"s": round(r["s"], 3), "ok": r["ok"], "rules": r["rules"]}
    return {"phase_s": lp["phase_s"], "all_s": lp.get("all_s"),
            "engines": {r["label"]: short(r) for r in
                        lp["cases"] + lp.get("families", [])
                        + ([lp["scheduler_drive"]]
                           if "scheduler_drive" in lp else [])},
            "faults": {k: {"s": round(r["s"], 3), "ok": r["ok"],
                           "rules": [x for x in r["rules"]
                                     if x.startswith("error")]}
                       for k, r in lp["faults"].items()},
            "launcher": {"s": round(lp["launcher"]["s"], 3),
                         "rc": lp["launcher"]["rc"]},
            "decode_vs_baseline": detail.get("decode_vs_baseline")}


def save_detail(detail):
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(
        json.dumps(detail, indent=1, default=str))


if __name__ == "__main__":
    sys.exit(main())
