"""Tiling geometry shared by the kernel wrappers: pad-and-trim helpers (port
of the framework-neutral part of ``repro.kernels.pallas_utils``), the
launch plan of the two weight-matmul kernels (``csrc/wmm_common.cuh``) and
that of split-KV decode attention (``csrc/paged_attention.cu``)."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# The weight-matmul kernels' launch geometry (csrc/wmm_common.cuh):
# M <= STREAM_MAX_M streams the weight bytes in row tiles of STREAM_ROWS
# (decode, the speculative draft, verify of up to 3 drafts at B = 4);
# larger M runs tensor-core tiles (verify, prefill).  Both measured on an
# H100 (scripts/matmul_probe.py switch; PERF.md).
STREAM_MAX_M = 16
STREAM_ROWS = 4
N_SMS = 132              # H100 SXM streaming multiprocessors
BLOCK_N = 128            # output columns of a block (kBN)
BLOCK_K = 32             # K rows of a tensor-regime tile (kBK)
X_STAGE = 8192           # f32 words of the stream regime's x stage (kXStage)


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def fit_block(pref: int, total: int, multiple: int) -> int:
    """Largest block <= pref that divides total and is a multiple of
    ``multiple`` (``total`` must itself be a multiple of ``multiple``)."""
    best = multiple
    d = multiple
    while d <= min(pref, total):
        if total % d == 0:
            best = d
        d += multiple
    return best


def pad_dim(a: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad ``a`` along ``axis`` up to length ``target`` (no-op if
    already there)."""
    axis = axis % a.ndim
    cur = a.shape[axis]
    if cur == target:
        return a
    pad = [0, 0] * (a.ndim - axis)
    pad[-1] = target - cur
    return F.pad(a, pad)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """Launch geometry of one weight-matmul call.

    ``regime``: "stream" (``rows`` = STREAM_ROWS) or "tensor" (``rows``
    is the block's BM, 32 or 128); either takes ``tiles_m`` row tiles of
    ``rows`` rows.  K is cut into ``ksplit``
    slices of ``kchunk`` rows (the last one shorter); the grid is
    ``tiles_n`` x ``tiles_m`` x ``ksplit`` blocks."""
    regime: str
    rows: int
    ksplit: int
    kchunk: int
    tiles_m: int
    tiles_n: int

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.ksplit

    def k_ranges(self, kend: int) -> List[Tuple[int, int]]:
        return [(s * self.kchunk, min(kend, (s + 1) * self.kchunk))
                for s in range(self.ksplit)]


@functools.lru_cache(maxsize=4096)
def matmul_plan(m: int, kend: int, n: int, *, unit: int, wbr: int
                ) -> MatmulPlan:
    """The plan of ``packed_matmul`` / ``bitplane_matmul`` for x (m, kend)
    and n output columns.  ``unit``: K rows a wire-format unit holds (1
    int8 row, 2 for an int4 nibble pair, 8 for a bit-plane byte row).
    M <= STREAM_MAX_M streams the weight bytes, larger M runs tensor-core
    tiles; cached, since every call of a decode step asks again."""
    return _plan("stream" if m <= STREAM_MAX_M else "tensor", m, kend, n,
                 unit, wbr)


def _plan(regime: str, m: int, kend: int, n: int, unit: int, wbr: int
          ) -> MatmulPlan:
    """The plan of ``regime`` (either may run any M).

    K slices start at multiples of lcm(unit, wbr) (stream) or
    lcm(BLOCK_K, unit, wbr) (tensor), so no WB row, nibble pair or byte
    row is cut, and no slice is empty.  Stream plans launch at least
    2 * N_SMS blocks (the bytes need many loads in flight), as few more as
    the alignment allows (a block past the resident wave waits for a whole
    block time, so those blocks get a short last slice), and fit the x
    stage; tensor plans at most 2 * N_SMS (a split costs a round trip of
    partial tiles through L2)."""
    if regime == "stream":
        rows = STREAM_ROWS
        align = math.lcm(unit, wbr)
        cap = X_STAGE // rows
    else:
        rows = 32 if m <= 32 else 128
        align = math.lcm(BLOCK_K, unit, wbr)
        cap = None
    tiles_m = -(-m // rows)
    tiles_n = -(-n // BLOCK_N)
    tiles = tiles_m * tiles_n
    want = max(1, -(-2 * N_SMS // tiles) if regime == "stream"
               else 2 * N_SMS // tiles)
    # ``want`` slices where the alignment allows; a stream plan rounds the
    # other way if it must, never to fewer than ``want`` slices
    kchunk = max(align, round_up(-(-kend // want), align))
    if regime == "stream" and -(-kend // kchunk) < want:
        kchunk = max(align, kend // want // align * align)
    if cap is not None:
        kchunk = min(kchunk, max(align, cap // align * align))
    ksplit = max(1, -(-kend // kchunk))
    if regime == "stream" and ksplit > 1 and tiles * ksplit > 2 * N_SMS:
        # the blocks past the resident wave are the last slice's: make it
        # a quarter slice, so that the wave they form is short
        longer = kend * 4 // (4 * ksplit - 3) // align * align
        if (cap is None or longer <= cap) and longer > kchunk \
                and -(-kend // longer) == ksplit:
            kchunk = longer
    return MatmulPlan(regime, rows, ksplit, kchunk, tiles_m, tiles_n)


# The split-KV attention kernel's geometry (csrc/paged_attention.cu)
ATTN_WARPS = 8           # warps of a CTA (kWarps)
ATTN_MAX_G = 8           # query heads per KV head (kMaxG)
ATTN_MAX_DH = 256        # (kMaxDh)
ATTN_MAX_HEADS = 4       # KV heads a CTA (kMaxHeads)
ATTN_MAX_SPLITS = 32     # splits of one (slot, head group) (kMaxSplits)
ATTN_STAGES = 2          # ring depth (kStages)
ATTN_WARP_POSITIONS = (32, 16, 8, 4)  # a warp's positions a stage, largest first
ATTN_RING_BUDGET = 108 << 10  # bytes the ring may take (two CTAs an SM)
ATTN_SHORT = 1024        # capacities walked unsplit, one CTA a KV head
ATTN_MIN_SPLIT = 16      # positions a split covers at the least
MAX_SMEM = 232448        # H100: dynamic shared memory a block may opt in to


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """Launch geometry of one ``paged_attention`` call: each slot's table
    capacity ``nb * page`` is cut into ``splits`` ranges of ``split_len``
    positions (split s covers [s * split_len, min((s + 1) * split_len,
    nb * page)), the last one possibly shorter or empty); a CTA takes
    ``heads`` neighbouring KV heads of one slot and split, and streams the
    split in sub-chunks of ``chunk`` positions.  ``n_tab`` table entries
    and ``smem`` bytes of shared memory a CTA; the grid is ``splits`` x
    KV / ``heads`` x B CTAs."""
    splits: int
    split_len: int
    heads: int
    chunk: int
    n_tab: int
    smem: int

    def ranges(self, capacity: int) -> List[Tuple[int, int]]:
        return [(min(capacity, s * self.split_len),
                 min(capacity, (s + 1) * self.split_len))
                for s in range(self.splits)]


def _attention_rows(dh: int, bits: int, heads: int) -> Tuple[int, int]:
    """(16-byte units of a head's row, bytes a position takes in a stage:
    an odd count of units)."""
    units = -(-(dh * bits // 8) // 16)
    pos_units = heads * units
    return units, (pos_units + (1 if pos_units % 2 == 0 else 0)) * 16


def attention_layout(g: int, dh: int, bits: int, heads: int, chunk: int,
                     n_tab: int, *, stages: int = ATTN_STAGES,
                     warps: int = ATTN_WARPS) -> int:
    """Shared-memory bytes of a CTA (``layout`` in the CUDA source, which
    checks the plan's figure against its own): the ring of K/V rows and
    scales, which the final reduction over warps and the last CTA's split
    weights reuse; the queries padded to whole units; each warp's p buffer
    (three int8 parts a position and query head where P.V runs on
    integers: int8 / int4 pools, G <= 2); the CTA's acc; stats; the
    split's table entries."""
    units, kpitch = _attention_rows(dh, bits, heads)
    qp = units * (128 // bits)
    ndg = -(-dh // (8 if bits == 4 else 4))
    ng = 32 // ndg if ndg <= 32 else 1
    pw = chunk * heads // warps
    ring = stages * (2 * chunk * kpitch + 2 * chunk * heads * 4)
    red = warps * ng * g * dh * 4
    weights = ATTN_MAX_HEADS * ATTN_MAX_G * ATTN_MAX_SPLITS * 4
    int_pv = bits in (8, 4) and g <= 2
    pbuf = 3 * g * pw if int_pv else pw * 8 * 4
    total = round_up(max(ring, red, weights), 16) + heads * g * qp * 4 \
        + warps * round_up(pbuf, 16) + round_up(heads * g * dh * 4, 16) \
        + (2 * warps * ATTN_MAX_G + ATTN_MAX_HEADS * ATTN_MAX_G * 9) * 4
    return total + n_tab * 4


@functools.lru_cache(maxsize=4096)
def attention_plan(b: int, kvh: int, g: int, dh: int, page: int, nb: int,
                   bits: int, *, splits: Optional[int] = None,
                   chunk: Optional[int] = None, heads: Optional[int] = None,
                   stages: int = ATTN_STAGES,
                   warps: int = ATTN_WARPS) -> AttentionPlan:
    """The plan of ``paged_attention`` from host-known shapes (never from
    ``kv_len``, which lives on the card: reading it would synchronize every
    layer).  Two regimes, by the table capacity nb * page:

    * short (<= ATTN_SHORT positions: decode at the smoke's fill), bound by
      latency: one CTA a KV head (its 8 warps share each sub-chunk), no
      split (no combine), and the longest sub-chunk that fits the card, so
      the walk takes the fewest steps;
    * long, bound by the bytes and the math: ``heads`` the largest of 4,
      2, 1 that divides KV and fits (a position's rows of the group are
      one contiguous run in the pool); splits double from 1 while twice as
      many CTAs, B * KV / heads * splits * 2, still fit one wave of two
      CTAs an SM (2 * N_SMS), up to ATTN_MAX_SPLITS, each split keeping at
      least ATTN_MIN_SPLIT positions; each warp takes 32, 16, 8 or 4
      positions of a sub-chunk (chunk = that * 8 / heads), the most whose
      ring fits ATTN_RING_BUDGET.

    A sub-chunk is never longer than the split needs.  ``splits``,
    ``chunk`` and ``heads`` force a choice, ``stages`` and ``warps`` size
    it for a kernel built with another ``PA_STAGES`` / ``PA_WARPS`` (the
    probe's sweep and variants); raises ValueError beyond the kernel's
    limits."""
    if not (1 <= g <= ATTN_MAX_G and 1 <= dh <= ATTN_MAX_DH):
        raise ValueError(f"paged_attention takes G <= {ATTN_MAX_G} and "
                         f"dh <= {ATTN_MAX_DH}; got G={g} dh={dh}")
    if bits not in (8, 4, 16, 32) or (bits == 4 and dh % 2):
        raise ValueError(f"pool of {bits} bits at dh={dh}")
    if heads is not None and (heads not in (1, 2, 4) or kvh % heads):
        raise ValueError(f"heads must be 1, 2 or 4 and divide KV={kvh}, "
                         f"got {heads}")
    short = nb * page <= ATTN_SHORT and heads is None and splits is None
    if short:
        splits, budget = 1, MAX_SMEM - (16 << 10)
        candidates = (1,)
    else:
        budget = ATTN_RING_BUDGET
        candidates = (heads,) if heads else (4, 2, 1)
    plan = None
    for h in candidates:
        if kvh % h == 0:
            plan = _attention_plan(b, kvh, g, dh, page, nb, bits, h, splits,
                                   chunk, stages, budget, warps)
            if plan.smem <= MAX_SMEM:
                return plan
    raise ValueError(f"paged_attention needs {plan.smem} bytes of shared "
                     f"memory a CTA (G={g} dh={dh} bits={bits} "
                     f"heads={plan.heads} chunk={plan.chunk}, {plan.n_tab} "
                     f"table entries a split); the card has {MAX_SMEM}")


def _attention_plan(b, kvh, g, dh, page, nb, bits, heads, splits, chunk,
                    stages, budget, warps) -> AttentionPlan:
    cap = nb * page
    if splits is None:
        splits = 1
        while (splits < ATTN_MAX_SPLITS
               and b * (kvh // heads) * splits * 2 <= 2 * N_SMS
               and cap >= 2 * splits * ATTN_MIN_SPLIT):
            splits *= 2
    if not 1 <= splits <= ATTN_MAX_SPLITS:
        raise ValueError(f"splits must be 1 to {ATTN_MAX_SPLITS}, got "
                         f"{splits}")
    split_len = max(1, -(-cap // splits))
    wph = warps // heads
    if chunk is None:
        _, kpitch = _attention_rows(dh, bits, heads)
        fits = [pw for pw in ATTN_WARP_POSITIONS
                if stages * (2 * pw * wph * (kpitch + heads * 4)) <= budget]
        pw = fits[0] if fits else ATTN_WARP_POSITIONS[-1]
        while pw > ATTN_WARP_POSITIONS[-1] and pw // 2 * wph >= split_len:
            pw //= 2
        chunk = pw * wph
    if chunk % wph or chunk // wph not in ATTN_WARP_POSITIONS:
        raise ValueError(f"chunk must be 4, 8, 16 or 32 positions a warp "
                         f"times {wph} warps a head, got {chunk}")
    n_tab = -(-split_len // page) + 1
    smem = attention_layout(g, dh, bits, heads, chunk, n_tab, stages=stages,
                            warps=warps)
    return AttentionPlan(splits, split_len, heads, chunk, n_tab, smem)


_ATTN_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def attention_scratch(device: torch.device, plan: AttentionPlan, b: int,
                      kvh: int, g: int, dh: int) -> Tuple[int, int]:
    """Data pointers of ``paged_attention``'s split workspace (f32, each
    CTA's m, l and acc: >= B * KV * splits * G * (dh + 2)) and its arrival
    counters (int32 zeros, one a (slot, head group), which the kernel leaves
    at zero), cached per device and grown on demand (an outgrown buffer is
    kept, never freed: cached launch arguments point at it); (0, 0) when
    the capacity is not split."""
    if plan.splits == 1:
        return 0, 0
    need_ws = b * kvh * plan.splits * g * (dh + 2)
    need_cnt = b * kvh // plan.heads
    ws, cnt = _ATTN_SCRATCH.get(device, (None, None))
    if ws is None or ws.numel() < need_ws:
        _RETIRED.extend([ws] if ws is not None else [])
        ws = torch.empty(need_ws, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < need_cnt:
        _RETIRED.extend([cnt] if cnt is not None else [])
        cnt = torch.zeros(need_cnt, dtype=torch.int32, device=device)
    _ATTN_SCRATCH[device] = (ws, cnt)
    return ws.data_ptr(), cnt.data_ptr()


_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
# outgrown scratch, kept: the wrappers' cached launch arguments point at it
_RETIRED: List[torch.Tensor] = []


def splitk_scratch(device: torch.device, plan: MatmulPlan, m: int, n: int
                   ) -> Tuple[int, int]:
    """Data pointers of the split-K workspace (f32, >= ksplit * m * n) and
    the per-tile arrival counters (int32 zeros, which the kernels leave at
    zero), cached per device and grown on demand (an outgrown buffer is
    kept, never freed); (0, 0) when K is not split."""
    if plan.ksplit == 1:
        return 0, 0
    need_ws = plan.ksplit * m * n
    need_cnt = plan.tiles_m * plan.tiles_n
    ws, cnt = _SCRATCH.get(device, (None, None))
    if ws is None or ws.numel() < need_ws:
        _RETIRED.extend([ws] if ws is not None else [])
        ws = torch.empty(need_ws, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < need_cnt:
        _RETIRED.extend([cnt] if cnt is not None else [])
        cnt = torch.zeros(need_cnt, dtype=torch.int32, device=device)
    _SCRATCH[device] = (ws, cnt)
    return ws.data_ptr(), cnt.data_ptr()
