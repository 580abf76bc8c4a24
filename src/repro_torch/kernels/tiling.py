"""Tiling geometry shared by the kernel wrappers: pad-and-trim helpers (port
of the framework-neutral part of ``repro.kernels.pallas_utils``) and the
launch plan of the two weight-matmul kernels (``csrc/wmm_common.cuh``)."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

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
