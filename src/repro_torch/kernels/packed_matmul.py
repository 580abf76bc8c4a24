"""Packed-integer dequant matmul: the wrapper of the CUDA kernel
``csrc/packed_matmul.cu`` (the port of the TPU kernel
``repro.kernels.packed_matmul``) and its plain PyTorch version.

Geometry comes from the per-WB scale grid: K = scale.shape[0] * wbr and
N = scale.shape[1] * wbc.  ``x`` may have fewer than K columns (the true
fan-in; the missing ones are zero), and int4 with an odd block-padded K
carries one zero nibble row.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.packed_matmul_ref`); a CUDA tensor launches
the kernel or raises.  The launch geometry (byte-streaming split-K at
M <= 16, tensor-core tiles above) is :func:`repro_torch.kernels.tiling.
matmul_plan`'s.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .boundary import RECORDERS
from .build import load, stream_ptr
from .ref import packed_matmul_ref
from .tiling import matmul_plan, splitk_scratch


class _Args(ctypes.Structure):
    """The launch's fixed geometry (``PackedArgs`` in the CUDA source):
    built once for each call shape, so a call converts six arguments."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "x_bf16", "ldx", "m", "kx", "bits", "n", "gc", "wbr", "wbc",
        "regime", "rows", "ksplit", "kchunk")] + [
        ("ws", ctypes.c_void_p), ("cnt", ctypes.c_void_p)]


_ARGS: Dict[tuple, Tuple[int, _Args]] = {}
# the operand pointers, the _Args address and the stream
_ARGTYPES = [ctypes.c_void_p] * 6


def _lib():
    lib = load("packed_matmul")
    fn = lib.packed_matmul_launch
    if fn.argtypes is None:          # declare once per process
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _args(key) -> int:
    """Address of the launch arguments of call shape ``key`` (built at its
    first call and kept, with the split-K scratch they point at)."""
    hit = _ARGS.get(key)
    if hit is None:
        device, bf16, ldx, m, k_x, bits, n, gc, wbr, wbc = key
        plan = matmul_plan(m, k_x, n, unit=1 if bits == 8 else 2, wbr=wbr)
        ws, cnt = splitk_scratch(device, plan, m, n)
        a = _Args(bf16, ldx, m, k_x, bits, n, gc, wbr, wbc,
                  int(plan.regime == "tensor"), plan.rows, plan.ksplit,
                  plan.kchunk, ws, cnt)
        hit = _ARGS[key] = (ctypes.addressof(a), a)
    return hit[0]


def packed_matmul(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor,
                  *, bits: int = 8, wbr: int = 8, wbc: int = 128,
                  grid: Optional[Tuple[int, int, int, int]] = None
                  ) -> torch.Tensor:
    """y[M, N] = x[M, K] @ (dequant(w_int) * per-WB scale), f32.

    int8: ``w_int`` (K, N) int8.  int4: (ceil(K/2), N) uint8, row 2j in
    the low nibble.  ``scale``: (K/wbr, N/wbc) f32.  ``x``: (M, K_x <= K)
    f32 or bf16 (other float types are cast to f32).  ``w_int`` may be a
    layer view of a stacked (L, ...) leaf; it is read in place.

    ``grid=(gr0, gc0, gr, gc)``: ``w_int`` is a shard whose WBs are the
    (gr, gc) sub-grid of ``scale`` at WB offset (gr0, gc0), so K = gr *
    wbr and N = gc * wbc; the launch reads ``scale`` in place at that
    offset (its row stride the whole grid's)."""
    if RECORDERS:
        return RECORDERS[-1].kernel_call(
            "packed_matmul", packed_matmul, (x, w_int, scale),
            dict(bits=bits, wbr=wbr, wbc=wbc, grid=grid))
    m, k_x = x.shape
    gr0, gc0, gr, gc = grid if grid is not None else (0, 0, *scale.shape)
    if gr0 + gr > scale.shape[0] or gc0 + gc > scale.shape[1]:
        raise ValueError(f"grid {grid} outside the scale grid "
                         f"{tuple(scale.shape)}")
    k, n = gr * wbr, gc * wbc
    if k_x > k or w_int.shape[-1] != n:
        raise ValueError(f"operand geometry mismatch: x K={k_x}, "
                         f"scale grid K={k} N={n}, w N={w_int.shape[-1]}")
    if bits not in (8, 4):
        raise ValueError(bits)
    if x.device.type in ("cpu", "meta"):   # meta: shapes only (dry run)
        return packed_matmul_ref(x, w_int, scale, bits, wbr, wbc, grid)
    if x.device.type != "cuda":
        raise ValueError(f"packed_matmul runs on cuda or cpu, not {x.device}")
    want = torch.int8 if bits == 8 else torch.uint8
    rows = k if bits == 8 else (k + 1) // 2
    if w_int.dtype != want or w_int.shape[0] < rows:
        raise ValueError(f"int{bits} weights must be {want} with >= {rows} "
                         f"rows, got {w_int.dtype} {tuple(w_int.shape)}")
    if not (w_int.is_contiguous() and scale.is_contiguous()
            and scale.dtype == torch.float32):
        raise ValueError("w_int and scale must be contiguous, scale f32")
    dev = x.device
    if w_int.device != dev or scale.device != dev:
        raise ValueError("x, w_int and scale must share one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    if x.stride(1) != 1:
        x = x.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    # the kernel reads scale[g * stride + h]: the whole grid's row stride,
    # from the shard's first WB
    stride = scale.shape[1]
    args = _args((dev, int(x.dtype == torch.bfloat16), x.stride(0), m,
                  k_x, bits, n, stride, wbr, wbc))
    s_ptr = scale.data_ptr() + 4 * (gr0 * stride + gc0)
    rc = _lib()(x.data_ptr(), w_int.data_ptr(), s_ptr,
                out.data_ptr(), args, stream_ptr(dev))
    if rc:
        raise RuntimeError(f"packed_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
