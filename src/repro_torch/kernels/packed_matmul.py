"""Packed-integer dequant matmul: the wrapper of the CUDA kernel
``csrc/packed_matmul.cu`` (the port of the TPU kernel
``repro.kernels.packed_matmul``) and its plain PyTorch version.

Geometry comes from the per-WB scale grid: K = scale.shape[0] * wbr and
N = scale.shape[1] * wbc.  ``x`` may have fewer than K columns (the true
fan-in; the missing ones are zero), and int4 with an odd block-padded K
carries one zero nibble row.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.packed_matmul_ref`); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load
from .ref import packed_matmul_ref


def _lib():
    lib = load("packed_matmul")
    fn = lib.packed_matmul_launch
    if fn.argtypes is None:          # declare once per process
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, P, I, P, I, I, I, I, P, P]
        fn.restype = ctypes.c_int
    return fn


def packed_matmul(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor,
                  *, bits: int = 8, wbr: int = 8, wbc: int = 128
                  ) -> torch.Tensor:
    """y[M, N] = x[M, K] @ (dequant(w_int) * per-WB scale), f32.

    int8: ``w_int`` (K, N) int8.  int4: (ceil(K/2), N) uint8, row 2j in
    the low nibble.  ``scale``: (K/wbr, N/wbc) f32.  ``x``: (M, K_x <= K)
    f32 or bf16 (other float types are cast to f32).  ``w_int`` may be a
    layer view of a stacked (L, ...) leaf; it is read in place."""
    m, k_x = x.shape
    gr, gc = scale.shape
    k, n = gr * wbr, gc * wbc
    if k_x > k or w_int.shape[-1] != n:
        raise ValueError(f"operand geometry mismatch: x K={k_x}, "
                         f"scale grid K={k} N={n}, w N={w_int.shape[-1]}")
    if bits not in (8, 4):
        raise ValueError(bits)
    if x.device.type == "cpu":
        return packed_matmul_ref(x, w_int, scale, bits, wbr, wbc)
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
    if w_int.device != x.device or scale.device != x.device:
        raise ValueError("x, w_int and scale must share one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    if x.stride(1) != 1:
        x = x.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0),
                m, k_x, w_int.data_ptr(), bits, scale.data_ptr(), n, gc,
                wbr, wbc, out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"packed_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
