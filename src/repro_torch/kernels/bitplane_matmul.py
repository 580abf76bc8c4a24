"""Bit-plane-sliced mixed-precision matmul: the wrapper of the CUDA kernel
``csrc/bitplane_matmul.cu`` (the port of the TPU kernel
``repro.kernels.bitplane_matmul``) and its plain PyTorch version.

Geometry comes from the mask LUT: K = mask.shape[-2] * wbr (the WB-padded
rows; ``planes`` may carry byte-pad rows past it, which are never read)
and N = ``planes.shape[-1]``, which may be fewer columns than the mask grid
covers (ragged N).  ``x`` may have fewer than K columns (the missing ones
are zero).  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.bitplane_matmul_ref`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load
from .ref import bitplane_matmul_ref


def _lib():
    lib = load("bitplane_matmul")
    fn = lib.bitplane_matmul_launch
    if fn.argtypes is None:          # declare once per process
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, I, I, I, I, P, P, I, LL, P, I, I, P, I, I, I, I,
                       P, P]
        fn.restype = ctypes.c_int
    return fn


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor,
                    sign: torch.Tensor, mask: torch.Tensor,
                    scale: torch.Tensor, *, wbr: int = 8, wbc: int = 128
                    ) -> torch.Tensor:
    """y[M, N] = x[M, K] @ compose(planes, sign, mask, scale), f32.

    ``planes`` (n, K8//8, N) uint8, 1 <= n <= 8; ``sign`` (K8//8, N)
    uint8; ``mask`` (n, K//wbr, GC) f32 of 0s and 1s; ``scale`` the
    per-WB effective LUT (K//wbr, GC) f32 or a per-layer (1,) scalar
    (divided by ``2^n - 1``).  ``x``: (M, K_x <= K) f32 or bf16 (other
    float types are cast to f32).  Payload tensors may be layer views of
    stacked (L, ...) leaves; they are read in place."""
    m, k_x = x.shape
    n_bits, rows8, n = planes.shape
    gr, gc = mask.shape[-2:]
    k = gr * wbr
    per_block = scale.ndim == 2
    if not 1 <= n_bits <= 8 or mask.shape[0] != n_bits:
        raise ValueError(f"need 1..8 planes matching the mask, got planes "
                         f"{tuple(planes.shape)}, mask {tuple(mask.shape)}")
    if k_x > k or rows8 * 8 < k or n > gc * wbc \
            or tuple(sign.shape) != (rows8, n) \
            or (per_block and tuple(scale.shape) != (gr, gc)) \
            or (not per_block and scale.numel() != 1):
        raise ValueError(f"operand geometry mismatch: x K={k_x}, mask grid "
                         f"K={k} N<={gc * wbc}, planes "
                         f"{tuple(planes.shape)}, sign {tuple(sign.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return bitplane_matmul_ref(x, planes, sign, mask, scale, wbr, wbc)
    if x.device.type != "cuda":
        raise ValueError(f"bitplane_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    if planes.dtype != torch.uint8 or sign.dtype != torch.uint8 \
            or mask.dtype != torch.float32 or scale.dtype != torch.float32:
        raise ValueError("planes and sign must be uint8, mask and scale f32")
    if not all(t.is_contiguous() for t in (planes, sign, mask, scale)):
        raise ValueError("planes, sign, mask and scale must be contiguous")
    if any(t.device != x.device for t in (planes, sign, mask, scale)):
        raise ValueError("x and the weight tensors must share one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    if x.stride(1) != 1:
        x = x.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0),
                m, min(k_x, k), planes.data_ptr(), sign.data_ptr(), n_bits,
                planes.stride(0), mask.data_ptr(), gr, gc, scale.data_ptr(),
                int(per_block), n, wbr, wbc, out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"bitplane_matmul kernel launch failed: CUDA "
                           f"error {rc}")
    bitplane_matmul.launches += 1
    return out


bitplane_matmul.launches = 0
