"""Bit-plane-sliced mixed-precision matmul: the wrapper of the CUDA kernel
``csrc/bitplane_matmul.cu`` (the port of the TPU kernel
``repro.kernels.bitplane_matmul``) and its plain PyTorch version.

Geometry comes from the mask LUT: K = mask.shape[-2] * wbr (the WB-padded
rows; ``planes`` may carry byte-pad rows past it, which are never read)
and N = ``planes.shape[-1]``, which may be fewer columns than the mask grid
covers (ragged N).  ``x`` may have fewer than K columns (the missing ones
are zero).  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.bitplane_matmul_ref`); a CUDA tensor
launches the kernel or raises.  The launch geometry (byte-streaming
split-K at M <= 16, tensor-core tiles above) is
:func:`repro_torch.kernels.tiling.matmul_plan`'s.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .boundary import RECORDERS
from .build import load, stream_ptr
from .ref import bitplane_matmul_ref
from .tiling import matmul_plan, splitk_scratch


class _Args(ctypes.Structure):
    """The launch's fixed geometry (``BitplaneArgs`` in the CUDA source):
    built once for each call shape, so a call converts eight arguments."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "x_bf16", "ldx", "m", "kend", "nbits", "gr", "gc", "per_block", "n",
        "wbr", "wbc", "regime", "rows", "ksplit", "kchunk")] + [
        ("pstride", ctypes.c_longlong), ("ws", ctypes.c_void_p),
        ("cnt", ctypes.c_void_p)]


_ARGS: Dict[tuple, Tuple[int, _Args]] = {}
# the operand pointers, the _Args address and the stream
_ARGTYPES = [ctypes.c_void_p] * 8


def _lib():
    lib = load("bitplane_matmul")
    fn = lib.bitplane_matmul_launch
    if fn.argtypes is None:          # declare once per process
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _args(key) -> int:
    """Address of the launch arguments of call shape ``key`` (built at its
    first call and kept, with the split-K scratch they point at)."""
    hit = _ARGS.get(key)
    if hit is None:
        (device, bf16, ldx, m, kend, n_bits, gr, gc, per_block, n, wbr, wbc,
         pstride) = key
        plan = matmul_plan(m, kend, n, unit=8, wbr=wbr)
        ws, cnt = splitk_scratch(device, plan, m, n)
        a = _Args(bf16, ldx, m, kend, n_bits, gr, gc, per_block, n, wbr, wbc,
                  int(plan.regime == "tensor"), plan.rows, plan.ksplit,
                  plan.kchunk, pstride, ws, cnt)
        hit = _ARGS[key] = (ctypes.addressof(a), a)
    return hit[0]


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor,
                    sign: torch.Tensor, mask: torch.Tensor,
                    scale: torch.Tensor, *, wbr: int = 8, wbc: int = 128,
                    grid: Optional[Tuple[int, int, int, int]] = None
                    ) -> torch.Tensor:
    """y[M, N] = x[M, K] @ compose(planes, sign, mask, scale), f32.

    ``planes`` (n, K8//8, N) uint8, 1 <= n <= 8; ``sign`` (K8//8, N)
    uint8; ``mask`` (n, K//wbr, GC) f32 of 0s and 1s; ``scale`` the
    per-WB effective LUT (K//wbr, GC) f32 or a per-layer (1,) scalar
    (divided by ``2^n - 1``).  ``x``: (M, K_x <= K) f32 or bf16 (other
    float types are cast to f32).  Payload tensors may be layer views of
    stacked (L, ...) leaves; they are read in place.

    ``grid=(gr0, gc0, gr, gc)``: the payload is a shard whose WBs are the
    (gr, gc) sub-grid of ``mask`` (and a per-WB ``scale``) at WB offset
    (gr0, gc0), so K = gr * wbr; the launch reads both in place at that
    offset (their row and plane strides the whole grid's)."""
    if RECORDERS:
        return RECORDERS[-1].kernel_call(
            "bitplane_matmul", bitplane_matmul,
            (x, planes, sign, mask, scale), dict(wbr=wbr, wbc=wbc, grid=grid))
    m, k_x = x.shape
    n_bits, rows8, n = planes.shape
    gr_all, gc_all = mask.shape[-2:]
    gr0, gc0, gr, gc = grid if grid is not None else (0, 0, gr_all, gc_all)
    if gr0 + gr > gr_all or gc0 + gc > gc_all:
        raise ValueError(f"grid {grid} outside the mask grid "
                         f"{tuple(mask.shape)}")
    k = gr * wbr
    per_block = scale.ndim == 2
    if not 1 <= n_bits <= 8 or mask.shape[0] != n_bits:
        raise ValueError(f"need 1..8 planes matching the mask, got planes "
                         f"{tuple(planes.shape)}, mask {tuple(mask.shape)}")
    if k_x > k or rows8 * 8 < k or n > gc * wbc \
            or tuple(sign.shape) != (rows8, n) \
            or (per_block and tuple(scale.shape) != (gr_all, gc_all)) \
            or (not per_block and scale.numel() != 1):
        raise ValueError(f"operand geometry mismatch: x K={k_x}, mask grid "
                         f"K={k} N<={gc * wbc}, planes "
                         f"{tuple(planes.shape)}, sign {tuple(sign.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if x.device.type in ("cpu", "meta"):   # meta: shapes only (dry run)
        return bitplane_matmul_ref(x, planes, sign, mask, scale, wbr, wbc,
                                   grid)
    if x.device.type != "cuda":
        raise ValueError(f"bitplane_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    if planes.dtype != torch.uint8 or sign.dtype != torch.uint8 \
            or mask.dtype != torch.float32 or scale.dtype != torch.float32:
        raise ValueError("planes and sign must be uint8, mask and scale f32")
    if not (planes.is_contiguous() and sign.is_contiguous()
            and mask.is_contiguous() and scale.is_contiguous()):
        raise ValueError("planes, sign, mask and scale must be contiguous")
    dev = x.device
    if planes.device != dev or sign.device != dev or mask.device != dev \
            or scale.device != dev:
        raise ValueError("x and the weight tensors must share one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    if x.stride(1) != 1:
        x = x.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    # the kernel reads mask[b * gr * gc + g * gc + h] and scale[g * gc + h]
    # with the whole grid's strides, from the shard's first WB
    args = _args((dev, int(x.dtype == torch.bfloat16), x.stride(0), m,
                  min(k_x, k), n_bits, gr_all, gc_all, int(per_block), n,
                  wbr, wbc, planes.stride(0)))
    off = 4 * (gr0 * gc_all + gc0)
    s_ptr = scale.data_ptr() + (off if per_block else 0)
    rc = _lib()(x.data_ptr(), planes.data_ptr(), sign.data_ptr(),
                mask.data_ptr() + off, s_ptr, out.data_ptr(), args,
                stream_ptr(dev))
    if rc:
        raise RuntimeError(f"bitplane_matmul kernel launch failed: CUDA "
                           f"error {rc}")
    bitplane_matmul.launches += 1
    return out


bitplane_matmul.launches = 0
