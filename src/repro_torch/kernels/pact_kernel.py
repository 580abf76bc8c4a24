"""Fused symmetric-PACT clip + uniform quantization: the wrapper of the
CUDA kernel ``csrc/pact_quant.cu`` (the port of the TPU kernel
``repro.kernels.pact_kernel.pact_quant_pallas``) and its plain PyTorch
version.

It is written in CUDA, not Triton, although Triton would suit a single
bandwidth-bound clip/round/scale pass with no shared memory or tensor
cores to manage: CUDA keeps the port on one build route (``nvcc`` into a
ctypes library, :mod:`.build`).  As on the TPU it computes in x's dtype
and returns x's dtype.  The models do not call it: they quantize
activations through :func:`repro_torch.core.pact.pact_sym_quant`, as the
reference's models do.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.pact_quant_ref`); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .boundary import RECORDERS
from .build import load, stream_ptr
from .ref import pact_quant_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib():
    lib = load("pact_quant")
    fn = lib.pact_quant_launch
    if fn.argtypes is None:          # declare once per process
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, ctypes.c_longlong, I, P]
        fn.restype = ctypes.c_int
    return fn


def pact_quant(x: torch.Tensor, beta: torch.Tensor, *,
               act_bits: int = 8) -> torch.Tensor:
    """``round(clip(x, -b, b) / b * L) * (b / L)`` with ``b = max(beta,
    1e-6)`` and ``L = 2^(act_bits-1) - 1``, in x's dtype.  ``x``: (R, C)
    f32, bf16 or f16; ``beta``: one clip level ((1,) or 0-d)."""
    if RECORDERS:
        return RECORDERS[-1].kernel_call("pact_quant", pact_quant,
                                         (x, beta), dict(act_bits=act_bits))
    if x.ndim != 2 or beta.numel() != 1:
        raise ValueError(f"x must be (R, C) and beta one value, got "
                         f"{tuple(x.shape)} and {tuple(beta.shape)}")
    if not 2 <= act_bits <= 16:
        raise ValueError(f"act_bits must be in [2, 16], got {act_bits}")
    if x.device.type in ("cpu", "meta"):   # meta: shapes only (dry run)
        return pact_quant_ref(x, beta, act_bits)
    if x.device.type != "cuda":
        raise ValueError(f"pact_quant runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"pact_quant takes f32, bf16 or f16, not {x.dtype}")
    if beta.device != x.device:
        raise ValueError("x and beta must share one device")
    x = x.contiguous()
    beta = beta.reshape(1).to(torch.float32).contiguous()
    out = torch.empty_like(x)
    stream = stream_ptr(x.device)
    rc = _lib()(x.data_ptr(), _DTYPES[x.dtype], beta.data_ptr(),
                out.data_ptr(), x.numel(), act_bits, stream)
    if rc:
        raise RuntimeError(f"pact_quant kernel launch failed: CUDA error "
                           f"{rc}")
    pact_quant.launches += 1
    return out


pact_quant.launches = 0
