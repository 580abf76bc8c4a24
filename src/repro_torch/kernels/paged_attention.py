"""Fused paged decode attention: the wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (the port of the TPU kernel
``repro.kernels.paged_attention``) and its plain PyTorch version.

One decode token per slot attends over the (quantized) page pool through
its block table, with int8 / nibble-packed int4 KV dequantized inside the
online-softmax loop.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.paged_attention_ref`); a CUDA tensor
launches the kernel or raises.  The kernel is split-KV: each slot's table
capacity is cut into ranges by :func:`repro_torch.kernels.tiling.
attention_plan` (from host shapes only), and the ranges of one
(slot, head group) are combined inside the same launch, through a
workspace that :func:`repro_torch.kernels.tiling.attention_scratch`
keeps.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .build import load, stream_ptr
from .ref import paged_attention_ref
from .tiling import attention_plan, attention_scratch

_POOL_BITS = {torch.int8: 8, torch.uint8: 4, torch.bfloat16: 16,
              torch.float32: 32}


class _Args(ctypes.Structure):
    """The launch's fixed geometry (``AttentionArgs`` in the CUDA source):
    built once for each call shape, so a call converts ten arguments."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "b", "kvh", "g", "dh", "page", "nb", "bits", "window", "splits",
        "split_len", "heads", "chunk", "n_tab", "smem")] + [
        ("sm_scale", ctypes.c_float), ("softcap", ctypes.c_float),
        ("ws", ctypes.c_void_p), ("cnt", ctypes.c_void_p)]


_ARGS: Dict[tuple, Tuple[int, _Args]] = {}
# q, k, v, k_scale, v_scale, table, kv_len, out, the _Args address, stream
_ARGTYPES = [ctypes.c_void_p] * 10


def _lib():
    lib = load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:          # declare once per process
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _args(key) -> int:
    """Address of the launch arguments of call shape ``key`` (built at its
    first call, with its plan and the split workspace, and kept)."""
    hit = _ARGS.get(key)
    if hit is None:
        device, b, kv, g, dh, page, nb, bits, window, softcap = key
        plan = attention_plan(b, kv, g, dh, page, nb, bits)
        ws, cnt = attention_scratch(device, plan, b, kv, g, dh)
        a = _Args(b, kv, g, dh, page, nb, bits, window, plan.splits,
                  plan.split_len, plan.heads, plan.chunk, plan.n_tab,
                  plan.smem, 1.0 / math.sqrt(dh), softcap, ws, cnt)
        hit = _ARGS[key] = (ctypes.addressof(a), a)
    return hit[0]


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, k_scale: Optional[torch.Tensor],
                    v_scale: Optional[torch.Tensor], table: torch.Tensor,
                    kv_len: torch.Tensor, *, window: Optional[int] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Decode attention straight over a (quantized) page pool.

    q:         (B, KV, G, dh) grouped queries (one decode token per slot).
    k/v:       (P, page, KV, dh) int8, bf16 or f32, or (P, page, KV, dh/2)
               uint8 nibble pairs (``core.quantize.pack_int4`` layout).
    k/v_scale: (P, page, KV) f32 per-token/head scales (None when float).
    table:     (B, nb) int32 block table; page 0 is the trash page.
    kv_len:    (B,) int32 fill levels, the decode token included.
    window:    > 0 restricts attention to the last ``window`` positions.

    Returns (B, KV, G, dh) f32; 0 for a slot with no valid position."""
    b, kv, g, dh = q.shape
    bits = _POOL_BITS.get(k_pages.dtype)
    if bits is None or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"unsupported pool dtypes {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    dh_s = k_pages.shape[-1]
    if (bits == 4 and dh_s * 2 != dh) or (bits != 4 and dh_s != dh):
        raise ValueError(f"pool head dim {dh_s} does not fit query dh {dh} "
                         f"at {bits} bits")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, k_scale, v_scale,
                                   table, kv_len, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    quantized = bits in (8, 4)
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("a quantized pool needs k_scale and v_scale")
    if quantized and not (k_scale.dtype == v_scale.dtype == torch.float32
                          and k_scale.is_contiguous()
                          and v_scale.is_contiguous()):
        raise ValueError("pool scales must be contiguous f32")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    dev = q.device
    if not (k_pages.device == v_pages.device == table.device
            == kv_len.device == dev) or (quantized and not (
                k_scale.device == v_scale.device == dev)):
        raise ValueError("paged_attention's operands must share one device")
    if q.dtype != torch.float32 or not q.is_contiguous():
        q = q.to(torch.float32).contiguous()
    if table.dtype != torch.int32 or not table.is_contiguous():
        table = table.to(torch.int32).contiguous()
    if kv_len.dtype != torch.int32 or kv_len.dim() != 1 \
            or not kv_len.is_contiguous():
        kv_len = kv_len.to(torch.int32).reshape(b).contiguous()
    out = torch.empty((b, kv, g, dh), dtype=torch.float32, device=dev)
    args = _args((dev, b, kv, g, dh, k_pages.shape[1], table.shape[1], bits,
                  int(window or 0), float(softcap)))
    rc = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr() if quantized else None,
                v_scale.data_ptr() if quantized else None,
                table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), args,
                stream_ptr(dev))
    if rc:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
