"""Shared building blocks: the quantized-linear dispatch, norms,
embeddings (port of ``repro.models.common``).

Params are plain nested dicts.  A weight matrix is a ``FakeQuantTensor``
(QAT form), a ``ServingWeight`` (deployed packed integers), a
``BitplaneServingWeight`` (deployed bit planes) or a plain tensor.  Layer
code never dequantizes a weight itself: every ``x @ W`` goes through
:func:`qmatmul`, which dispatches on the weight representation and the
execution backend, passed explicitly per call:

* ``dense``    — dequantize the leaf and run a plain matmul (works for
  every representation);
* ``kernel``   — stream a deployed leaf through its hand-written CUDA
  kernel, ``packed_matmul`` or ``bitplane_matmul`` (the counterpart of the
  reference's ``pallas`` backend; on CPU tensors the wrapper runs the
  kernel's plain version);
* ``bitplane`` — ``bitplane_matmul`` for bit-plane leaves, and only for
  them: a packed leaf falls back to the dense dot, as in the reference;
* ``ref``      — the leaf's kernel's plain PyTorch version, on whatever
  device the tensors lie (the comparison path on the card).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import QuantConfig
from ..core.fakequant import FakeQuantTensor, fq_compose, fq_from_float
from ..core.pact import pact_sym_quant
from ..kernels.bitplane_matmul import bitplane_matmul
from ..kernels.packed_matmul import packed_matmul
from ..kernels.ref import bitplane_matmul_ref, packed_matmul_ref
from ..serve.deploy import (BitplaneServingWeight, ServingWeight,
                            bitplane_serving_compose, serving_compose)

MATMUL_BACKENDS = ("dense", "kernel", "bitplane", "ref")

__all__ = ["QuantConfig", "MATMUL_BACKENDS", "make_weight", "qdense",
           "qmatmul", "prepare_params", "act_quant", "make_beta",
           "rms_norm", "embed_init", "softcap"]


def make_weight(shape, qc: QuantConfig, *, generator: torch.Generator,
                device, scale: float = 1.0, quantize: bool = True) -> Any:
    """Initialize one (possibly stacked) weight matrix (..., K, N)."""
    fan_in = shape[-2]
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * (scale / fan_in ** 0.5)
    if not quantize or not qc.enabled:
        return w
    if qc.mode == "fake":
        return fq_from_float(w, qc.n_bits, qc.spec)
    raise ValueError(f"quant mode {qc.mode!r} is not ported yet")


def qdense(w: Any, dtype=None) -> torch.Tensor:
    """Dequantize ONE weight leaf to a plain tensor (the dense backend)."""
    if isinstance(w, FakeQuantTensor):
        return fq_compose(w, dtype)
    if isinstance(w, ServingWeight):
        return serving_compose(w, dtype or torch.bfloat16)
    if isinstance(w, BitplaneServingWeight):
        return bitplane_serving_compose(w, dtype or torch.bfloat16)
    if dtype is not None and w.is_floating_point():
        return w.to(dtype)
    return w


def _qmatmul_packed(x: torch.Tensor, sw: ServingWeight,
                    backend: str) -> torch.Tensor:
    """x (..., K) @ packed ServingWeight (Kp, Np) -> (..., N)."""
    n = sw.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    wbr, wbc = sw.spec.wb_rows, sw.spec.wb_cols
    if backend == "kernel":
        y = packed_matmul(x2, sw.w_int, sw.scale, bits=sw.bits, wbr=wbr,
                          wbc=wbc)
    else:                                                  # 'ref'
        y = packed_matmul_ref(x2, sw.w_int, sw.scale, sw.bits, wbr, wbc)
    return y[:, :n].reshape(*lead, n).to(x.dtype)


def _qmatmul_bitplane(x: torch.Tensor, sw: BitplaneServingWeight,
                      backend: str) -> torch.Tensor:
    """x (..., K) @ bit-plane BitplaneServingWeight (Kp, Np) -> (..., N)."""
    n = sw.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    wbr, wbc = sw.spec.wb_rows, sw.spec.wb_cols
    if backend == "ref":
        y = bitplane_matmul_ref(x2, sw.planes, sw.sign, sw.mask, sw.scale,
                                wbr, wbc)
    else:                                      # 'bitplane' / 'kernel'
        y = bitplane_matmul(x2, sw.planes, sw.sign, sw.mask, sw.scale,
                            wbr=wbr, wbc=wbc)
    return y[:, :n].reshape(*lead, n).to(x.dtype)


def qmatmul(x: torch.Tensor, w: Any, backend: str = "dense") -> torch.Tensor:
    """y = x @ W for any weight representation (the model-side matmul).

    A deployed (2-D, i.e. layer-sliced) leaf runs on its compressed form
    under a non-dense backend: a bit-plane leaf runs ``bitplane_matmul``
    under ``kernel`` or ``bitplane`` and its plain version under ``ref``;
    a packed leaf runs ``packed_matmul`` under ``kernel`` and its plain
    version under ``ref``.  Every other combination (a packed leaf under
    ``bitplane`` included) dequantizes the single leaf and runs a plain
    matmul."""
    if isinstance(w, BitplaneServingWeight) and backend != "dense" \
            and w.sign.ndim == 2:
        return _qmatmul_bitplane(x, w, backend)
    if isinstance(w, ServingWeight) and backend in ("kernel", "ref") \
            and w.w_int.ndim == 2:
        return _qmatmul_packed(x, w, backend)
    return x @ qdense(w, x.dtype)


def prepare_params(params: Any, dtype=None) -> Any:
    """Once-per-step param prep: cast plain float leaves to the compute
    dtype.  Quantized leaves stay in their storage; :func:`qmatmul`
    consumes them one layer at a time."""
    if isinstance(params, dict):
        return {k: prepare_params(v, dtype) for k, v in params.items()}
    if dtype is not None and isinstance(params, torch.Tensor) \
            and params.is_floating_point():
        return params.to(dtype)
    return params


def act_quant(x: torch.Tensor, beta: Optional[torch.Tensor],
              qc: QuantConfig) -> torch.Tensor:
    """Symmetric PACT activation quantization in front of a quantized
    matmul."""
    if not qc.enabled or qc.act_bits >= 32 or beta is None:
        return x
    return pact_sym_quant(x, beta.to(x.dtype), qc.act_bits)


def make_beta(qc: QuantConfig, device, dtype=torch.float32):
    return torch.tensor(qc.pact_init, dtype=dtype, device=device) \
        if qc.enabled and qc.act_bits < 32 else None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def embed_init(vocab: int, d: int, *, generator: torch.Generator, device):
    return torch.randn((vocab, d), generator=generator, device=device,
                       dtype=torch.float32) * 0.02


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap and cap > 0 else x
