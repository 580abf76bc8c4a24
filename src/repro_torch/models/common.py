"""Shared building blocks: the quantized-linear dispatch, norms,
embeddings (port of ``repro.models.common``).

Params are plain nested dicts.  A weight matrix is a ``QuantizedTensor``
(paper-faithful bit planes), a ``FakeQuantTensor`` (memory-scalable QAT
form), a ``ServingWeight`` (deployed packed integers), a
``BitplaneServingWeight`` (deployed bit planes) or a plain tensor.  Layer
code never dequantizes a weight itself: every ``x @ W`` goes through
:func:`qmatmul`, which dispatches on the weight representation and the
execution backend, passed explicitly per call:

* ``dense``    — dequantize the leaf and run a plain matmul (works for
  every representation; the only backend that training uses);
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

import contextlib
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import QuantConfig
from ..core.bitrep import QuantizedTensor, compose, from_float
from ..core.fakequant import FakeQuantTensor, fq_compose, fq_from_float
from ..core.pact import pact_sym_quant
from ..core.state import tensor_leaves, tree_map
from ..kernels.bitplane_matmul import bitplane_matmul
from ..kernels.packed_matmul import packed_matmul
from ..kernels.ref import bitplane_matmul_ref, packed_matmul_ref
from ..serve.deploy import (BitplaneServingWeight, ServingWeight,
                            bitplane_serving_compose, serving_compose)

MATMUL_BACKENDS = ("dense", "kernel", "bitplane", "ref")

__all__ = ["QuantConfig", "MATMUL_BACKENDS", "make_weight", "qdense",
           "qmatmul", "col_matmul", "row_matmul", "window_weight",
           "record_qmatmul_inputs", "prepare_params",
           "act_quant", "make_beta", "rms_norm", "embed_init", "softcap"]


def make_weight(shape, qc: QuantConfig, *, generator: torch.Generator,
                device, scale: float = 1.0, quantize: bool = True) -> Any:
    """Initialize one (possibly stacked) weight matrix (..., K, N)."""
    fan_in = shape[-2]
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * (scale / fan_in ** 0.5)
    if not quantize or not qc.enabled:
        return w
    if qc.mode == "bitplane":
        return from_float(w, qc.n_bits, qc.spec,
                          per_block_scale=qc.per_block_scale)
    if qc.mode == "fake":
        return fq_from_float(w, qc.n_bits, qc.spec)
    raise ValueError(qc.mode)


def qdense(w: Any, dtype=None) -> torch.Tensor:
    """Dequantize ONE weight leaf to a plain tensor (the dense backend)."""
    if isinstance(w, QuantizedTensor):
        return compose(w, dtype)
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


def _shard_grid(w) -> tuple:
    """``(gr0, gc0, gr, gc)``: the WB sub-grid a sharded deployed leaf's
    window covers (the whole grid when only FSDP-sharded)."""
    grid = w.mask if isinstance(w, BitplaneServingWeight) else w.scale
    gr_all, gc_all = grid.shape[-2:]
    sh = w.shard
    wbr, wbc = w.spec.wb_rows, w.spec.wb_cols
    start, stop = sh.window
    if sh.kind == "col":
        return 0, sh.grid0, gr_all, -(-(stop - start) // wbc)
    if sh.kind == "row":
        return sh.grid0, 0, (stop - start) // wbr, gc_all
    return 0, 0, gr_all, gc_all


def window_weight(w) -> Any:
    """The deployed leaf a sharded leaf's window forms on its own: the
    window's payload (its FSDP chunks gathered over ``data``) with the
    scale / mask sub-grid it covers (views of the replicated grids); its
    shape is the window's padded extent along the sharded dim and the true
    size along the other.  Its dequantization is the window's alone."""
    from ..dist.parallel import gather_payload
    pay = gather_payload(w)
    gr0, gc0, gr, gc = _shard_grid(w)
    k, n = w.shape[-2:]
    if w.shard.kind == "row":
        k = gr * w.spec.wb_rows
    elif w.shard.kind == "col":
        n = gc * w.spec.wb_cols
    shape = (*w.scale.shape[:-2], k, n)

    def sub(g):
        return g[..., gr0:gr0 + gr, gc0:gc0 + gc]
    if isinstance(w, BitplaneServingWeight):
        return BitplaneServingWeight(
            planes=pay["planes"], sign=pay["sign"], mask=sub(w.mask),
            scale=sub(w.scale) if w.scale.ndim >= 2 else w.scale,
            shape=shape, spec=w.spec, bits=w.bits)
    return ServingWeight(w_int=pay["w_int"], scale=sub(w.scale),
                         shape=shape, spec=w.spec, bits=w.bits)


def _window_product(x: torch.Tensor, w, backend: str) -> torch.Tensor:
    """x (M, K_window) @ the rank's window of a sharded deployed leaf ->
    (M, N_window) f32: the leaf's kernel (or its plain version) on the
    local payload, its FSDP chunks gathered over ``data`` first, reading
    the replicated scale / mask grids at the window's WB offset; the
    ``dense`` backend dequantizes the window alone."""
    sub = window_weight(w)
    grid = _shard_grid(w)
    wbr, wbc = w.spec.wb_rows, w.spec.wb_cols
    if isinstance(w, BitplaneServingWeight):
        if backend in ("kernel", "bitplane"):
            return bitplane_matmul(x, sub.planes, sub.sign, w.mask,
                                   w.scale, wbr=wbr, wbc=wbc, grid=grid)
        if backend == "ref":
            return bitplane_matmul_ref(x, sub.planes, sub.sign, w.mask,
                                       w.scale, wbr, wbc, grid)
        return x.to(torch.float32) @ bitplane_serving_compose(
            sub, torch.float32)
    if backend == "kernel":
        return packed_matmul(x, sub.w_int, w.scale, bits=w.bits, wbr=wbr,
                             wbc=wbc, grid=grid)
    if backend == "ref":
        return packed_matmul_ref(x, sub.w_int, w.scale, w.bits, wbr, wbc,
                                 grid)
    return x.to(torch.float32) @ serving_compose(sub, torch.float32)


def col_matmul(x: torch.Tensor, w: Any, backend: str = "dense"):
    """Column-parallel ``x @ W`` under a mesh: a sharded leaf multiplies
    its N window and keeps the columns its rank owns
    (:class:`~repro_torch.dist.parallel.Cols`); any other leaf gives the
    whole product on every rank."""
    from ..dist.parallel import Cols
    sh = getattr(w, "shard", None)
    if sh is None or sh.kind != "col":
        y = qmatmul(x, w, backend) if sh is None else \
            _sharded_whole(x, w, backend)
        return Cols.whole(y)
    lead = x.shape[:-1]
    y = _window_product(x.reshape(-1, x.shape[-1]), w, backend)
    start = sh.window[0]
    lo, hi = sh.own
    y = y[:, lo - start:hi - start].reshape(*lead, hi - lo).to(x.dtype)
    return Cols(y, lo, hi, w.shape[-1], sh.ranges)


def row_matmul(xc, w: Any, backend: str = "dense") -> torch.Tensor:
    """Row-parallel ``x @ W`` under a mesh, ``xc`` the input's columns on
    this rank (:class:`~repro_torch.dist.parallel.Cols`): a sharded leaf
    multiplies the input's columns over its K window (gathered over
    ``model`` when this rank does not hold them) and all-reduces the
    partial sums over ``model``; any other leaf multiplies the whole
    input."""
    from ..dist.parallel import all_reduce, gather_cols, take_cols
    sh = getattr(w, "shard", None)
    if sh is None or sh.kind != "row":
        x = gather_cols(xc)
        return qmatmul(x, w, backend) if sh is None else \
            _sharded_whole(x, w, backend)
    x = take_cols(xc, sh.windows)
    lead = x.shape[:-1]
    y = _window_product(x.reshape(-1, x.shape[-1]), w, backend)
    n = w.shape[-1]
    y = all_reduce(y[:, :n].contiguous())
    return y.reshape(*lead, n).to(xc.t.dtype)


def _sharded_whole(x: torch.Tensor, w, backend: str) -> torch.Tensor:
    """``x @ W`` for a leaf sharded only on ``data`` (FSDP): its payload
    gathered, the whole product."""
    lead = x.shape[:-1]
    y = _window_product(x.reshape(-1, x.shape[-1]), w, backend)
    n = w.shape[-1]
    return y[:, :n].reshape(*lead, n).to(x.dtype)


def qmatmul(x: torch.Tensor, w: Any, backend: str = "dense") -> torch.Tensor:
    """y = x @ W for any weight representation (the model-side matmul).

    A deployed (2-D, i.e. layer-sliced) leaf runs on its compressed form
    under a non-dense backend: a bit-plane leaf runs ``bitplane_matmul``
    under ``kernel`` or ``bitplane`` and its plain version under ``ref``;
    a packed leaf runs ``packed_matmul`` under ``kernel`` and its plain
    version under ``ref``.  Every other combination (a packed leaf under
    ``bitplane`` included) dequantizes the single leaf and runs a plain
    matmul.

    Inside :func:`record_qmatmul_inputs`, a call on a tagged bit-plane
    leaf first records the mean square of its input rows (the autotune
    calibration)."""
    if _ACT_RECORDERS and isinstance(w, BitplaneServingWeight) and w.tag:
        # (K,) per-input-feature second moment, kept on the device; the
        # layer loop runs the layers in order, so the appends restack
        x2 = torch.mean(torch.square(
            x.reshape(-1, x.shape[-1]).to(torch.float32)), dim=0)
        _ACT_RECORDERS[-1].setdefault(w.tag, []).append(x2)
    if getattr(w, "shard", None) is not None:
        # a shard under a mesh, reached outside the parallel paths: the
        # whole product (column and row shards gathered / reduced)
        from ..dist.parallel import Cols, gather_cols
        if w.shard.kind == "col":
            return gather_cols(col_matmul(x, w, backend))
        if w.shard.kind == "row":
            return row_matmul(Cols.whole(x), w, backend)
        return _sharded_whole(x, w, backend)
    if isinstance(w, BitplaneServingWeight) and backend != "dense" \
            and w.sign.ndim == 2:
        return _qmatmul_bitplane(x, w, backend)
    if isinstance(w, ServingWeight) and backend in ("kernel", "ref") \
            and w.w_int.ndim == 2:
        return _qmatmul_packed(x, w, backend)
    return x @ qdense(w, x.dtype)


# Stack of active calibration stores (dicts tag -> [x2 per consuming
# call, in call order]); empty in normal serving, so the hot path pays
# one falsy check a qmatmul.
_ACT_RECORDERS: list = []


@contextlib.contextmanager
def record_qmatmul_inputs(store: Optional[dict] = None):
    """Capture activation second moments for tagged bit-plane leaves:
    inside the context every :func:`qmatmul` against a ``tag``-labelled
    BitplaneServingWeight appends the (K,) mean square of its input
    activations to ``store[tag]``.  Yields the store."""
    store = {} if store is None else store
    _ACT_RECORDERS.append(store)
    try:
        yield store
    finally:
        _ACT_RECORDERS.pop()


def prepare_params(params: Any, dtype=None) -> Any:
    """Once-per-step param prep: cast plain float leaves to the compute
    dtype and compose bit-plane ``QuantizedTensor`` leaves up front (their
    bit axis leads, so the layer loop cannot slice them).  The other
    quantized leaves stay in their storage; :func:`qmatmul` consumes them
    one layer at a time."""
    def leaf(x):
        if isinstance(x, QuantizedTensor):
            return compose(x, dtype)
        if dtype is not None and isinstance(x, torch.Tensor) \
                and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(leaf, params)


def builds_graph(*trees) -> bool:
    """Whether a call on ``trees`` (tensors, and param trees of them)
    records a graph: grad mode is on and some tensor asks for a
    gradient.  A walk asks once, of its activation and its stacked layer
    params, not once a layer."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for _, t in tensor_leaves(tree))


def remat_call(on: bool, fn, *args):
    """``fn(*args)`` of one layer body, recomputed in the backward
    (``torch.utils.checkpoint``) when ``on`` (the walk's ``cfg.remat`` and
    :func:`builds_graph`): the reference's ``jax.checkpoint`` of a layer
    body."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def chunk_call(fn, *args):
    """``fn(*args)`` of one chunk of a sequence scan (tensor arguments),
    recomputed in the backward (``torch.utils.checkpoint``) when the call
    builds a graph; plain otherwise."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


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
