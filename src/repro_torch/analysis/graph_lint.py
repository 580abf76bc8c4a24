"""Hot-path graph lint: record the serving entry points, prove the
compressed wire formats stay compressed (port of
``repro.analysis.graph_lint``).

The BWQ efficiency claim is structural: under a kernel backend no
prefill / decode / chunk step may hold a dequantized full-weight-shape
float tensor — dequantization belongs inside the CUDA kernels (a tile at
a time, in registers and shared memory) or, for ``dense`` / ``ref``, is
the sanctioned strategy.  The reference traces its jitted entry points to
jaxprs and executes nothing.  The port runs eagerly, so it *records*
instead: :func:`lint_traced_fn` executes the entry point once under a
``TorchDispatchMode`` (:class:`_Recorder`, on a scratch decode state
that :func:`repro_torch.analysis.lint_engine` builds at lint sizes) and
applies *taint tracking* from every deployed payload tensor (``w_int`` /
``planes`` / ``sign``) to every op the call dispatched:

* ``dequant-materialization`` — a float op output whose trailing two dims
  equal a deployed leaf's block-padded (Kp, Np) / true (K, N) footprint
  and that derives from that leaf's payload.  Error under ``kernel`` /
  ``bitplane``; info (``sanctioned-dequant``) under ``dense`` / ``ref``;
  warning (``sanctioned-moe-dequant``) for the ragged MoE product's
  expert leaves and (``bitplane-dense-fallback``) for a packed leaf
  under ``bitplane``.
* ``payload-convert`` — ``to`` / ``_to_copy`` / ``copy_`` to a float
  dtype on a payload tensor or a view of one, outside any kernel: the
  start of a dequant in Python.
* ``payload-transpose`` — a transposed view of a payload *materialized*
  (``clone`` / ``contiguous`` / a copy).  A transpose alone is a free
  view in torch; the copy is the layout break the in-place kernel reads
  forbid.
* ``missing-donation`` (:func:`check_decode_donation`) — the torch form
  of the reference's donation rule: a decode step must write the cache
  in place, returning the input's storage for every state leaf, and
  allocate no tensor of a whole cache leaf's shape.

The same machinery audits the KV cache's read side against the
decode-attention backend (``attn_backend``):

* ``kv-dequant-materialization`` — a float tensor with a cache leaf's
  full (T, KV, dh) footprint derives from an int8 / int4 KV payload
  outside any kernel.  Error when the fused kernel was requested for
  decode (``attn_backend='fused'`` and ``fn_name='decode'``: the gather
  fallback ran instead); info (``sanctioned-kv-dequant``) under
  ``gather`` / ``ref`` and for prefill and chunks, where the gather read
  is the design.
* ``kv-full-width-gather`` — an ``index`` op materializes the contiguous
  (B, nb, page, ...) view of a paged pool leaf: the O(max_len)
  ``paged_gather`` the fused kernel exists to delete.  Same policy
  (``sanctioned-kv-gather``).
* ``kv-clean`` — fused decode saw KV payloads and materialized neither.

Contiguous *float* caches are not taint sources: their in-place write is
unavoidably a full-width float op.

Taint dies at the kernel boundary (:mod:`repro_torch.kernels.boundary`:
each wrapper call is one opaque op whose output carries no taint) and at
the product ops (``mm``, ``bmm``, ``einsum``, convolutions...): a product
is an activation, not a weight.  Taint is keyed by tensor identity
(``WeakIdKeyDictionary``), never by address: the caching allocator
reuses addresses.  A view's output inherits its input's taint and
payload identity, so a layer view of a stacked (L, K, N) leaf maps back
to the stacked leaf's keystr; an in-place or ``out=`` op taints the
argument it writes.  Findings collapse to one per (rule, leaf path).
"""
from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from ..core.state import tensor_leaves
from ..kernels.boundary import RECORDERS
from .contracts import _deployed_types, iter_deployed_leaves
from .report import Finding

_PAYLOAD_FIELDS = ("w_int", "planes", "sign")
_EXPERT_LEAF = re.compile(r"expert_(gate|up|down)")
# product ops: their outputs are activations, never weights (taint sinks;
# composite forms appear undecomposed under inference_mode)
_SINKS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "linear",
    "einsum", "tensordot", "mv", "addmv", "dot", "vdot", "bilinear",
    "convolution", "_convolution", "conv1d", "conv2d", "conv3d",
    "_grouped_mm", "_scaled_mm"})
# converts: a float-typed copy of a payload starts a dequant
_CONVERTS = frozenset({"_to_copy", "to", "copy_", "type_as"})
# copies that materialize a (transposed) view
_MATERIALIZE = frozenset({"clone", "contiguous", "_to_copy", "to", "copy_",
                          "copy"})
# non-view ops through which a payload tensor stays "direct" (the
# reference's squeeze / slice / gather / reshape / copy / convert)
_PASSTHROUGH = frozenset({"_to_copy", "to", "clone", "contiguous", "copy",
                          "index", "index_select", "gather", "reshape",
                          "_unsafe_view", "flatten", "unflatten",
                          "squeeze", "unsqueeze"})
# ops that read a pool leaf through a table (the paged gather)
_GATHERS = frozenset({"index", "index_select", "gather"})


@dataclasses.dataclass(frozen=True)
class PayloadLeaf:
    """One deployed leaf's identity + the float footprints that would
    betray its materialization outside a kernel."""
    path: str
    kind: str                 # 'packed' | 'bitplane'
    bits: int
    mat_shapes: frozenset     # of trailing-2-dim (rows, cols) tuples


def _leaf_info(path: str, leaf) -> PayloadLeaf:
    if path.startswith("[0]"):       # recorded args tuple: params is arg 0
        path = path[3:]
    _, bp_t = _deployed_types()
    wbr, wbc = leaf.spec.wb_rows, leaf.spec.wb_cols
    gr, gc = leaf.scale.shape[-2], leaf.scale.shape[-1]
    kp, np_ = gr * wbr, gc * wbc
    k, n = leaf.shape[-2], leaf.shape[-1]
    shapes = {(kp, np_), (k, n)}
    if isinstance(leaf, bp_t):
        kind = "bitplane"
        shapes.add((-(-kp // 8) * 8, np_))        # byte-padded Kp8 rows
    else:
        kind = "packed"
        if leaf.bits == 4:
            shapes.add((kp + kp % 2, np_))        # nibble-unpack even rows
    return PayloadLeaf(path=path, kind=kind, bits=leaf.bits,
                       mat_shapes=frozenset(shapes))


def deployed_leaves(params: Any) -> Dict[str, Any]:
    """keystr path -> deployed leaf object, over the whole tree."""
    return dict(iter_deployed_leaves(params))


def fallback_leaf_paths(params: Any, backend: str) -> List[str]:
    """Deployed leaves ``backend`` cannot execute natively (they fall back
    to the dense dequant matmul): packed ServingWeight leaves under the
    ``bitplane`` backend.  Static — nothing runs."""
    if backend != "bitplane":
        return []
    sw_t, _ = _deployed_types()
    return [p for p, leaf in deployed_leaves(params).items()
            if isinstance(leaf, sw_t)]


def _payload_tensors(args: tuple) -> Dict[int, Tuple[torch.Tensor,
                                                     PayloadLeaf]]:
    """id -> (payload tensor, its PayloadLeaf) for every ``w_int`` /
    ``planes`` / ``sign`` of a deployed leaf in ``args``."""
    out = {}
    for path, leaf in deployed_leaves(args).items():
        info = _leaf_info(path, leaf)
        for name in _PAYLOAD_FIELDS:
            t = getattr(leaf, name, None)
            if isinstance(t, torch.Tensor):
                out[id(t)] = (t, info)
    return out


class _Recorder(TorchDispatchMode):
    """Executes a call and shows each dispatched op to its walks:
    ``walk.op(name, args, inputs, outputs, written, view)`` with the op's
    packet name, its positional args, its tensor inputs and outputs, the
    tensors it writes in place (the schema's ``alias_info.is_write``, and
    the base of a written view) and whether it returns a view.  A kernel
    wrapper call is one op named after the kernel, counted in
    ``kernel_ops``; no walk sees it, so its output carries no taint."""

    # op -> (the (index, name) of each argument it writes, returns a view)
    _SCHEMA: Dict[Any, Tuple[Tuple[Tuple[int, str], ...], bool]] = {}

    def __init__(self, walks):
        super().__init__()
        self.walks = walks
        self.paused = 0
        self.kernel_ops: Counter = Counter()

    def __enter__(self):
        RECORDERS.append(self)
        try:
            return super().__enter__()
        except BaseException:
            RECORDERS.remove(self)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            RECORDERS.remove(self)

    def kernel_call(self, name: str, fn: Callable, args: tuple,
                    kwargs: dict):
        stack = RECORDERS[:]
        RECORDERS.clear()
        self.paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.paused -= 1
            RECORDERS[:] = stack
        self.kernel_ops[name] += 1
        return out

    @classmethod
    def _writes(cls, func) -> Tuple[Tuple[Tuple[int, str], ...], bool]:
        hit = cls._SCHEMA.get(func)
        if hit is None:
            hit = tuple((i, a.name) for i, a in
                        enumerate(func._schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            hit = cls._SCHEMA[func] = (hit, view)
        return hit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        writes, view = self._writes(func)
        inputs = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        written = []
        for i, name in writes:
            t = args[i] if i < len(args) else kwargs.get(name)
            if isinstance(t, torch.Tensor):
                written.append(t)
                if t._base is not None:
                    written.append(t._base)
        name = func.overloadpacket.__name__
        for w in self.walks:
            w.op(name, args, inputs, outputs, written, view)
        return out


def _swaps_last_two(name: str, args: tuple) -> bool:
    """Whether a view op ``name`` on ``args[0]`` exchanges its last two
    dims (``t``, ``transpose``, ``permute``...)."""
    if name == "t":
        return True
    x = args[0] if args else None
    if not isinstance(x, torch.Tensor) or x.ndim < 2:
        return False
    nd = x.ndim
    if name in ("transpose", "swapaxes", "swapdims") and len(args) >= 3:
        return {int(args[1]) % nd, int(args[2]) % nd} == {nd - 2, nd - 1}
    if name == "permute" and len(args) >= 2:
        dims = [int(d) % nd for d in args[1]]
        return dims[-2:] != [nd - 2, nd - 1]
    return False


class _Taint:
    """A walk's shared state: the direct payload tensors (``payload``:
    tensor -> leaf identity), the taint of every other tensor derived
    from them (tensor -> set of leaves), and the findings, one per
    (rule, leaf path)."""

    def __init__(self, fn_name: str):
        self.fn = fn_name
        self.findings: List[Finding] = []
        self._seen: Set[tuple] = set()
        self.payload = WeakIdKeyDictionary()
        self.taint = WeakIdKeyDictionary()

    def read(self, inputs) -> Set:
        """The union of the inputs' taint."""
        out: Set = set()
        for t in inputs:
            got = self.taint.get(t)
            if got:
                out |= got
        return out

    def spread(self, tensors, leaves: Set) -> None:
        for t in tensors:
            cur = self.taint.get(t)
            if cur is None:
                self.taint[t] = set(leaves)
            else:
                cur |= leaves

    def add(self, severity: str, rule: str, path: str, message: str):
        if (rule, path) in self._seen:
            return
        self._seen.add((rule, path))
        self.findings.append(Finding(
            severity=severity, pass_name="graph", rule=rule,
            path=f"{self.fn}:{path}", message=message))


class _Walk(_Taint):
    """One recorded function's weight walk: payload identity (and whether
    a view of it is transposed), taint, the severity policy."""

    def __init__(self, fn_name: str, backend: str, payload: Dict):
        super().__init__(fn_name)
        self.backend = backend
        for t, info in payload.values():
            self.payload[t] = (info, False)
        from ..models.moe import GROUPED_IMPL
        self._ragged_moe = GROUPED_IMPL.get("impl") == "ragged"

    def _severity(self, leaf: PayloadLeaf, rule: str) -> Tuple[str, str]:
        """(severity, rule) under the backend's materialization policy."""
        if self.backend == "bitplane" and leaf.kind == "packed":
            return "warning", "bitplane-dense-fallback"
        if self.backend in ("kernel", "bitplane"):
            if self._ragged_moe and _EXPERT_LEAF.search(leaf.path):
                return "warning", "sanctioned-moe-dequant"
            return "error", rule
        return "info", "sanctioned-dequant"

    def emit(self, leaf: PayloadLeaf, rule: str, message: str) -> None:
        severity, rule = self._severity(leaf, rule)
        self.add(severity, rule, leaf.path, message)

    def op(self, name, args, inputs, outputs, written, view) -> None:
        in_payload = [self.payload[t] for t in inputs if t in self.payload]
        in_taint = self.read(inputs)
        if name in _SINKS:
            return                       # activations, not weights
        if in_payload:
            leaves = [p for p, _ in in_payload]
            if name in _CONVERTS and \
                    any(o.is_floating_point() for o in outputs):
                for leaf in leaves:
                    self.emit(leaf, "payload-convert",
                              f"{name} to {outputs[0].dtype} on packed "
                              f"payload ({leaf.kind}, int{leaf.bits}) "
                              f"outside any kernel")
            if name in _MATERIALIZE:
                for leaf, transposed in in_payload:
                    if transposed:
                        self.emit(leaf, "payload-transpose",
                                  f"{name} materializes a transposed view "
                                  f"of packed payload ({leaf.kind}): "
                                  f"breaks the in-place kernel layout "
                                  f"contract")
            if view or name in _PASSTHROUGH:
                leaf, transposed = in_payload[0]
                if view:
                    transposed = transposed != _swaps_last_two(name, args)
                else:
                    transposed = False
                for o in outputs:
                    self.payload[o] = (leaf, transposed)
        if not (in_taint or in_payload):
            return
        out_taint = in_taint | {p for p, _ in in_payload}
        self.spread(outputs + written, out_taint)
        for o in outputs + written:
            if not o.is_floating_point() or o.ndim < 2:
                continue
            t2 = tuple(o.shape[-2:])
            for leaf in out_taint:
                if t2 in leaf.mat_shapes:
                    self.emit(
                        leaf, "dequant-materialization",
                        f"float {o.dtype} tensor {tuple(o.shape)} "
                        f"materializes the {leaf.kind} int{leaf.bits} "
                        f"leaf's {t2} weight footprint outside any kernel "
                        f"(op '{name}') under backend={self.backend!r}")


# ---------------------------------------------------------------------------
# KV-cache read-side lint (decode-attention backend)
# ---------------------------------------------------------------------------

_KV_FIELDS = ("['k']", "['v']")


@dataclasses.dataclass(frozen=True)
class KVLeaf:
    """One KV cache leaf's identity + the footprints that betray a
    full-width read outside the fused kernel."""
    path: str
    bits: int                 # 8 / 4 (quantized-at-rest) or 32 (float)
    paged: bool
    kv: int                   # KV heads
    dh: int                   # dequantized head dim (2x stored for int4)
    tail3: tuple              # stored trailing dims (page|T, KV, dh_s)


def _kv_payload(args: tuple) -> Dict[int, Tuple[torch.Tensor, KVLeaf]]:
    """id -> (tensor, KVLeaf) for every cache ``k`` / ``v`` in ``args``.

    Contiguous float caches are skipped: their in-place write is an
    unavoidable full-width float op, so they cannot be lint sources."""
    out = {}
    for path, leaf in tensor_leaves(args):
        if not path.endswith(_KV_FIELDS) or "['cache']" not in path:
            continue
        shape = tuple(leaf.shape)
        if len(shape) < 3:
            continue                             # recurrent state rows
        bits = {torch.int8: 8, torch.uint8: 4}.get(leaf.dtype, 32)
        paged = "['pages']" in path
        if bits == 32 and (not paged or not leaf.is_floating_point()):
            continue
        dh = shape[-1] * 2 if bits == 4 else shape[-1]
        out[id(leaf)] = (leaf, KVLeaf(path=path, bits=bits, paged=paged,
                                      kv=shape[-2], dh=dh,
                                      tail3=shape[-3:]))
    return out


class _KVWalk(_Taint):
    """Taint walk over the KV-cache read side (severity keyed on the
    decode-attention backend, not the matmul backend)."""

    def __init__(self, fn_name: str, attn_backend: str, payload: Dict):
        super().__init__(fn_name)
        self.attn = attn_backend
        for t, info in payload.values():
            self.payload[t] = info

    def _emit(self, leaf: KVLeaf, rule: str, sanctioned: str,
              message: str) -> None:
        if self.attn == "fused" and self.fn == "decode":
            severity = "error"          # fused requested, fallback ran
        else:
            severity, rule = "info", sanctioned
        self.add(severity, rule, leaf.path, message)

    def op(self, name, args, inputs, outputs, written, view) -> None:
        in_payload = [self.payload[t] for t in inputs if t in self.payload]
        in_taint = self.read(inputs)
        src = args[0] if args and isinstance(args[0], torch.Tensor) \
            else None
        if name in _GATHERS and src is not None and src in self.payload \
                and self.payload[src].paged:
            leaf = self.payload[src]
            for o in outputs:
                if o.ndim == src.ndim + 1 \
                        and tuple(o.shape[-3:]) == tuple(leaf.tail3):
                    self._emit(
                        leaf, "kv-full-width-gather", "sanctioned-kv-gather",
                        f"{name} materializes the contiguous "
                        f"{tuple(o.shape)} view of the paged KV pool "
                        f"(O(max_len) per decode step) under "
                        f"attn_backend={self.attn!r}")
        if name in _SINKS:
            return
        if in_payload and (view or name in _PASSTHROUGH
                           or name in _GATHERS) \
                and src is not None and src in self.payload:
            for o in outputs:
                self.payload[o] = self.payload[src]
        quant_in = {leaf for leaf in in_payload if leaf.bits < 32}
        if not (in_taint or quant_in):
            return
        out_taint = in_taint | quant_in
        self.spread(outputs + written, out_taint)
        for o in outputs + written:
            if not o.is_floating_point() or o.ndim < 3:
                continue
            osh = tuple(o.shape)
            for leaf in out_taint:
                if osh[-2:] == (leaf.kv, leaf.dh) \
                        and osh[-3] >= leaf.tail3[0]:
                    self._emit(
                        leaf, "kv-dequant-materialization",
                        "sanctioned-kv-dequant",
                        f"float {o.dtype} tensor {osh} materializes the "
                        f"int{leaf.bits} KV cache leaf's full (T, KV, dh) "
                        f"tree outside any kernel (op {name!r}) under "
                        f"attn_backend={self.attn!r}")


def _launch_counts() -> Dict[str, int]:
    from ..kernels import launch_counts
    return launch_counts()


def _call_record(fn_name: str, rec: _Recorder,
                 before: Dict[str, int]) -> Dict[str, Any]:
    """One recorded call: the kernel-boundary ops its recorder saw and the
    wrappers' launch counters over the call."""
    after = _launch_counts()
    return {"fn": fn_name, "kernel_ops": dict(rec.kernel_ops),
            "launches": {k: after[k] - before[k] for k in after}}


def lint_traced_fn(fn: Callable, args: tuple, *, fn_name: str, backend: str,
                   attn_backend: str = "gather",
                   calls: Optional[List[Dict[str, Any]]] = None
                   ) -> List[Finding]:
    """Execute ``fn(*args)`` once under the recorder and lint what it
    dispatched (weight materialization + KV-cache read side).

    ``backend`` / ``attn_backend`` set the severity policy; ``fn`` passes
    the backends to the model itself (the port's model calls take them
    explicitly).  The call runs for real, so ``args`` are concrete
    tensors, and a decode state among them is written in place: give it
    a scratch state.  ``calls``, when given, gets one record for the
    call: ``fn``, the kernel-boundary ops the recorder saw
    (``kernel_ops``) and the kernel wrappers' launch counters over the
    call (``launches``)."""
    payload = _payload_tensors(args)
    kv_payload = _kv_payload(args)
    w = _Walk(fn_name, backend, payload)
    kw = _KVWalk(fn_name, attn_backend, kv_payload)
    findings: List[Finding] = []
    before = _launch_counts()
    rec = _Recorder([w, kw])
    try:
        with rec:
            fn(*args)
    except Exception as e:
        findings.append(Finding(
            severity="error", pass_name="graph", rule="trace-failure",
            path=fn_name,
            message=f"recording failed ({type(e).__name__}: {e})"))
        return findings
    if calls is not None:
        calls.append(_call_record(fn_name, rec, before))
    if not payload:
        findings.append(Finding(
            severity="info", pass_name="graph", rule="no-payload",
            path=fn_name,
            message="no deployed packed leaves reach this function; "
                    "materialization lint is vacuous"))
    else:
        if not w.findings:
            findings.append(Finding(
                severity="info", pass_name="graph", rule="clean",
                path=fn_name,
                message=f"{len(payload)} packed payload inputs; no "
                        f"materialization outside the kernels under "
                        f"backend={backend!r}"))
        findings += w.findings
    if kv_payload:
        if not kw.findings and attn_backend == "fused" \
                and fn_name == "decode":
            findings.append(Finding(
                severity="info", pass_name="graph", rule="kv-clean",
                path=fn_name,
                message=f"{len(kv_payload)} KV cache payload inputs; "
                        f"fused decode materializes neither the "
                        f"contiguous KV view nor the f32 KV tree"))
        findings += kw.findings
    return findings


# ---------------------------------------------------------------------------
# donation check (the torch form: the cache is written in place)
# ---------------------------------------------------------------------------

class _AllocWalk:
    """Records every fresh op output (sharing no input's storage) whose
    (shape, dtype) is a whole cache leaf's."""

    def __init__(self, leaves: Dict[Tuple, str]):
        self.leaves = leaves
        self.hits: List[str] = []

    def op(self, name, args, inputs, outputs, written, view) -> None:
        if view:
            return
        ptrs = {t.untyped_storage().data_ptr() for t in inputs}
        for o in outputs:
            key = (tuple(o.shape), o.dtype)
            if key in self.leaves and \
                    o.untyped_storage().data_ptr() not in ptrs:
                self.hits.append(f"{name}->{self.leaves[key]}")


def check_decode_donation(engine, tokens, state, index,
                          calls: Optional[List[Dict[str, Any]]] = None
                          ) -> List[Finding]:
    """Verify a decode step writes its state in place (the torch form of
    the reference's donated decode state).

    Runs ``engine.decode(tokens, state, index)`` once under the recorder
    (``state`` is written: give it a scratch state) and holds that every
    leaf of the returned state is the input leaf's storage, and that no
    op of the step allocated a tensor of a whole cache leaf's shape and
    dtype (a double-buffered cache).  ``calls`` gets the call's record,
    as :func:`lint_traced_fn` gives it (``fn`` ``"donation"``)."""
    findings: List[Finding] = []
    before = dict(tensor_leaves(state))
    leaves = {(tuple(t.shape), t.dtype): p for p, t in
              tensor_leaves(state.get("cache", {}), "['cache']")}
    walk = _AllocWalk(leaves)
    rec = _Recorder([walk])
    counts = _launch_counts()
    try:
        with rec:
            _, new_state = engine.decode(tokens, state, index)
    except Exception as e:
        findings.append(Finding(
            severity="error", pass_name="graph", rule="donation-lowering",
            path="decode", message=f"could not run decode to inspect its "
                                   f"state writes ({type(e).__name__}: "
                                   f"{e})"))
        return findings
    if calls is not None:
        calls.append(_call_record("donation", rec, counts))
    after = dict(tensor_leaves(new_state))
    missing = [p for p, t in before.items()
               if p not in after or after[p].untyped_storage().data_ptr()
               != t.untyped_storage().data_ptr()]
    if missing or walk.hits:
        findings.append(Finding(
            severity="error", pass_name="graph", rule="missing-donation",
            path="decode:state",
            message=f"{len(missing)}/{len(before)} decode-state buffers are "
                    f"not written in place (double-buffered KV cache per "
                    f"tick): {missing[:5]}; whole-leaf allocations: "
                    f"{walk.hits[:5]}"))
    else:
        findings.append(Finding(
            severity="info", pass_name="graph", rule="donation-ok",
            path="decode:state",
            message=f"all {len(before)} decode-state buffers donated "
                    f"(written in place)"))
    return findings
