"""Logical-axis sharding rules over a context-managed mesh (port of
``repro.dist.sharding``).

The rules map *logical* axis names ("batch", "heads", "ff", ...) and
*parameter paths* (regexes over the keystr strings that
:func:`repro_torch.core.state.tensor_leaves` spells as the reference's
``jax.tree_util.keystr``) onto mesh axes, maxtext-style.  Everything
degrades to replicated specs when no mesh is active.

Conventions (as the reference's):
  * column-parallel projections (wq/wk/wv, FFN up/gate) put their output
    dim on 'model'; row-parallel ones (wo, FFN down) their input dim;
  * big weights also get their free dim on 'data' (ZeRO-3 FSDP), gated on
    a size threshold and the ``FSDP`` toggle;
  * MoE routers and quantization metadata (scale / mask / bit-width LUTs)
    stay replicated;
  * the data-parallel ("batch") logical axis spans every data-ish mesh
    axis present, in ('pod', 'data') order.

A spec is a :class:`PSpec`, a plain tuple of the port's own with one
entry a dim: ``None`` (replicated), an axis name, or a tuple of axis
names.  Every emitted spec passes through :func:`fit_spec`, which drops
axes that are absent or already used, and keeps an axis that does not
divide its dim by ceil-division padding (``PADDED``; a :class:`SpecPad`
event), the placement boundary zero-padding the dim (:func:`pad_leaf`)
and the consumer slicing back (:func:`unpad_leaf`).  The rule layer
consults only ``mesh.shape`` (axis name -> size), so it runs devicelessly
under a shape-only stand-in (``analysis.sharding_lint.ShapeOnlyMesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
import warnings
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..core.state import _is_node, tensor_leaves


class PSpec(tuple):
    """A partition spec: one entry a dim (``None``, an axis name, or a
    tuple of axis names); compares equal to the plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PSpec{tuple(self)!r}"


# --------------------------------------------------------------------------
# mesh context
# --------------------------------------------------------------------------

_STATE = threading.local()


def get_mesh():
    """The innermost active mesh, or None (single device / replicated)."""
    stack = getattr(_STATE, "mesh_stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the sharding rules and the model's parallel
    paths; ``use_mesh(None)`` is a no-op context."""
    stack = getattr(_STATE, "mesh_stack", None)
    if stack is None:
        stack = _STATE.mesh_stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


# Data-ish mesh axes in their canonical (outer -> inner) order.
DATA_AXES: Tuple[str, ...] = ("pod", "data")

# ZeRO-3 toggle: big weights get their free dim sharded on 'data'.
FSDP = {"enabled": True, "min_bytes": 1 << 20}

# Padded-sharding toggle: a mesh axis that does not divide a dim keeps the
# dim sharded by ceil-division padding instead of being dropped.  Callers
# can override per call with ``fit_spec(..., pad=...)``.
PADDED = {"enabled": True}


def batch_axes(mesh=None) -> Tuple[str, ...]:
    """The data-parallel mesh axes present in ``mesh`` (pod-major)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in DATA_AXES if a in mesh.shape)


def _batch_entry(mesh):
    dp = batch_axes(mesh)
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else tuple(dp)


# logical axis name -> mesh axes (resolved against the active mesh)
_LOGICAL = {
    "batch": _batch_entry,
    "data": lambda mesh: "data",
    "pod": lambda mesh: "pod",
    "model": lambda mesh: "model",
    "heads": lambda mesh: "model",
    "kv_heads": lambda mesh: "model",
    "ff": lambda mesh: "model",
    "expert": lambda mesh: "model",
    "vocab": lambda mesh: "model",
}


class ShardingDropWarning(UserWarning):
    """A requested mesh axis did not divide its dim and was dropped."""


@dataclasses.dataclass(frozen=True)
class SpecDrop:
    """One mesh axis removed from a requested spec.

    ``reason`` is ``'absent'`` (axis not in the mesh), ``'used'`` (axis
    already consumed by an earlier dim) or ``'indivisible'`` (the axis
    group's size does not divide the dim AND padding was off for the
    call)."""
    label: str                 # leaf keystr, or '<unlabeled>'
    dim: int
    axis: str
    reason: str                # 'absent' | 'used' | 'indivisible'
    dim_size: int
    axis_size: int             # 0 when the axis is absent from the mesh

    def message(self) -> str:
        if self.reason == "indivisible":
            return (f"{self.label}: dim {self.dim} (size {self.dim_size}) "
                    f"is not divisible by mesh axis {self.axis!r} "
                    f"(size {self.axis_size}); axis dropped, dim serves "
                    f"replicated")
        if self.reason == "absent":
            return (f"{self.label}: dim {self.dim} requested mesh axis "
                    f"{self.axis!r}, which this mesh does not have")
        return (f"{self.label}: dim {self.dim} requested mesh axis "
                f"{self.axis!r}, already used by an earlier dim")


@dataclasses.dataclass(frozen=True)
class SpecPad:
    """One dim kept sharded by ceil-division padding: the placement
    boundary zero-pads ``dim_size`` to ``padded_size`` (the next multiple
    of ``group_size``) and the consumer slices back."""
    label: str
    dim: int
    axes: Tuple[str, ...]
    dim_size: int
    padded_size: int
    group_size: int

    def message(self) -> str:
        return (f"{self.label}: dim {self.dim} (size {self.dim_size}) "
                f"pads to {self.padded_size} for mesh axes "
                f"{'x'.join(self.axes)} (size {self.group_size}); "
                f"sharded via ceil-division, masked at the consumer")


@contextlib.contextmanager
def collect_spec_events():
    """Capture every :class:`SpecDrop` / :class:`SpecPad` recorded by
    :func:`fit_spec` in the dynamic extent (innermost collector wins; the
    sharding lint's event source)."""
    stack = getattr(_STATE, "spec_events", None)
    if stack is None:
        stack = _STATE.spec_events = []
    events: List[Any] = []
    stack.append(events)
    try:
        yield events
    finally:
        stack.pop()


_WARNED_DROPS: set = set()


def _record_drop(label: Optional[str], dim: int, axis: str, reason: str,
                 dim_size: int, axis_size: int) -> None:
    drop = SpecDrop(label=label or "<unlabeled>", dim=dim, axis=axis,
                    reason=reason, dim_size=dim_size, axis_size=axis_size)
    stack = getattr(_STATE, "spec_events", None)
    if stack:
        stack[-1].append(drop)
    if reason == "indivisible":
        key = (drop.label, dim, axis)
        if key not in _WARNED_DROPS:
            _WARNED_DROPS.add(key)
            warnings.warn(ShardingDropWarning(drop.message()), stacklevel=3)


def _record_pad(label: Optional[str], dim: int, axes: Tuple[str, ...],
                dim_size: int, padded_size: int, group_size: int) -> None:
    stack = getattr(_STATE, "spec_events", None)
    if stack:
        stack[-1].append(SpecPad(label=label or "<unlabeled>", dim=dim,
                                 axes=axes, dim_size=dim_size,
                                 padded_size=padded_size,
                                 group_size=group_size))


def spec(*logical: Optional[str]) -> PSpec:
    """Logical axis names -> a spec against the active mesh (not fitted:
    pair with :func:`fit_spec`)."""
    mesh = get_mesh()
    if mesh is None:
        return PSpec()
    entries = []
    for name in logical:
        fn = _LOGICAL.get(name) if name is not None else None
        entries.append(fn(mesh) if fn else None)
    return PSpec(*entries)


def fit_spec(ps: Sequence, shape: Sequence[int], mesh=None,
             label: Optional[str] = None, pad: Optional[bool] = None
             ) -> PSpec:
    """Fit ``ps`` to ``shape`` under ``mesh``: drop axes that are not in
    the mesh or already used by an earlier dim; returns ``len(shape)``
    entries.  An axis group whose size does not divide the dim is kept by
    ceil-division padding when ``pad`` (default: :data:`PADDED`), and
    dropped (a :class:`SpecDrop`, warned once per (label, dim, axis))
    otherwise."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return PSpec(*([None] * len(shape)))
    do_pad = PADDED["enabled"] if pad is None else pad
    used: set = set()
    out: List[Any] = []
    for i, dim in enumerate(shape):
        entry = ps[i] if i < len(ps) else None
        if entry is None:
            out.append(None)
            continue
        axes = []
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a not in mesh.shape:
                _record_drop(label, i, a, "absent", dim, 0)
            elif a in used:
                _record_drop(label, i, a, "used", dim, mesh.shape[a])
            else:
                axes.append(a)
        size = math.prod(mesh.shape[a] for a in axes)
        if axes and size > 1 and dim % size and do_pad:
            _record_pad(label, i, tuple(axes), dim,
                        -(-dim // size) * size, size)
            used.update(axes)
            out.append(tuple(axes) if len(axes) > 1 else axes[0])
        elif not axes or size == 0 or dim % size:
            for a in axes:
                _record_drop(label, i, a, "indivisible", dim, mesh.shape[a])
            out.append(None)
        else:
            used.update(axes)
            out.append(tuple(axes) if len(axes) > 1 else axes[0])
    return PSpec(*out)


# --------------------------------------------------------------------------
# padded placement helpers
# --------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for a replicated dim)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _group_size(entry, mesh) -> int:
    return math.prod(mesh.shape[a] for a in entry_axes(entry)
                     if a in mesh.shape)


def padded_shape(ps: Sequence, shape: Sequence[int],
                 mesh=None) -> Tuple[int, ...]:
    """The ceil-division padded shape ``ps`` implies for ``shape``."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return tuple(shape)
    out = []
    for i, dim in enumerate(shape):
        entry = ps[i] if i < len(ps) else None
        if entry is None:
            out.append(dim)
            continue
        size = _group_size(entry, mesh)
        out.append(-(-dim // size) * size if size > 1 else dim)
    return tuple(out)


def pad_leaf(x, ps: Sequence, mesh=None):
    """Zero-pad ``x`` (a tensor or numpy array) to :func:`padded_shape`
    (identity when nothing pads)."""
    import numpy as np
    shape = tuple(x.shape)
    target = padded_shape(ps, shape, mesh)
    if target == shape:
        return x
    widths = [(0, t - s) for s, t in zip(shape, target)]
    if isinstance(x, np.ndarray):
        return np.pad(x, widths)
    flat = [w for pair in reversed(widths) for w in pair]
    return torch.nn.functional.pad(x, flat)


def unpad_leaf(x, true_shape: Sequence[int]):
    """Slice a padded leaf back to its true shape (identity when the
    shapes match)."""
    shape = tuple(true_shape)
    if tuple(x.shape) == shape:
        return x
    return x[tuple(slice(0, s) for s in shape)]


# --------------------------------------------------------------------------
# parameter rules (path-regex keyed, maxtext logical_axis_rules style)
# --------------------------------------------------------------------------
#
# Each rule is (compiled path regex, kind).  First match wins.
#   'replicated'  -> rank-matched (None, ...)  (excluded from FSDP too)
#   'meta'        -> ()  (quant scales / masks / bit-width LUTs)
#   'col'         -> trailing (K, N): N on 'model', FSDP candidate dim K
#   'row'         -> trailing (K, N): K on 'model', FSDP candidate dim N
# Leading (stack / bit-plane) dims are never sharded by parameter rules.

_RULES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pat), kind) for pat, kind in [
        (r"router", "replicated"),
        (r"\.(scale|mask|bitwidth)$", "meta"),
        (r"\['(k|v)_scale'\]", "meta"),
        (r"\['(ln[_a-z0-9]*|final_norm|enc_norm|shared_ln2?|"
         r"beta_[a-z]+|b[qkv]|alpha)'\]", "replicated"),
        (r"\['(wq|wk|wv|w_gate|w_up|w_in|shared_gate|shared_up|"
         r"expert_gate|expert_up|conv_pw1|lm_head|vision_proj)'\]", "col"),
        (r"\['(wo|w_down|w_out|shared_down|expert_down|conv_pw2)'\]", "row"),
        (r"\['embed'\]", "row"),
    ])


def _leaf_bytes(leaf) -> int:
    # the reference canonicalizes dtypes with x64 off: 8-byte types count
    # as their 4-byte counterparts.  A tensor or a host numpy copy (a
    # checkpoint's; bfloat16 as 2-byte void)
    try:
        return int(math.prod(leaf.shape)) * min(leaf.itemsize, 4)
    except (AttributeError, TypeError):
        return 0


def _leaf_spec(path: str, leaf, pad: Optional[bool] = None) -> PSpec:
    """The spec of one parameter leaf keyed by its keystr ``path``
    (``()`` with no active mesh or a 0-d leaf)."""
    mesh = get_mesh()
    shape = tuple(getattr(leaf, "shape", ()))
    if mesh is None or len(shape) < 1:
        return PSpec()
    kind = None
    for pat, k in _RULES:
        if pat.search(path):
            kind = k
            break
    if kind == "meta":
        return PSpec()
    rank = len(shape)
    dims: List[Any] = [None] * rank
    if kind in ("col", "row") and rank >= 2:
        model_dim = rank - 1 if kind == "col" else rank - 2
        fsdp_dim = rank - 2 if kind == "col" else rank - 1
        dims[model_dim] = "model"
        if FSDP["enabled"] and "data" in mesh.shape \
                and _leaf_bytes(leaf) >= FSDP["min_bytes"]:
            dims[fsdp_dim] = "data"
    return fit_spec(PSpec(*dims), shape, mesh, label=path, pad=pad)


def map_with_path(fn: Callable[[str, torch.Tensor], Any], tree: Any,
                  path: str = "") -> Any:
    """A tree of ``tree``'s structure with ``fn(keystr, leaf)`` at every
    tensor leaf (a quantized weight node's tensor fields included);
    non-tensor leaves pass through."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{path}[{k!r}]")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: fn(f"{path}.{f.name}", getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def _specs_tree(tree, leaf_fn):
    """Spec tree of ``tree`` with ``leaf_fn(path, leaf)`` evaluated in the
    reference's flatten order (sorted keys), so the recorded events come
    out in its order."""
    specs = {p: leaf_fn(p, x) for p, x in tensor_leaves(tree)}
    return map_with_path(lambda p, _: specs[p], tree)


def param_pspecs(params, pad: Optional[bool] = None) -> Any:
    """Tree of specs mirroring ``params`` (optimizer moments inherit their
    weight's rule, the weight's dict key being in their path too).  ``pad``
    selects padded sharding for indivisible dims (default:
    :data:`PADDED`)."""
    mesh = get_mesh()
    if mesh is None:
        return map_with_path(lambda p, x: PSpec(), params)
    return _specs_tree(params, lambda p, x: _leaf_spec(p, x, pad=pad))


# --------------------------------------------------------------------------
# batch / cache rules
# --------------------------------------------------------------------------

def batch_pspecs(batch) -> Any:
    """Shard dim 0 (the global batch) of every leaf across the data axes.
    Always fitted with ``pad=False``: a batch is placed as it is every
    tick, so an indivisible batch serves replicated."""
    mesh = get_mesh()

    def leaf(path, x):
        shape = tuple(getattr(x, "shape", ()))
        if mesh is None or not shape:
            return PSpec()
        dims: List[Any] = [None] * len(shape)
        dims[0] = _batch_entry(mesh)
        return fit_spec(PSpec(*dims), shape, mesh, label=path, pad=False)

    return _specs_tree(batch, leaf)


_DICT_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def dict_keys(path: str) -> List[str]:
    """The dict keys of a keystr path, in order (list indices and
    dataclass fields skipped, as the reference's ``DictKey`` filter)."""
    return _DICT_KEY.findall(path)


def cache_pspecs(state, batch_size: int, pad: Optional[bool] = None) -> Any:
    """Decode-state specs: the batch dim (found by ``batch_size``; a
    rank >= 4 leaf's leading stacked-layer dim never) shards on the data
    axes, and the KV-head dim of rank >= 5 (L, B, T, KV, dh) leaves on
    'model', fitted per ``pad`` (default :data:`PADDED`; the live engine
    passes False).  Paged pool leaves (under ``'pages'``) shard their page
    axis on the data axes and keep the KV-head rule; ``'table'`` block
    tables stay replicated."""
    mesh = get_mesh()

    def leaf(path, x):
        shape = tuple(getattr(x, "shape", ()))
        if mesh is None or not shape:
            return PSpec()
        dims: List[Any] = [None] * len(shape)
        keys = dict_keys(path)
        if keys and keys[-1] == "table":
            return PSpec(*dims)
        if "pages" in keys:
            dims[1] = _batch_entry(mesh)
            if len(shape) >= 5:
                dims[-2] = "model"
            return fit_spec(PSpec(*dims), shape, mesh, label=path, pad=pad)
        start = 1 if len(shape) >= 4 else 0
        for i in range(start, len(shape)):
            if shape[i] == batch_size:
                dims[i] = _batch_entry(mesh)
                break
        if len(shape) >= 5 and dims[-2] is None:
            dims[-2] = "model"
        return fit_spec(PSpec(*dims), shape, mesh, label=path, pad=pad)

    return _specs_tree(state, leaf)


def spec_leaves(specs) -> List[Tuple[str, PSpec]]:
    """(path, spec) of every spec in a spec tree, in the reference's
    flatten order."""
    out: List[Tuple[str, PSpec]] = []

    def walk(tree, path=""):
        if isinstance(tree, PSpec):
            out.append((path, tree))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}[{k!r}]")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}[{i}]")
        elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            for f in dataclasses.fields(tree):
                v = getattr(tree, f.name)
                if isinstance(v, PSpec):
                    out.append((f"{path}.{f.name}", v))
    walk(specs)
    return out
