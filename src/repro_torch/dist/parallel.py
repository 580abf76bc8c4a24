"""Local shards and the collectives that follow them: what GSPMD supplies
to the reference, written out for torch (the port's own module; the
reference has no counterpart file).

A serving run under a mesh is one program on every rank of a
``torch.distributed`` group.  :class:`Mesh` names the group's axes
(``data``, ``model``) over a ``DeviceMesh``.  Placement
(``serve.engine``) gives every rank the local shard of each deployed leaf
that its fitted spec (``dist.sharding.param_pspecs``, padded) assigns to
it, and the model's parallel paths run each weight product on that shard
through the same kernel wrappers, with these collectives around them:

* after a row-parallel product (input dim on ``model``), an all-reduce
  over ``model`` of the partial sums (:func:`all_reduce`);
* the columns a column-parallel product leaves on each rank are gathered
  over ``model`` where a consumer needs other columns than its own
  (:func:`take_cols`; vocab-sharded logits always);
* a leaf whose free dim is FSDP-sharded on ``data`` is gathered over
  ``data`` when its layer is used (ZeRO-3 unshard at use,
  :func:`gather_payload`);
* under expert parallelism each rank's experts of a d_ff-sharded expert
  stack are moved to it by one all-to-all over ``model``
  (:func:`unshard` with an expert range);
* the rows of batch-sharded logits are gathered over ``data``
  (:func:`gather_rows`), so every rank reads the same tokens and runs the
  same scheduler.

Training under a mesh (``train.step.data_parallel``) places nothing: each
rank takes its rows of the global batch (:func:`batch_rows`), and its
gradients are summed over every rank of the mesh through flat buffers
(:func:`all_reduce_tensors`); a statistic of the whole batch (the MoE
load-balancing term's means, BatchNorm's moments) is summed over the
data axes by :func:`batch_sum`, which autograd passes through; a
checkpoint's nonce and commit use :func:`broadcast_object` and
:func:`barrier`.

**The dry run** (``launch.dryrun``) runs a step for one rank of a
:class:`RecordingMesh`: the production mesh's shape and a coordinate, no
process group.  The model's parallel paths take it for a live mesh, and
each collective helper returns a tensor of its result's shape and logs
a :class:`Collective` instead of communicating; :func:`collective_log`
takes the same log from a live mesh's ranks.

**Shard windows.**  A deployed leaf's payload is blocked into weight
blocks (WBs) of ``wb_rows x wb_cols``; its per-WB scale (and bit-plane
mask) grid stays replicated.  A rank's shard along the model-sharded dim
covers element range ``[own_lo, own_hi)`` of the padded payload, which
need not start on a WB (the 9x8 geometry), nor on an int4 nibble pair or a
bit-plane byte.  The rank therefore holds the *window* ``[start, stop)``
that starts on the WB holding ``own_lo`` and ends on a WB edge past
``own_hi``, re-encoded from its own first row or column (nibble pairs and
plane bytes counted from ``start``) and zero outside ``[own_lo,
own_hi)``.  A kernel launch on the window reads the replicated grids at
the window's WB offset (``grid=`` of the wrappers), never a copy of them.
The zero rows or columns of a window add nothing to a product, so the
ranks' partial results sum (row-parallel) or concatenate
(column-parallel) to the single-device result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import batch_axes, entry_axes, get_mesh


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

class Mesh:
    """A named process mesh over a ``torch.distributed`` ``DeviceMesh``:
    ``shape`` maps each axis name to its size (what the rule layer
    reads), :meth:`group` is an axis's process group and :meth:`coord`
    this rank's index along it."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self._coords = {a: device_mesh.get_local_rank(a)
                        for a in self.axis_names}
        self._groups = {a: device_mesh.get_group(a) for a in self.axis_names}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self._coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, rank {dist.get_rank()})"


class RecordingMesh(Mesh):
    """One rank of a mesh of ``shape`` (axis name -> size), at ``coords``
    (default all zeros), with no process group: the dry run's
    (``launch.dryrun``).  It is live to the model's parallel paths
    (:func:`active_mesh`), and under it each collective helper returns a
    tensor of its result's shape (``meta`` for a ``meta`` input) without
    communicating, and records what it would have moved in
    :attr:`log`."""

    def __init__(self, shape: Dict[str, int],
                 coords: Optional[Dict[str, int]] = None):
        self.device_mesh = None
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self._coords = dict(coords or {})
        self._groups = {}
        self.log: List["Collective"] = []

    def group(self, axis: str):
        raise RuntimeError("a recording mesh has no process group")

    def __repr__(self):
        return f"RecordingMesh({self.shape}, at {self._coords})"


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as a rank issues it: ``op`` in the reference's
    vocabulary (``all-reduce``, ``all-gather``, ``all-to-all``,
    ``collective-broadcast``), the result's ``shape`` and ``dtype``, its
    ``bytes`` (the result's: what XLA's HLO count takes a device) and the
    mesh axes it spans."""
    op: str
    shape: Tuple[int, ...]
    dtype: str
    bytes: int
    axis: Tuple[str, ...]


# process-wide, not thread-local: the autograd engine runs a CUDA
# backward (a ``batch_sum``'s reduction, a checkpointed layer's
# recomputed forward) on a thread of its own; each log holds its mesh
_LOGS: List[Tuple["Mesh", List["Collective"]]] = []


@contextlib.contextmanager
def collective_log(mesh: "Mesh"):
    """Inside: every collective a helper issues on the live process mesh
    ``mesh`` is appended to the yielded list (what a
    :class:`RecordingMesh` records in its own
    :attr:`~RecordingMesh.log`).  Collectives on another mesh or group (a
    checkpoint save's, say) are not."""
    entry = (mesh, [])
    _LOGS.append(entry)
    try:
        yield entry[1]
    finally:
        _LOGS[:] = [e for e in _LOGS if e is not entry]


def _issue(mesh: Mesh, op: str, t: torch.Tensor, axis: Optional[str],
           shape: Sequence[int]) -> Optional[torch.Tensor]:
    """Log a collective of result ``shape``; under a recording mesh, the
    stand-in result (``t`` itself for the in-place all-reduce and
    broadcast), else None (the caller communicates)."""
    axes = (axis,) if axis is not None else tuple(mesh.axis_names)
    entry = Collective(op, tuple(int(d) for d in shape), str(t.dtype)
                       .replace("torch.", ""), math.prod(shape)
                       * t.element_size(), axes)
    if isinstance(mesh, RecordingMesh):
        mesh.log.append(entry)
        if op in ("all-reduce", "collective-broadcast"):
            return t
        return t.new_empty(tuple(shape)) if t.is_meta else \
            t.new_zeros(tuple(shape))
    for owner, log in _LOGS:
        if owner is mesh:
            log.append(entry)
    return None


def active_mesh() -> Optional[Mesh]:
    """The active mesh when it is a process mesh of more than one rank,
    or a :class:`RecordingMesh` standing for one (a shape-only stand-in,
    or a 1-rank mesh, runs nothing in parallel)."""
    mesh = get_mesh()
    if isinstance(mesh, Mesh) and mesh.size > 1:
        return mesh
    return None


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
#
# Over gloo, two ranks on one card included.  The helpers use
# ``all_reduce``, ``all_gather_into_tensor``, ``all_to_all_single`` and
# ``broadcast``; gloo takes them (and the list ``all_gather`` and
# ``reduce_scatter_tensor``) for host tensors in torch 2.13 and for CUDA
# tensors in torch 2.11 (``scripts/mesh_probe.py`` on the H100).

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, axis: Optional[str] = "model",
               op: str = "sum", mesh: Optional["Mesh"] = None
               ) -> torch.Tensor:
    """Reduce ``t`` (``op``: ``sum`` or ``max``) over ``axis``, or over
    every rank of the mesh with ``axis=None``, in place (identity on a
    1-rank axis or mesh).  ``mesh``: reduce over it rather than the
    active one (a mesh the caller holds while the context is
    suspended)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or (axis is not None and mesh.axis_size(axis) == 1):
        return t
    stand_in = _issue(mesh, "all-reduce", t, axis, t.shape)
    if stand_in is not None:
        return stand_in
    t = t.contiguous()
    dist.all_reduce(t, op=_OPS[op],
                    group=mesh.group(axis) if axis is not None else None)
    return t


# a flat buffer's bytes in :func:`all_reduce_tensors`: a few buffers a
# step at full width (phi3 at 2 layers: ~1.3 GB of f32 gradients)
BUCKET_BYTES = 256 << 20


def all_reduce_tensors(ts: Sequence[torch.Tensor], scale: float = 1.0
                       ) -> None:
    """Sum every tensor of ``ts`` over every rank of the mesh, in place,
    each rank's values multiplied by ``scale`` first: through flat
    buffers, one a (dtype, device), each cut into buckets of at most
    :data:`BUCKET_BYTES` (a few collectives, not one a tensor)."""
    mesh = active_mesh()
    if mesh is None:
        if scale != 1.0:
            for t in ts:
                t.mul_(scale)
        return
    groups: Dict[Tuple[Any, Any], List[torch.Tensor]] = {}
    for t in ts:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        bucket: List[torch.Tensor] = []
        size = 0
        for i, t in enumerate(group):
            bucket.append(t)
            size += t.numel() * t.element_size()
            if size >= BUCKET_BYTES or i == len(group) - 1:
                flat = torch.cat([b.reshape(-1) for b in bucket])
                if scale != 1.0:
                    flat.mul_(scale)
                all_reduce(flat, axis=None)
                off = 0
                for b in bucket:
                    b.copy_(flat[off:off + b.numel()].view_as(b))
                    off += b.numel()
                bucket, size = [], 0


# --------------------------------------------------------------------------
# statistics of the whole batch under a data-split batch
# --------------------------------------------------------------------------
#
# The data-parallel step (``train.step.data_parallel``) runs each rank's
# rows with the mesh suspended and then scales the rank's gradients by
# its share ``w`` of the batch's label count before summing them.  A loss
# term built from a statistic of the whole batch (the MoE load-balancing
# term's means, BatchNorm's moments) reads that statistic through
# :func:`batch_sum`: its forward sums a rank's partial statistic over the
# data axes, and its backward sums the ranks' incoming gradients weighted
# by their shares over this rank's share, so that after the step's
# scaling each rank's rows carry the whole-batch gradient.

# process-wide, not thread-local: a checkpointed layer's forward is
# recomputed in the backward, which the autograd engine runs on a thread
# of its own for CUDA tensors, and must take the same path
_SPLIT: List[Optional[Tuple["Mesh", float]]] = [None]


@contextlib.contextmanager
def batch_split(mesh: "Mesh", share: float):
    """Inside: the batch is split over ``mesh``'s data axes and this rank
    holds ``share`` of its label count (what :func:`batch_sum` reads)."""
    prev = _SPLIT[0]
    _SPLIT[0] = (mesh, share) if batch_group_size(mesh) > 1 else None
    try:
        yield
    finally:
        _SPLIT[0] = prev


def split_mesh() -> Optional["Mesh"]:
    """The mesh whose data axes split the batch, inside
    :func:`batch_split` (None outside it)."""
    return _SPLIT[0][0] if _SPLIT[0] is not None else None


def reduce_batch_axes(t: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
    """Sum ``t`` over ``mesh``'s data axes (``pod`` x ``data``: one
    all-reduce an axis), in place."""
    for a in batch_axes(mesh):
        t = all_reduce(t, a, mesh=mesh)
    return t


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, share):
        ctx.mesh, ctx.share = mesh, share
        return reduce_batch_axes(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        g = reduce_batch_axes(g * ctx.share, ctx.mesh)
        return (g / ctx.share if ctx.share else torch.zeros_like(g)), \
            None, None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """A rank's partial sum over its rows -> the whole batch's, under
    :func:`batch_split` (``t`` itself outside it), differentiable.  Exact
    when every data rank holds rows with labels (a share of 0 would take
    the rank's rows out of the step's gradient)."""
    if _SPLIT[0] is None:
        return t
    return _BatchSum.apply(t, *_SPLIT[0])


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (default: the whole world)."""
    dist.barrier(group=group)


def broadcast_object(obj: Any, group=None) -> Any:
    """Rank 0's ``obj`` (of ``group``; a small picklable value: a step
    number, a nonce) on every rank of ``group``."""
    box = [obj]
    dist.broadcast_object_list(
        box, src=0 if group is None else dist.get_global_rank(group, 0),
        group=group)
    return box[0]


def all_gather(t: torch.Tensor, axis: str) -> List[torch.Tensor]:
    """Every rank's ``t`` along ``axis`` (equal shapes), in coord order:
    one flat buffer (``all_gather_into_tensor``: half the time of the
    list form at 6 MB over gloo on the H100, the same at 48 MB:
    ``chip_smoke.mesh_collectives``), viewed per rank."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size(axis) == 1:
        return [t]
    n = mesh.axis_size(axis)
    stand_in = _issue(mesh, "all-gather", t, axis, (n, *t.shape))
    if stand_in is not None:
        return list(stand_in.unbind(0))
    t = t.contiguous()
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1), group=mesh.group(axis))
    return list(out.view(n, *t.shape).unbind(0))


def all_to_all(t: torch.Tensor, axis: str) -> List[torch.Tensor]:
    """Chunk ``j`` of ``t``'s leading dim (split evenly) to the rank at
    coord ``j`` of ``axis``; returns the chunk each rank sent here, in
    coord order (``all_to_all_single``)."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size(axis) == 1:
        return [t]
    n = mesh.axis_size(axis)
    out = _issue(mesh, "all-to-all", t, axis, t.shape)
    if out is None:
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=mesh.group(axis))
    return list(out.view(n, t.shape[0] // n, *t.shape[1:]).unbind(0))


def broadcast(t: torch.Tensor, axis: str, src_coord: int) -> torch.Tensor:
    """``t`` of the rank at ``src_coord`` along ``axis``, on every rank of
    this rank's ``axis`` group (in place)."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size(axis) == 1:
        return t
    stand_in = _issue(mesh, "collective-broadcast", t, axis, t.shape)
    if stand_in is not None:
        return stand_in
    group = mesh.group(axis)
    src = dist.get_process_group_ranks(group)[src_coord]
    t = t.contiguous()
    dist.broadcast(t, src=src, group=group)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Batch rows sharded on ``data`` -> every row on every rank (what the
    host reads: the logits)."""
    return torch.cat(all_gather(t, "data"), dim=0)


# --------------------------------------------------------------------------
# the batch over the data axes
# --------------------------------------------------------------------------

def batch_group_size(mesh) -> int:
    """Ranks along the data axes (``pod`` x ``data``): the batch's
    parallel copies."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def batch_coord(mesh) -> int:
    """This rank's index along the data axes (pod-major)."""
    idx = 0
    for a in batch_axes(mesh):
        idx = idx * mesh.axis_size(a) + mesh.coord(a)
    return idx


def batch_rows(n_rows: int, mesh) -> List[Tuple[int, int]]:
    """The rows ``[lo, hi)`` of a global batch of ``n_rows`` that each
    data-axes coordinate holds (:func:`batch_coord` order), as the
    reference places a batch (``batch_pspecs``: dim 0 on the data axes,
    fitted with ``pad=False``): equal contiguous chunks when the axes'
    size divides ``n_rows``; else the fit drops the axes and every
    coordinate holds the whole batch."""
    n = batch_group_size(mesh)
    if n_rows % n:
        return [(0, n_rows)] * n
    c = n_rows // n
    return [(i * c, (i + 1) * c) for i in range(n)]


# --------------------------------------------------------------------------
# shard geometry
# --------------------------------------------------------------------------

def even_ranges(n_padded: int, parts: int, true_n: int
                ) -> Tuple[Tuple[int, int], ...]:
    """The ceil-division shards of a dim padded to ``n_padded`` over
    ``parts`` ranks, clipped to its ``true_n`` elements."""
    c = n_padded // parts
    return tuple((min(r * c, true_n), min((r + 1) * c, true_n))
                 for r in range(parts))


@dataclasses.dataclass(frozen=True)
class LocalShard:
    """Where a rank's piece of a deployed leaf (or of a plain tensor) lies.

    ``kind``: ``col`` (the output dim on ``model``), ``row`` (the input
    dim on ``model``) or ``none`` (whole along both, only FSDP on
    ``data``).  Along the model-sharded dim, in elements: ``own`` the range
    this rank owns (clipped to the true size), ``ranges`` every model
    rank's, ``window`` the held ``[start, stop)`` (``start`` on a WB
    edge), ``grid0`` its WB offset, ``windows`` every rank's and ``full``
    the dim's unsharded length.  ``data``: (field, dim, length) of
    each payload field whose free dim is split over ``data``, gathered
    back to ``length`` at use."""
    kind: str
    own: Tuple[int, int] = (0, 0)
    ranges: Tuple[Tuple[int, int], ...] = ()
    window: Tuple[int, int] = (0, 0)
    grid0: int = 0
    data: Tuple[Tuple[str, int, int], ...] = ()
    windows: Tuple[Tuple[int, int], ...] = ()   # every model rank's
    full: int = 0          # elements of the model-sharded dim unsharded


@dataclasses.dataclass
class ShardedTensor:
    """A plain tensor's local shard (the embedding, an unquantized LM
    head): ``t`` holds rows (``row``) or columns (``col``) ``window`` of the
    padded tensor, zero past its true size."""
    t: torch.Tensor
    shard: LocalShard
    shape: Tuple[int, ...]          # the true global shape


def _model_dim_kind(ps: Sequence, rank: int) -> Optional[str]:
    """``col`` / ``row`` when the fitted spec puts ``model`` on the last
    / second-to-last dim."""
    if rank >= 1 and "model" in entry_axes(ps[rank - 1] if len(ps) >= rank
                                           else None):
        return "col"
    if rank >= 2 and len(ps) >= rank - 1 and \
            "model" in entry_axes(ps[rank - 2]):
        return "row"
    return None


def _data_dim(ps: Sequence, rank: int) -> Optional[int]:
    """The payload dim (negative) whose spec entry holds ``data``."""
    for i, entry in enumerate(ps):
        if "data" in entry_axes(entry):
            return i - rank
    return None


def _unit(field: str, node: Any) -> int:
    """Elements of the blocked dim in one payload row along K: 1 (int8
    rows, plain tensors), 2 (int4 nibble pairs) or 8 (plane bytes)."""
    if field in ("planes", "sign"):
        return 8
    if field == "w_int" and getattr(node, "bits", 8) == 4:
        return 2
    return 1


def _unpack_rows(p: torch.Tensor, unit: int) -> torch.Tensor:
    """Payload rows (dim -2) -> one row an element of K."""
    if unit == 1:
        return p
    if unit == 2:
        from ..core.quantize import unpack_int4
        return unpack_int4(p, axis=-2).to(torch.int8)
    from ..kernels.ref import unpack_bits_u8
    return unpack_bits_u8(p)


def _pack_rows(q: torch.Tensor, unit: int) -> torch.Tensor:
    """Inverse of :func:`_unpack_rows`; pads K to a multiple of ``unit``."""
    if unit == 1:
        return q.contiguous()
    k = q.shape[-2]
    pad = -k % unit
    if pad:
        q = torch.cat([q, q.new_zeros((*q.shape[:-2], pad, q.shape[-1]))],
                      dim=-2)
    if unit == 2:
        from ..core.quantize import pack_int4
        return pack_int4(q, axis=-2).contiguous()
    from ..kernels.ref import pack_bits
    return pack_bits(q).contiguous()


def _window_rows(p: torch.Tensor, unit: int, start: int, stop: int,
                 own: Tuple[int, int]) -> torch.Tensor:
    """Rows [start, stop) of payload ``p`` (in elements of K), zero
    outside ``own``, re-encoded from ``start``."""
    q = _unpack_rows(p, unit)
    k = q.shape[-2]
    w = q[..., start:min(stop, k), :].clone()
    if w.shape[-2] < stop - start:
        w = torch.cat([w, w.new_zeros((*w.shape[:-2], stop - start
                                       - w.shape[-2], w.shape[-1]))], -2)
    rows = torch.arange(start, stop, device=w.device)
    keep = (rows >= own[0]) & (rows < own[1])
    w = w * keep[:, None].to(w.dtype)
    return _pack_rows(w, unit)


def _window_cols(p: torch.Tensor, start: int, stop: int,
                 own: Tuple[int, int]) -> torch.Tensor:
    """Columns [start, stop) of ``p``, zero outside ``own``."""
    w = p[..., start:min(stop, p.shape[-1])].clone()
    if w.shape[-1] < stop - start:
        w = torch.cat([w, w.new_zeros((*w.shape[:-1],
                                       stop - start - w.shape[-1]))], -1)
    cols = torch.arange(start, stop, device=w.device)
    keep = (cols >= own[0]) & (cols < own[1])
    return (w * keep.to(w.dtype)).contiguous()


def _split_data(t: torch.Tensor, dim: int, parts: int,
                coord: int) -> torch.Tensor:
    """This data rank's ceil-division chunk of ``t`` along ``dim``."""
    n = t.shape[dim]
    c = -(-n // parts)
    pad = c * parts - n
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim=dim)
    return t.narrow(dim, coord * c, c).contiguous()


def _window(lo: int, hi: int, wb: int, n: int) -> Tuple[int, int]:
    """The WB-aligned window [start, stop) around [lo, hi) within n."""
    start = (lo // wb) * wb
    stop = min(-(-hi // wb) * wb, n) if hi > lo else start
    return start, stop


def deployed_shard(node: Any, specs: Dict[str, Sequence], mesh: Mesh):
    """The local shard of a deployed leaf (``ServingWeight`` /
    ``BitplaneServingWeight``) under its fitted padded ``specs`` (field
    -> spec): payload windows on ``model``, FSDP chunks on ``data``,
    metadata whole.  Returns the node with ``shard`` set."""
    payload = ("planes", "sign") if hasattr(node, "planes") else ("w_int",)
    main = getattr(node, payload[0])
    ps = specs[payload[0]]
    rank = main.ndim
    kind = _model_dim_kind(ps, rank) if mesh.axis_size("model") > 1 \
        else None
    m, r = mesh.axis_size("model"), mesh.coord("model")
    wbr, wbc = node.spec.wb_rows, node.spec.wb_cols
    new = {}
    shard = LocalShard(kind="none")
    if kind == "col":
        n_pay = main.shape[-1]
        c = -(-n_pay // m)
        pads = [(min(i * c, n_pay), min((i + 1) * c, n_pay))
                for i in range(m)]
        wins = tuple(_window(lo, hi, wbc, n_pay) for lo, hi in pads)
        start, stop = wins[r]
        for f in payload:
            new[f] = _window_cols(getattr(node, f), start, stop, pads[r])
        ranges = even_ranges(c * m, m, node.shape[-1])
        shard = LocalShard(kind="col", own=ranges[r], ranges=ranges,
                           window=wins[r], grid0=start // wbc,
                           windows=wins, full=n_pay)
    elif kind == "row":
        unit = _unit(payload[0], node)
        kp = node.scale.shape[-2] * wbr
        c = -(-main.shape[-2] // m) * unit
        pads = [(min(i * c, kp), min((i + 1) * c, kp)) for i in range(m)]
        wins = tuple(_window(lo, hi, wbr, kp) for lo, hi in pads)
        start, stop = wins[r]
        for f in payload:
            new[f] = _window_rows(getattr(node, f), _unit(f, node), start,
                                  stop, pads[r])
        ranges = tuple((min(lo, node.shape[-2]), min(hi, node.shape[-2]))
                       for lo, hi in pads)
        shard = LocalShard(kind="row", own=ranges[r], ranges=ranges,
                           window=wins[r], grid0=start // wbr,
                           windows=wins, full=kp)
    else:
        for f in payload:
            new[f] = getattr(node, f)
    data = []
    d, q = mesh.axis_size("data"), mesh.coord("data")
    for f in payload:
        dd = _data_dim(specs[f], getattr(node, f).ndim)
        if dd is not None and d > 1:
            data.append((f, dd, new[f].shape[dd]))
            new[f] = _split_data(new[f], dd, d, q)
    shard = dataclasses.replace(shard, data=tuple(data))
    from ..serve.deploy import (ShardedBitplaneServingWeight,
                                ShardedServingWeight)
    cls = ShardedBitplaneServingWeight if hasattr(node, "planes") \
        else ShardedServingWeight
    fields = {f.name: getattr(node, f.name) for f in dataclasses.fields(node)}
    return cls(**dict(fields, **new, shard=shard))


def tensor_shard(t: torch.Tensor, ps: Sequence, mesh: Mesh,
                 kind: str) -> ShardedTensor:
    """The local shard of a plain 2-D tensor whose spec puts ``model`` on
    its rows (``row``: the embedding's vocab) or columns (``col``: an
    unquantized LM head's vocab), plus its FSDP chunk on ``data``."""
    m, r = mesh.axis_size("model"), mesh.coord("model")
    dim = -2 if kind == "row" else -1
    n = t.shape[dim]
    c = -(-n // m)
    ranges = even_ranges(c * m, m, n)
    start, stop = r * c, (r + 1) * c
    if kind == "row":
        loc = _window_rows(t, 1, start, stop, ranges[r])
    else:
        loc = _window_cols(t, start, stop, ranges[r])
    data = ()
    dd = _data_dim(ps, t.ndim)
    if dd is not None and mesh.axis_size("data") > 1:
        data = (("t", dd, loc.shape[dd]),)
        loc = _split_data(loc, dd, mesh.axis_size("data"), mesh.coord("data"))
    shard = LocalShard(kind=kind, own=ranges[r], ranges=ranges,
                       window=(start, stop), grid0=0, data=data)
    return ShardedTensor(t=loc, shard=shard, shape=tuple(t.shape))


def unshard(node: Any, experts: Optional[Tuple[int, int]] = None) -> Any:
    """A sharded deployed leaf made whole again on every rank: its layer's
    FSDP chunks gathered over ``data``, its windows over ``model`` laid
    back at their offsets (each zero outside what its rank owns, so they
    add up to the payload bit for bit).

    ``experts=(e0, n)``, on an (E, K, N) expert stack with ``n`` experts
    a model rank: only experts ``[e0, e0 + n)`` (this rank's under expert
    parallelism) are made whole, each model rank's windows of them moved
    here by one all-to-all over ``model``.  Every rank calls it, each
    with its own range."""
    pay = gather_payload(node)
    sh = node.shard
    if experts is not None:
        e0, n = experts
    if sh.kind not in ("col", "row"):
        if experts is not None:
            pay = {f: t.narrow(0, e0, n) for f, t in pay.items()}
        return _whole(node, pay, experts)
    dim = -1 if sh.kind == "col" else -2
    full = {}
    for f, t in pay.items():
        unit = _unit(f, node) if sh.kind == "row" else 1
        # payload rows (cols) of the widest window, every rank's padded
        # to it so that the exchange is of equal shapes
        width = max(-(-(b - a) // unit) for a, b in sh.windows)
        if t.shape[dim] < width:
            shape = list(t.shape)
            shape[dim] = width - t.shape[dim]
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
        parts = all_gather(t, "model") if experts is None \
            else all_to_all(t, "model")
        out = None
        for part, (a, b) in zip(parts, sh.windows):
            part = _unpack_rows(part, unit)
            if out is None:
                shape = list(part.shape)
                shape[dim] = sh.full
                out = part.new_zeros(shape)
            out.narrow(dim, a, b - a).add_(part.narrow(dim, 0, b - a))
        full[f] = _pack_rows(out, unit)
    return _whole(node, full, experts)


def _whole(node: Any, payload: Dict[str, torch.Tensor],
           experts: Optional[Tuple[int, int]] = None) -> Any:
    """The unsharded deployed leaf of a shard's fields and ``payload``;
    with ``experts=(e0, n)``, of those experts' metadata."""
    from ..serve.deploy import BitplaneServingWeight, ServingWeight
    cls = BitplaneServingWeight if hasattr(node, "planes") \
        else ServingWeight
    fields = {f.name: getattr(node, f.name) for f in dataclasses.fields(cls)}
    if experts is not None:
        e0, n = experts
        for f in ("scale", "mask"):
            if f in fields:
                fields[f] = fields[f].narrow(0, e0, n)
        fields["shape"] = (*node.shape[:-3], n, *node.shape[-2:])
    return cls(**dict(fields, **payload))


def gather_payload(node: Any) -> Dict[str, torch.Tensor]:
    """The model-local payload of a sharded node's layer, its FSDP chunks
    gathered over ``data`` (ZeRO-3 unshard at use): field -> tensor."""
    out = {}
    data = {f: (dim, n) for f, dim, n in node.shard.data}
    fields = ("t",) if isinstance(node, ShardedTensor) else \
        (("planes", "sign") if hasattr(node, "planes") else ("w_int",))
    for f in fields:
        t = getattr(node, f)
        if f in data:
            dim, n = data[f]
            t = torch.cat(all_gather(t, "data"), dim=dim)
            t = t.narrow(dim, 0, n).contiguous()
        out[f] = t
    return out


# --------------------------------------------------------------------------
# activations split by columns
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Cols:
    """Columns ``[lo, hi)`` of a width-``n`` activation on this rank;
    ``ranges`` holds every model rank's (None: the whole activation on
    every rank)."""
    t: torch.Tensor
    lo: int
    hi: int
    n: int
    ranges: Optional[Tuple[Tuple[int, int], ...]] = None

    @classmethod
    def whole(cls, t: torch.Tensor) -> "Cols":
        return cls(t, 0, t.shape[-1], t.shape[-1])

    @property
    def wants(self) -> Tuple[Tuple[int, int], ...]:
        """Every model rank's columns, as :func:`take_cols` takes them."""
        return self.ranges or ((self.lo, self.hi),)


def gather_cols(c: Cols) -> torch.Tensor:
    """The whole activation from every model rank's columns (an
    all-gather over ``model`` of pieces padded to one width)."""
    if c.ranges is None:
        return c.t
    width = max(hi - lo for lo, hi in c.ranges)
    t = c.t
    if t.shape[-1] < width:
        t = torch.cat([t, t.new_zeros((*t.shape[:-1],
                                       width - t.shape[-1]))], -1)
    parts = all_gather(t, "model")
    return torch.cat([p[..., :hi - lo] for p, (lo, hi)
                      in zip(parts, c.ranges)], dim=-1)


def take_cols(c: Cols, wants: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """This rank's columns ``wants[rank]`` of the activation (zero past
    its width), where ``wants`` names every model rank's: a slice of the
    rank's own columns when every rank's own cover its want, else of the
    gathered whole (the same choice on every rank, so the gather is
    collective)."""
    mesh = active_mesh()
    r = mesh.coord("model") if mesh is not None else 0
    lo, hi = wants[r] if len(wants) > 1 else wants[0]
    haves = c.ranges or ((c.lo, c.hi),) * len(wants)
    local = all(a <= w0 and min(w1, c.n) <= b
                for (a, b), (w0, w1) in zip(haves, wants))
    if local:
        t = c.t[..., lo - c.lo:min(hi, c.n) - c.lo]
    else:
        t = gather_cols(c)[..., lo:min(hi, c.n)]
    if t.shape[-1] < hi - lo:
        t = torch.cat([t, t.new_zeros((*t.shape[:-1],
                                       hi - lo - t.shape[-1]))], -1)
    return t


def local_cols(width: int, shards: int = 1) -> Cols:
    """An empty :class:`Cols` naming this rank's ``width`` columns of a
    ``width x shards``-wide activation split evenly over ``model`` (the
    local heads of a placed config: ``width`` = local heads x d_head,
    ``shards`` its ``head_shards``); the whole ``width`` with one
    shard."""
    if shards == 1:
        return Cols(None, 0, width, width)
    mesh = active_mesh()
    if mesh is None or mesh.axis_size("model") != shards:
        raise RuntimeError(
            f"a config whose heads are split {shards} ways runs under a "
            f"mesh of {shards} model ranks, got {mesh!r}")
    r = mesh.coord("model")
    ranges = tuple((i * width, (i + 1) * width) for i in range(shards))
    return Cols(None, r * width, (r + 1) * width, width * shards, ranges)
