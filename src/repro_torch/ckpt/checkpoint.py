"""Crash-safe checkpoints in the reference's on-disk format 2 (port of
``repro.ckpt.checkpoint``).

Layout::

    <dir>/step_<N>/
        META                          # JSON: manifest + mesh + extra
        shard_00000-of-0000M.npz      # one file per (emulated) host

META records, per leaf, its ``jax.tree_util.keystr`` path, the sanitized
npz key, the true shape, the dtype name and the spec entries, and the
saving mesh's axis sizes; a leaf is reassembled from the shard chunks
its spec assigns to each host, so a save restores under any other mesh
or none (elastic restore).  Legacy (format 1, ``arrays.npz``) saves are
read too.

**Sharded saves.**  With ``mesh``, every leaf is chunked by its fitted
spec (``pad=False``: the chunks tile the true array) — the parameter
rules of ``dist.sharding`` keyed by the leaf's path unless ``specs``
names them — and each chunk lands in the shard file of the host that
owns it, one file a coordinate over the mesh axes any leaf uses.  Under
a shape-only mesh (anything with ``.shape``: ``ShapeOnlyMesh``) one
process writes every host's file, as the reference emulates a fleet.
Under a live process mesh (``dist.parallel.Mesh``) every rank holds the
whole tree and writes the files of the hosts whose coordinates are its
own on the used axes (0 on the others); rank 0 then writes META and
commits.  Restore gives every rank whole leaves (the reference places
them by ``param_pspecs`` instead: a recorded divergence, the values are
the same).

Leaf paths are the reference's: dict keys in sorted order, list indices,
and a dataclass node's data fields (``.w``, ``.planes``) — so a tree the
port saves restores in the reference and the other way round.  A
``TrainState`` saves its ``step`` (a Python ``int`` in the port) as the
reference's 0-d int32 leaf ``.step``.  bfloat16 tensors are stored as
2-byte void (``V2``) with META dtype ``"bfloat16"``, as the reference's
``np.savez`` of an ``ml_dtypes`` array writes them, and read back by that
name (no ``ml_dtypes`` needed).

Commit protocol (crash-safe at every point): write into a unique
``<path>.tmp.<nonce>``, fsync every file and the directory, move an
existing ``<path>`` aside to ``<path>.old.<nonce>``, rename the tmp dir
in, fsync the parent, and only then delete the old copy.  Under a live
mesh the nonce is rank 0's, every rank fsyncs its own files, and after a
barrier rank 0 alone writes META and commits; a second barrier holds
every rank until the step is live.
``CheckpointManager._gc`` sweeps stale ``.tmp.*`` / ``.old.*`` debris.

Restore maps saved arrays onto a template tree by path; a disagreement
raises :class:`CheckpointMismatchError` unless ``partial=True``.  Static
structure (blocking specs, shapes, bit counts) comes from the template.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

CKPT_FORMAT = 2
_BF16 = "bfloat16"


def _ckpt_int(f: dataclasses.Field) -> bool:
    """A dataclass ``int`` field saved as a 0-d int32 leaf (TrainState's
    ``step``), marked ``metadata={"ckpt": "int32"}``."""
    return f.metadata.get("ckpt") == "int32"


def _data_field(node, f: dataclasses.Field) -> bool:
    v = getattr(node, f.name)
    return _ckpt_int(f) or isinstance(
        v, (torch.Tensor, np.ndarray, dict, list, tuple)) or (
        dataclasses.is_dataclass(v) and not isinstance(v, type))


def iter_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) for every array leaf of a tree, in the
    reference's flatten order.  A dataclass without array fields (a CNN
    ``ConvMeta``) and any other non-array value are static: no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if _data_field(tree, f):
                v = getattr(tree, f.name)
                if _ckpt_int(f):
                    yield f"{path}.{f.name}", np.asarray(v, np.int32)
                else:
                    yield from iter_leaves(v, f"{path}.{f.name}")
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield path, tree


def map_leaves(fn, tree: Any, path: str = "") -> Any:
    """The tree with ``fn(path, leaf)`` at every leaf :func:`iter_leaves`
    visits (an int32-marked field gets its ``int``); static values are
    kept."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        upd = {}
        for f in dataclasses.fields(tree):
            if not _data_field(tree, f):
                continue
            v = getattr(tree, f.name)
            upd[f.name] = fn(f"{path}.{f.name}", v) if _ckpt_int(f) \
                else map_leaves(fn, v, f"{path}.{f.name}")
        return dataclasses.replace(tree, **upd)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(path, tree)
    return tree


def _sanitize(key: str) -> str:
    """Collision-free npz key: every char outside [A-Za-z0-9.] becomes
    ``_xx`` (two hex digits), and ``_`` itself escapes to ``_5f``."""
    return re.sub(r"[^A-Za-z0-9.]",
                  lambda m: f"_{ord(m.group(0)):02x}", key)


def to_host(x) -> Tuple[np.ndarray, str]:
    """A leaf as (a host numpy copy, its dtype name).  A bfloat16 tensor
    becomes a 2-byte void array named ``"bfloat16"``.  Always a copy: the
    optimizers update their tensors in place, so a save must not keep
    views of them."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            a = x.view(torch.int16).to("cpu", copy=True).numpy()
            return a.view(np.dtype("V2")), _BF16
        return x.to("cpu", copy=True).numpy(), str(x.dtype).removeprefix(
            "torch.")
    a = np.array(x, copy=True)
    return a, str(a.dtype)


def _storage_dtype(name: str) -> np.dtype:
    return np.dtype("V2") if name == _BF16 else np.dtype(name)


def to_tensor(arr: np.ndarray, dtype_name: Optional[str] = None,
              device=None) -> torch.Tensor:
    """A stored array as a tensor; a 2-byte void array (or any array
    named ``"bfloat16"``) becomes bfloat16, bit for bit."""
    # ascontiguousarray makes a 0-d array 1-d: keep the shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype_name == _BF16 or (arr.dtype.kind == "V" and arr.itemsize == 2):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_file(name: str) -> None:
    fd = os.open(name, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(tmp: str) -> None:
    for name in os.listdir(tmp):
        _fsync_file(os.path.join(tmp, name))
    _fsync_dir(tmp)


def _commit_dir(tmp: str, path: str) -> None:
    """Atomically make ``tmp`` live at ``path`` (see module docstring)."""
    old = None
    if os.path.exists(path):
        old = f"{path}.old.{uuid.uuid4().hex[:8]}"
        os.rename(path, old)
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _chunk_slices(shape: Sequence[int], entries: List[Any],
                  mesh_axes: Dict[str, int],
                  coords: Dict[str, int]) -> Optional[Tuple[slice, ...]]:
    """The sub-slice of a leaf that the host at ``coords`` owns, or None
    when another host owns the (replicated-dim) copy: the host whose
    coordinates are 0 on every axis the leaf does not shard over writes
    the chunk; sharded dims index by the host's coordinates."""
    sl: List[slice] = []
    used: set = set()
    for dim, entry in zip(shape, entries):
        if not entry:
            sl.append(slice(None))
            continue
        size = 1
        idx = 0
        for a in entry:
            idx = idx * mesh_axes[a] + coords[a]
            size *= mesh_axes[a]
            used.add(a)
        step = dim // size
        sl.append(slice(idx * step, (idx + 1) * step))
    for a, c in coords.items():
        if a not in used and c != 0:
            return None
    return tuple(sl)


class HostTree(dict):
    """Leaves already copied to the host: keystr path -> (array, dtype
    name), in flatten order (what :meth:`CheckpointManager.save` hands its
    writer thread)."""

    @classmethod
    def of(cls, tree: Any) -> "HostTree":
        if isinstance(tree, HostTree):
            return tree
        return cls((k, to_host(v)) for k, v in iter_leaves(tree))


# --------------------------------------------------------------------------
# sharded layout
# --------------------------------------------------------------------------

def _spec_entries(ps) -> List[Any]:
    """JSON-able spec: one entry a dim, None or a list of axis names."""
    out: List[Any] = []
    for entry in tuple(ps):
        if entry is None:
            out.append(None)
        else:
            out.append(list(entry) if isinstance(entry, tuple)
                       else [entry])
    return out


def _leaf_specs(flat: "HostTree", mesh, specs) -> Dict[str, List[Any]]:
    """Fitted, divisible (``pad=False``) spec entries per leaf path: a
    padded placement still saves its true array, which is what elastic
    restore wants.  ``specs`` (a spec tree) overrides the parameter rules,
    which key every leaf of a ``TrainState`` by its path (``.params…``,
    ``.opt_state…``; the 0-d ``.step`` and ``.alpha`` replicated).

    One entry a dim, always: the rules' replicated quantization metadata
    (``.scale``, ``.mask``, ``.bitwidth``) is ``[None] * rank``, where the
    reference writes ``[]``, which its own ``validate_checkpoint`` rejects
    (CK1, and CK2 for the whole chunk) though both readers assemble the
    same leaf from either."""
    from ..dist.sharding import _leaf_spec, fit_spec, spec_leaves, use_mesh
    if mesh is None:
        return {k: [None] * v.ndim for k, (v, _) in flat.items()}
    if specs is None:
        with use_mesh(mesh):
            out = {k: _spec_entries(_leaf_spec(k, v, pad=False))
                   for k, (v, _) in flat.items()}
        return {k: e + [None] * (flat[k][0].ndim - len(e))
                for k, e in out.items()}
    spec_flat = dict(spec_leaves(specs))
    out = {}
    for k, (v, _) in flat.items():
        ps = spec_flat.get(k)
        out[k] = [None] * v.ndim if ps is None else _spec_entries(
            fit_spec(ps, v.shape, mesh, label=k, pad=False))
    return out


def _used_axes(leaf_specs: Dict[str, List[Any]]) -> List[str]:
    axes: List[str] = []
    for entries in leaf_specs.values():
        for entry in entries:
            for a in entry or ():
                if a not in axes:
                    axes.append(a)
    return sorted(axes)


def _host_grid(mesh_axes: Dict[str, int],
               axes: Sequence[str]) -> List[Dict[str, int]]:
    """One host per coordinate tuple over ``axes`` (the mesh axes any
    leaf spec uses), the last axis fastest."""
    hosts: List[Dict[str, int]] = [{}]
    for a in axes:
        hosts = [dict(h, **{a: i}) for h in hosts
                 for i in range(mesh_axes.get(a, 1))]
    return hosts


def _live(mesh) -> bool:
    """A process mesh whose ranks each run this call."""
    from ..dist.parallel import Mesh
    return isinstance(mesh, Mesh) and torch.distributed.is_initialized()


def _writes(mesh, coords: Dict[str, int]) -> bool:
    """Whether this rank of a live ``mesh`` writes the host at ``coords``:
    its coordinates there on the used axes, 0 on the others (one writer
    a host)."""
    return all(mesh.coord(a) == coords.get(a, 0) for a in mesh.axis_names)


def save_tree(tree: Any, path: str, extra_meta: Optional[Dict] = None,
              mesh=None, specs: Any = None, group=None) -> None:
    """Atomic sharded write of all array leaves of ``tree`` to ``path``.

    With no ``mesh``, one shard file.  With one, every leaf is chunked by
    its fitted spec (``specs``, a spec tree, overrides the parameter
    rules) into the shard file of the host that owns the chunk; META
    carries the spec and mesh-shape metadata that makes restore
    topology-independent.  Under a live process mesh every rank of it
    calls this with the same tree; the nonce, the barriers and the
    commit run over ``group`` (default: the whole world)."""
    from ..dist.parallel import barrier, broadcast_object
    flat = HostTree.of(tree)
    mesh_axes = {a: int(n) for a, n in dict(
        getattr(mesh, "shape", {}) or {}).items()} if mesh is not None \
        else {}
    leaf_specs = _leaf_specs(flat, mesh, specs)
    axes = _used_axes(leaf_specs)
    hosts = _host_grid(mesh_axes, axes)
    n = len(hosts)
    live = _live(mesh)
    rank0 = not live or torch.distributed.get_rank(group) == 0

    manifest: Dict[str, Dict[str, Any]] = {}
    seen: Dict[str, str] = {}
    for k, (v, dtype) in flat.items():
        sk = _sanitize(k)
        if sk in seen:
            raise ValueError(
                f"sanitized key collision: {k!r} and {seen[sk]!r} both "
                f"map to {sk!r}")
        seen[sk] = k
        manifest[k] = {"key": sk, "shape": list(v.shape), "dtype": dtype,
                       "spec": leaf_specs[k]}
    nonce = uuid.uuid4().hex[:8]
    if live:
        nonce = broadcast_object(nonce, group)
    tmp = f"{path}.tmp.{nonce}"
    os.makedirs(tmp, exist_ok=True)
    written = []
    for h, coords in enumerate(hosts):
        if live and not _writes(mesh, coords):
            continue
        arrays = {}
        for k, (v, _) in flat.items():
            sl = _chunk_slices(v.shape, leaf_specs[k], mesh_axes, coords)
            if sl is not None:
                arrays[manifest[k]["key"]] = v[sl]
        name = os.path.join(tmp, f"shard_{h:05d}-of-{n:05d}.npz")
        np.savez(name, **arrays)
        written.append(name)
    if live:
        for name in written:
            _fsync_file(name)
        barrier(group)
    if rank0:
        with open(os.path.join(tmp, "META"), "w") as f:
            json.dump({"format": CKPT_FORMAT, "manifest": manifest,
                       "mesh_axes": mesh_axes, "shard_axes": axes,
                       "n_shards": n,
                       "hosts": [[hst.get(a, 0) for a in axes]
                                 for hst in hosts],
                       "extra": extra_meta or {}}, f)
        _fsync_tree(tmp)
        _commit_dir(tmp, path)
    if live:
        barrier(group)


class CheckpointMismatchError(ValueError):
    """Template and checkpoint manifest disagree on the set of leaves.

    ``missing`` — template keys the checkpoint does not hold;
    ``extra`` — checkpoint keys the template does not expect."""

    def __init__(self, path: str, missing: List[str], extra: List[str]):
        self.path = path
        self.missing = list(missing)
        self.extra = list(extra)
        lines = [f"checkpoint {path!r} does not match the restore template "
                 f"({len(missing)} missing, {len(extra)} extra):"]
        for k in missing[:8]:
            lines.append(f"  missing from checkpoint: {k}")
        for k in extra[:8]:
            lines.append(f"  extra in checkpoint:     {k}")
        if len(missing) > 8 or len(extra) > 8:
            lines.append("  ...")
        lines.append("pass partial=True to keep template values for "
                     "missing keys and ignore extras")
        super().__init__("\n".join(lines))


class CheckpointReader:
    """Lazy reader over a (sharded or legacy) checkpoint directory: one
    leaf at a time, assembled from its shard chunks — the streaming
    primitive behind :func:`restore_tree` and the checkpoint-to-serving
    cold start, which never holds the whole tree on the host."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "META")) as f:
            self.meta = json.load(f)
        self.extra = self.meta.get("extra", {})
        self._files: Dict[str, Any] = {}
        if self.meta.get("format", 1) >= 2:
            self.manifest: Dict[str, Dict[str, Any]] = self.meta["manifest"]
            self._legacy = False
        else:                                 # v1: monolithic arrays.npz
            self.manifest = {k: {"key": sk} for k, sk
                             in self.meta["manifest"].items()}
            self._legacy = True

    def keys(self) -> List[str]:
        return list(self.manifest)

    def _file(self, name: str):
        if name not in self._files:
            self._files[name] = np.load(os.path.join(self.path, name))
        return self._files[name]

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def _hosts(self) -> List[Dict[str, int]]:
        axes = self.meta["shard_axes"]
        return [dict(zip(axes, c)) for c in self.meta["hosts"]]

    def read(self, key: str) -> np.ndarray:
        """Assemble one leaf (as stored: bfloat16 as ``V2``)."""
        ent = self.manifest[key]
        if self._legacy:
            return self._file("arrays.npz")[ent["key"]]
        mesh_axes = self.meta["mesh_axes"]
        entries = ent["spec"]
        shape = tuple(ent["shape"])
        out: Optional[np.ndarray] = None
        n = self.meta["n_shards"]
        for h, coords in enumerate(self._hosts()):
            sl = _chunk_slices(shape, entries, mesh_axes, coords)
            if sl is None:
                continue
            chunk = self._file(f"shard_{h:05d}-of-{n:05d}.npz")[ent["key"]]
            if out is None:
                if all(s == slice(None) for s in sl):
                    out = chunk           # replicated leaf: single owner
                    break
                out = np.empty(shape, dtype=_storage_dtype(ent["dtype"]))
            out[sl] = chunk
        if out is None:
            raise KeyError(f"{key!r} has no chunks in {self.path!r}")
        return out

    def read_tensor(self, key: str, device=None) -> torch.Tensor:
        """One leaf as a tensor of its META dtype on ``device``."""
        return to_tensor(self.read(key), self.manifest[key].get("dtype"),
                         device)

    def iter_arrays(self) -> Iterator[Tuple[str, np.ndarray]]:
        for k in self.manifest:
            yield k, self.read(k)


def restore_tree(template: Any, path: str, mesh=None,
                 shardings: Any = None, partial: bool = False,
                 device=None) -> Any:
    """Load arrays onto ``template``'s structure, one leaf at a time.

    Each leaf takes its template leaf's dtype and device (``device``
    overrides the latter; a template on the ``meta`` device needs it).
    A key-set mismatch raises :class:`CheckpointMismatchError` unless
    ``partial=True`` (missing keys keep their template values, extra
    checkpoint keys are skipped).

    Any save restores under any ``mesh`` or none: each leaf is assembled
    whole from whatever shard files the saving mesh wrote, and every rank
    of a live mesh holds it whole (the port's train state is whole on
    every rank; the reference places the leaves by ``param_pspecs``
    instead).  ``shardings`` (the reference's per-leaf JAX shardings) has
    no counterpart and is refused."""
    if shardings is not None:
        raise TypeError("restore_tree(shardings=...) places JAX arrays; "
                        "the port restores whole leaves on every rank")
    reader = CheckpointReader(path)
    try:
        keys = [k for k, _ in iter_leaves(template)]
        have = set(keys)
        missing = [k for k in keys if k not in reader.manifest]
        extra = [k for k in reader.manifest if k not in have]
        if (missing or extra) and not partial:
            raise CheckpointMismatchError(path, missing, extra)

        def load(key, leaf):
            if key not in reader.manifest:
                return leaf                  # partial: keep template value
            arr = reader.read(key)
            if isinstance(leaf, int):        # an int32-marked field
                return int(arr)
            t = to_tensor(arr, reader.manifest[key].get("dtype"))
            if isinstance(leaf, np.ndarray):
                return t.numpy().astype(leaf.dtype)
            dev = torch.device(device) if device is not None \
                else leaf.device
            if dev.type == "meta":
                raise ValueError("the template lies on the meta device; "
                                 "pass device= to restore onto")
            return t.to(device=dev, dtype=leaf.dtype)
        return map_leaves(load, template)
    finally:
        reader.close()


class CheckpointManager:
    """Rolling checkpoints + an async save thread + latest-step discovery.

    ``save`` copies every leaf to host numpy before the writer thread
    starts, so an optimizer updating its tensors in place during the
    write cannot tear the saved state.  A failed async save is never
    silent: it is re-raised from the next :meth:`wait` or :meth:`save`.

    Under a live process mesh every rank calls ``save`` and
    ``restore_latest`` at the same steps.  The writer thread's
    collectives (the nonce, the barriers around the commit) run on a gloo
    group of the manager's own, made by every rank at the first such call:
    gloo does not order collectives that two threads start on one group,
    and the training step's gradient all-reduce runs on the main thread
    meanwhile.  Rank 0 alone picks the latest step (broadcast to the
    others, on that group, after the writer is joined) and prunes old
    steps."""

    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.dir = directory
        self.keep = keep
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None
        os.makedirs(directory, exist_ok=True)

    def _group_for(self, mesh):
        """The manager's own group under a live ``mesh`` (None without
        one); collective the first time."""
        if not _live(mesh):
            return None
        if self._group is None:
            self._group = torch.distributed.new_group(backend="gloo")
        return self._group

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "META")):
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def join(self):
        """Join any in-flight async save, keeping its failure for
        :meth:`wait` (a crashing trainer lets its last save land first)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self):
        """Join any in-flight async save; re-raise its failure, if any."""
        self.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save failed: {err!r}") from err

    def save(self, step: int, tree: Any, extra_meta: Optional[Dict] = None,
             mesh=None, specs: Any = None):
        self.wait()
        group = self._group_for(mesh)
        host = HostTree.of(tree)     # synchronous copy; written async
        path = os.path.join(self.dir, f"step_{step}")

        def work():
            try:
                save_tree(host, path, extra_meta, mesh=mesh, specs=specs,
                          group=group)
                if group is None or torch.distributed.get_rank(group) == 0:
                    self._gc()
            except BaseException as e:       # surfaced by the next wait()
                self._error = e

        if self.use_async:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error is not None:
                self.wait()                  # re-raise immediately

    def _gc(self):
        dirs = self._step_dirs()
        # keep=0 prunes everything; fewer dirs than ``keep`` prunes none
        cut = max(0, len(dirs) - self.keep)
        for _, p in dirs[:cut]:
            shutil.rmtree(p, ignore_errors=True)
        for name in os.listdir(self.dir):    # crash debris from _commit_dir
            if re.search(r"\.(tmp|old)\.[0-9a-f]{8}$", name):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    def restore_latest(self, template: Any, mesh=None, shardings=None,
                       partial: bool = False, device=None):
        self.wait()
        group = self._group_for(mesh)
        step = self.latest_step()
        if group is not None:
            from ..dist.parallel import broadcast_object
            step = broadcast_object(step, group)
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "META")) as f:
            extra = json.load(f)["extra"]
        tree = restore_tree(template, path, mesh, shardings,
                            partial=partial, device=device)
        return (step, extra), tree
