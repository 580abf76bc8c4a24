"""Production-mesh dry run: run every (arch x shape cell x mesh) cell's
step on ``meta`` tensors for one rank and record what it costs (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's memory and cost analyses and the compiled HLO.  Torch has
neither, so here one rank of a
:class:`~repro_torch.dist.parallel.RecordingMesh` of the production shape
(16x16 single-pod, 2x16x16 multi-pod; ``coords`` all zeros) runs the
step itself on ``meta`` tensors (nothing is allocated, no kernel runs:
a wrapper routes a ``meta`` input to its plain version, which computes
shapes only), and:

* **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode``'s
  formulas, applied to every op the meter (:class:`_Meter`) sees;
* **bytes accessed** is the sum of every op's input and output tensor
  bytes (ops whose results alias an input move nothing), from a dispatch
  mode (:class:`_Meter`);
* **temp bytes** is the peak, over the step, of the bytes of the storages
  the step made and still holds (each new storage's bytes added when it
  is made and subtracted when it is freed);
* **argument and output bytes** are the sums of this rank's shard shapes
  of the step's inputs and results under the reference's placement
  (``param_pspecs``, padded for serving, ``pad=False`` for the train
  state; ``batch_pspecs``; ``cache_pspecs`` with ``pad=False``): the
  figures XLA's memory analysis gives the reference;
* **collectives** are the recording mesh's log
  (``dist.cost_analysis.collective_stats``).

Each cell's step, as the reference lowers it (the MoE layer on its
``capacity`` dispatch, as the reference's dry run sets it):

* ``train`` — ``train_batch_spec``, then the loss, its backward and the
  AdamW update of ``train.step.build_train_step`` under the data-parallel
  step (every rank holds the whole train state and runs its rows of the
  batch, ``microbatches`` at a time; ``port_argument_bytes`` records what
  the port's rank holds);
* ``prefill`` — ``ServeEngine.prefill`` on the engine's placement;
* ``decode`` — ``decode_state_spec`` / ``decode_token_spec``, the state
  as the placed engine holds it (its rows and heads), then
  ``ServeEngine.decode`` at the fill level ``seq_len - 1``.

Serving cells run the ``dense`` backend on the QAT tree, as the
reference's lower its ``api`` defaults; with ``deploy_bits`` > 0 the tree
is deployed (``to_serving_params`` on ``meta``) and runs the ``kernel``
backend and ``fused`` decode attention, through the wrappers.

Torch runs every layer eagerly, so there is no scan whose body a cost
analysis counts once: ``raw_scan_*`` equal the full counts, ``calibrate``
is accepted and changes nothing, and ``compile_s`` is 0 (``lower_s`` is
the seconds the meta run took).  A cell the port refuses writes
``<tag>__<arch>__<cell>.ERROR`` with the traceback, as the reference's
does: today heads or KV heads that do not divide ``model``, and the
``pod`` axis in serving (``serve.engine.ServeEngine._place_params``).

Run: ``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch
phi3-mini-3.8b --mesh single`` (deviceless; records into
``experiments/dryrun_torch/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import REGISTRY
from ..configs.base import ModelConfig, ShapeCell, cells_for
from ..core.state import tensor_leaves
from ..dist.cost_analysis import (collective_stats, dominant_term,
                                  roofline_terms, shape_census)
from ..dist.parallel import RecordingMesh
from ..dist.sharding import (batch_pspecs, cache_pspecs,
                             param_pspecs, spec_leaves, use_mesh)
from ..models import moe as moe_mod
from ..models.api import build

OUT_DIR = os.path.join("experiments", "dryrun_torch")
# the checkout holding this package (``src/repro_torch/launch/``)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))) + os.sep


def production_mesh(multi_pod: bool = False,
                    coords: Optional[Dict[str, int]] = None
                    ) -> RecordingMesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod (the
    reference's ``make_production_mesh``), one rank of it recording."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    return RecordingMesh(shape, coords)


def _model_flops_estimate(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (fwd-only)."""
    d, L = cfg.d_model, cfg.n_layers
    dh = cfg.head_dim
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) * dh
    if cfg.n_experts:
        ff_active = 3 * d * cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
    elif cfg.family == "ssm":
        ff_active = 5 * d * d + 2 * d * cfg.d_ff     # time mix + channel mix
        attn = 0
    elif cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        ff_active = 2 * d * di + 2 * d * cfg.ssm_state + d * di
        attn = 0
    else:
        mult = 3 if cfg.mlp_kind == "swiglu" else 2
        ff_active = mult * d * cfg.d_ff
    n_active = L * (attn + ff_active)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        blocks = cfg.n_layers // cfg.hybrid_attn_every
        n_active += blocks * (
            2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh   # 2d-in qkv
            + cfg.n_heads * dh * d                            # wo
            + 3 * d * cfg.d_ff)                               # shared mlp
    if cfg.is_encdec and cell.kind != "decode":
        n_active *= 2            # encoder stack of similar size
    n_active += 2 * cfg.vocab * d    # embed + lm head
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    factor = 6.0 if cell.kind == "train" else 2.0
    return factor * n_active * tokens


# --------------------------------------------------------------------------
# shard shapes
# --------------------------------------------------------------------------

def _shard_shape(ps: Sequence, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """This rank's shard of a leaf of ``shape`` under fitted spec ``ps``
    (ceil division: a padded spec's shard, or a dropped axis's whole
    dim)."""
    out = []
    for i, dim in enumerate(shape):
        entry = ps[i] if i < len(ps) else None
        axes = () if entry is None else \
            ((entry,) if isinstance(entry, str) else tuple(entry))
        g = math.prod(mesh.axis_size(a) for a in axes)
        out.append(-(-dim // g))
    return tuple(out)


def _nbytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _shard_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes of this rank's shards of every tensor leaf of ``tree``
    under the spec tree ``specs`` (the same paths)."""
    by_path = dict(spec_leaves(specs))
    return sum(_nbytes(_shard_shape(by_path[p], t.shape, mesh), t.dtype)
               for p, t in tensor_leaves(tree))


def _tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for _, t in tensor_leaves(tree))


# --------------------------------------------------------------------------
# the meter
# --------------------------------------------------------------------------

def _arg_key(x):
    """A hashable stand-in for an op argument (a ``meta`` tensor by its
    metadata), or raise ``TypeError`` for one that has none."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError("a host tensor's op runs")
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_arg_key(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple((k, _arg_key(v)) for k, v in sorted(x.items()))
    hash(x)
    return x


class _Meter(TorchDispatchMode):
    """Counts, over the ops it sees: ``bytes`` accessed (every op's
    input and output tensor bytes; an op whose results all alias an input
    moves nothing), the ``live`` bytes of the storages those ops made
    (each added when made, subtracted when its last tensor is freed) and
    their ``peak``, and ``results``: (dtype, bytes) of every new result
    (``shape_census``'s input).

    A functional op on ``meta`` tensors is computed once for each
    (op, argument metadata): torch's meta kernels are Python decompositions
    (~0.4 ms an op), and a model repeats the same shapes layer after
    layer, so later calls take the cached result's metadata (shape,
    strides, dtype) for a fresh ``meta`` tensor."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.results: List[Tuple[str, int]] = []
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self._cache: Dict[Any, Any] = {}
        # the counter's formulas, applied to each op here (entered as a
        # mode it would see only the ops the cache computes)
        self.flops = FlopCounterMode(display=False)

    def _drop(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._size.pop(key)

    def _hold(self, t: torch.Tensor, new: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            if not new:
                return                  # a view of a tensor made outside
            self._refs[key] = 0
            self._size[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _call(self, func, args, kwargs):
        """``func``'s result, from the cache where it may be."""
        schema = func._schema
        if schema.is_mutable or any(r.alias_info is not None
                                    for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _arg_key(args), _arg_key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        hit = self._cache.get(key)
        if hit is not None:
            seq, metas = hit
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in metas]
            return outs[0] if seq is None else seq(outs)
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            seq, flat = None, [out]
        elif isinstance(out, (tuple, list)):
            seq, flat = type(out), list(out)
        else:
            return out
        if all(isinstance(t, torch.Tensor) and t.is_meta for t in flat):
            self._cache[key] = (seq, [(t.shape, t.stride(), t.dtype)
                                      for t in flat])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._call(func, args, kwargs)
        self.flops._count_flops(func._overloadpacket, out, args, kwargs)
        outs = list(_tensors(out))
        rets = func._schema.returns
        fresh = [i >= len(rets) or rets[i].alias_info is None
                 for i in range(len(outs))]
        if any(fresh):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs)))
            self.bytes += sum(t.numel() * t.element_size() for t in outs)
        for t, new in zip(outs, fresh):
            if new:
                self.results.append((str(t.dtype).replace("torch.", ""),
                                     t.numel() * t.element_size()))
            self._hold(t, new)
        return out


def _tensors(x):
    """The tensors in an op's arguments or result (nested tuples, lists
    and dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


# --------------------------------------------------------------------------
# the cells
# --------------------------------------------------------------------------

def _default_microbatches(cell: ShapeCell, mesh) -> int:
    """~1 sequence a device a microbatch (the reference's default)."""
    if cell.kind != "train":
        return 0
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    mb = max(1, cell.global_batch // dp)
    while cell.global_batch % mb:
        mb -= 1
    return mb


def _train_step(api, cell: ShapeCell, mesh, microbatches: int):
    """(run, argument bytes, output bytes, the port's held bytes)."""
    from ..optim.optimizers import adamw
    from ..train.state import TrainState
    from ..train.step import build_train_step
    opt = adamw()
    state = TrainState.create(api.abstract_params(), opt, alpha=1e-3)
    batch = api.train_batch_spec(cell)
    tree = {"params": state.params, "opt_state": state.opt_state}
    with use_mesh(mesh):
        s_specs = param_pspecs(tree, pad=False)
        b_specs = batch_pspecs(batch)
    # the reference's state also holds its int32 step and f32 alpha (the
    # port's ``step`` is a Python int, its alpha a host scalar)
    state_bytes = _shard_bytes(tree, s_specs, mesh) + 8
    arg = state_bytes + _shard_bytes(batch, b_specs, mesh)
    out = state_bytes + 4                              # + the f32 loss
    n_dp = math.prod(mesh.axis_size(a) for a in ("pod", "data"))
    held = _tree_bytes(tree) + 8 + _tree_bytes(batch) // n_dp
    step = build_train_step(api.loss, opt, lambda s: 1e-3,
                            num_mb=max(microbatches, 1))

    def run():
        with use_mesh(mesh):
            step(state, batch)
    return run, arg, out, held


def _serve_step(api, cell: ShapeCell, mesh, deploy_bits: int):
    """(run, argument bytes, output bytes, the port's held bytes) of a
    prefill or decode cell through the engine's placement."""
    from ..dist.sharding import padded_shape
    from ..serve.engine import ServeEngine
    params = api.abstract_params()
    be = dict(backend="dense", attn_backend="gather")
    if deploy_bits:
        # the deployed tree through the kernel wrappers (on ``meta``, their
        # plain versions' shapes), decode attention through
        # ``paged_attention``
        from ..serve.deploy import to_serving_params
        params = to_serving_params(params, deploy_bits, device="meta",
                                   validate=False)
        be = dict(backend="kernel", attn_backend="fused")
    with use_mesh(mesh):
        p_specs = param_pspecs(params, pad=True)
        engine = ServeEngine(api, params, device="meta", validate=False,
                             **be)
    by_path = dict(spec_leaves(p_specs))
    p_bytes = sum(_nbytes(_shard_shape(
        by_path[p], padded_shape(by_path[p], t.shape, mesh), mesh), t.dtype)
        for p, t in tensor_leaves(params))
    cfg = api.cfg
    b = cell.global_batch
    logits_bytes = _nbytes((b, cfg.vocab), torch.float32)
    if cell.kind == "prefill":
        batch = api.train_batch_spec(cell)
        batch.pop("labels", None)
        with use_mesh(mesh):
            b_specs = batch_pspecs(batch)
        arg = p_bytes + _shard_bytes(batch, b_specs, mesh)
        # the prefill's fresh cache, placed as the decode state is
        cache = api.decode_state_spec(cell)
        with use_mesh(mesh):
            c_specs = cache_pspecs(cache, b, pad=False)
        out = logits_bytes + _shard_bytes(cache, c_specs, mesh)
        held = _tree_bytes(engine.params) + \
            _shard_bytes(batch, b_specs, mesh)

        def run():
            engine.prefill(batch)
        return run, arg, out, held
    state = api.decode_state_spec(cell)
    tok = api.decode_token_spec(cell)
    with use_mesh(mesh):
        c_specs = cache_pspecs(state, b, pad=False)
        t_specs = batch_pspecs({"t": tok})
    c_bytes = _shard_bytes(state, c_specs, mesh)
    arg = p_bytes + c_bytes + _shard_bytes({"t": tok}, t_specs, mesh) + 4
    out = logits_bytes + c_bytes
    # the state as the placed engine holds it (``init_decode_state``):
    # its rows, its heads (RWKV-6 keeps every head)
    rows = engine.local_slots(b) if engine.global_params is not None else b
    local = engine.api.decode_state_spec(
        dataclasses.replace(cell, global_batch=rows))
    if rows != b:
        local["_n_slots"] = b
    held = _tree_bytes(engine.params) + _tree_bytes(local)
    index = cell.seq_len - 1

    def run():
        engine.decode(tok, local, index)
    return run, arg, out, held


def _metered(run, train: bool) -> "_Meter":
    meter = _Meter()
    with torch.enable_grad() if train else torch.no_grad(), meter:
        run()
    return meter


def _repeat_log(two: List, three: List, n: int) -> List:
    """The collective log of ``n`` microbatches from the logs of two and
    of three: each microbatch issues the same collectives (its
    statistics' batch sums), then the step's own follow (the gradient and
    metrics buckets)."""
    k = len(three) - len(two)
    seg = three[:k]
    if k < 0 or three[:3 * k] != seg * 3 or two[:2 * k] != seg * 2 or \
            three[3 * k:] != two[2 * k:]:
        raise RuntimeError("the microbatches' collectives differ")
    return seg * n + two[2 * k:]


def trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               microbatches: int = 0, deploy_bits: int = 0
               ) -> Dict[str, Any]:
    """Run one cell's step on ``meta`` for ``mesh``'s recording rank;
    returns the raw counts, the collective log and the result census.

    A train step of more than three microbatches runs every layer of two
    and of three microbatches (each of the cell's microbatch rows) and
    extends the counts linearly to ``microbatches``: from the second on,
    the microbatches are the same ops on the same shapes (the first also
    makes the gradients the others add into; the gradients' division by
    the count, their reductions and the update run once in every run), so
    the difference of the two runs is one microbatch's count exactly (the
    live peak's too: a microbatch's loss and metrics stay held)."""
    if not isinstance(mesh, RecordingMesh):
        raise TypeError(f"the dry run records on a RecordingMesh, got "
                        f"{mesh!r}")
    impl = moe_mod.GROUPED_IMPL["impl"]
    moe_mod.GROUPED_IMPL["impl"] = "capacity"   # at-scale MoE path
    api = build(cfg)
    train = cell.kind == "train"
    try:
        t0 = time.time()
        if train:
            _, arg, out, held = _train_step(api, cell, mesh, microbatches)
        else:
            run, arg, out, held = _serve_step(api, cell, mesh, deploy_bits)
        n = max(microbatches, 1)
        if train and n > 3:
            rows = cell.global_batch // n
            runs = []
            for k in (2, 3):
                sub = dataclasses.replace(cell, global_batch=k * rows)
                run, *_ = _train_step(api, sub, mesh, k)
                mesh.log.clear()
                runs.append((_metered(run, True), list(mesh.log)))
            (m2, l2), (m3, l3) = runs
            flops2, flops3 = (m.flops.get_total_flops() for m in (m2, m3))
            flops = flops2 + (n - 2) * (flops3 - flops2)
            nbytes = m2.bytes + (n - 2) * (m3.bytes - m2.bytes)
            c2, c3 = shape_census(m2.results), shape_census(m3.results)
            census = {k: c2.get(k, 0) + (n - 2) * (c3.get(k, 0)
                                                   - c2.get(k, 0))
                      for k in set(c2) | set(c3)}
            log = _repeat_log(l2, l3, n)
            peak = m2.peak + (n - 2) * (m3.peak - m2.peak)
        else:
            if train:
                run, *_ = _train_step(api, cell, mesh, n)
            mesh.log.clear()
            meter = _metered(run, train)
            flops, nbytes = meter.flops.get_total_flops(), meter.bytes
            census, log, peak = shape_census(meter.results), list(mesh.log), \
                meter.peak
        elapsed = time.time() - t0
    finally:
        moe_mod.GROUPED_IMPL["impl"] = impl
    return dict(flops=float(flops), bytes=float(nbytes), temp=int(peak),
                argument=int(arg), output=int(out), held=int(held),
                log=log, census=census, seconds=elapsed)


def lower_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               include_text: bool = False, microbatches: int = 0,
               calibrate: bool = True,
               deploy_bits: int = 0) -> Dict[str, Any]:
    """The record of one cell, in the reference's JSON layout
    (``calibrate`` is accepted and changes nothing: there is no scan to
    calibrate).  ``include_text`` adds the collective log
    (``collective_log``) and the results' bytes by dtype
    (``shape_census``), the counterparts of the reference's HLO text."""
    del calibrate
    if microbatches == 0:
        microbatches = _default_microbatches(cell, mesh)
    tr = trace_cell(cfg, cell, mesh, microbatches, deploy_bits)
    colls = collective_stats(tr["log"])
    flops, bytes_acc = tr["flops"], tr["bytes"]
    terms = roofline_terms(flops, bytes_acc, colls.total_bytes)
    model_flops = _model_flops_estimate(cfg, cell)
    chips = mesh.size
    arg, out, temp = tr["argument"], tr["output"], tr["temp"]
    rec = dict(
        arch=cfg.name, cell=cell.name, kind=cell.kind,
        mesh=list(mesh.shape.values()), chips=chips,
        seq_len=cell.seq_len, global_batch=cell.global_batch,
        microbatches=microbatches,
        lower_s=round(tr["seconds"], 1), compile_s=0.0,
        per_device=dict(
            flops=flops, bytes_accessed=bytes_acc,
            collective_bytes=colls.total_bytes,
            raw_scan_flops=flops, raw_scan_bytes=bytes_acc,
            raw_scan_collective_bytes=colls.total_bytes,
            argument_bytes=arg, output_bytes=out, temp_bytes=temp,
            peak_hbm_gib=round((arg + temp + out) / 2**30, 3),
            port_argument_bytes=tr["held"],
            peak_bytes=tr["held"] + temp,
        ),
        collectives=dict(counts=colls.counts, bytes=colls.bytes_by_op),
        roofline=terms,
        dominant=dominant_term(terms),
        model_flops_global=model_flops,
        hlo_flops_global=flops * chips,
        useful_flops_frac=(model_flops / (flops * chips)
                           if flops else 0.0),
    )
    if include_text:
        rec["shape_census"] = tr["census"]
        rec["collective_log"] = collective_records(tr["log"])
    return rec


def collective_records(log) -> List[Dict[str, Any]]:
    """A collective log as the records hold it (JSON: lists for tuples)."""
    return [dict(op=c.op, shape=list(c.shape), dtype=c.dtype,
                 bytes=c.bytes, axis=list(c.axis)) for c in log]


def run_cells(arch_names, cell_names, multi_pod: bool, out_dir: str,
              skip_existing: bool = True) -> None:
    mesh = production_mesh(multi_pod=multi_pod)
    tag = "multipod" if multi_pod else "singlepod"
    os.makedirs(out_dir, exist_ok=True)
    for name in arch_names:
        cfg = REGISTRY[name]
        for cell in cells_for(cfg):
            if cell_names and cell.name not in cell_names:
                continue
            out = os.path.join(out_dir, f"{tag}__{name}__{cell.name}.json")
            err = os.path.join(out_dir, f"{tag}__{name}__{cell.name}.ERROR")
            if skip_existing and os.path.exists(out):
                print(f"[skip] {out}")
                continue
            print(f"[dryrun] {tag} {name} {cell.name} ...", flush=True)
            try:
                rec = lower_cell(cfg, cell, mesh, calibrate=not multi_pod)
                with open(out, "w") as f:
                    json.dump(rec, f, indent=1)
                if os.path.exists(err):
                    os.remove(err)
                print(f"  ok: dominant={rec['dominant']} "
                      f"hbm/dev={rec['per_device']['peak_hbm_gib']}GiB "
                      f"meta run={rec['lower_s']}s", flush=True)
            except Exception as e:
                # the traceback's paths relative to the checkout
                with open(err, "w") as f:
                    f.write(traceback.format_exc().replace(_ROOT, ""))
                print(f"  FAIL: {type(e).__name__}: {e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    archs = sorted(REGISTRY) if args.arch == "all" else args.arch.split(",")
    cells = None if args.cell == "all" else args.cell.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for mp in meshes:
        run_cells(archs, cells, mp, args.out, skip_existing=not args.force)


if __name__ == "__main__":
    main()
