"""Serving engine: prefill / decode / generate over the ModelAPI, and
request-level serving through the continuous-batching scheduler (port of
``repro.serve.engine``).

``kv_quant_bits`` of 8 or 4 rebuilds the model config so the KV cache
stores int8 / nibble-packed int4 entries plus per-token scales; each
written position is rounded once.  ``backend`` selects how deployed
matmuls execute (``dense`` | ``kernel`` | ``bitplane`` | ``ref``;
``kernel`` is the counterpart of the reference's ``pallas``) and
``attn_backend`` how decode attention reads the cache (``gather`` |
``fused`` | ``ref``).  Both are passed explicitly into every model call.

``speculate_planes=k`` turns greedy ``generate`` into self-speculative
decoding: a draft tree reads the same bit-plane payload through masks
truncated to each block's top-k planes, proposes ``draft_gamma`` tokens a
round, and one full-precision verify forward accepts the longest matching
prefix (``serve/autotune/speculative.py``).  The tokens are those of
non-speculative greedy decoding.

The engine runs on ``device``: the CUDA card unless the caller names
another; it raises when no card is present and the caller did not ask for
the CPU.  At construction it contract-checks the deployed leaves
(``validate``, on by default: a tree with an SW/BP error finding is
refused), warns when a non-dense backend gets no leaf it can accelerate
and names the packed leaves a ``bitplane`` engine would dequantize
(``analysis.graph_lint.fallback_leaf_paths``), moves the params to the device and casts plain float leaves to the
compute dtype once, so no step repeats that cast.

Two call surfaces, as in the reference:

* ``generate(batch, max_new)`` — one-shot static-batch decoding;
* ``serve(requests)`` — request-level continuous batching through
  :class:`repro_torch.serve.scheduler.Scheduler` (its speculative ticks
  included); the ``page_size`` / ``n_pages`` / ``prefill_chunk`` /
  ``overcommit`` / ``prefix_cache`` fields (or per-call overrides) select
  the paged block-table cache, chunked prompt insertion, reservation
  overcommit with park/restore preemption, and prompt-page sharing.

**Under a mesh.**  An engine built while a process mesh is active
(``dist.sharding.use_mesh`` of a ``launch.mesh.make_mesh`` mesh, the
same program on every rank) places its params by
``dist.sharding.param_pspecs`` with padded placement: each rank keeps the
local shard of every deployed leaf (``ServingWeight.w_int``,
``BitplaneServingWeight.planes`` / ``sign``; ``scale`` / ``mask`` stay
whole) and of the vocab-sharded embedding, with big leaves' free dims
split over ``data`` (FSDP); every other leaf stays whole.  Its config
counts each rank's heads (``head_shards`` the model axis), the KV cache
holds them, and every entry point runs under the mesh: each sharded
leaf's product runs on its shard with the collectives of
``dist.parallel``.  Batches split their rows over ``data`` when the
data axis divides them (``batch_pspecs``), and so does a contiguous decode
state (``cache_pspecs``); the logits the host reads are gathered back, so
every rank sees the same tokens.  A paged pool is held whole on every data
rank (a placement that differs from ``cache_pspecs``, which puts its pages
on ``data``): prompts are inserted on every rank, a decode step writes its
own rows' tokens, and parking takes a slot's pages from the rank that
decodes it.  Every family serves under a mesh, and so does
self-speculative decoding (its draft reads the placed shards through
truncated masks; draft and verify steps split and gather rows as a decode
step does).  RWKV-6 splits no head (its scans run every head on every
rank, ``wk`` / ``wv`` gathered after their column-parallel products); the
other families' heads and KV heads must divide ``model``.  Recurrent rows
and an encoder-decoder state's ``enc_out`` follow the KV rows: split over
``data`` in a contiguous state, whole (and narrowed to a rank's rows for
its steps) beside a paged pool.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import PlacedConfig
from ..dist import parallel as par
from ..dist.sharding import (get_mesh, padded_shape, param_pspecs,
                             spec_leaves, use_mesh)
from ..models.api import (ModelAPI, _write_enc_out, _write_tree,
                          cache_is_paged)
from ..models.attention import PAGED_ATTN_BACKENDS
from ..models.common import MATMUL_BACKENDS, prepare_params
from ..models.transformer import _cdtype
from ..core.device import resolve_device
from .autotune.speculative import greedy_verify, make_draft_params
from .deploy import (BitplaneServingWeight, ServingWeight, tree_leaves,
                     tree_map, tree_to)
from .sampling import SamplingParams, sample_token


def _roundup64(n: int) -> int:
    # decode headroom rounded up, so cache widths match the reference's
    return -(-n // 64) * 64


def _first_rows(cache) -> int:
    """The slots of a stacked cache tree: a paged sub-dict's block-table
    rows, else a leaf's batch rows (dim 1)."""
    if isinstance(cache, dict):
        if "table" in cache:
            return int(cache["table"].shape[1])
        return _first_rows(next(iter(cache.values())))
    return int(cache.shape[1])


def _narrow_rows(cache, row: int):
    """Views of row ``row`` (dim 1) of every leaf of a contiguous cache."""
    if isinstance(cache, dict):
        return {k: _narrow_rows(v, row) for k, v in cache.items()}
    return cache[:, row:row + 1]


def _zero_row(cache):
    """A zero one-row cache shaped as a row of ``cache``."""
    if isinstance(cache, dict):
        return {k: _zero_row(v) for k, v in cache.items()}
    return torch.zeros_like(cache[:, :1])


@dataclasses.dataclass
class ServeEngine:
    api: ModelAPI
    params: Any
    kv_quant_bits: int = 32       # 8 / 4 select the quantized-at-rest cache
    backend: str = "dense"        # 'dense'|'kernel'|'bitplane'|'ref' matmul
    attn_backend: str = "gather"  # 'gather' | 'fused' | 'ref' decode attn
    page_size: int = 0            # >0: paged KV cache (tokens per page)
    n_pages: Optional[int] = None  # page-pool capacity (None = worst case)
    prefill_chunk: int = 0        # >0: insert prompts in chunks this wide
    overcommit: float = 1.0       # >1: admit past capacity, park victims
    prefix_cache: bool = False    # share full prompt pages by content hash
    device: Any = None            # None = the CUDA card
    validate: bool = True         # contract-check deployed leaves on build
    speculate_planes: int = 0     # >0: self-speculative decode, top-k draft
    draft_gamma: int = 4          # draft tokens proposed per round

    def __post_init__(self):
        if self.backend not in MATMUL_BACKENDS:
            raise ValueError(f"backend must be one of {MATMUL_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.attn_backend not in PAGED_ATTN_BACKENDS:
            raise ValueError(
                f"attn_backend must be one of {PAGED_ATTN_BACKENDS}, "
                f"got {self.attn_backend!r}")
        self.device = resolve_device(self.device)
        cfg = self.api.cfg
        leaves = tree_leaves(self.params)
        want = (BitplaneServingWeight,) if self.backend == "bitplane" \
            else (ServingWeight, BitplaneServingWeight)
        if self.backend != "dense" and not any(isinstance(x, want)
                                               for x in leaves):
            hint = ", layout='bitplane'" if self.backend == "bitplane" else ""
            warnings.warn(
                f"backend={self.backend!r} only accelerates deployed packed "
                f"weights (serve.deploy.to_serving_params(...{hint})); this "
                f"param tree has none, so execution is identical to 'dense'",
                stacklevel=2)
        if self.kv_quant_bits < 32:
            if self.kv_quant_bits not in (4, 8):
                raise ValueError(f"kv_quant_bits must be 4, 8 or >=32, "
                                 f"got {self.kv_quant_bits}")
            if cfg.family == "ssm":
                warnings.warn(
                    f"kv_quant_bits={self.kv_quant_bits} has no effect on "
                    f"family 'ssm': recurrent state has no KV cache and "
                    f"serves at full precision", stacklevel=2)
            cfg = dataclasses.replace(cfg, kv_cache_bits=self.kv_quant_bits)
            self.api = ModelAPI(cfg)
        if self.backend == "bitplane":
            from ..analysis.graph_lint import fallback_leaf_paths
            stale = fallback_leaf_paths(self.params, self.backend)
            if stale:
                warnings.warn(
                    f"backend='bitplane' executes only the plane-sliced "
                    f"layout; {len(stale)} packed ServingWeight leaves "
                    f"fall back to the dense dequant matmul (deploy with "
                    f"layout='bitplane'): {stale[:4]}", stacklevel=2)
        if self.validate:
            from ..analysis.contracts import validate_serving_tree
            bad = [f for f in validate_serving_tree(self.params)
                   if f.severity == "error"]
            if bad:
                raise ValueError(
                    "deployed param tree violates the serving contract:\n"
                    + "\n".join(f.format() for f in bad[:8]))
        self.params = prepare_params(tree_to(self.params, self.device),
                                     _cdtype(cfg))
        self.mesh = get_mesh()
        self.global_params = None
        self.global_api = self.api     # the unsharded config's API
        if self.mesh is not None and math.prod(self.mesh.shape.values()) > 1:
            self._place_params()
        self.draft_params = None
        # one entry per speculative round of the last speculative_generate:
        # gamma (drafts, or 0 for a plain decode step), drafted,
        # accepted_drafts and emitted token counts over the batch
        self.round_log: List[Dict[str, int]] = []
        if self.speculate_planes:
            if cfg.is_encdec or cfg.family in ("ssm", "hybrid", "rwkv"):
                raise ValueError(
                    f"speculate_planes needs a purely positional KV cache "
                    f"(rejected drafts roll back by fill level); family "
                    f"{cfg.family!r} carries recurrent state")
            if self.draft_gamma < 1:
                raise ValueError(f"draft_gamma must be >= 1, "
                                 f"got {self.draft_gamma}")
            # a view: payload tensors (a placed engine's shards) shared,
            # only the masks are new
            self.draft_params = make_draft_params(self.params,
                                                  self.speculate_planes)

    @property
    def _be(self) -> Dict[str, str]:
        return {"backend": self.backend, "attn_backend": self.attn_backend}

    def _inputs(self, batch: Dict[str, Any], rows=None
                ) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v).to(self.device)
               for k, v in batch.items()}
        if rows is not None and rows[0]:
            out = {k: v[rows[1]:rows[2]] for k, v in out.items()}
        return out

    # ---- mesh placement ---------------------------------------------------
    def _place_params(self) -> None:
        """Padded placement under ``self.mesh``: specs fitted with padding,
        each deployed leaf cut to this rank's shard, the vocab-sharded
        embedding (or unquantized LM head) to its rows (columns); the
        config's head counts become this rank's (RWKV-6, which has no
        head-split layer, keeps its config).  ``global_params`` keeps the
        padded global shapes (``meta`` tensors) for the sharding lint."""
        cfg = self.api.cfg
        mesh = self.mesh
        if not isinstance(mesh, par.Mesh):
            raise TypeError(
                f"a ServeEngine places its params on a process mesh "
                f"(launch.mesh.make_mesh), got {mesh!r}; lint a shape-only "
                f"mesh through analysis.lint_engine(engine, mesh=...)")
        if set(mesh.shape) - {"data", "model"}:
            raise NotImplementedError(
                f"serving under mesh axes {tuple(mesh.shape)} is not "
                f"ported; the port serves on ('data', 'model') meshes "
                f"(ROADMAP item 6, distribution)")
        m = mesh.axis_size("model")
        # the reference's rules shard only RWKV-6's column-parallel wk /
        # wv, whose products every rank gathers whole: its heads stay whole
        split_heads = cfg.family != "ssm"
        if split_heads and (cfg.n_heads % m or cfg.n_kv_heads % m):
            raise NotImplementedError(
                f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads do not "
                f"divide the model axis ({m}); the port shards heads "
                f"evenly, where GSPMD pads them (ROADMAP item 6)")
        with use_mesh(mesh):
            specs = dict(spec_leaves(param_pspecs(self.params, pad=True)))

        def meta(path, t):
            return torch.empty(padded_shape(specs[path], t.shape, mesh),
                               dtype=t.dtype, device="meta")
        from ..dist.sharding import map_with_path
        self.global_params = map_with_path(meta, self.params)

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}
            if isinstance(node, (ServingWeight, BitplaneServingWeight)):
                fields = {f: specs[f"{path}.{f}"]
                          for f in ("w_int", "planes", "sign")
                          if hasattr(node, f)}
                return par.deployed_shard(node, fields, mesh)
            if isinstance(node, torch.Tensor) and node.ndim == 2 and \
                    path in ("['embed']", "['lm_head']"):
                kind = "row" if path == "['embed']" else "col"
                return par.tensor_shard(node, specs[path], mesh, kind)
            return node
        self.params = walk(self.params, "")
        if m > 1 and split_heads:
            fields = {f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)}
            self.api = ModelAPI(PlacedConfig(**dict(
                fields, n_heads=cfg.n_heads // m,
                n_kv_heads=cfg.n_kv_heads // m, d_head=cfg.head_dim,
                head_shards=m)))

    def whole_params(self) -> Any:
        """The deployed tree with every sharded leaf made whole again (its
        shards gathered over the mesh: every rank calls it); the params
        themselves without a mesh.  What the contracts check."""
        if self.global_params is None:
            return self.params
        with use_mesh(self.mesh):
            return tree_map(lambda x: par.unshard(x)
                            if getattr(x, "shard", None) is not None
                            and not isinstance(x, par.ShardedTensor)
                            else x, self.params)

    def _run(self, fn, *args, **kwargs):
        """``fn`` under the engine's mesh (a plain call without one)."""
        if self.mesh is None:
            return fn(*args, **kwargs)
        with use_mesh(self.mesh):
            return fn(*args, **kwargs)

    def _rows(self, n: int):
        """(sharded, r0, r1): this rank's rows of an ``n``-row batch, split
        over ``data`` when the axis divides ``n`` (``batch_pspecs``'s
        rule), else every row."""
        d = self.mesh.axis_size("data") if self.global_params is not None \
            else 1
        if d > 1 and n % d == 0:
            c = n // d
            q = self.mesh.coord("data")
            return True, q * c, (q + 1) * c
        return False, 0, n

    def local_slots(self, n_slots: int) -> int:
        """The contiguous decode-state rows this rank holds of
        ``n_slots``."""
        _, r0, r1 = self._rows(n_slots)
        return r1 - r0

    def _row_view(self, state: Any, rows) -> Any:
        """The state as a step over this rank's rows sees it.  A
        contiguous state's rows are already local; beside a paged pool
        (whole on every rank) the block tables, the recurrent rows and
        ``enc_out`` are whole, and are narrowed to the rows (views, so the
        step's writes land in the state)."""
        if not rows[0] or not cache_is_paged(state["cache"]):
            return state
        r0, r1 = rows[1], rows[2]

        def walk(cache):
            if isinstance(cache, dict):
                if "table" in cache:
                    return dict(cache, table=cache["table"][:, r0:r1])
                return {k: walk(v) for k, v in cache.items()}
            return cache[:, r0:r1]
        out = dict(state, cache=walk(state["cache"]))
        if "enc_out" in state:
            out["enc_out"] = state["enc_out"][r0:r1]
        return out

    # ---- core ops ---------------------------------------------------------
    def prefill(self, batch: Dict[str, Any], extra_slots: int = 0) -> tuple:
        """Whole-prompt forward; returns (last-token logits, decode
        state).  Under a mesh the state holds this rank's rows."""
        rows = self._rows(int(np.shape(batch["tokens"])[0]))
        logits, state = self._run(self.api.prefill, self.params,
                                  self._inputs(batch, rows),
                                  extra_slots=extra_slots, **self._be)
        return self._gather(logits, rows), state

    def _gather(self, logits: torch.Tensor, rows) -> torch.Tensor:
        """Every row's logits on every rank (``rows[0]``: the rows were
        split over ``data``)."""
        if not rows[0]:
            return logits
        with use_mesh(self.mesh):
            return par.gather_rows(logits)

    def _owner(self, state: Any, slot: int):
        """(holds, local row) of a contiguous state's ``slot`` on this
        rank."""
        n = self._state_slots(state)
        sharded, r0, r1 = self._rows(n)
        if not sharded:
            return True, slot
        return r0 <= slot < r1, slot - r0

    def _state_slots(self, state: Any) -> int:
        """The global slot count of a decode state."""
        return state.get("_n_slots", 0) or _first_rows(state["cache"])

    def prefill_at(self, batch: Dict[str, Any], state: Any,
                   slot: int) -> tuple:
        """Insert a prompt into batch row ``slot`` of a live decode state.
        Under a mesh every rank runs the prompt; a contiguous row is
        written by the rank holding it."""
        inputs = self._inputs(batch)
        if self.mesh is None or cache_is_paged(state["cache"]) or \
                not self._rows(self._state_slots(state))[0]:
            return self._run(self.api.prefill_at, self.params, inputs,
                             state, slot, **self._be)
        logits, sub = self._run(self.api.prefill, self.params, inputs,
                                extra_slots=0, **self._be)
        holds, local = self._owner(state, slot)
        if holds:
            _write_tree(state["cache"], sub["cache"], local)
            if "enc_out" in state:
                _write_enc_out(state, sub["enc_out"], local)
        return logits, state

    def prefill_chunk_at(self, batch: Dict[str, Any], state: Any, slot: int,
                         start: int) -> tuple:
        """Insert a prompt chunk at cache position ``start`` of row
        ``slot``; returns (full (1, W, V) chunk logits, state).  Under a
        mesh every rank runs the chunk; where a contiguous state's rows
        are split over ``data``, a rank that does not hold the row runs it
        on a scratch row (its weight gathers over ``data`` must meet the
        holder's) and takes the holder's logits."""
        inputs = self._inputs(batch)
        if self.mesh is None or cache_is_paged(state["cache"]) or \
                not self._rows(self._state_slots(state))[0]:
            return self._run(self.api.prefill_chunk_at, self.params, inputs,
                             state, slot, start, **self._be)
        holds, local = self._owner(state, slot)
        if holds:
            view = dict(state, cache=_narrow_rows(state["cache"], local))
            if "enc_out" in state:
                view["enc_out"] = state["enc_out"][local:local + 1]
        else:
            view = {"cache": _zero_row(state["cache"])}
            if "enc_out" in state:
                view["enc_out"] = torch.zeros_like(state["enc_out"][:1])
        logits, _ = self._run(self.api.prefill_chunk_at, self.params,
                              inputs, view, 0, start, **self._be)
        with use_mesh(self.mesh):
            logits = par.broadcast(logits.contiguous(), "data",
                                   self._slot_rank(state, slot))
        return logits, state

    def init_decode_state(self, example: Dict[str, Any], n_slots: int,
                          max_len: int, page_size: int = 0,
                          n_pages: Optional[int] = None) -> Any:
        """Empty (zeroed) decode state, paged when ``page_size > 0``.
        Under a mesh it holds this rank's heads, and a contiguous state
        this rank's rows; a paged pool, and the rows beside it, are whole
        (an ssm state has no pool: its rows are this rank's)."""
        paged = page_size > 0 and self.api.cfg.family != "ssm"
        rows = n_slots if paged else self.local_slots(n_slots)
        state = self.api.init_decode_state(self.params, self._inputs(example),
                                           rows, max_len,
                                           page_size=page_size,
                                           n_pages=n_pages)
        if rows != n_slots:
            state["_n_slots"] = n_slots
        return state

    def tile_state(self, sub: Any, n_slots: int) -> Any:
        """A one-row prefill state tiled to ``n_slots`` rows as separate
        storage (the scheduler's lazy fixed-width state); under a mesh to
        this rank's rows."""
        from .scheduler import _tile_rows
        local = self.local_slots(n_slots)
        state = dict(sub, cache=_tile_rows(sub["cache"], local))
        if "enc_out" in sub:
            state["enc_out"] = sub["enc_out"].repeat(local, 1, 1)
        if local != n_slots:
            state["_n_slots"] = n_slots
        return state

    def set_tables(self, state: Any, tables) -> Any:
        """Copy host-side block tables ((n_slots, nb) int32) into every
        paged KV sub-dict of ``state`` (broadcast over the stack dim), in
        place."""
        tables = torch.as_tensor(np.asarray(tables, np.int32))

        def walk(cache):
            if "table" in cache:
                cache["table"].copy_(tables.expand_as(cache["table"]))
            else:
                for v in cache.values():
                    if isinstance(v, dict):
                        walk(v)
        walk(state["cache"])
        return state

    def decode(self, tokens: torch.Tensor, state: Any, index) -> tuple:
        """One decode step; ``index`` is the shared fill level (int or 0-d)
        or a per-slot (B,) vector.  Under a mesh a rank steps its rows and
        the logits of every row come back."""
        return self._step(self.api.decode_step, self.params, tokens, state,
                          index)

    def _step(self, fn, params, tokens: torch.Tensor, state: Any,
              index) -> tuple:
        """``fn`` (a decode or verify step) over ``tokens``' rows: without
        a mesh all of them; under one this rank's rows of the tokens, the
        fill levels and the state, with every row's logits gathered back,
        so every rank reads the same tokens."""
        if self.mesh is None:
            return fn(params, tokens.to(self.device), state, index,
                      **self._be)
        rows = self._rows(int(tokens.shape[0]))
        tok = tokens.to(self.device)[rows[1]:rows[2]]
        if not isinstance(index, int) and torch.as_tensor(index).ndim == 1:
            index = torch.as_tensor(index)[rows[1]:rows[2]]
        logits, _ = self._run(fn, params, tok, self._row_view(state, rows),
                              index, **self._be)
        return self._gather(logits, rows), state

    def draft_decode(self, tokens: torch.Tensor, state: Any, index) -> tuple:
        """One decode step with the truncated-mask draft tree.  Its K/V
        writes are transient: the verify pass rewrites every drafted
        position at full precision before it is read below the accepted
        fill level."""
        if self.draft_params is None:
            raise ValueError("engine built without speculate_planes")
        return self._step(self.api.decode_step, self.draft_params, tokens,
                          state, index)

    def verify(self, tokens: torch.Tensor, state: Any, index) -> tuple:
        """Batched W-token verify forward with the full deployed tree.

        ``tokens`` (B, W): each slot's last accepted token followed by its
        draft proposals; returns ((B, W, V) logits, state) with all W
        positions (re)written at full precision."""
        if self.draft_params is None:
            raise ValueError("engine built without speculate_planes")
        return self._step(self.api.verify_step, self.params, tokens, state,
                          index)

    # ---- preemption / prefix-cache state plumbing ------------------------
    def park_slot(self, state: Any, slot: int, pages) -> Dict[str, Any]:
        """Snapshot everything batch row ``slot`` holds to host memory:
        its pool pages (in ``pages``/block order) from every paged KV
        sub-dict, its row of every non-paged per-slot cache leaf (the
        recurrent rwkv / mamba state among them), and its
        encoder output row if the family has one (``enc_out``).  The
        stored representation is copied as raw bytes (quantized payloads
        and scales, no dequantization), so :meth:`restore_slot`
        round-trips bit-identically.  Every entry is a copy: the live
        state is written in place, and a view of it (``cache[:, slot]``,
        or a CPU tensor's ``.cpu()``) would read back later writes."""
        ids = torch.as_tensor(np.asarray(pages, np.int64))
        rec: Dict[str, Any] = {"pages": {}, "rows": {}, "enc_out": None,
                               "n_pages": len(ids)}
        # under a mesh whose data axis splits the slots, only the rank
        # stepping ``slot`` holds its decoded tokens and recurrent rows:
        # every rank takes them from that rank
        src = self._slot_rank(state, slot)

        def take(t):
            if src is not None:
                with use_mesh(self.mesh):
                    t = par.broadcast(t.contiguous(), "data", src)
            return t.to("cpu", copy=True)

        def row(leaf, dim):
            holds, i = self._slot_row(state, slot, leaf.shape[dim])
            return take(leaf.select(dim, i) if holds
                        else torch.zeros_like(leaf.select(dim, 0)))

        def walk(cache, path):
            if isinstance(cache, dict):
                if "table" in cache:
                    for name, leaf in cache["pages"].items():
                        rec["pages"][f"{path}.{name}"] = take(
                            leaf[:, ids.to(leaf.device)])
                    return
                for k, v in cache.items():
                    walk(v, f"{path}.{k}")
                return
            rec["rows"][path] = row(cache, 1)

        walk(state["cache"], "cache")
        if "enc_out" in state:
            rec["enc_out"] = row(state["enc_out"], 0)
        return rec

    def restore_slot(self, state: Any, slot: int, pages,
                     record: Dict[str, Any]) -> Any:
        """Write a :meth:`park_slot` snapshot back into batch row ``slot``,
        landing the parked pool pages on the freshly allocated ``pages``
        (same count, any ids — the caller rewrites its block-table row to
        match).  The inverse of parking, bit for bit, written into the
        live state in place (under a mesh, into every rank's copy of the
        row, or the holder's)."""
        if len(pages) != record["n_pages"]:
            raise ValueError(f"snapshot holds {record['n_pages']} pages, "
                             f"restore got {len(pages)} page ids")
        ids = torch.as_tensor(np.asarray(pages, np.int64))

        def put(leaf, dim, value):
            holds, i = self._slot_row(state, slot, leaf.shape[dim])
            if holds:
                leaf.select(dim, i).copy_(value.to(leaf.device))

        def walk(cache, path):
            if isinstance(cache, dict):
                if "table" in cache:
                    if record["n_pages"]:
                        for name, leaf in cache["pages"].items():
                            leaf[:, ids.to(leaf.device)] = record["pages"][
                                f"{path}.{name}"].to(leaf.device)
                    return
                for k, v in cache.items():
                    walk(v, f"{path}.{k}")
                return
            put(cache, 1, record["rows"][path])

        walk(state["cache"], "cache")
        if record.get("enc_out") is not None and "enc_out" in state:
            put(state["enc_out"], 0, record["enc_out"])
        return state

    def _slot_row(self, state: Any, slot: int, rows: int):
        """(holds, index) of ``slot`` in a per-slot leaf of ``rows`` rows:
        a whole leaf (every slot's row, as beside a paged pool) holds it at
        ``slot``; a leaf of this rank's rows at its local row, if this
        rank's."""
        if rows == self._state_slots(state):
            return True, slot
        return self._owner(state, slot)

    def _slot_rank(self, state: Any, slot: int) -> Optional[int]:
        """The data coord of the rank stepping ``slot`` when the data axis
        splits the slots (None otherwise)."""
        if self.mesh is None:
            return None
        sharded, r0, r1 = self._rows(self._state_slots(state))
        return slot // (r1 - r0) if sharded else None

    def copy_pool_page(self, state: Any, src: int, dst: int) -> Any:
        """Copy pool page ``src`` onto ``dst`` in every paged KV sub-dict
        (payloads and scales alike), in place — the scheduler's
        copy-on-write primitive for diverging from a shared prefix
        page."""
        def walk(cache):
            if isinstance(cache, dict):
                if "table" in cache:
                    for leaf in cache["pages"].values():
                        leaf[:, dst] = leaf[:, src]
                    return
                for v in cache.values():
                    walk(v)
        walk(state["cache"])
        return state

    def prompt_width(self, batch: Dict[str, Any]) -> int:
        """Cache positions a prompt occupies: its tokens and a vlm
        prompt's vision prefix (an encoder-decoder prompt's frames fill
        ``enc_out``, not the cache)."""
        p = int(batch["tokens"].shape[1])
        if self.api.cfg.family == "vlm":
            p += self.api.cfg.vision_tokens
        return p

    # ---- one-shot API (static batch) ------------------------------------
    def generate(self, batch: Dict[str, Any], max_new: int = 16,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
        """batch: {"tokens": (B, P)}, plus ``frames`` (B, S_enc, d_model)
        for the encoder-decoder family or ``vision_embeds`` (B,
        vision_tokens, d_model) for the vlm family.  Returns (B, max_new)
        int32 tokens.

        ``greedy`` (or no ``generator``) takes the per-step argmax;
        otherwise tokens are drawn at ``temperature`` over the ``top_k``
        best logits with ``generator`` (on the engine's device).  With
        ``speculate_planes`` set, greedy decoding runs the draft/verify
        protocol (:meth:`speculative_generate`): the same tokens, fewer
        full-precision passes."""
        if self.speculate_planes and (greedy or generator is None):
            return self.speculative_generate(batch, max_new)[0]
        logits, state = self.prefill(batch, extra_slots=_roundup64(max_new))
        sp = SamplingParams(temperature=temperature, top_k=top_k)

        def pick(logits):
            if greedy or generator is None:
                return torch.argmax(logits, -1)[:, None].to(torch.int32)
            return sample_token(logits, sp, generator)[:, None]

        outs: List[torch.Tensor] = []
        tok = pick(logits)            # first token sampled like the rest
        outs.append(tok[:, 0])
        index = self.prompt_width(batch)
        for _ in range(max_new - 1):  # max_new-1 steps, like the scheduler
            logits, state = self.decode(tok, state, index)
            tok = pick(logits)
            outs.append(tok[:, 0])
            index += 1
        return torch.stack(outs, dim=1)

    def speculative_generate(self, batch: Dict[str, Any], max_new: int = 16,
                             keep_logits: bool = False) -> tuple:
        """Greedy static-batch decoding by draft/verify rounds.

        Returns the (B, max_new) int32 tokens and, with ``keep_logits``,
        the (max_new, B, V) f32 full-precision logits each emitted token
        was chosen from (else None).  Rows accept different draft counts,
        so fill levels are per-row (B,) vectors; a row that reaches
        ``max_new`` stops taking tokens (its index freezes and later writes
        land in masked headroom).  Fills :attr:`round_log`."""
        if self.draft_params is None:
            raise ValueError("engine built without speculate_planes")
        gamma = self.draft_gamma
        logits, state = self.prefill(
            batch, extra_slots=_roundup64(max_new + gamma + 1))
        b = int(batch["tokens"].shape[0])
        p = self.prompt_width(batch)
        first = torch.argmax(logits, -1)
        kept = None
        if keep_logits:
            kept = torch.zeros((max_new, b, logits.shape[-1]),
                               dtype=torch.float32, device=self.device)
            kept[0] = logits
        outs: List[List[int]] = [[t] for t in first.tolist()]
        counts = np.ones((b,), dtype=np.int64)
        index = np.full((b,), p, dtype=np.int64)
        self.round_log = []

        def at(idx):
            return torch.as_tensor(idx, dtype=torch.int32).to(self.device)

        tok = first[:, None].to(torch.int32)
        while int(counts.min()) < max_new:
            g = min(gamma, max_new - int(counts.min()) - 1)
            active = counts < max_new
            if g < 1:                      # last token: plain decode step
                logits, state = self.decode(tok, state, at(index))
                vlogits = logits[:, None]
                accepted = [np.asarray([t]) for t in
                            torch.argmax(logits, -1).tolist()]
                n_draft = np.zeros((b,), dtype=np.int64)
            else:
                cur, drafts = tok, []
                for j in range(g):
                    lg, state = self.draft_decode(cur, state, at(index + j))
                    cur = torch.argmax(lg, -1)[:, None].to(torch.int32)
                    drafts.append(cur)
                vtoks = torch.cat([tok] + drafts, dim=1)       # (B, g+1)
                vlogits, state = self.verify(vtoks, state, at(index))
                accepted, n_draft = greedy_verify(
                    vtoks[:, 1:].cpu().numpy(),
                    torch.argmax(vlogits, -1).cpu().numpy())
            rec = dict(gamma=g, drafted=0, accepted_drafts=0, emitted=0)
            for r in range(b):
                take = min(len(accepted[r]), max_new - int(counts[r]))
                if kept is not None and take:
                    kept[counts[r]:counts[r] + take, r] = vlogits[r, :take]
                outs[r].extend(int(t) for t in accepted[r][:take])
                rec["drafted"] += g * int(active[r])
                rec["accepted_drafts"] += min(int(n_draft[r]), take)
                rec["emitted"] += take
                counts[r] += take
                index[r] += take
            self.round_log.append(rec)
            tok = torch.tensor([[o[-1]] for o in outs], dtype=torch.int32,
                               device=self.device)
        tokens = torch.tensor([o[:max_new] for o in outs], dtype=torch.int32,
                              device=self.device)
        return tokens, kept

    # ---- request-level API ----------------------------------------------
    def make_scheduler(self, requests, n_slots: int = 8,
                       max_len: Optional[int] = None,
                       page_size: Optional[int] = None,
                       n_pages: Optional[int] = None,
                       prefill_chunk: Optional[int] = None,
                       overcommit: Optional[float] = None,
                       prefix_cache: Optional[bool] = None,
                       record_ticks: bool = False):
        """Continuous-batching scheduler sized for ``requests``, on the
        engine's device; ``record_ticks`` keeps its per-tick log.

        ``max_len`` (total per-slot cache width) defaults to the widest
        request's prompt plus 64-rounded generation headroom — the same
        rounding ``generate`` uses.  ``page_size`` / ``n_pages`` /
        ``prefill_chunk`` / ``overcommit`` / ``prefix_cache`` default to
        the engine's settings (0 = contiguous slots / monolithic prefill;
        1.0 = reservation-safe admission; False = no prompt-page sharing).
        The scheduler is the stats surface too (``cache_report()``)."""
        from .scheduler import Scheduler
        if max_len is None:
            max_len = max(self.prompt_width(r.inputs) +
                          _roundup64(r.sampling.max_new_tokens)
                          for r in requests)
        return Scheduler(
            self, n_slots=n_slots, max_len=max_len,
            page_size=self.page_size if page_size is None else page_size,
            n_pages=self.n_pages if n_pages is None else n_pages,
            prefill_chunk=(self.prefill_chunk if prefill_chunk is None
                           else prefill_chunk),
            overcommit=self.overcommit if overcommit is None else overcommit,
            prefix_cache=(self.prefix_cache if prefix_cache is None
                          else prefix_cache), record_ticks=record_ticks)

    def serve(self, requests, n_slots: int = 8,
              max_len: Optional[int] = None,
              page_size: Optional[int] = None,
              n_pages: Optional[int] = None,
              prefill_chunk: Optional[int] = None,
              overcommit: Optional[float] = None,
              prefix_cache: Optional[bool] = None):
        """Run ``requests`` through a continuous-batching scheduler (see
        :meth:`make_scheduler`); results come back in submission order."""
        return self.make_scheduler(
            requests, n_slots=n_slots, max_len=max_len,
            page_size=page_size, n_pages=n_pages,
            prefill_chunk=prefill_chunk, overcommit=overcommit,
            prefix_cache=prefix_cache).run(requests)
