"""Contract validation of deployed serving trees, checkpoints, autotuned
and draft trees, the decode state and the scheduler's ledger (port of
``repro.analysis.contracts``).

Each violation is one path-qualified
:class:`~repro_torch.analysis.report.Finding`, never a crash.  Value
checks run as torch reductions on the leaf's own device; only their
verdicts come back to the host.

* ``SW1``  geometry: ``scale`` is (..., GR, GC); Kp = GR*wbr, Np = GC*wbc.
* ``SW2``  true shape: (K, N) = ``shape[-2:]`` with K <= Kp < K + wbr and
  N <= Np < N + wbc (the block grid is the minimal cover).
* ``SW3``  stack dims LEAD: ``w_int``/``scale`` share ``shape[:-2]``.
* ``SW4``  payload: bits=8 -> int8 (..., Kp, Np); bits=4 -> uint8
  (..., ceil(Kp/2), Np) nibble pairs; an odd Kp's high pad nibble is 0.
* ``BP1``  plane tensors: ``planes`` (..., bits, Kp8//8, Np) uint8 and
  ``sign`` (..., Kp8//8, Np) uint8 with Kp8 = ceil(Kp/8)*8; byte-pad rows
  beyond Kp hold zeros.
* ``BP2``  mask LUT: (..., bits, GR, GC) binary, prefix-monotone along
  the bit axis, f32.
* ``BP3``  scale LUT: (..., GR, GC) f32, finite.
* ``CK1``-``CK3``  checkpoint META, shard set and debris
  (:func:`validate_checkpoint`).
* ``AT1``  an autotuned tree respects its byte budget
  (:func:`validate_allocation`); ``AT2`` a speculative draft is a top-k
  mask-truncation view of the deployed tree
  (:func:`validate_draft_truncation`).

What :meth:`repro_torch.serve.scheduler.Scheduler.validate` returns:

* ``PC1``  paged cache: pool leaves agree on (stack, n_pages, page_size)
  leading dims; ``table`` is integer (stack, n_slots, nb).
* ``PC2``  block tables: every entry in [0, n_pages); a non-zero page
  owned by two slots is flagged unless a refcount ledger (the scheduler's
  ``PrefixCache``) accounts for the sharing.
* ``PC3``  quantized pools carry their per-token scale leaves.
* ``PA1``  fused-kernel pool layout: ``k``/``v`` agree on dtype and
  shape, in a storage format the kernel reads (int8, uint8 nibble pairs,
  or float: float32 as in the reference, and bfloat16, which the port's
  kernel also reads); scale leaves match the payload's (stack, n_pages,
  page, KV) prefix and are float32.
* ``PA2``  pool capacity: >= 2 pages and >= 1 table block per slot.
* ``PA3``  each slot's live (non-zero) pages form a contiguous prefix of
  its table row.
* ``PX1``  refcounts equal the live slots aliasing each page, every
  slot-shared page is registered, and the allocator's ``in_use`` equals
  the distinct pages owned by live slots + the cache (parked snapshots
  hold no pool pages).
* ``PX2``  each slot's write frontier sits at or past the end of its
  shared-prefix region.
* ``PX3``  a free or parked slot's table row is all zeros, and a live
  slot's row mirrors its book-kept (shared + owned) pages.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from .report import Finding

_FLOATS = ("float32",)
_POOL_DTYPES = ("int8", "uint8", "float32", "bfloat16")


def _concrete(x) -> Optional[np.ndarray]:
    """Host array for value-level checks."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return None


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _dtype(x) -> str:
    return str(getattr(x, "dtype", "?")).removeprefix("torch.")


def _is_integer(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.dtype.is_floating_point or x.dtype.is_complex
                    or x.dtype == torch.bool)
    return np.issubdtype(np.dtype(_dtype(x)), np.integer)


class _Ctx:
    """Per-leaf finding accumulator with the leaf path pre-bound."""

    def __init__(self, findings: List[Finding], path: str):
        self.findings = findings
        self.path = path

    def err(self, rule: str, msg: str, sub: str = "") -> None:
        self.findings.append(Finding(
            severity="error", pass_name="contracts", rule=rule,
            path=self.path + sub, message=msg))

    def warn(self, rule: str, msg: str, sub: str = "") -> None:
        self.findings.append(Finding(
            severity="warning", pass_name="contracts", rule=rule,
            path=self.path + sub, message=msg))


def _check_pool_layout(c: _Ctx, pages) -> None:
    """PA1 over one page pool's leaves."""
    kl, vl = pages["k"], pages["v"]
    if _dtype(kl) != _dtype(vl) or _shape(kl) != _shape(vl):
        c.err("PA1", f"k/v pool leaves disagree: {_dtype(kl)}{_shape(kl)} "
                     f"vs {_dtype(vl)}{_shape(vl)} (the fused kernel "
                     f"dequantizes both with one code path)", "['pages']")
    if _dtype(kl) not in _POOL_DTYPES:
        c.err("PA1", f"pool payload dtype {_dtype(kl)} is not a storage "
                     f"format the fused kernel reads {_POOL_DTYPES}",
              "['pages']['k']")
    for name in ("k_scale", "v_scale"):
        if name not in pages:
            continue
        want = _shape(pages[name[0]])[:4]
        if _shape(pages[name]) != want:
            c.err("PA1", f"scale leaf shape {_shape(pages[name])} != "
                         f"payload (stack, n_pages, page, KV) prefix "
                         f"{want}", f"['pages']['{name}']")
        if _dtype(pages[name]) not in _FLOATS:
            c.err("PA1", f"per-token scale must be float32, got "
                         f"{_dtype(pages[name])}", f"['pages']['{name}']")


def _check_table_values(c: _Ctx, tval: np.ndarray, n_pages: int,
                        refcounts: Optional[dict]) -> None:
    """PC2 and PA3 over a concrete (stack, n_slots, nb) block table."""
    bad = (tval < 0) | (tval >= n_pages)
    if bad.any():
        ids = sorted(set(int(v) for v in tval[bad]))[:8]
        c.err("PC2", f"{int(bad.sum())} block-table entries reference "
                     f"pages outside the pool [0, {n_pages}): orphaned ids "
                     f"{ids}", "['table']")
    live = tval[0][tval[0] != 0]              # stack dim 0 is broadcast
    uniq, counts = np.unique(live, return_counts=True)
    shared = uniq[counts > 1]
    ledger = refcounts or {}
    unbooked = [int(p) for p in shared if int(p) not in ledger]
    if unbooked:
        c.warn("PC2", f"non-zero pages owned by multiple slots with no "
                      f"refcount ledger entry (enable prefix_cache for "
                      f"safe sharing): {unbooked[:8]}", "['table']")
    occ = tval[0] != 0                        # (n_slots, nb)
    holes = (~occ[:, :-1]) & occ[:, 1:]
    if holes.any():
        rows = sorted(set(int(r) for r in np.where(holes)[0]))[:8]
        c.err("PA3", f"slot rows {rows} have live pages after a trash-page "
                     f"hole; live blocks must be a contiguous prefix of the "
                     f"row", "['table']")


def _walk_paged(cache, path, findings: List[Finding],
                n_slots: Optional[int],
                refcounts: Optional[dict] = None) -> None:
    if not isinstance(cache, dict):
        return
    if "table" not in cache:
        for key, sub in cache.items():
            _walk_paged(sub, f"{path}['{key}']", findings, n_slots,
                        refcounts)
        return
    c = _Ctx(findings, path)
    table, pages = cache["table"], cache.get("pages")
    if not _is_integer(table):
        c.err("PC1", f"block table must be integer, got {_dtype(table)}",
              "['table']")
    tshape = _shape(table)
    if len(tshape) != 3:
        c.err("PC1", f"block table must be (stack, n_slots, nb), got "
                     f"{tshape}", "['table']")
        return
    if n_slots is not None and tshape[1] != n_slots:
        c.err("PC1", f"block table holds {tshape[1]} slots, scheduler has "
                     f"{n_slots}", "['table']")
    if not isinstance(pages, dict) or not pages:
        c.err("PC1", "paged KV node has a table but no page pool",
              "['pages']")
        return
    heads = {name: _shape(leaf)[:3] for name, leaf in pages.items()}
    first = next(iter(heads.values()))
    for name, h in heads.items():
        if len(h) < 3:
            c.err("PC1", f"pool leaf must be (stack, n_pages, page_size, "
                         f"...), got {_shape(pages[name])}",
                  f"['pages']['{name}']")
            return
        if h != first:
            c.err("PC1", f"pool leaves disagree on (stack, n_pages, "
                         f"page_size): {heads}", f"['pages']['{name}']")
    n_pages = first[1]
    if tshape[0] != first[0]:
        c.err("PC1", f"table stack dim {tshape[0]} != pool stack dim "
                     f"{first[0]}", "['table']")
    quantized = any(_dtype(v) in ("int8", "uint8")
                    for k, v in pages.items() if k in ("k", "v"))
    if quantized and not any(k.endswith("_scale") for k in pages):
        c.err("PC3", "quantized page pool is missing its per-token scale "
                     "leaves", "['pages']")
    if "k" in pages and "v" in pages:
        _check_pool_layout(c, pages)
    if n_pages < 2:
        c.err("PA2", f"page pool holds {n_pages} page(s); needs the "
                     f"reserved trash page 0 plus at least one allocatable "
                     f"page", "['pages']")
    if tshape[2] < 1:
        c.err("PA2", f"block table has {tshape[2]} blocks per slot; the "
                     f"fused kernel needs nb >= 1", "['table']")
    tval = _concrete(table)
    if tval is not None:
        _check_table_values(c, tval, n_pages, refcounts)


def validate_decode_state(state: Any, n_slots: Optional[int] = None,
                          refcounts: Optional[dict] = None) -> List[Finding]:
    """Contract-check a decode state's paged KV sub-trees (PC1-PC3,
    PA1-PA3).  Contiguous states have nothing paged and validate
    trivially.  ``refcounts`` (page id -> count, from the scheduler's
    prefix cache) marks pages whose multi-slot ownership is deliberate."""
    findings: List[Finding] = []
    cache = state.get("cache", state) if isinstance(state, dict) else state
    try:
        _walk_paged(cache, "state['cache']", findings, n_slots, refcounts)
    except Exception as e:
        findings.append(Finding(
            severity="error", pass_name="contracts", rule="PC0",
            path="state['cache']",
            message=f"validator could not walk this cache tree "
                    f"({type(e).__name__}: {e})"))
    return findings


def validate_scheduler(sched) -> List[Finding]:
    """PX1-PX3: checks of the scheduler's host-side ledger (duck-typed on
    :class:`repro_torch.serve.scheduler.Scheduler`).  Non-paged schedulers
    validate trivially."""
    findings: List[Finding] = []
    c = _Ctx(findings, "scheduler")
    if not getattr(sched, "paged", False) or sched.tables is None:
        return findings
    ps = sched.page_size
    live = {i: s for i, s in enumerate(sched.slots) if s is not None}
    # -- PX1: refcounts mirror live aliases; pool accounting closes -------
    owned: dict = {}
    for s in live.values():
        for p in s.pages:
            owned[p] = owned.get(p, 0) + 1
    held: dict = {}
    for s in live.values():
        for p in s.shared_pages:
            held[p] = held.get(p, 0) + 1
    if sched.prefix_cache is not None:
        refs = sched.prefix_cache.refcounts
        for p, n in refs.items():
            if held.get(p, 0) != n:
                c.err("PX1", f"page {p} has refcount {n} but "
                             f"{held.get(p, 0)} live slot(s) alias it")
        for p in held:
            if p not in refs:
                c.err("PX1", f"slot-shared page {p} is not registered in "
                             f"the prefix cache")
        for p in refs:
            owned[p] = owned.get(p, 0) + 1
    else:
        for p, n in held.items():
            owned[p] = owned.get(p, 0) + n
    multi = sorted(p for p, n in owned.items() if n > 1)
    if multi:
        c.err("PX1", f"pages owned more than once (slot-private lists / "
                     f"cache registry overlap): {multi[:8]}")
    if sched.allocator.in_use != len(owned):
        c.err("PX1", f"allocator reports {sched.allocator.in_use} pages in "
                     f"use but live slots + prefix cache own {len(owned)} "
                     f"(parked snapshots must hold no pool pages)")
    # -- PX2: shared prefix strictly behind the write frontier ------------
    for i, s in live.items():
        if s.n_shared and s.index < s.n_shared * ps:
            c.err("PX2", f"slot {i} write frontier {s.index} falls inside "
                         f"its shared-prefix region [0, {s.n_shared * ps}) "
                         f"— a decode/prefill write would corrupt a page "
                         f"other requests alias")
    # -- PX3: device tables mirror the ledger; parked rows are zeroed -----
    for i in range(sched.n_slots):
        row = np.asarray(sched.tables[i])
        s = sched.slots[i]
        if s is None:
            stale = sorted(set(int(p) for p in row[row != 0]))
            if stale:
                c.err("PX3", f"free/parked slot row {i} still references "
                             f"pages {stale[:8]}; swapped-out state lives "
                             f"in the host snapshot only")
        else:
            bp = [int(p) for p in s.block_pages]
            if [int(p) for p in row[:len(bp)]] != bp or row[len(bp):].any():
                c.err("PX3", f"slot {i} table row {row.tolist()} does not "
                             f"mirror its book-kept pages {bp}")
    return findings


# ---------------------------------------------------------------------------
# deployed serving leaves (SW1-SW4, BP1-BP3)
# ---------------------------------------------------------------------------

def _values(x) -> Optional[torch.Tensor]:
    """The leaf as a tensor for value checks, on its own device; None for
    a leaf without values (the ``meta`` device).  Checks reduce on that
    device and bring back only their verdicts."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return x.detach()
    return None


def _grid_geometry(c: _Ctx, scale, spec, shape) -> Optional[tuple]:
    """Shared SW1/SW2/BP3 geometry: returns (lead, K, N, Kp, Np) or None."""
    sshape = _shape(scale)
    if len(sshape) < 2:
        c.err("SW1", f"per-WB scale must be (..., GR, GC), got {sshape}",
              ".scale")
        return None
    wbr, wbc = spec.wb_rows, spec.wb_cols
    gr, gc = sshape[-2], sshape[-1]
    kp, np_ = gr * wbr, gc * wbc
    if not (isinstance(shape, tuple) and len(shape) >= 2):
        c.err("SW2", f"true shape must be a (..., K, N) tuple, got {shape!r}",
              ".shape")
        return None
    k, n = shape[-2], shape[-1]
    lead = tuple(shape[:-2])
    if not (0 < k <= kp and kp - k < wbr):
        c.err("SW2", f"scale grid GR={gr} (Kp={kp}) is not the minimal "
                     f"{wbr}-row cover of K={k}", ".scale")
    if not (0 < n <= np_ and np_ - n < wbc):
        c.err("SW2", f"scale grid GC={gc} (Np={np_}) is not the minimal "
                     f"{wbc}-col cover of N={n}", ".scale")
    if sshape[:-2] != lead:
        c.err("SW3", f"scale stack dims {sshape[:-2]} != leaf stack dims "
                     f"{lead} (layer-stack dims must LEAD)", ".scale")
    if _dtype(scale) not in _FLOATS:
        c.err("BP3", f"scale LUT must be float32, got {_dtype(scale)}",
              ".scale")
    sval = _values(scale)
    if sval is not None and sval.is_floating_point() \
            and not bool(torch.isfinite(sval).all()):
        c.err("BP3", "scale LUT has non-finite entries", ".scale")
    return lead, k, n, kp, np_


def _check_serving_weight(c: _Ctx, sw) -> None:
    geo = _grid_geometry(c, sw.scale, sw.spec, sw.shape)
    if geo is None:
        return
    lead, k, n, kp, np_ = geo
    wshape = _shape(sw.w_int)
    if sw.bits == 8:
        want = lead + (kp, np_)
        if wshape != want:
            c.err("SW4", f"int8 payload shape {wshape} != {want}", ".w_int")
        if _dtype(sw.w_int) != "int8":
            c.err("SW4", f"bits=8 payload must be int8, got "
                         f"{_dtype(sw.w_int)}", ".w_int")
    elif sw.bits == 4:
        want = lead + (-(-kp // 2), np_)
        if wshape != want:
            c.err("SW4", f"int4 nibble payload shape {wshape} != {want} "
                         f"(pairs packed along K, odd Kp pads one zero row)",
                  ".w_int")
        if _dtype(sw.w_int) != "uint8":
            c.err("SW4", f"bits=4 payload must be uint8 nibble pairs, got "
                         f"{_dtype(sw.w_int)}", ".w_int")
        wval = _values(sw.w_int)
        if wval is not None and kp % 2 and wshape == want:
            nz = int(((wval[..., -1, :] >> 4) != 0).sum())
            if nz:
                c.err("SW4", f"odd block-padded K={kp}: high pad nibble of "
                             f"the last byte row must be 0, found {nz} "
                             f"non-zero entries", ".w_int")
    else:
        c.err("SW4", f"bits must be 4 or 8, got {sw.bits}", ".bits")
        return
    if len(wshape) >= 2 and wshape[:-2] != lead:
        c.err("SW3", f"payload stack dims {wshape[:-2]} != leaf stack dims "
                     f"{lead} (layer-stack dims must LEAD)", ".w_int")


def _check_mask_values(c: _Ctx, mval: torch.Tensor, bits: int) -> None:
    """BP2's value rules: binary, occupancy <= bits, prefix-monotone."""
    binary = (mval == 0) | (mval == 1)
    if not bool(binary.all()):
        c.err("BP2", f"mask LUT must be binary; "
                     f"{int((~binary).sum())} entries outside {{0, 1}} "
                     f"(max {float(mval.max())})", ".mask")
        return
    occ = mval.sum(dim=-3)
    if occ.numel() and float(occ.max()) > bits:
        c.err("BP2", f"plane occupancy {int(occ.max())} exceeds the "
                     f"container bits={bits}", ".mask")
    # live planes must be the LOW planes: occupancy is a prefix
    if not bool(torch.equal(torch.cumprod(mval, dim=-3), mval)):
        c.err("BP2", "mask is not prefix-monotone along the bit axis: a "
                     "live plane b requires plane b-1 live (occupancy = "
                     "min(bw, bits) LOW planes)", ".mask")


def _check_bitplane_weight(c: _Ctx, sw) -> None:
    geo = _grid_geometry(c, sw.scale, sw.spec, sw.shape)
    if geo is None:
        return
    lead, k, n, kp, np_ = geo
    kp8 = -(-kp // 8) * 8
    bits = sw.bits
    pshape, gshape, mshape = _shape(sw.planes), _shape(sw.sign), \
        _shape(sw.mask)
    want_p = lead + (bits, kp8 // 8, np_)
    if pshape != want_p:
        c.err("BP1", f"packed planes shape {pshape} != {want_p} "
                     f"(bits, byte-padded K rows, Np; stack dims lead)",
              ".planes")
    want_s = lead + (kp8 // 8, np_)
    if gshape != want_s:
        c.err("BP1", f"packed sign plane shape {gshape} != {want_s} "
                     f"(truncated/misaligned sign plane)", ".sign")
    for name, leaf in (("planes", sw.planes), ("sign", sw.sign)):
        if _dtype(leaf) != "uint8":
            c.err("BP1", f"{name} must be uint8 bit-packed, got "
                         f"{_dtype(leaf)}", f".{name}")
    gr_gc = _shape(sw.scale)[-2:]
    want_m = lead + (bits, gr_gc[0], gr_gc[1]) if gr_gc else None
    if mshape != want_m:
        c.err("BP2", f"mask LUT shape {mshape} != {want_m} "
                     f"((bits, GR, GC) with stack dims leading)", ".mask")
    if _dtype(sw.mask) not in _FLOATS:
        c.err("BP2", f"mask LUT must be float32 in {{0, 1}}, got "
                     f"{_dtype(sw.mask)}", ".mask")
    mval = _values(sw.mask)
    if mval is not None and mshape == want_m:
        _check_mask_values(c, mval, bits)
    if kp8 > kp and kp % 8:
        # byte-pad rows live in the last byte row: bit positions kp%8..7
        padmask = 0xFF & ~((1 << (kp % 8)) - 1)
        for name, leaf, want in (("planes", sw.planes, want_p),
                                 ("sign", sw.sign, want_s)):
            val = _values(leaf)
            if val is not None and _shape(leaf) == want \
                    and bool((val[..., kp // 8, :] & padmask).any()):
                c.err("BP1", f"byte-pad rows [{kp}, {kp8}) of {name} "
                             f"must be zero", f".{name}")


def _deployed_types():
    from ..serve.deploy import BitplaneServingWeight, ServingWeight
    return ServingWeight, BitplaneServingWeight


def iter_deployed_leaves(params: Any):
    """(keystr path, leaf) for every deployed serving leaf, in the
    reference's flatten order (dict keys sorted)."""
    from ..core.state import quant_nodes
    return quant_nodes(params, _deployed_types()).items()


def validate_serving_tree(params: Any) -> List[Finding]:
    """Contract-check every deployed leaf of ``params`` (SW1-SW4 for
    packed leaves, BP1-BP3 and the shared geometry for bit-plane ones).

    Never raises on a malformed tree: a leaf whose corruption breaks the
    validator itself yields one path-qualified ``SW0`` error; a tree
    without deployed leaves yields one ``SW0`` info."""
    _, bp_t = _deployed_types()
    findings: List[Finding] = []
    n_checked = 0
    for path, leaf in iter_deployed_leaves(params):
        c = _Ctx(findings, path)
        n_checked += 1
        try:
            if isinstance(leaf, bp_t):
                _check_bitplane_weight(c, leaf)
            else:
                _check_serving_weight(c, leaf)
        except Exception as e:                      # corrupted beyond checks
            c.err("SW0", f"validator could not interpret this leaf "
                         f"({type(e).__name__}: {e})")
    if n_checked == 0:
        findings.append(Finding(
            severity="info", pass_name="contracts", rule="SW0",
            path="<tree>", message="no deployed serving leaves to check"))
    return findings


# ---------------------------------------------------------------------------
# checkpoint shard-manifest validation (CK1-CK3)
# ---------------------------------------------------------------------------

def _npz_headers(fp: str) -> dict:
    """npz member -> (shape, dtype name) from the .npy headers alone (no
    array is read).  A 2-byte void member is named ``bfloat16``, the
    dtype a checkpoint's META gives it."""
    import zipfile
    fmt = np.lib.format
    out = {}
    with zipfile.ZipFile(fp) as zf:
        for name in zf.namelist():
            if not name.endswith(".npy"):
                continue
            with zf.open(name) as f:
                version = fmt.read_magic(f)
                read = fmt.read_array_header_1_0 if version == (1, 0) \
                    else fmt.read_array_header_2_0
                shape, _, dtype = read(f)
            dname = "bfloat16" if dtype.kind == "V" and dtype.itemsize == 2 \
                else str(dtype)
            out[name[:-4]] = (tuple(shape), dname)
    return out


def validate_checkpoint(path: str) -> List[Finding]:
    """CK1-CK3: validate a (sharded) checkpoint directory on disk.

    * ``CK1`` META is well formed: known format, manifest entries carry
      (key, shape, dtype, spec), every spec axis exists in ``mesh_axes``
      and its axis group divides the dim, sanitized npz keys are unique;
    * ``CK2`` the shard set is complete: every shard file META promises
      exists and each leaf's owning shards hold a chunk of exactly the
      expected shape and dtype;
    * ``CK3`` no orphans: shard files hold no array absent from the
      manifest (or a chunk they do not own), and no ``.tmp``/``.old``
      commit debris sits beside the checkpoint (a warning).

    Reads META and the npy headers only, so it is cheap for multi-GB
    checkpoints.  Legacy (format 1) checkpoints validate trivially."""
    import json
    import os
    import re as _re

    from ..ckpt.checkpoint import _chunk_slices
    findings: List[Finding] = []
    c = _Ctx(findings, path)
    meta_path = os.path.join(path, "META")
    if not os.path.exists(meta_path):
        c.err("CK1", "no META file: not a checkpoint directory")
        return findings
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except Exception as e:
        c.err("CK1", f"META is not valid JSON ({type(e).__name__}: {e})")
        return findings
    fmt = meta.get("format", 1)
    if fmt == 1:
        if not os.path.exists(os.path.join(path, "arrays.npz")):
            c.err("CK2", "legacy checkpoint is missing arrays.npz")
        return findings
    if fmt != 2:
        c.err("CK1", f"unknown checkpoint format {fmt!r}")
        return findings
    manifest = meta.get("manifest")
    mesh_axes = meta.get("mesh_axes", {})
    axes = meta.get("shard_axes", [])
    hosts = meta.get("hosts", [])
    n = meta.get("n_shards", 0)
    if not isinstance(manifest, dict) or not isinstance(hosts, list) \
            or len(hosts) != n:
        n_hosts = len(hosts) if isinstance(hosts, list) else "?"
        c.err("CK1", f"META manifest/hosts malformed "
                     f"(n_shards={n}, hosts={n_hosts})")
        return findings
    fields = ("key", "shape", "dtype", "spec")
    sanitized: dict = {}
    for key, ent in manifest.items():
        sub = f"[{key!r}]"
        if not all(f in ent for f in fields):
            c.err("CK1", "manifest entry lacks key/shape/dtype/spec fields",
                  sub)
            continue
        sk = ent["key"]
        if sk in sanitized:
            c.err("CK1", f"sanitized npz key {sk!r} collides with "
                         f"{sanitized[sk]!r}", sub)
        sanitized[sk] = key
        shape, spec = ent["shape"], ent["spec"]
        if len(spec) != len(shape):
            c.err("CK1", f"spec has {len(spec)} entries for a rank-"
                         f"{len(shape)} leaf", sub)
            continue
        for dim, entry in zip(shape, spec):
            if not entry:
                continue
            group = 1
            for a in entry:
                if a not in mesh_axes:
                    c.err("CK1", f"spec axis {a!r} not in the saving "
                                 f"mesh axes {sorted(mesh_axes)}", sub)
                    group = 0
                    break
                group *= mesh_axes[a]
            if group and dim % group:
                c.err("CK1", f"dim {dim} is not divisible by its axis "
                             f"group {entry} (size {group}): chunks "
                             f"cannot tile the leaf", sub)
    # -- CK2: every promised shard file exists and holds the right chunks
    headers: dict = {}
    for h in range(n):
        name = f"shard_{h:05d}-of-{n:05d}.npz"
        fp = os.path.join(path, name)
        if not os.path.exists(fp):
            c.err("CK2", f"missing shard file {name} (host {hosts[h]})")
            continue
        try:
            headers[h] = _npz_headers(fp)
        except Exception as e:
            c.err("CK2", f"unreadable shard file {name} "
                         f"({type(e).__name__}: {e})")
    coord_maps = [dict(zip(axes, co)) for co in hosts]
    for key, ent in manifest.items():
        if not all(f in ent for f in fields):
            continue
        shape = tuple(ent["shape"])
        for h, coords in enumerate(coord_maps):
            if h not in headers:
                continue
            sl = _chunk_slices(shape, ent["spec"], mesh_axes, coords)
            if sl is None:
                if ent["key"] in headers[h]:
                    c.err("CK3", f"shard {h} holds a chunk of "
                                 f"[{key!r}] it does not own")
                continue
            got = headers[h].get(ent["key"])
            want = tuple(len(range(*s.indices(d)))
                         for s, d in zip(sl, shape))
            if got is None:
                c.err("CK2", f"shard {h} is missing its chunk of "
                             f"[{key!r}]")
            elif got != (want, ent["dtype"]):
                c.err("CK2", f"shard {h} chunk of [{key!r}] is "
                             f"{got[1]}{got[0]}, expected "
                             f"{ent['dtype']}{want}")
    # -- CK3: orphan arrays + commit debris
    expected = {ent["key"] for ent in manifest.values() if "key" in ent}
    for h, hdr in headers.items():
        orphans = sorted(set(hdr) - expected)
        if orphans:
            c.err("CK3", f"shard {h} holds {len(orphans)} arrays absent "
                         f"from the manifest: {orphans[:4]}")
    parent = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(os.path.abspath(path))
    for name in os.listdir(parent):
        if _re.fullmatch(_re.escape(base) + r"\.(tmp|old)\.[0-9a-f]{8}",
                         name):
            c.warn("CK3", f"stale commit debris {name!r} next to the "
                          f"checkpoint (crashed save; gc will sweep it)")
    if not findings:
        findings.append(Finding(
            severity="info", pass_name="contracts", rule="CK0",
            path=path, message=f"checkpoint valid: {len(manifest)} leaves "
                               f"across {n} shard(s), mesh {mesh_axes}"))
    return findings


# ---------------------------------------------------------------------------
# autotune / speculative-draft validation (AT1-AT2)
# ---------------------------------------------------------------------------

def validate_allocation(params: Any, budget_bytes: int) -> List[Finding]:
    """AT1: an autotuned tree respects its byte budget exactly, by the
    same per-block occupancy accounting the allocator optimized against
    (``weight_stream_bytes``)."""
    from ..serve.deploy import weight_stream_bytes
    findings: List[Finding] = []
    total = weight_stream_bytes(params)
    if total > budget_bytes:
        findings.append(Finding(
            severity="error", pass_name="contracts", rule="AT1",
            path="<tree>",
            message=f"allocation streams {total} B per step, over the "
                    f"{budget_bytes} B budget"))
    return findings


def validate_draft_truncation(draft: Any, deployed: Any) -> List[Finding]:
    """AT2: a draft tree is a pure top-k mask-truncation view: for every
    bit-plane leaf pair the payload tensors (planes/sign/scale) are the
    deployed tree's own objects, and each block's draft mask keeps a
    contiguous run of the highest deployed live planes, with one
    truncation depth k across the leaf."""
    _, bp_t = _deployed_types()
    findings: List[Finding] = []
    dep = {p: leaf for p, leaf in iter_deployed_leaves(deployed)
           if isinstance(leaf, bp_t)}
    drf = {p: leaf for p, leaf in iter_deployed_leaves(draft)
           if isinstance(leaf, bp_t)}
    if set(dep) != set(drf):
        findings.append(Finding(
            severity="error", pass_name="contracts", rule="AT2",
            path="<tree>",
            message=f"draft/deployed bitplane leaves differ: "
                    f"{sorted(set(dep) ^ set(drf))[:4]}"))
        return findings
    for p in sorted(dep):
        c = _Ctx(findings, p)
        d, f = dep[p], drf[p]
        for name in ("planes", "sign", "scale"):
            if getattr(d, name) is not getattr(f, name):
                c.warn("AT2", f".{name} is not shared with the deployed "
                              f"tree (draft should be a zero-copy view)")
        dm, fm = _values(d.mask), _values(f.mask)
        if dm is None or fm is None:
            continue
        if fm.shape != dm.shape:
            c.err("AT2", f".mask shape {tuple(fm.shape)} != deployed "
                         f"{tuple(dm.shape)}")
            continue
        fm = fm.to(dm.device)
        if bool(((fm > 0) & (dm == 0)).any()):
            c.err("AT2", ".mask lights planes dead in the deployed tree "
                         "(draft must be a subset view)")
            continue
        occ = dm.sum(dim=-3)                           # (..., GR, GC)
        k_blk = fm.sum(dim=-3)
        bits = dm.shape[-3]
        idx = torch.arange(bits, device=dm.device).reshape(bits, 1, 1)
        lo = (occ - k_blk).unsqueeze(-3)
        want = ((idx >= lo) & (idx < occ.unsqueeze(-3))).to(fm.dtype)
        if not bool(torch.equal(fm, want)):
            c.err("AT2", ".mask is not a contiguous top run of the "
                         "deployed live planes")
            continue
        # one truncation depth k per leaf: every block keeps min(occ, k)
        if k_blk.numel() and float(k_blk.max()) > 0:
            k = k_blk.max()
            if not bool(torch.equal(k_blk, torch.minimum(occ, k))):
                c.err("AT2", "inconsistent truncation depth across blocks "
                             "(mask is not a single top-k view)")
    return findings
