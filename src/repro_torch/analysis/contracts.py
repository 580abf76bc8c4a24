"""Contract validation of the decode state and the scheduler's ledger
(port of ``validate_decode_state`` and ``validate_scheduler`` from
``repro.analysis.contracts``).

These are what :meth:`repro_torch.serve.scheduler.Scheduler.validate`
returns.  Each violation is one path-qualified
:class:`~repro_torch.analysis.report.Finding`, never a crash.

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
