"""Slot-based continuous-batching scheduler with a paged KV option (port of
``repro.serve.scheduler``).

A fixed-capacity decode batch of ``n_slots`` rows; requests are admitted
into free slots as they arrive (their prompt is prefilled INTO the live
cache at that batch row), every live slot advances one token per tick
through one decode step with a per-slot index vector, and slots retire on
EOS / max-token budget, freeing the row for the next waiting request.
Rows are independent in attention (masked by each slot's own fill level),
so on the CPU a request's tokens are identical whether it runs one-shot
or staggered through a live batch.  On the card the kernels' launch plans
depend on the batch shape (``kernels/tiling.py``), so the sums of a row
are taken in another order than at B=1.

Extensions over the fixed-width layout, as in the reference:

* ``page_size > 0`` — **paged KV cache**: K/V live in a global pool of
  fixed-size pages addressed through per-slot block tables.  The
  scheduler owns a host-side free list (page 0 is the reserved trash page
  that free and parked rows write into): a request is admitted when its
  worst-case page total fits the pool's reservation headroom, takes only
  its prompt's pages up front, grows one page at a time as decode crosses
  block boundaries, and returns everything on retirement.
* ``prefill_chunk > 0`` — **chunked prefill**: prompts longer than the
  chunk width are inserted over several ticks, one chunk per tick
  (``ModelAPI.prefill_chunk_at``), interleaved with the other slots'
  decode steps.  The final chunk is padded to the chunk width (never past
  the slot's cache extent); padded positions stay masked until decode
  overwrites them.
* **priority classes** — ``SamplingParams.priority`` orders the waiting
  queue (higher first, ties by arrival tick then submission order), and
  admission *skips over* requests the pool cannot host yet.
* ``overcommit > 1`` — **reservation overcommit with preemption**: when
  decode growth finds the free list empty, the lowest-priority / most
  recently admitted victim is **parked**: its pool pages are copied to
  host memory bit for bit (``ServeEngine.park_slot``), its pages return
  to the free list, and the request rejoins the queue to resume later
  (``restore_slot``).
* ``prefix_cache=True`` — **content-addressed prefix caching**: every
  complete prompt page strictly before the last prompt token is keyed by
  a chained token-content hash in a refcounted :class:`PrefixCache`; a
  later request with the same leading tokens aliases those read-only
  pages through its block table and prefills only the rest.

Time is measured in scheduler *ticks* (one decode step per tick).  With
``record_ticks`` the port keeps a per-tick ``tick_log`` (what each tick
ran, which requests got their first token and which were parked), from
which a run's kernel launches and first-token ticks are derived; without
it (the default, as the reference) no per-tick record is kept.  As in the
reference, an MoE model under capacity dispatch
(``models.moe.GROUPED_IMPL["impl"] == "capacity"``) warns: other slots'
tokens compete for expert capacity, so a request may part from its
one-shot tokens; the exact ``ragged`` dispatch keeps rows independent.
An encoder-decoder request's ``frames`` ride its first chunk (the
encoder runs once, into the slot's ``enc_out`` row, parked and restored
with its pages), every request must share the live batch's encoder
length, and ``prefix_cache`` is turned off with a warning, as for any
family but dense and moe: its per-slot encoder buffer is not in the
hashed tokens.  A vlm request's ``vision_embeds`` ride its first chunk
(starting at cache position 0), and its later chunks start at their
cache position, the vision prefix included.  The recurrent families
(ssm, hybrid) always insert a prompt whole: their state has no fill-level
mask, so padding would pollute it, and the chunked scans are only
approximately invariant to where a prompt is cut.  The ssm family has no
KV cache, so ``page_size`` is ignored for it, with a warning.
``compile_footprint`` censuses the distinct call shapes a workload
reaches (``analysis.footprint``): in the eager port one launch-plan entry
a shape, where the reference counts one XLA compile.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from .sampling import (GenerationResult, Request, sample_token,
                       token_generator)


def _host_tokens(inputs) -> np.ndarray:
    """A request's (1, P) prompt tokens as a host int32 array."""
    toks = inputs["tokens"]
    if isinstance(toks, torch.Tensor):
        toks = toks.cpu().numpy()
    return np.asarray(toks, np.int32)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class _Slot:
    """Book-keeping for one live request occupying one batch row."""
    req: Request
    index: int                    # fill level: next cache write position
    last_tok: int
    generated: List[int]
    admitted_tick: int
    pages: List[int] = dataclasses.field(default_factory=list)
    reserve_left: int = 0         # growth pages still drawable from pool
    # queued prompt chunks: (inputs, start, last-logit column or None)
    chunks: List[tuple] = dataclasses.field(default_factory=list)
    # refcounted prefix-cache pages aliased at the block-table head; the
    # slot's own pages follow at blocks [n_shared, n_shared + len(pages))
    shared_pages: List[int] = dataclasses.field(default_factory=list)
    # chained content hashes of the prompt's sharable full pages
    prefix_hashes: List[bytes] = dataclasses.field(default_factory=list)

    @property
    def n_shared(self) -> int:
        return len(self.shared_pages)

    @property
    def n_blocks(self) -> int:
        return len(self.shared_pages) + len(self.pages)

    @property
    def block_pages(self) -> List[int]:
        return self.shared_pages + self.pages


@dataclasses.dataclass
class _Parked:
    """A preempted request waiting to resume: the bit-exact host snapshot
    of its pool pages, plus the book-keeping to pick up decoding where it
    stopped."""
    req: Request
    index: int
    last_tok: int
    generated: List[int]
    admitted_tick: int
    chunks: List[tuple]
    prefix_hashes: List[bytes]
    n_blocks: int                 # block-table entries the snapshot holds
    reserve_need: int             # growth pages still needed after resume
    record: Any                   # ServeEngine.park_slot host snapshot


def _entry_req(entry) -> Request:
    return entry.req if isinstance(entry, _Parked) else entry


def _queue_key(seq_of: Dict[int, int]):
    """Waiting-queue order: priority desc, arrival asc, submission asc.
    Parked requests keep their original request's key (no re-queue
    penalty, no queue jumping)."""
    def key(entry):
        r = _entry_req(entry)
        return (-r.sampling.priority, r.arrival, seq_of[r.uid])
    return key


class PageAllocator:
    """Host-side free list over the global page pool.

    Page 0 is reserved as the trash page, so capacity ``n_pages`` serves at
    most ``n_pages - 1`` live pages.  The free list is a min-heap, so
    allocation pops the globally lowest free id no matter how slots
    churned — traces are deterministic and replayable.

    Admission is *reservation*-based: a request enters a slot only when
    its worst-case page total fits the reservation headroom, and its
    not-yet-drawn tail is recorded in ``reserved``.  Pages are allocated
    lazily, so ``in_use``/``peak_in_use`` track tokens actually held.
    With ``overcommit=1.0`` mid-decode growth can never exhaust the pool;
    ``overcommit > 1`` admits up to that multiple of physical capacity in
    promises, and the scheduler parks victims when :meth:`alloc` then
    comes up empty."""

    def __init__(self, n_pages: int, overcommit: float = 1.0):
        if n_pages < 2:
            raise ValueError(f"page pool needs >= 2 pages (one is the "
                             f"reserved trash page), got {n_pages}")
        if overcommit < 1.0:
            raise ValueError(f"overcommit must be >= 1.0, got {overcommit}")
        self.n_pages = n_pages
        self.overcommit = overcommit
        self._free = list(range(1, n_pages))        # already heap-ordered
        self.reserved = 0          # promised to live slots, not yet drawn
        self.peak_in_use = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def can_admit(self, total_pages: int, now: int = 0) -> bool:
        """``total_pages`` new worst-case promises fit the (possibly
        overcommitted) reservation budget, and the ``now`` pages needed
        immediately are physically on the free list."""
        cap = int((self.n_pages - 1) * self.overcommit)
        return (total_pages + self.in_use + self.reserved <= cap
                and now <= len(self._free))

    def alloc(self, n: int, from_reserve: int = 0) -> Optional[List[int]]:
        """n pages (releasing ``from_reserve`` of the caller's
        reservation), or None if the free list cannot satisfy it."""
        if n > len(self._free):
            return None
        self.reserved -= from_reserve
        pages = [heapq.heappop(self._free) for _ in range(n)]
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def release(self, pages: List[int], from_reserve: int = 0) -> None:
        self.reserved -= from_reserve
        for p in pages:
            heapq.heappush(self._free, p)


class PrefixCache:
    """Content-addressed, refcounted registry of read-only prompt pages.

    Keys are *chained* hashes: page j's key digests page j-1's key plus
    page j's tokens, so a hit at block j certifies the whole prefix
    [0, (j+1) * page_size) and lookups stop at the first miss.  Ownership
    of a registered page transfers here: the registering slot holds one
    reference like any later aliaser, and :meth:`release` hands the page
    id back (for the allocator's free list) once the last reference
    drops."""

    def __init__(self):
        self._page_of: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._refs: Dict[int, int] = {}
        self.hits = 0              # page-granular hit counter
        self.lookups = 0

    def __len__(self) -> int:
        return len(self._page_of)

    @property
    def refcounts(self) -> Dict[int, int]:
        return dict(self._refs)

    @property
    def outstanding_refs(self) -> int:
        return sum(self._refs.values())

    @staticmethod
    def chain(prev: bytes, tokens: np.ndarray) -> bytes:
        return hashlib.sha256(
            prev + np.ascontiguousarray(tokens, np.int32).tobytes()).digest()

    def lookup(self, h: bytes) -> Optional[int]:
        self.lookups += 1
        page = self._page_of.get(h)
        if page is not None:
            self.hits += 1
        return page

    def acquire(self, page: int) -> None:
        self._refs[page] += 1

    def register(self, h: bytes, page: int) -> None:
        """Publish ``page`` under ``h``; the registering slot holds the
        first reference."""
        if h in self._page_of:
            raise ValueError(f"hash already registered to page "
                             f"{self._page_of[h]}")
        self._page_of[h] = page
        self._hash_of[page] = h
        self._refs[page] = 1

    def release(self, page: int) -> bool:
        """Drop one reference; True when the page just became free (the
        caller returns it to the allocator)."""
        self._refs[page] -= 1
        if self._refs[page] > 0:
            return False
        del self._refs[page]
        del self._page_of[self._hash_of.pop(page)]
        return True


def _paged_pool_bytes(cache) -> int:
    """Total at-rest bytes of every page-pool leaf in a cache tree."""
    if isinstance(cache, dict):
        if "table" in cache:
            return sum(_nbytes(leaf) for leaf in cache["pages"].values())
        return sum(_paged_pool_bytes(v) for v in cache.values())
    return 0


def _kv_resident_bytes(cache) -> int:
    """At-rest bytes of a contiguous cache's KV leaves (k/v + scales)."""
    if isinstance(cache, dict):
        if "k" in cache and "v" in cache:
            return sum(_nbytes(leaf) for leaf in cache.values())
        return sum(_kv_resident_bytes(v) for v in cache.values())
    return 0


# families whose paged KV cache is purely positional and whose prompts are
# token-only: prefix pages can be shared by token-content hash alone (an
# enc-dec slot carries a per-request encoder buffer)
_PREFIX_CACHE_FAMILIES = ("dense", "moe")


def _tile_rows(tree, n_slots: int):
    """A single-row cache tree tiled to ``n_slots`` rows along dim 1, as
    separate storage: the cache is written in place, so a broadcast
    (stride-0) view would land one slot's writes in every row."""
    if isinstance(tree, dict):
        return {k: _tile_rows(v, n_slots) for k, v in tree.items()}
    return tree.repeat(1, n_slots, *([1] * (tree.ndim - 2)))


class Scheduler:
    """Continuous batching over a :class:`ServeEngine`, on the engine's
    device (the CUDA card unless the engine was built for another; raises
    when that card is missing).

    ``max_len`` is the per-slot cache width; a request needs
    ``prompt_width + max_new_tokens - 1 <= max_len`` positions.  With the
    fixed-width cache the decode state is created lazily on the first
    admission (the first prompt's prefill, tiled across all rows).  Paged /
    chunked modes build a zeroed state via ``init_decode_state`` instead
    and insert every prompt through the same block-table write path.

    ``overcommit`` (> 1, paged only) admits more worst-case reservations
    than the pool physically holds and parks victims on exhaustion;
    ``prefix_cache`` (paged only) shares complete prompt pages across
    requests by content hash."""

    def __init__(self, engine, n_slots: int = 8, max_len: int = 256,
                 page_size: int = 0, n_pages: Optional[int] = None,
                 prefill_chunk: int = 0, overcommit: float = 1.0,
                 prefix_cache: bool = False, record_ticks: bool = False):
        self.engine = engine
        self.device = resolve_device(engine.device)
        self.n_slots = n_slots
        self.max_len = max_len
        cfg = engine.api.cfg
        if page_size and cfg.family == "ssm":
            warnings.warn("family 'ssm' has no KV cache to page; "
                          "page_size ignored", stacklevel=3)
            page_size = 0
        if cfg.n_experts:
            from ..models.moe import GROUPED_IMPL
            if GROUPED_IMPL["impl"] == "capacity":
                warnings.warn(
                    "continuous batching with capacity-dropping MoE "
                    "dispatch: parked slots' dummy tokens compete for "
                    "expert capacity, so live requests may diverge from "
                    "one-shot generate(); use GROUPED_IMPL['impl']="
                    "'ragged' for exact parity", stacklevel=3)
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.paged = page_size > 0
        if overcommit > 1.0 and not self.paged:
            raise ValueError("overcommit > 1 needs a paged cache "
                             "(page_size > 0): preemption parks pool "
                             "pages, fixed-width slots have none")
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache needs a paged cache "
                             "(page_size > 0): sharing happens through "
                             "the block table")
        if prefix_cache and cfg.family not in _PREFIX_CACHE_FAMILIES:
            warnings.warn(
                f"prefix_cache needs a purely positional token-only KV "
                f"cache; family {cfg.family!r} carries per-request "
                f"vision/encoder/recurrent state — disabled", stacklevel=3)
            prefix_cache = False
        self.overcommit = overcommit
        if self.paged:
            self.nb = -(-max_len // page_size)
            self.total_len = self.nb * page_size
            self.allocator = PageAllocator(n_pages or 1 + n_slots * self.nb,
                                           overcommit=overcommit)
            self.tables = np.zeros((n_slots, self.nb), np.int32)
        else:
            self.nb = 0
            self.total_len = max_len
            self.allocator = None
            self.tables = None
        self.prefix_cache: Optional[PrefixCache] = \
            PrefixCache() if prefix_cache else None
        self._tables_dirty = False
        # paged / chunked prompts go through the zero-state insertion path
        self._insert_path = self.paged or prefill_chunk > 0
        self.state: Any = None
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.waiting: List[Any] = []       # Request | _Parked, queue-ordered
        self._seq_of: Dict[int, int] = {}  # uid -> submission sequence
        self.tick = 0
        self.results: Dict[int, GenerationResult] = {}
        # speculative-decode accounting (acceptance rate)
        self.spec_stats: Dict[str, int] = {
            "rounds": 0, "drafted": 0, "accepted_drafts": 0, "emitted": 0}
        # priority / preemption / prefix-cache accounting
        self.sched_stats: Dict[str, int] = {
            "preemptions": 0, "resumes": 0, "cow_copies": 0,
            "prefix_lookups": 0, "prefix_hits": 0, "prefix_hit_tokens": 0,
            "prefix_pages_registered": 0}
        # with record_ticks, one record a tick: the widths of the prompts /
        # chunks it inserted (cache positions, a vision prefix included),
        # its plain decode forwards (0/1), draft
        # forwards and verify width, the live decoding slots, the uids that
        # got their first token and those it parked; the current tick's
        # record is kept either way
        self.tick_log: Optional[List[Dict[str, Any]]] = \
            [] if record_ticks else None
        self._log: Dict[str, Any] = {}

    # ---- submission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.uid in self.results or \
                any(_entry_req(e).uid == req.uid for e in self.waiting) or \
                any(s is not None and s.req.uid == req.uid
                    for s in self.slots):
            raise ValueError(f"duplicate request uid {req.uid}")
        need = self.engine.prompt_width(req.inputs) + \
            req.sampling.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"request {req.uid} needs {need} cache positions, "
                f"scheduler max_len is {self.max_len}")
        if self.paged:
            pages = -(-need // self.page_size)
            if pages > self.allocator.n_pages - 1:
                raise ValueError(
                    f"request {req.uid} needs {pages} pages, pool capacity "
                    f"is {self.allocator.n_pages - 1} live pages "
                    f"(overcommit promises concurrency, not capacity)")
        self._seq_of[req.uid] = len(self._seq_of)
        self.waiting.append(req)
        self._sort_waiting()

    def _sort_waiting(self) -> None:
        self.waiting.sort(key=_queue_key(self._seq_of))

    # ---- admission -------------------------------------------------------
    def _first_token(self, slot: _Slot, logits_row) -> None:
        sp = slot.req.sampling
        row = logits_row.to(torch.float32).cpu()
        if sp.temperature > 0:
            tok = int(sample_token(row, sp, token_generator(
                sp.seed, len(slot.generated))))
        else:
            tok = int(row.argmax())
        slot.generated.append(tok)
        slot.last_tok = tok
        self._log["first"].append(slot.req.uid)

    def _flush_tables(self) -> None:
        if self._tables_dirty:
            self.state = self.engine.set_tables(self.state, self.tables)
            self._tables_dirty = False

    def _plan_chunks(self, req: Request, skip: int = 0) -> List[tuple]:
        """Split a prompt into (inputs, start, last-col) insertion chunks.

        Only the final chunk reports a logits column (the last *real*
        token — the final chunk is zero-padded to the chunk width).
        ``skip > 0`` (prefix-cache hit) drops the first ``skip`` tokens:
        their K/V already sit in aliased shared pages, so insertion starts
        at cache position ``skip`` and attends over the shared prefix
        exactly as later chunks attend over earlier ones.  An
        encoder-decoder prompt's frames and a vlm prompt's vision prefix
        ride the first chunk, which starts at cache position 0 (prefix
        hits never happen for those families); later chunks start at
        their cache position, the vision offset included.  The recurrent
        families (ssm, hybrid) always insert monolithically."""
        inputs = req.inputs
        toks = _host_tokens(inputs)
        p = toks.shape[1]
        cw = self.prefill_chunk
        cfg = self.engine.api.cfg
        tv = cfg.vision_tokens if cfg.family == "vlm" else 0
        if skip and (cw <= 0 or p - skip <= cw):
            return [({"tokens": toks[:, skip:]}, skip, None)]
        if cw <= 0 or p <= cw or cfg.family in ("ssm", "hybrid"):
            return [(inputs, 0, None)]
        chunks = []
        n_c = -(-(p - skip) // cw)
        for c in range(n_c):
            lo, hi = skip + c * cw, min(skip + (c + 1) * cw, p)
            w = hi - lo
            ct = toks[:, lo:hi]
            last = c == n_c - 1
            if last and w < cw:
                # pad to the chunk width, but never past the slot's cache
                # extent: an overflowing write would clamp (contiguous) or
                # alias in-page offsets (paged) onto real prompt K/V
                padded = min(cw, self.total_len - (tv + lo))
                ct = np.pad(ct, ((0, 0), (0, padded - w)))
            b = {"tokens": ct}
            first = c == 0 and skip == 0
            if first:
                for extra in ("vision_embeds", "frames"):
                    if extra in inputs:
                        b[extra] = inputs[extra]
            start = 0 if first else tv + lo
            col = ((tv if first else 0) + w - 1) if last else None
            chunks.append((b, start, col))
        return chunks

    # ---- prefix cache ----------------------------------------------------
    def _prefix_hashes(self, req: Request) -> List[bytes]:
        """Chained content hashes of the prompt's *sharable* full pages:
        those whose whole range lies strictly before the last prompt token
        (the final position is always recomputed for the first-token
        logits), so no write can ever land on a shared page."""
        toks = _host_tokens(req.inputs)
        pw = toks.shape[1]
        ps = self.page_size
        limit = ((pw - 1) // ps) * ps
        hashes, h = [], b""
        for j in range(limit // ps):
            h = PrefixCache.chain(h, toks[:, j * ps:(j + 1) * ps])
            hashes.append(h)
        return hashes

    def _register_prompt_pages(self, i: int) -> None:
        """Publish slot ``i``'s freshly prefilled full prompt pages into
        the prefix cache (once its prompt is fully inserted).  Ownership of
        each registered page moves to the cache; the slot keeps one
        reference, so its block layout (shared prefix, then owned pages)
        stays contiguous."""
        if self.prefix_cache is None:
            return
        s = self.slots[i]
        for j in range(s.n_shared, len(s.prefix_hashes)):
            h = s.prefix_hashes[j]
            if self.prefix_cache._page_of.get(h) is not None:
                # a same-prefix sibling registered this page range first;
                # keep ours private (one page per hash)
                break
            page = s.pages.pop(0)
            self.prefix_cache.register(h, page)
            s.shared_pages.append(page)
            self.sched_stats["prefix_pages_registered"] += 1

    def _decref(self, page: int) -> None:
        if self.prefix_cache.release(page):
            self.allocator.release([page])

    def _admit_into(self, i: int, req: Request) -> bool:
        """Place ``req`` into free slot ``i``; False if the page pool
        cannot cover its prompt yet (request stays queued)."""
        inputs = req.inputs
        pw = self.engine.prompt_width(inputs)
        if self._insert_path:
            if self.state is None:
                self.state = self.engine.init_decode_state(
                    inputs, self.n_slots, self.max_len,
                    page_size=self.page_size,
                    n_pages=self.allocator.n_pages if self.paged else None)
            if "frames" in inputs and \
                    inputs["frames"].shape[1] != \
                    self.state["enc_out"].shape[1]:
                raise ValueError(
                    "enc-dec slot insertion needs the same encoder length "
                    f"as the live batch: {inputs['frames'].shape[1]} != "
                    f"{self.state['enc_out'].shape[1]}")
            reserve, hits, hashes = 0, [], []
            if self.paged:
                if self.prefix_cache is not None:
                    hashes = self._prefix_hashes(req)
                    for h in hashes:
                        page = self.prefix_cache.lookup(h)
                        self.sched_stats["prefix_lookups"] += 1
                        if page is None:
                            break
                        hits.append(page)
                need = pw + req.sampling.max_new_tokens - 1
                total = -(-need // self.page_size)
                prompt_pages = min(-(-pw // self.page_size), total)
                fresh = prompt_pages - len(hits)
                if not self.allocator.can_admit(total - len(hits),
                                                now=fresh):
                    return False
                pages = self.allocator.alloc(fresh)
                for page in hits:
                    self.prefix_cache.acquire(page)
                if hits:
                    self.sched_stats["prefix_hits"] += len(hits)
                    self.sched_stats["prefix_hit_tokens"] += \
                        len(hits) * self.page_size
                reserve = total - prompt_pages
                self.allocator.reserved += reserve
                self.tables[i, :len(hits)] = hits
                self.tables[i, len(hits):prompt_pages] = pages
                self._tables_dirty = True
            else:
                pages = []
            skip = len(hits) * self.page_size
            self.slots[i] = _Slot(req=req, index=pw, last_tok=0,
                                  generated=[], admitted_tick=self.tick,
                                  pages=pages, reserve_left=reserve,
                                  chunks=self._plan_chunks(req, skip=skip),
                                  shared_pages=list(hits),
                                  prefix_hashes=hashes)
            return True
        # ---- fixed-width path (monolithic prefill) ----------------------
        if self.state is None:
            # Lazy state init: prefill the first prompt once at full cache
            # width, then tile its rows (and encoder rows) across all slots
            extra = self.max_len - pw
            logits, sub = self.engine.prefill(inputs, extra_slots=extra)
            self.state = self.engine.tile_state(sub, self.n_slots)
        else:
            logits, self.state = self.engine.prefill_at(inputs, self.state,
                                                        i)
        self._log["inserts"].append(pw)
        slot = _Slot(req=req, index=pw, last_tok=0, generated=[],
                     admitted_tick=self.tick)
        self._first_token(slot, logits[0])
        self.slots[i] = slot
        self._maybe_retire(i)
        return True

    def _resume_into(self, i: int, pk: _Parked) -> bool:
        """Restore a parked request into free slot ``i``: re-allocate its
        block pages, write the host snapshot back bit for bit, and pick up
        decoding (or remaining prefill chunks) where it stopped."""
        if not self.allocator.can_admit(pk.n_blocks + pk.reserve_need,
                                        now=pk.n_blocks):
            return False
        pages = self.allocator.alloc(pk.n_blocks)
        self.allocator.reserved += pk.reserve_need
        self.state = self.engine.restore_slot(self.state, i, pages,
                                              pk.record)
        self.tables[i, :] = 0
        self.tables[i, :len(pages)] = pages
        self._tables_dirty = True
        # resumed pages are private even if some were shared before the
        # park (their refs were dropped then; the snapshot carried the
        # content instead), so the slot re-enters fully owned
        self.slots[i] = _Slot(req=pk.req, index=pk.index,
                              last_tok=pk.last_tok, generated=pk.generated,
                              admitted_tick=pk.admitted_tick, pages=pages,
                              reserve_left=pk.reserve_need,
                              chunks=pk.chunks,
                              prefix_hashes=pk.prefix_hashes)
        self.sched_stats["resumes"] += 1
        return True

    def _admit(self) -> None:
        """Fill free slots from the priority/arrival-ordered queue.
        Requests the pool cannot host yet are *skipped over* (no
        head-of-line stall); they stay queued at their rank and are
        retried every tick."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.waiting:
            return
        for entry in list(self.waiting):
            if not free:
                return
            if _entry_req(entry).arrival > self.tick:
                continue
            if isinstance(entry, _Parked):
                ok = self._resume_into(free[0], entry)
            else:
                ok = self._admit_into(free[0], entry)
            if ok:
                free.pop(0)
                self.waiting.remove(entry)

    # ---- chunked / paged prompt insertion --------------------------------
    def _advance_prefills(self) -> None:
        """One prompt chunk per mid-prefill slot per tick; the final chunk
        samples the request's first token and publishes the prompt's full
        pages to the prefix cache."""
        for i, s in enumerate(self.slots):
            if s is None or not s.chunks:
                continue
            self._flush_tables()
            batch, start, col = s.chunks.pop(0)
            logits, self.state = self.engine.prefill_chunk_at(
                batch, self.state, i, start)
            self._log["inserts"].append(self.engine.prompt_width(batch)
                                        if "vision_embeds" in batch
                                        else int(batch["tokens"].shape[1]))
            if not s.chunks:
                self._register_prompt_pages(i)
                self._first_token(s, logits[0, -1 if col is None else col])
                self._maybe_retire(i)

    # ---- preemption ------------------------------------------------------
    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Lowest-priority live slot (ties: most recently admitted, then
        highest row) other than ``exclude``."""
        candidates = [i for i, s in enumerate(self.slots)
                      if s is not None and i != exclude]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda i: (self.slots[i].req.sampling.priority,
                                  -self.slots[i].admitted_tick, -i))

    def _park(self, i: int) -> None:
        """Swap slot ``i`` out to host memory: snapshot its pool pages bit
        for bit, return its pages + reservation to the allocator, drop its
        shared-page refs (the snapshot carries their content), and
        re-queue the request at its original priority/arrival rank."""
        s = self.slots[i]
        rec = self.engine.park_slot(self.state, i, s.block_pages)
        for page in s.shared_pages:
            self._decref(page)
        self.allocator.release(s.pages, from_reserve=s.reserve_left)
        self.tables[i, :] = 0
        self._tables_dirty = True
        need = self.engine.prompt_width(s.req.inputs) + \
            s.req.sampling.max_new_tokens - 1
        nb_total = -(-need // self.page_size)
        self.waiting.append(_Parked(
            req=s.req, index=s.index, last_tok=s.last_tok,
            generated=s.generated, admitted_tick=s.admitted_tick,
            chunks=s.chunks, prefix_hashes=s.prefix_hashes,
            n_blocks=s.n_blocks, reserve_need=nb_total - s.n_blocks,
            record=rec))
        self._sort_waiting()
        self.slots[i] = None
        self.sched_stats["preemptions"] += 1
        self._log["parked"].append(s.req.uid)

    # ---- copy-on-write ---------------------------------------------------
    def _cow_from(self, i: int, blk: int) -> None:
        """Divergent-write guard: copy slot ``i``'s shared blocks
        ``blk..`` into fresh private pages before a write can land there.
        Unreachable under the hashed-region rule (PX2), kept as the
        enforcement backstop."""
        s = self.slots[i]
        moved = []
        for j in range(blk, s.n_shared):
            src = s.shared_pages[j]
            page = self.allocator.alloc(1)
            assert page is not None, "copy-on-write needs a free page"
            self.state = self.engine.copy_pool_page(self.state, src,
                                                    page[0])
            self.tables[i, j] = page[0]
            self._tables_dirty = True
            moved.append(page[0])
            self._decref(src)
            self.sched_stats["cow_copies"] += 1
        s.pages = moved + s.pages
        del s.shared_pages[blk:]

    # ---- paged growth ----------------------------------------------------
    def _grow_pages(self, live: List[int], lookahead: int = 0) -> List[int]:
        """Allocate pages for every slot whose upcoming writes cross block
        boundaries (up to ``lookahead`` positions past the fill level for
        a speculative round); returns the slots still live afterwards.
        Beyond ``overcommit`` 1 an empty free list parks the
        lowest-priority victim (or the slot itself) and retries."""
        still = []
        for i in live:
            s = self.slots[i]
            if s is None:
                continue           # parked as a victim earlier this tick
            wb = s.index // self.page_size
            if wb < s.n_shared:
                self._cow_from(i, wb)
            blk_hi = (s.index + lookahead) // self.page_size
            parked_self = False
            while s.n_blocks <= blk_hi:
                page = self.allocator.alloc(1, from_reserve=1)
                if page is None:   # failed alloc leaves `reserved` intact
                    victim = self._pick_victim(exclude=i)
                    if victim is None:
                        self._park(i)
                        parked_self = True
                        break
                    self._park(victim)
                    continue
                assert s.reserve_left > 0, \
                    f"reservation accounting broke for slot {i}"
                s.reserve_left -= 1
                blk = s.n_blocks
                s.pages += page
                self.tables[i, blk] = page[0]
                self._tables_dirty = True
            if not parked_self:
                still.append(i)
        return [i for i in still if self.slots[i] is not None]

    # ---- retirement ------------------------------------------------------
    def _maybe_retire(self, i: int) -> None:
        slot = self.slots[i]
        sp = slot.req.sampling
        stop = sp.eos_id is not None and slot.generated[-1] == sp.eos_id
        length = len(slot.generated) >= sp.max_new_tokens
        if stop or length:
            self.results[slot.req.uid] = GenerationResult(
                uid=slot.req.uid, tokens=list(slot.generated),
                finish_reason="stop" if stop else "length",
                prompt_len=int(slot.req.inputs["tokens"].shape[1]),
                admitted_tick=slot.admitted_tick,
                finished_tick=self.tick)
            if self.paged and (slot.block_pages or slot.reserve_left):
                for page in slot.shared_pages:
                    self._decref(page)
                self.allocator.release(slot.pages,
                                       from_reserve=slot.reserve_left)
                self.tables[i, :] = 0
                self._tables_dirty = True
            self.slots[i] = None

    # ---- decode inputs ---------------------------------------------------
    def _decode_inputs(self, live: List[int]) -> tuple:
        """(n_slots, 1) last tokens and (n_slots,) fill levels on the
        device.  Free and parked rows write their (ignored) K/V at the
        last position — with a paged cache that position routes to the
        trash page — where it stays masked by the row's fill level."""
        toks = np.zeros((self.n_slots, 1), np.int32)
        idx = np.full((self.n_slots,), self.total_len - 1, np.int32)
        for i in live:
            toks[i, 0] = self.slots[i].last_tok
            idx[i] = self.slots[i].index
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(idx).to(self.device))

    # ---- speculative tick ------------------------------------------------
    def _spec_tick(self, live: List[int]) -> bool:
        """One draft/verify round over the live greedy slots.

        Draft depth is clamped round-wide to the tightest slot's remaining
        token budget minus one, so every cache write — γ draft steps at
        ``index..index+γ-1`` plus the (γ+1)-wide verify at ``index`` —
        stays inside each slot's page reservation.  Rejected draft K/V
        needs no rollback: it sits above the accepted fill level, masked,
        and the next verify rewrites it.  Draft tokens stay on the device;
        the round makes one host transfer (drafts and verify argmax) for
        :func:`greedy_verify`.  Returns False (caller runs the plain tick)
        when no draft depth fits."""
        from .autotune.speculative import greedy_verify
        eng = self.engine
        g = min(eng.draft_gamma,
                min(self.slots[i].req.sampling.max_new_tokens
                    - len(self.slots[i].generated) for i in live) - 1)
        if g < 1:
            return False
        if self.paged:
            live = self._grow_pages(live, lookahead=g)
            if not live:
                return True        # every slot parked; the tick still ran
        self._flush_tables()
        first, idx = self._decode_inputs(live)
        cur, drafts, state = first, [], self.state
        for j in range(g):
            lg, state = eng.draft_decode(cur, state, idx + j)
            cur = torch.argmax(lg, -1)[:, None].to(torch.int32)
            drafts.append(cur)
        vtoks = torch.cat([first] + drafts, dim=1)
        vlogits, self.state = eng.verify(vtoks, state, idx)
        self._log.update(draft=g, verify=g + 1, live=len(live))
        host = torch.cat([vtoks[:, 1:], torch.argmax(vlogits, -1).to(
            torch.int32)], dim=1).cpu().numpy()
        accepted, n_draft = greedy_verify(host[:, :g], host[:, g:])
        self.spec_stats["rounds"] += 1
        for i in live:
            slot = self.slots[i]
            sp = slot.req.sampling
            self.spec_stats["drafted"] += g
            self.spec_stats["accepted_drafts"] += int(n_draft[i])
            for t in accepted[i]:
                slot.generated.append(int(t))
                slot.last_tok = int(t)
                slot.index += 1
                self.spec_stats["emitted"] += 1
                if (sp.eos_id is not None and int(t) == sp.eos_id) or \
                        len(slot.generated) >= sp.max_new_tokens:
                    break                 # discard the rest of the round
            self._maybe_retire(i)
        return True

    # ---- one tick --------------------------------------------------------
    def step(self) -> None:
        """Admit what has arrived, advance mid-prefill slots one chunk,
        then advance every decoding slot one token (or one speculative
        round).  Appends the tick's record to ``tick_log`` when the
        scheduler records ticks."""
        self._log = {"tick": self.tick, "inserts": [], "decode": 0,
                     "draft": 0, "verify": 0, "live": 0, "first": [],
                     "parked": []}
        self._tick()
        if self.tick_log is not None:
            self.tick_log.append(self._log)
        self.tick += 1

    def _tick(self) -> None:
        self._admit()
        if self._insert_path:
            self._advance_prefills()
        live = [i for i, s in enumerate(self.slots)
                if s is not None and not s.chunks]
        if live and self.engine.speculate_planes and \
                all(self.slots[i].req.sampling.temperature == 0
                    for i in live):
            if self._spec_tick(live):
                return
        if live and self.paged:
            live = self._grow_pages(live)
        if not live:
            return
        self._flush_tables()
        toks, idx = self._decode_inputs(live)
        logits, self.state = self.engine.decode(toks, self.state, idx)
        self._log.update(decode=1, live=len(live))
        lg = logits.to(torch.float32).cpu()  # one host transfer per tick
        for i in live:
            slot = self.slots[i]
            sp = slot.req.sampling
            if sp.temperature > 0:
                tok = int(sample_token(lg[i], sp, token_generator(
                    sp.seed, len(slot.generated))))
            else:
                tok = int(lg[i].argmax())
            slot.generated.append(tok)
            slot.last_tok = tok
            slot.index += 1
            self._maybe_retire(i)

    # ---- reporting -------------------------------------------------------
    def compile_footprint(self, prompt_widths=None) -> List[Any]:
        """Static census of every call signature this scheduler's workload
        reaches (``analysis.footprint``: one launch-plan entry, and one
        graph to capture, a signature) — run it *before* serving to catch
        a shape blowup as a lint failure.  ``prompt_widths`` defaults to
        the submitted requests'."""
        from ..analysis.footprint import scheduler_footprint
        return scheduler_footprint(self, prompt_widths)

    def validate(self):
        """Contract-check the live scheduler state: the paged decode tree
        (PC*/PA*) plus the refcount / shared-write / parked-hygiene rules
        (PX1-PX3, ``analysis.contracts.validate_scheduler``)."""
        from ..analysis.contracts import (validate_decode_state,
                                          validate_scheduler)
        findings = list(validate_scheduler(self))
        if self.state is not None:
            refcounted = None if self.prefix_cache is None else \
                self.prefix_cache.refcounts
            findings += validate_decode_state(self.state,
                                              n_slots=self.n_slots,
                                              refcounts=refcounted)
        return findings

    def cache_report(self) -> Dict[str, Any]:
        """Resident-cache accounting (the paged-vs-fixed-width headline).

        ``bytes_in_use_peak`` charges each allocated page its full at-rest
        footprint across every layer; ``fixed_equiv_bytes`` is what the
        same workload would hold resident as ``n_slots`` fixed
        ``max_len``-wide rows (rounded up to whole pages)."""
        if self.state is None:
            return {"paged": self.paged}
        if not self.paged:
            return {"paged": False,
                    "resident_bytes": _kv_resident_bytes(
                        self.state["cache"])}
        pool_bytes = _paged_pool_bytes(self.state["cache"])
        cap = self.allocator.n_pages
        page_bytes = pool_bytes // cap
        rep = {
            "paged": True,
            "page_size": self.page_size,
            "pool_capacity_pages": cap,
            "pages_in_use": self.allocator.in_use,
            "peak_pages_in_use": self.allocator.peak_in_use,
            "page_bytes": page_bytes,
            "bytes_in_use_peak": self.allocator.peak_in_use * page_bytes,
            "fixed_equiv_bytes": page_bytes * self.n_slots * self.nb,
            "overcommit": self.overcommit,
            **{k: v for k, v in self.sched_stats.items()},
        }
        if self.prefix_cache is not None:
            rep["prefix_cached_pages"] = len(self.prefix_cache)
            rep["prefix_outstanding_refs"] = \
                self.prefix_cache.outstanding_refs
        return rep

    # ---- drive to completion --------------------------------------------
    def run(self, requests: List[Request],
            validate_every: int = 0) -> List[GenerationResult]:
        """Submit ``requests`` and tick until all have finished; results
        come back in the order the requests were given.  With
        ``validate_every`` N > 0, :meth:`validate` runs every N ticks and
        once at the end, and any finding raises."""
        for r in requests:
            self.submit(r)
        idle = 0
        while self.waiting or any(s is not None for s in self.slots):
            before = len(self.results)
            self.step()
            if validate_every and self.tick % validate_every == 0:
                self._check_contracts()
            if any(s is not None for s in self.slots) or \
                    len(self.results) != before or \
                    any(_entry_req(e).arrival >= self.tick
                        for e in self.waiting):
                idle = 0
            else:
                idle += 1          # nothing live, nothing admissible
                if idle > len(self.waiting) + 2:
                    free = self.allocator.free_count if self.paged else "n/a"
                    rsv = self.allocator.reserved if self.paged else 0
                    raise RuntimeError(
                        f"admission deadlock: {len(self.waiting)} queued "
                        f"requests, none admissible (free={free}, "
                        f"reserved={rsv})")
        if validate_every:
            self._check_contracts()
        return [self.results[r.uid] for r in requests]

    def _check_contracts(self) -> None:
        findings = self.validate()
        if findings:
            raise RuntimeError(
                f"scheduler contracts at tick {self.tick}:\n" +
                "\n".join(f.format() for f in findings[:8]))
