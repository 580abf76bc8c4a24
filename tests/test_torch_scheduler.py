"""The port's scheduler ledger held against the JAX scheduler: case by case
the companions of tests/test_scheduler_priority.py, and a whole trace run
side by side tick by tick.

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")``, 9x8 blocks,
8-bit activations, params from the reference's ``init(PRNGKey(0))``
deployed to int8 by the reference and carried across through numpy.  The
reference serves through its ``ref`` matmuls and ``gather`` attention,
the port through its ``kernel``/``fused`` wrappers (their plain versions
on the CPU).  Prompts come from ``numpy.random.default_rng``; prompt seed
1 draws, as in tests/test_torch_slice.py, have no rounding tie that moves
a greedy token between the two packages.

* :class:`PageAllocator` (min-heap order, overcommit arithmetic) and
  :class:`PrefixCache` (chained hashes, refcounts) behave as the
  reference's, step for step;
* ``cache_report`` charges the fixed-width equivalent its ceil block
  count;
* priority classes order admission and blocked requests are skipped over;
* ``park_slot``/``restore_slot`` round-trip bit-identically (the snapshot
  is a copy, not a view of the live pool) at int8 and int4 KV;
* copy-on-write privatizes shared pages without moving a token;
* an overcommit + prefix-cache + priority trace gives the reference's
  tokens, ticks, block tables after every tick, stats and
  ``cache_report``, with ``validate()`` empty wherever the reference's is
  (the speculative trace: tests/test_torch_scheduler_spec.py);
* the contracts flag a corrupted ledger with the reference's rules.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve.scheduler import PageAllocator as JAllocator  # noqa: E402
from repro.serve.scheduler import PrefixCache as JPrefixCache  # noqa: E402
from repro_torch.serve.scheduler import PageAllocator, PrefixCache  # noqa: E402
from torch_port_helpers import (engine_pair, prompt,  # noqa: E402
                                request_pair, run_lockstep, tiny_fixture)

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def fx():
    return tiny_fixture()


def _tokens(fx, n, seed):
    return prompt(fx["vocab"], n, seed)


def _oneshot(eng, toks, max_new):
    return eng.generate({"tokens": toks}, max_new=max_new)[0].tolist()


# ---------------------------------------------------------------------------
# PageAllocator: min-ordered free list + overcommit arithmetic
# ---------------------------------------------------------------------------

def test_allocator_always_pops_lowest_free_id():
    for cls in (PageAllocator, JAllocator):
        a = cls(10)
        assert a.alloc(5) == [1, 2, 3, 4, 5]
        a.release([2, 4])
        assert a.alloc(3) == [2, 4, 6]
        a.release([1, 5, 3])
        assert a.alloc(4) == [1, 3, 5, 7]
        a.release([6, 2, 7, 1, 3, 4, 5])
        assert a.alloc(2) == [1, 2]
        assert (a.in_use, a.free_count, a.peak_in_use) == (2, 7, 7)


def test_allocator_release_order_does_not_change_allocation():
    def churn(release_order):
        a = PageAllocator(8)
        a.alloc(7)
        for p in release_order:
            a.release([p])
        return a.alloc(4)
    assert churn([3, 1, 7, 5, 2]) == churn([7, 5, 3, 2, 1]) \
        == churn([1, 2, 3, 5, 7]) == [1, 2, 3, 5]


def test_allocator_overcommit_admission():
    for cls in (PageAllocator, JAllocator):
        a = cls(5, overcommit=2.0)          # 4 live pages, cap 8
        assert a.can_admit(8) and not a.can_admit(9)
        assert not a.can_admit(5, now=5), "immediate need is physical"
        a.reserved += 6
        assert a.can_admit(2) and not a.can_admit(3)
        assert a.alloc(9) is None and a.reserved == 6
        strict = cls(5)
        assert strict.can_admit(4) and not strict.can_admit(5)
        with pytest.raises(ValueError, match="overcommit"):
            cls(5, overcommit=0.5)
        with pytest.raises(ValueError, match="trash page"):
            cls(1)


# ---------------------------------------------------------------------------
# PrefixCache ledger
# ---------------------------------------------------------------------------

def test_prefix_cache_refcounts_and_release():
    h1 = PrefixCache.chain(b"", np.arange(4))
    h2 = PrefixCache.chain(h1, np.arange(4, 8))
    assert h1 == JPrefixCache.chain(b"", np.arange(4))
    assert h2 == JPrefixCache.chain(h1, np.arange(4, 8)) and h1 != h2
    pc = PrefixCache()
    pc.register(h1, 3)
    pc.register(h2, 5)
    assert pc.lookup(h1) == 3 and pc.lookup(b"missing") is None
    pc.acquire(3)
    assert pc.refcounts == {3: 2, 5: 1} and pc.outstanding_refs == 3
    assert pc.release(3) is False
    assert pc.release(5) is True
    assert pc.release(3) is True
    assert len(pc) == 0 and pc.outstanding_refs == 0
    assert pc.hits == 1 and pc.lookups == 2
    pc.register(h1, 7)
    with pytest.raises(ValueError, match="already registered"):
        pc.register(h1, 8)


# ---------------------------------------------------------------------------
# cache_report: ceil fixed-width equivalent
# ---------------------------------------------------------------------------

def test_cache_report_fixed_equiv_uses_ceil_blocks(fx):
    jeng, teng = engine_pair(fx)
    jr, tr = request_pair(0, _tokens(fx, 4, 0), max_new=3)
    js = jeng.make_scheduler([jr], n_slots=2, max_len=10, page_size=4)
    ts = teng.make_scheduler([tr], n_slots=2, max_len=10, page_size=4)
    run_lockstep(js, ts, [jr], [tr])
    rep = ts.cache_report()
    assert ts.nb == 3
    assert rep["fixed_equiv_bytes"] == rep["page_bytes"] * 2 * 3


# ---------------------------------------------------------------------------
# priority classes + skip-over admission
# ---------------------------------------------------------------------------

def test_higher_priority_admitted_first(fx):
    jeng, teng = engine_pair(fx)
    lo, hi = _tokens(fx, 4, 1), _tokens(fx, 4, 2)
    pairs = [request_pair(0, lo, max_new=3, priority=0),
             request_pair(1, hi, max_new=3, priority=5)]
    jr, tr = [p[0] for p in pairs], [p[1] for p in pairs]
    js = jeng.make_scheduler(jr, n_slots=1, page_size=4)
    ts = teng.make_scheduler(tr, n_slots=1, page_size=4)
    run_lockstep(js, ts, jr, tr)
    assert ts.results[1].admitted_tick < ts.results[0].admitted_tick
    assert ts.results[0].tokens == _oneshot(teng, lo, 3)
    assert ts.results[1].tokens == _oneshot(teng, hi, 3)
    ties = [request_pair(0, lo, max_new=2)[1],
            request_pair(1, hi, max_new=2)[1]]
    ts = teng.make_scheduler(ties, n_slots=1, page_size=4)
    res = {r.uid: r for r in ts.run(ties)}
    assert res[0].admitted_tick < res[1].admitted_tick


def _blocked_trace(eng, big, smalls):
    """tests/test_scheduler_priority.py's skip-over scenario on ``eng``;
    returns the scheduler and its block tables after every tick."""
    sched = eng.make_scheduler([big] + smalls, n_slots=2, page_size=4,
                               n_pages=5, max_len=16)
    sched.submit(smalls[0])
    sched.step()
    assert sched.slots[0] is not None
    sched.submit(big)
    sched.submit(smalls[1])
    sched.step()
    # big (priority 9) heads the queue but cannot fit; small #2 was
    # admitted past it into the second slot
    assert any(s is not None and s.req.uid == 2 for s in sched.slots)
    assert all(not (s is not None and s.req.uid == 0) for s in sched.slots)
    tables = []
    while sched.waiting or any(s is not None for s in sched.slots):
        sched.step()
        tables.append(sched.tables.copy())
    return sched, tables


def test_blocked_request_does_not_stall_queue(fx):
    """A high-priority request whose pages do not fit yet is skipped over,
    as in the reference, tick for tick."""
    jeng, teng = engine_pair(fx)
    big = request_pair(0, _tokens(fx, 8, 3), max_new=8, priority=9)
    smalls = [request_pair(i, _tokens(fx, 2, 3 + i), max_new=4)
              for i in (1, 2)]
    js, jtables = _blocked_trace(jeng, big[0], [s[0] for s in smalls])
    ts, ttables = _blocked_trace(teng, big[1], [s[1] for s in smalls])
    assert len(ttables) == len(jtables)
    for a, b in zip(ttables, jtables):
        np.testing.assert_array_equal(a, b)
    for uid, r in js.results.items():
        assert vars(ts.results[uid]) == vars(r)
    assert ts.results[0].tokens == _oneshot(teng, big[1].inputs["tokens"], 8)
    assert ts.allocator.free_count == 4 and ts.allocator.reserved == 0


# ---------------------------------------------------------------------------
# park / restore: bit-identical host round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [8, 4])
def test_park_restore_roundtrip_bit_identical(fx, kv_bits):
    """Snapshot a mid-decode slot, overwrite its pool pages with the trash
    page in place, restore: every leaf comes back bit for bit, and the
    snapshot holds the reference's leaves for the same pages."""
    jeng, teng = engine_pair(fx, kv_bits)
    pairs = [request_pair(0, _tokens(fx, 6, 4), max_new=8),
             request_pair(1, _tokens(fx, 3, 5), max_new=8)]
    scheds = []
    for k, eng in enumerate((jeng, teng)):
        reqs = [p[k] for p in pairs]
        sched = eng.make_scheduler(reqs, n_slots=2, page_size=4)
        for r in reqs:
            sched.submit(r)
        for _ in range(4):
            sched.step()
        scheds.append(sched)
    js, ts = scheds
    s = ts.slots[0]
    assert s is not None and s.pages
    assert s.block_pages == js.slots[0].block_pages
    before = {k: v.clone() for k, v in ts.state["cache"]["pages"].items()}
    rec = teng.park_slot(ts.state, 0, s.block_pages)
    assert rec["pages"].keys() == jeng.park_slot(
        js.state, 0, js.slots[0].block_pages)["pages"].keys()
    state = ts.state
    for p in s.block_pages:
        state = teng.copy_pool_page(state, 0, p)
    assert state is ts.state, "copy_pool_page writes the live pool"
    changed = any(not torch.equal(v, before[k])
                  for k, v in state["cache"]["pages"].items())
    assert changed, "the trash page must differ from the slot's pages"
    restored = teng.restore_slot(state, 0, s.block_pages, rec)
    assert restored is ts.state, "restore_slot writes the live pool"
    for k, v in restored["cache"]["pages"].items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="snapshot holds"):
        teng.restore_slot(state, 0, s.block_pages[:-1], rec)


# ---------------------------------------------------------------------------
# copy-on-write guard
# ---------------------------------------------------------------------------

def test_cow_privatizes_shared_pages_without_token_drift(fx):
    jeng, teng = engine_pair(fx)
    shared = _tokens(fx, 9, 6)
    pairs = [request_pair(0, shared, max_new=6),
             request_pair(1, shared, max_new=6, arrival=1)]
    ref = _oneshot(teng, shared, 6)
    scheds = []
    for k, eng in enumerate((jeng, teng)):
        reqs = [p[k] for p in pairs]
        sched = eng.make_scheduler(reqs, n_slots=2, page_size=4,
                                   prefix_cache=True)
        for r in reqs:
            sched.submit(r)
        sched.step()
        sched.step()
        follower = next(i for i, s in enumerate(sched.slots)
                        if s is not None and s.req.uid == 1)
        s = sched.slots[follower]
        assert s.n_shared == 2, "prefix hit did not alias the shared pages"
        in_use = sched.allocator.in_use
        sched._cow_from(follower, 0)
        assert s.n_shared == 0 and len(s.pages) == s.n_blocks
        assert sched.sched_stats["cow_copies"] == 2
        assert sched.allocator.in_use == in_use + 2
        assert not sched.validate(), sched.validate()
        scheds.append(sched)
    js, ts = scheds
    np.testing.assert_array_equal(ts.tables, js.tables)
    while js.waiting or any(s is not None for s in js.slots):
        js.step()
        ts.step()
        np.testing.assert_array_equal(ts.tables, js.tables)
    for uid in (0, 1):
        assert ts.results[uid].tokens == ref == js.results[uid].tokens
    assert ts.allocator.in_use == 0
    assert ts.prefix_cache.outstanding_refs == 0
    assert ts.cache_report() == js.cache_report()


# ---------------------------------------------------------------------------
# whole traces, side by side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits,chunk", [(8, 0), (4, 3), (32, 3)])
def test_overcommit_prefix_priority_trace_matches_reference(fx, kv_bits,
                                                            chunk):
    """Overcommit 1.5 over a pool sized to force parking, a shared 9-token
    prefix on every other request, priorities cycling {0, 1, 2}: tokens,
    ticks, block tables after every tick, stats, ``cache_report`` and
    ``validate()`` as the reference's."""
    jeng, teng = engine_pair(fx, kv_bits)
    shared = _tokens(fx, 9, 7)
    pairs, worst = [], 0
    for i, (tail, new, arr) in enumerate([(3, 6, 0), (2, 5, 0), (5, 7, 1),
                                          (1, 4, 2), (4, 8, 2), (6, 3, 3)]):
        t = _tokens(fx, tail, 10 + i)
        toks = np.concatenate([shared, t], 1) if i % 2 == 0 else t
        pairs.append(request_pair(i, toks, max_new=new, arrival=arr,
                           priority=i % 3))
        worst = max(worst, -(-(toks.shape[1] + new - 1) // 4))
    jr, tr = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(n_slots=3, page_size=4, n_pages=worst + 2,
              prefill_chunk=chunk, overcommit=1.5, prefix_cache=True)
    js = jeng.make_scheduler(jr, **kw)
    ts = teng.make_scheduler(tr, record_ticks=True, **kw)
    run_lockstep(js, ts, jr, tr)
    assert ts.sched_stats["preemptions"] >= 1
    assert ts.sched_stats["resumes"] == ts.sched_stats["preemptions"]
    assert ts.sched_stats["prefix_hits"] >= 1
    assert not ts.validate() and ts.allocator.in_use == 0
    assert not ts.tables.any()
    assert sum(len(r["parked"]) for r in ts.tick_log) == \
        ts.sched_stats["preemptions"]


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def test_validate_flags_a_corrupted_ledger_as_the_reference_does(fx):
    """Stale table rows (PX3), a refcount that disagrees with its aliases
    (PX1), a hole before live pages (PA3) and an id outside the pool (PC2)
    are reported with the reference's rules; a clean state reports
    nothing."""
    jeng, teng = engine_pair(fx)
    shared = _tokens(fx, 9, 8)
    pairs = [request_pair(0, shared, max_new=6),
             request_pair(1, shared, max_new=6, arrival=1)]
    scheds = []
    for k, eng in enumerate((jeng, teng)):
        reqs = [p[k] for p in pairs]
        sched = eng.make_scheduler(reqs, n_slots=3, page_size=4,
                                   prefix_cache=True)
        for r in reqs:
            sched.submit(r)
        sched.step()
        sched.step()
        assert not sched.validate()
        scheds.append(sched)

    def rules(s):
        return sorted((f.severity, f.rule) for f in s.validate())

    for s in scheds:                       # a free row left pointing at a page
        s.tables[2, 0] = s.tables[0, 0]
    assert rules(scheds[1]) == rules(scheds[0]) and \
        ("error", "PX3") in rules(scheds[1])
    for s in scheds:
        s.tables[2, 0] = 0
        s.prefix_cache._refs[s.slots[0].shared_pages[0]] += 1
    assert rules(scheds[1]) == rules(scheds[0]) == [("error", "PX1")]
    for s in scheds:
        s.prefix_cache._refs[s.slots[0].shared_pages[0]] -= 1
        s.tables[0, 0] = 0                 # a hole before live pages
        s._tables_dirty = True
        s._flush_tables()
    assert rules(scheds[1]) == rules(scheds[0])
    assert {("error", "PA3"), ("error", "PX3")} <= set(rules(scheds[1]))
    for s in scheds:
        s.tables[0, 0] = s.allocator.n_pages + 3
        s._tables_dirty = True
        s._flush_tables()
    assert rules(scheds[1]) == rules(scheds[0])
    assert ("error", "PC2") in rules(scheds[1])
