"""Serving the vlm (qwen2-vl-2b), ssm (rwkv6-1.6b) and hybrid (zamba2-1.2b)
families through the port, held against the JAX reference: the
companions of the reference's rows for these families in
tests/test_serving.py and tests/test_autotune.py.

Fixture: each architecture at ``tiny(dtype="float32")`` with 9x8 blocks
and 8-bit activations in both packages, the reference's
``init(PRNGKey(0))`` QAT tree, deployed by the reference and carried
across through numpy (``torch_port_helpers.family_fx``).  Prompt
tokens come from ``numpy.random.default_rng`` (prompt seed 1, see
tests/test_torch_slice.py on rounding ties); a qwen2-vl prompt's vision
prefix is ``0.1 * normal`` from numpy.  The families' other tests are in
``tests/test_torch_families_{serving,generate,scheduler,decode,launch}.py``.

Staggered (fixed-width), paged and chunked scheduler drives keep the
reference's ledger tick by tick (qwen2-vl chunked at 3 with its vision
prefix on the first chunk; rwkv6 and zamba2 insert whole; zamba2 paged
and overcommitted, parking its recurrent rows with its pages); a zamba2
slot parks and restores bit for bit, in the reference's record layout.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_port_helpers import (family_engines, family_fx,  # noqa: E402
                                family_pairs, np_of, run_lockstep)

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"
SPECS = [(6, 5, 0, 0), (3, 4, 0, 1), (9, 6, 1, 0), (4, 3, 2, 1),
         (8, 4, 3, 0)]


@pytest.mark.parametrize("arch,kv,kw", [
    (QWEN, 8, dict(n_slots=3)),                              # staggered
    (QWEN, 8, dict(n_slots=3, page_size=4, prefill_chunk=3)),
    (QWEN, 4, dict(n_slots=3, page_size=4)),
    (RWKV, 32, dict(n_slots=3)),
    (RWKV, 32, dict(n_slots=3, prefill_chunk=3)),            # whole insert
    (ZAMBA, 8, dict(n_slots=3)),
    (ZAMBA, 8, dict(n_slots=3, page_size=4, prefill_chunk=3)),
    (ZAMBA, 4, dict(n_slots=3, page_size=4, n_pages=8, overcommit=1.5)),
])
def test_scheduler_lockstep_with_reference(arch, kv, kw):
    """Tokens, ticks, slot occupancy, block tables after every tick,
    stats, ``cache_report`` and ``validate()`` as the reference's; the
    overcommitted zamba2 pool parks at least one slot (its mamba rows ride
    the snapshot)."""
    fx = family_fx(arch)
    jeng, teng = family_engines(fx, kv)
    jr, tr = family_pairs(fx, SPECS)
    js = jeng.make_scheduler(jr, **kw)
    ts = teng.make_scheduler(tr, record_ticks=True, **kw)
    run_lockstep(js, ts, jr, tr)
    if kw.get("overcommit"):
        assert ts.sched_stats["preemptions"] >= 1
        assert ts.sched_stats["resumes"] == ts.sched_stats["preemptions"]
    if arch != QWEN and kw.get("prefill_chunk"):
        # one whole insertion a prompt
        assert sorted(w for t in ts.tick_log for w in t["inserts"]) == \
            sorted(s[0] for s in SPECS)
    if arch == QWEN and kw.get("prefill_chunk"):
        tv = fx["tapi"].cfg.vision_tokens
        assert max(w for t in ts.tick_log for w in t["inserts"]) == tv + 3


def test_zamba2_park_restore_roundtrip_bit_identical():
    """Park a mid-decode zamba2 slot (its attention pool pages and its
    mamba rows), overwrite both in place, restore into another slot on
    other pages: everything comes back bit for bit, in the reference's
    record layout (its values within 1e-4: the two packages round the f32
    scans differently), and the restored slot decodes the token it would
    have."""
    fx = family_fx(ZAMBA)
    jeng, teng = family_engines(fx, 8)
    jr, tr = family_pairs(fx, [(6, 8, 0, 0), (3, 8, 0, 0)])
    kw = dict(n_slots=3, page_size=4)
    js, ts = jeng.make_scheduler(jr, **kw), teng.make_scheduler(tr, **kw)
    for s, reqs in ((js, jr), (ts, tr)):
        for r in reqs:
            s.submit(r)
        for _ in range(4):
            s.step()
    state, slot0 = ts.state, ts.slots[0]
    pages = slot0.block_pages
    assert pages and ts.slots[2] is None
    rec = teng.park_slot(state, 0, pages)
    jrec = jeng.park_slot(js.state, 0, js.slots[0].block_pages)
    assert rec["rows"].keys() == jrec["rows"].keys() == {
        "cache.mamba.conv", "cache.mamba.ssm"}
    assert rec["pages"].keys() == jrec["pages"].keys()
    for part in ("rows", "pages"):
        for k, v in rec[part].items():
            want = np.array(jrec[part][k])
            assert v.dtype == torch.from_numpy(want).dtype, k
            assert tuple(v.shape) == want.shape, k
            if v.is_floating_point():
                np.testing.assert_allclose(np_of(v), want, rtol=1e-4,
                                           atol=1e-4, err_msg=k)
    rows = {k: v.clone() for k, v in rec["rows"].items()}
    pool = {k: v[:, pages].clone()
            for k, v in state["cache"]["attn"]["pages"].items()}
    for leaf in state["cache"]["mamba"].values():
        leaf[:, 0] = 7.0
    for p in pages:
        teng.copy_pool_page(state, 0, p)
    dest = ts.allocator.alloc(len(pages))
    assert teng.restore_slot(state, 2, dest, rec) is state
    for name, leaf in state["cache"]["mamba"].items():
        assert torch.equal(leaf[:, 2], rows[f"cache.mamba.{name}"]), name
    for k, v in state["cache"]["attn"]["pages"].items():
        assert torch.equal(v[:, dest], pool[k]), k
    table = np.zeros_like(ts.tables)
    table[2, :len(dest)] = dest
    teng.set_tables(state, table)
    tok = torch.zeros((3, 1), dtype=torch.int32)
    tok[2, 0] = slot0.last_tok
    index = torch.zeros((3,), dtype=torch.int32)
    index[2] = slot0.index
    logits, _ = teng.decode(tok, state, index)
    x = tr[0].inputs
    one = teng.generate(x, max_new=slot0.index - x["tokens"].shape[1] + 2)
    assert int(logits[2].argmax()) == int(one[0, -1])
