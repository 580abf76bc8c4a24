"""Request-level serving in the port: the companions of tests/test_serving.py
and of the deterministic leg of tests/test_serving_stress.py, the port's
scheduler run side by side with the JAX scheduler over {contiguous,
page 4} x {chunk 0, 3} x KV {32, 8, 4}, and the launcher on the CPU.

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")``, 9x8 blocks,
8-bit activations, params from the reference's ``init(PRNGKey(0))``
deployed to int8 by the reference and carried across through numpy; the
port serves through its ``kernel``/``fused`` wrappers (their plain
versions on the CPU), the reference through ``ref``/``gather``.  Prompts
come from ``numpy.random.default_rng`` with prompt seed 1 (see
tests/test_torch_slice.py on rounding ties).

* staggered, paged and chunked requests give the one-shot ``generate``
  tokens and drain the pool; paged peak bytes undercut fixed-width rows;
  EOS retires a request and frees its slot;
* sampled requests are reproducible, draw only from the top k of their
  logits, and draw the same tokens whatever else is in the batch (each
  draw is keyed by (request seed, token index)); they are not held to the
  reference's ``jax.random`` draws;
* side by side with the reference: greedy tokens, admitted / finished
  ticks and finish reasons, block tables after every tick, stats and
  ``cache_report``;
* ``python -m repro_torch.launch.serve --device cpu --requests`` serves
  and writes its stats.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro_torch.serve import Request, SamplingParams, Scheduler  # noqa: E402
from repro_torch.serve.sampling import top_k_mask  # noqa: E402
from torch_port_helpers import (engine_pair, prompt,  # noqa: E402
                                run_lockstep, tiny_fixture)

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def fx():
    return tiny_fixture()


def _port(fx, kv=8):
    return engine_pair(fx, kv)[1]


def _tokens(fx, n, seed, b=1):
    return prompt(fx["vocab"], n, seed, b)


def _requests(batch, max_new, gap=2, **sp):
    return [Request(uid=i, inputs={"tokens": batch[i:i + 1]},
                    sampling=SamplingParams(max_new_tokens=max_new, **sp),
                    arrival=gap * i) for i in range(batch.shape[0])]


def _oneshot(eng, toks, max_new):
    return eng.generate({"tokens": toks}, max_new=max_new)[0].tolist()


# ---------------------------------------------------------------------------
# continuous batching == one-shot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [32, 8, 4])
def test_staggered_requests_match_oneshot(fx, kv_bits):
    """Requests arriving mid-decode (3 slots, 4 requests: slot reuse) give
    the static-batch greedy tokens; the fixed-width state's rows are
    separate storage (a broadcast view would write one slot into all)."""
    eng = _port(fx, kv_bits)
    batch = _tokens(fx, 8, 0, b=4)
    oneshot = eng.generate({"tokens": batch}, max_new=6).numpy()
    reqs = _requests(batch, 6)
    sched = eng.make_scheduler(reqs, n_slots=3)
    for i, r in enumerate(sched.run(reqs)):
        assert r.tokens == oneshot[i].tolist(), f"slot parity @req {i}"
        assert r.finish_reason == "length"
        assert r.admitted_tick >= reqs[i].arrival
    assert all(leaf.stride(1) != 0
               for leaf in sched.state["cache"].values())


@pytest.mark.parametrize("kv_bits,page,chunk", [(8, 4, 0), (4, 4, 3)])
def test_paged_staggered_requests_match_oneshot(fx, kv_bits, page, chunk):
    eng = _port(fx, kv_bits)
    batch = _tokens(fx, 8, 0, b=4)
    oneshot = eng.generate({"tokens": batch}, max_new=6).numpy()
    reqs = _requests(batch, 6)
    sched = eng.make_scheduler(reqs, n_slots=3, page_size=page,
                               prefill_chunk=chunk)
    for i, r in enumerate(sched.run(reqs)):
        assert r.tokens == oneshot[i].tolist(), f"paged parity @req {i}"
    report = sched.cache_report()
    assert report["pages_in_use"] == 0, f"leaked pages: {report}"
    assert report["peak_pages_in_use"] > 0
    assert (sched.tables == 0).all()


def test_paged_resident_bytes_below_fixed_width(fx):
    eng = _port(fx)
    reqs = [Request(uid=i, inputs={"tokens": _tokens(fx, pl, 10 + i)},
                    sampling=SamplingParams(max_new_tokens=mn), arrival=i)
            for i, (pl, mn) in enumerate([(2, 2), (8, 4), (16, 4), (4, 2)])]
    paged = eng.make_scheduler(reqs, n_slots=4, max_len=64, page_size=4)
    res_p = paged.run(list(reqs))
    fixed = eng.make_scheduler(reqs, n_slots=4, max_len=64, page_size=0)
    res_f = fixed.run(list(reqs))
    assert all(a.tokens == b.tokens for a, b in zip(res_p, res_f))
    rp, rf = paged.cache_report(), fixed.cache_report()
    assert rp["bytes_in_use_peak"] < rf["resident_bytes"], (rp, rf)


def test_eos_retirement_frees_slot(fx):
    eng = _port(fx, 32)
    batch = _tokens(fx, 8, 0, b=3)
    oneshot = eng.generate({"tokens": batch}, max_new=8).numpy()
    eos = int(oneshot[0, 2])
    reqs = [Request(uid=i, inputs={"tokens": batch[i:i + 1]},
                    sampling=SamplingParams(
                        max_new_tokens=8, eos_id=eos if i == 0 else None),
                    arrival=i) for i in range(3)]
    results = eng.serve(reqs, n_slots=1)
    assert results[0].finish_reason == "stop"
    assert results[0].tokens == oneshot[0, :3].tolist()
    for i in (1, 2):
        assert results[i].tokens == oneshot[i].tolist()
        assert results[i].finish_reason == "length"


# ---------------------------------------------------------------------------
# sampled decoding
# ---------------------------------------------------------------------------

def test_sampling_reproducible_and_respects_top_k(fx):
    """Two runs draw the same tokens, and every drawn token is among the
    top k logits of its step (teacher-forced through a prefill of the
    prompt and the tokens before it)."""
    eng = _port(fx)
    batch = _tokens(fx, 8, 0, b=2)
    sp = dict(temperature=0.7, top_k=5, seed=11)
    r1 = eng.serve(_requests(batch, 6, gap=0, **sp), n_slots=2)
    r2 = eng.serve(_requests(batch, 6, gap=0, **sp), n_slots=2)
    assert [r.tokens for r in r1] == [r.tokens for r in r2]
    greedy = eng.serve(_requests(batch[:1], 6), n_slots=1)
    assert len(r1[0].tokens) == len(greedy[0].tokens) == 6
    assert r1[0].tokens != greedy[0].tokens
    for i, r in enumerate(r1):
        for j, tok in enumerate(r.tokens):
            prefix = np.concatenate(
                [batch[i:i + 1], np.asarray([r.tokens[:j]], np.int32)], 1)
            logits, _ = eng.prefill({"tokens": prefix})
            kept = torch.isfinite(top_k_mask(logits[0] / 0.7, 5))
            assert bool(kept[tok]), (i, j, tok)


def test_sampled_tokens_do_not_depend_on_the_batch(fx):
    """A sampled request draws the same tokens served alone, beside other
    requests in another slot, and paged: each draw is keyed by (its seed,
    the token's index), never by the rest of the batch."""
    eng = _port(fx)
    batch = _tokens(fx, 8, 1, b=3)
    sp = SamplingParams(max_new_tokens=7, temperature=1.0, top_k=20, seed=5)
    alone = eng.serve([Request(uid=0, inputs={"tokens": batch[:1]},
                               sampling=sp)], n_slots=1)[0].tokens
    mixed = [Request(uid=1, inputs={"tokens": batch[1:2]},
                     sampling=SamplingParams(max_new_tokens=5,
                                             temperature=0.9, seed=1)),
             Request(uid=2, inputs={"tokens": batch[2:3]},
                     sampling=SamplingParams(max_new_tokens=3)),
             Request(uid=0, inputs={"tokens": batch[:1]}, sampling=sp,
                     arrival=2)]
    for kw in (dict(n_slots=3), dict(n_slots=2, page_size=4,
                                     prefill_chunk=3)):
        res = {r.uid: r for r in eng.serve(mixed, **kw)}
        assert res[0].tokens == alone, kw


# ---------------------------------------------------------------------------
# side by side with the reference scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [32, 8, 4])
@pytest.mark.parametrize("chunk", [0, 3])
@pytest.mark.parametrize("page", [0, 4])
def test_scheduler_matches_reference(fx, page, chunk, kv_bits):
    """Staggered requests with slot reuse (3 slots, 4 requests of 3-11
    tokens): the reference's tokens, ticks, finish reasons, block tables
    after every tick, stats and ``cache_report``."""
    jeng, teng = engine_pair(fx, kv_bits)
    specs = [(8, 6, 0), (5, 4, 2), (11, 6, 4), (3, 5, 6)]
    jr, tr = [], []
    for i, (w, new, arr) in enumerate(specs):
        toks = _tokens(fx, w, 30 + i)
        jr.append(JRequest(uid=i, inputs={"tokens": jnp.asarray(toks)},
                           sampling=JSP(max_new_tokens=new), arrival=arr))
        tr.append(Request(uid=i, inputs={"tokens": toks},
                          sampling=SamplingParams(max_new_tokens=new),
                          arrival=arr))
    kw = dict(n_slots=3, max_len=24, page_size=page, prefill_chunk=chunk)
    js = jeng.make_scheduler(jr, **kw)
    ts = teng.make_scheduler(tr, record_ticks=True, **kw)
    ticks = run_lockstep(js, ts, jr, tr)
    assert ticks == len(ts.tick_log)
    for r in tr:
        assert ts.results[r.uid].tokens == _oneshot(
            teng, r.inputs["tokens"], r.sampling.max_new_tokens)


# ---------------------------------------------------------------------------
# deterministic leg of the stress suite
# ---------------------------------------------------------------------------

def test_preemption_and_prefix_sharing_match_oneshot(fx):
    """A fixed draw of the stress suite's preemption leg: overcommit 2
    over a pool of the largest request plus two pages, a shared prefix on
    half the requests, priorities {0, 1, 2}: one-shot tokens, a drained
    pool with no refcount, and ``validate()`` empty."""
    eng = _port(fx)
    shared = _tokens(fx, 8, 40)
    reqs, expected, worst = [], [], 0
    for uid, (tail, new, arr, prio) in enumerate(
            [(2, 6, 0, 2), (5, 8, 0, 0), (1, 4, 3, 1), (6, 7, 2, 0),
             (3, 5, 4, 2), (4, 3, 5, 1)]):
        toks = _tokens(fx, tail, 50 + uid)
        if uid % 2 == 0:
            toks = np.concatenate([shared, toks], 1)
        expected.append(_oneshot(eng, toks, new))
        reqs.append(Request(uid=uid, inputs={"tokens": toks},
                            sampling=SamplingParams(max_new_tokens=new,
                                                    priority=prio),
                            arrival=arr))
        worst = max(worst, -(-(toks.shape[1] + new - 1) // 3))
    sched = eng.make_scheduler(reqs, n_slots=3, page_size=3,
                               n_pages=worst + 2, prefill_chunk=4,
                               overcommit=2.0, prefix_cache=True)
    results = sched.run(reqs, validate_every=1)
    for r, ref in zip(results, expected):
        assert r.tokens == ref, r.uid
    rep = sched.cache_report()
    assert rep["preemptions"] >= 1 and rep["prefix_hits"] >= 1, rep
    assert rep["pages_in_use"] == 0 and sched.allocator.reserved == 0
    assert rep["prefix_outstanding_refs"] == 0 and len(sched.prefix_cache) == 0
    assert (sched.tables == 0).all() and not sched.validate()


def test_tight_pool_blocks_admission_then_drains(fx):
    eng = _port(fx)
    reqs = [Request(uid=i, inputs={"tokens": _tokens(fx, 8, 100 + i)},
                    sampling=SamplingParams(max_new_tokens=6))
            for i in range(6)]
    expected = [_oneshot(eng, r.inputs["tokens"], 6) for r in reqs]
    sched = eng.make_scheduler(reqs, n_slots=4, page_size=4, n_pages=10)
    for r, ref in zip(sched.run(reqs), expected):
        assert r.tokens == ref
    rep = sched.cache_report()
    assert rep["pages_in_use"] == 0
    assert rep["peak_pages_in_use"] <= 8
    assert sched.allocator.free_count == 9 and sched.allocator.reserved == 0
    assert (sched.tables == 0).all()


def test_oversized_request_rejected_up_front(fx):
    eng = _port(fx)
    toks = np.zeros((1, 8), np.int32)
    sched = Scheduler(eng, n_slots=2, max_len=32, page_size=4, n_pages=4)
    with pytest.raises(ValueError, match="pool capacity"):
        sched.submit(Request(uid=0, inputs={"tokens": toks},
                             sampling=SamplingParams(max_new_tokens=16)))
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(uid=1, inputs={"tokens": toks},
                             sampling=SamplingParams(max_new_tokens=40)))
    small = SamplingParams(max_new_tokens=4)
    sched.submit(Request(uid=2, inputs={"tokens": toks}, sampling=small))
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(Request(uid=2, inputs={"tokens": toks}, sampling=small))
    with pytest.raises(ValueError, match="overcommit > 1 needs a paged"):
        Scheduler(eng, overcommit=2.0)
    with pytest.raises(ValueError, match="prefix_cache needs a paged"):
        Scheduler(eng, prefix_cache=True)


def test_scheduler_keeps_no_tick_record_by_default(fx):
    """A scheduler built without ``record_ticks`` keeps no per-tick list
    (the reference keeps none; the record grew by one dict a tick for the
    scheduler's life), and serves the same tokens as one that does."""
    eng = _port(fx)
    toks = [_tokens(fx, w, 40 + w) for w in (5, 9)]

    def reqs():
        return [Request(uid=i, inputs={"tokens": t},
                        sampling=SamplingParams(max_new_tokens=5))
                for i, t in enumerate(toks)]
    quiet = eng.make_scheduler(reqs(), n_slots=1, page_size=4)
    logged = eng.make_scheduler(reqs(), n_slots=1, page_size=4,
                                record_ticks=True)
    got, want = quiet.run(reqs()), logged.run(reqs())
    assert quiet.tick_log is None
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert len(logged.tick_log) == logged.tick == quiet.tick > 2


def test_padded_final_chunk_respects_cache_extent(fx):
    eng = _port(fx)
    toks = _tokens(fx, 17, 11)
    ref = _oneshot(eng, toks, 4)
    for page in (0, 4):
        sched = Scheduler(eng, n_slots=1, max_len=20, page_size=page,
                          prefill_chunk=16, record_ticks=True)
        res = sched.run([Request(uid=0, inputs={"tokens": toks},
                                 sampling=SamplingParams(max_new_tokens=4))])
        assert res[0].tokens == ref, f"page_size={page}"
        # the 1-token tail is padded only up to the cache extent (20 - 16)
        assert [r["inserts"] for r in sched.tick_log[:2]] == [[16], [4]]


def test_chunked_prefill_interleaves_with_decode(fx):
    eng = _port(fx)
    long_toks, short_toks = _tokens(fx, 16, 7), _tokens(fx, 2, 8)
    reqs = [Request(uid=0, inputs={"tokens": long_toks},
                    sampling=SamplingParams(max_new_tokens=4)),
            Request(uid=1, inputs={"tokens": short_toks},
                    sampling=SamplingParams(max_new_tokens=3))]
    sched = eng.make_scheduler(reqs, n_slots=2, page_size=4,
                               prefill_chunk=4, record_ticks=True)
    results = sched.run(reqs)
    assert results[0].tokens == _oneshot(eng, long_toks, 4)
    assert results[1].tokens == _oneshot(eng, short_toks, 3)
    assert results[1].finished_tick < results[0].admitted_tick + 4
    assert sched.cache_report()["pages_in_use"] == 0
    firsts = {u: r["tick"] for r in sched.tick_log for u in r["first"]}
    assert firsts == {1: 0, 0: 3}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_requests_on_cpu(tmp_path, capsys):
    from repro_torch.launch.serve import main
    stats = tmp_path / "stats.json"
    out = main(["--arch", "phi3-mini-3.8b", "--device", "cpu", "--requests",
                "--backend", "kernel", "--attn-backend", "fused",
                "--kv-bits", "8", "--batch", "5", "--n-slots", "3",
                "--page-size", "4", "--prefill-chunk", "3",
                "--prompt-lens", "12,5,14,7,10", "--max-news", "4,6,3",
                "--priority", "0,1", "--overcommit", "1.5",
                "--n-pages", "12", "--prefix-cache", "--shared-prefix", "9",
                "--shared-every", "2", "--validate-every", "2",
                "--stats-out", str(stats)])
    rep = json.loads(stats.read_text())
    assert rep["contract_findings"] == [] and rep["pages_in_use"] == 0
    assert rep["prefix_hits"] >= 1
    res = out["results"]
    assert [len(r.tokens) for r in res] == [4, 6, 3, 4, 6]
    assert all(r.finish_reason == "length" for r in res)
    toks = [r.inputs["tokens"] for r in out["requests"]]
    assert [t.shape[1] for t in toks] == [12, 5, 14, 7, 10]
    assert (toks[2][:, :9] == toks[0][:, :9]).all()
    assert (toks[4][:, :9] == toks[0][:, :9]).all()
    printed = capsys.readouterr().out
    assert "deployed: packed int8" in printed and "[4] arrived@8" in printed
    eng = out["engine"]
    for r, t in zip(res, toks):
        assert r.tokens == _oneshot(eng, t, len(r.tokens))


def test_launcher_generate_mode_on_cpu(capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", "phi3-mini-3.8b", "--device", "cpu",
                "--backend", "kernel", "--batch", "2", "--prompt-len", "6",
                "--max-new", "3"])
    assert tuple(out["tokens"].shape) == (2, 3)
    assert "[1] " in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--arch", "phi3-mini-3.8b", "--device", "cpu",
              "--prompt-lens", "4,5"])
