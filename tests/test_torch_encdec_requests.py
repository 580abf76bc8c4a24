"""Encoder-decoder serving in the port, held against the JAX reference: the
companions of the reference's seamless rows in tests/test_backend_parity.py
and tests/test_serving.py, and the family through the port's deploy,
engine, scheduler and launcher.

Fixture: ``seamless-m4t-large-v2`` (24 + 24 layers, d_model 1024 at full
width; 2 + 2 layers at d_model 128 here) at ``tiny(dtype="float32")``
with 9x8 blocks and 8-bit activations, the reference's
``init(PRNGKey(0))`` QAT tree, deployed by the reference and carried
across through numpy (``torch_port_helpers.encdec_fixture``).  Tokens
come from ``numpy.random.default_rng`` (prompt seed 1, see
tests/test_torch_slice.py on rounding ties) and frames are ``0.1 *
normal`` from numpy (``torch_port_helpers.frames``); every request of a
batch shares one encoder length (8 frames), as the reference requires.

* staggered, paged and chunked requests give the reference's one-shot
  tokens; a vector fill index equals a scalar one; a paged, chunked,
  overcommitted trace keeps the reference's ledger tick by tick, parking
  included;
* park / restore round-trips a slot, its ``enc_out`` row included, bit
  for bit, into the same slot and into another;
* the launcher serves the family on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro_torch.serve import Request, SamplingParams  # noqa: E402
from torch_port_helpers import (encdec_batch, encdec_fixture,  # noqa: E402
                                encdec_qat_engines, engine_pair, frames,
                                jax_inputs, np_of, prompt, run_lockstep)

torch.set_num_threads(2)
ARCH = "seamless-m4t-large-v2"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
S_ENC = 8


@pytest.fixture(scope="module")
def fx():
    return encdec_fixture()


def _requests(batch, max_new, gap=2):
    return [Request(uid=i, inputs={k: v[i:i + 1] for k, v in batch.items()},
                    sampling=SamplingParams(max_new_tokens=max_new),
                    arrival=gap * i)
            for i in range(batch["tokens"].shape[0])]


def _oneshot_want(fx, kv, batch, max_new):
    jeng, teng = encdec_qat_engines(fx, kv)
    want = np.asarray(jeng.generate(jax_inputs(batch), max_new=max_new))
    np.testing.assert_array_equal(
        np_of(teng.generate(batch, max_new=max_new)), want)
    return teng, want


def _request_pairs(fx, specs):
    """The same greedy requests (tokens, frames) for both packages."""
    pairs = []
    for uid, (width, new, arrival, prio) in enumerate(specs):
        inputs = {"tokens": prompt(fx["vocab"], width, 20 + uid),
                  "frames": frames(fx["frames"].shape[-1], S_ENC, 20 + uid)}
        sp = dict(max_new_tokens=new, priority=prio)
        pairs.append((JRequest(uid=uid, inputs=jax_inputs(inputs),
                               sampling=JSP(**sp), arrival=arrival),
                      Request(uid=uid, inputs=inputs,
                              sampling=SamplingParams(**sp),
                              arrival=arrival)))
    return pairs


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_staggered_requests_match_oneshot(fx, kv_bits):
    """Requests arriving mid-decode (3 slots, 4 requests: slot reuse) in
    the fixed-width cache give the reference's one-shot tokens (the lazy
    state tiles the first request's encoder row across the slots, as
    separate storage)."""
    batch = encdec_batch(fx, b=4)
    teng, want = _oneshot_want(fx, kv_bits, batch, 6)
    reqs = _requests(batch, 6)
    for i, r in enumerate(teng.serve(reqs, n_slots=3)):
        assert r.tokens == want[i].tolist(), f"slot parity @req {i}"
        assert r.finish_reason == "length"
        assert r.admitted_tick >= reqs[i].arrival


@pytest.mark.parametrize("kv_bits,page,chunk", [(8, 4, 3), (4, 4, 0)])
def test_paged_staggered_requests_match_oneshot(fx, kv_bits, page, chunk):
    """The paged cache (block tables over a shared pool, slot reuse,
    chunked prefill: the frames ride the first chunk) gives the
    reference's one-shot tokens and drains."""
    batch = encdec_batch(fx, b=4)
    teng, want = _oneshot_want(fx, kv_bits, batch, 6)
    reqs = _requests(batch, 6)
    sched = teng.make_scheduler(reqs, n_slots=3, page_size=page,
                                prefill_chunk=chunk)
    for i, r in enumerate(sched.run(reqs)):
        assert r.tokens == want[i].tolist(), f"paged parity @req {i}"
    rep = sched.cache_report()
    assert rep["pages_in_use"] == 0 and rep["peak_pages_in_use"] > 0
    assert (sched.tables == 0).all()


def test_vector_index_matches_scalar_decode(fx):
    """Decode steps with a per-slot (B,) index give the scalar index's
    logits bit for bit, and the reference's within 2e-4."""
    jeng, teng = encdec_qat_engines(fx, 32)
    batch = encdec_batch(fx)
    p = batch["tokens"].shape[1]
    api, japi = teng.api, jeng.api
    logits, st_s = api.prefill(teng.params, teng._inputs(batch),
                               extra_slots=8)
    jlog, jst = japi.prefill(jeng.params, jax_inputs(batch), extra_slots=8)
    st_v = {"cache": {k: v.clone() for k, v in st_s["cache"].items()},
            "enc_out": st_s["enc_out"]}
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for i in range(3):
        lg_s, st_s = api.decode_step(teng.params, tok, st_s, p + i)
        lg_v, st_v = api.decode_step(teng.params, tok, st_v,
                                     torch.full((2,), p + i,
                                                dtype=torch.int32))
        jlog, jst = japi.decode_step(jeng.params, jnp.asarray(np_of(tok)),
                                     jst, jnp.asarray(p + i, jnp.int32))
        assert torch.equal(lg_s, lg_v), i
        np.testing.assert_allclose(np_of(lg_s), np.asarray(jlog),
                                   **LOGIT_TOL)
        tok = lg_s.argmax(-1)[:, None].to(torch.int32)


@pytest.mark.parametrize("kv_bits,chunk", [(8, 3), (4, 0)])
def test_overcommit_trace_matches_reference(fx, kv_bits, chunk):
    """A paged trace with overcommit 1.5 over a pool sized to force
    parking, priorities {0, 1, 2}, chunked or not, through the port's
    kernel wrappers: tokens, ticks, block tables after every tick, stats,
    ``cache_report`` and ``validate()`` as the reference's (a parked
    slot's ``enc_out`` row comes back with its pages)."""
    jeng, teng = engine_pair(fx, kv_bits)
    specs = [(6, 6, 0, 0), (3, 5, 0, 1), (9, 7, 1, 2), (2, 4, 2, 0),
             (7, 8, 2, 1), (5, 3, 3, 2)]
    pairs = _request_pairs(fx, specs)
    worst = max(-(-(w + n - 1) // 4) for w, n, _, _ in specs)
    jr, tr = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(n_slots=3, page_size=4, n_pages=worst + 2,
              prefill_chunk=chunk, overcommit=1.5)
    js = jeng.make_scheduler(jr, **kw)
    ts = teng.make_scheduler(tr, record_ticks=True, **kw)
    run_lockstep(js, ts, jr, tr)
    assert ts.sched_stats["preemptions"] >= 1
    assert not ts.validate() and ts.allocator.in_use == 0


@pytest.mark.parametrize("target", ["same slot", "other slot"])
def test_park_restore_roundtrip_bit_identical(fx, target):
    """Park a mid-decode slot (its pool pages and its ``enc_out`` row),
    overwrite both in place, restore into the same slot or into a free
    one on other pages: every pool leaf and the encoder row come back bit
    for bit, and the restored slot decodes the tokens it would have."""
    teng = engine_pair(fx, 8)[1]
    reqs = [r for _, r in _request_pairs(fx, [(6, 8, 0, 0), (3, 8, 0, 0)])]
    sched = teng.make_scheduler(reqs, n_slots=3, page_size=4)
    for r in reqs:
        sched.submit(r)
    for _ in range(4):
        sched.step()
    state, s = sched.state, sched.slots[0]
    assert s is not None and s.pages and sched.slots[2] is None
    pages = s.block_pages
    pool = {k: v[:, pages].clone()
            for k, v in state["cache"]["pages"].items()}
    enc = state["enc_out"][0].clone()
    rec = teng.park_slot(state, 0, pages)
    assert torch.equal(rec["enc_out"], enc)
    for p in pages:
        teng.copy_pool_page(state, 0, p)
    state["enc_out"][0] = 0.0
    if target == "same slot":
        slot, dest = 0, pages
    else:
        slot = 2
        dest = sched.allocator.alloc(len(pages))
    restored = teng.restore_slot(state, slot, dest, rec)
    assert restored is state, "restore_slot writes the live state"
    assert torch.equal(state["enc_out"][slot], enc)
    for k, v in state["cache"]["pages"].items():
        assert v.dtype == pool[k].dtype and \
            torch.equal(v[:, dest], pool[k]), k
    # the restored row decodes as the parked one would have: one step of
    # slot 0's request from its own fill level, through either row
    table = np.zeros_like(sched.tables)
    table[slot, :len(dest)] = dest
    teng.set_tables(state, table)
    tok = torch.zeros((3, 1), dtype=torch.int32)
    tok[slot, 0] = s.last_tok
    index = torch.zeros((3,), dtype=torch.int32)
    index[slot] = s.index
    logits, _ = teng.decode(tok, state, index)
    want = reqs[0].inputs
    one = teng.generate(want, max_new=s.index - want["tokens"].shape[1] + 2)
    assert int(logits[slot].argmax()) == int(one[0, -1])


def test_launcher_serves_encdec_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch seamless-m4t-large-v2``
    on the CPU: paged, chunked, prefix cache asked for (warned off),
    varying token widths over one frames width; with the quantizers off
    each request's tokens equal one-shot ``generate`` on its inputs.
    Then the one-shot launcher path through the bit-plane kernels."""
    from repro_torch.launch.serve import main
    with pytest.warns(UserWarning, match="prefix_cache"):
        out = main(["--arch", ARCH, "--device", "cpu", "--requests",
                    "--backend", "kernel", "--attn-backend", "fused",
                    "--kv-bits", "32", "--act-bits", "32", "--page-size",
                    "4", "--prefill-chunk", "3", "--prefix-cache",
                    "--overcommit", "1.5", "--n-pages", "12", "--batch",
                    "5", "--n-slots", "3", "--prompt-len", "6",
                    "--prompt-lens", "6,2,9,4,7", "--max-news", "5,3",
                    "--validate-every", "2"])
    eng = out["engine"]
    assert eng.api.cfg.is_encdec and out["scheduler"].prefix_cache is None
    for req, res in zip(out["requests"], out["results"]):
        assert req.inputs["frames"].shape == (1, 6, eng.api.cfg.d_model)
        assert req.inputs["frames"].dtype == np.float32
        assert res.finish_reason == "length"
        want = eng.generate(req.inputs,
                            max_new=req.sampling.max_new_tokens)
        assert res.tokens == np_of(want)[0].tolist(), req.uid
    main(["--arch", ARCH, "--device", "cpu", "--backend", "bitplane",
          "--attn-backend", "fused", "--kv-bits", "4", "--max-new", "3",
          "--batch", "2"])
    assert "deployed: bitplane int8" in capsys.readouterr().out
