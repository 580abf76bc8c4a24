"""Encoder-decoder serving in the port, held against the JAX reference: the
companions of the reference's seamless rows in tests/test_backend_parity.py
and tests/test_serving.py, and the family through the port's deploy,
engine, scheduler and launcher.

Fixture: ``seamless-m4t-large-v2`` (24 + 24 layers, d_model 1024 at full
width; 2 + 2 layers at d_model 128 here) at ``tiny(dtype="float32")``
with 9x8 blocks and 8-bit activations, the reference's
``init(PRNGKey(0))`` QAT tree, deployed by the reference and carried
across through numpy.  Tokens come from ``numpy.random.default_rng``
(prompt seed 1, see tests/test_torch_slice.py on rounding ties) and
frames are ``0.1 * normal`` from numpy (``torch_port_helpers.frames``);
every request of a batch shares one encoder length (8 frames), as the
reference requires.

* the port's deploy of the carried QAT tree equals the reference's bit
  for bit (packed int8 / int4, bit-plane), a stack a layer at a time, the
  depthwise kernel and the embedding left float;
* prefill logits within 2e-4 of the reference across the backends, the
  bit-plane compose bit for bit the packed one; greedy tokens identical
  across the backend matrix and to the reference's;
* staggered, paged and chunked requests give the reference's one-shot
  tokens; a vector fill index equals a scalar one; a paged, chunked,
  overcommitted trace keeps the reference's ledger tick by tick, parking
  included;
* park / restore round-trips a slot, its ``enc_out`` row included, bit
  for bit, into the same slot and into another;
* the refusals and the prefix-cache warning are the reference's; the
  launcher serves the family on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.common import qdense  # noqa: E402
from repro_torch.serve import Request, SamplingParams  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight)
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (engine_pair, frames,  # noqa: E402
                                mixed_bitwidths, np_of, prompt,
                                run_lockstep, tiny_fixture, tree_to_numpy)

torch.set_num_threads(2)
ARCH = "seamless-m4t-large-v2"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
S_ENC = 8


@pytest.fixture(scope="module")
def fx():
    fx = tiny_fixture(ARCH)
    fx["tqat"] = params_from_numpy(tree_to_numpy(fx["qat"]), device="cpu")
    fx["jtrees"], fx["ttrees"], fx["qat_engines"] = {}, {}, {}
    return fx


def _trees(fx, bits, layout="packed"):
    key = (bits, layout)
    if key not in fx["jtrees"]:
        fx["jtrees"][key] = j_deploy(fx["qat"], bits, layout=layout)
        fx["ttrees"][key] = params_from_numpy(
            tree_to_numpy(fx["jtrees"][key]), device="cpu")
    return fx["jtrees"][key], fx["ttrees"][key]


def _batch(fx, b=2, p=8):
    """{"tokens" (b, p), "frames" (b, S_ENC, d)} as numpy."""
    return {"tokens": prompt(fx["vocab"], p, 0, b),
            "frames": fx["frames"][:b]}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _qat_engines(fx, kv):
    """The reference's engine over its QAT tree (``dense``, as its serving
    tests run the family) and the port's over the carried tree."""
    if kv not in fx["qat_engines"]:
        fx["qat_engines"][kv] = (
            JEngine(fx["japi"], fx["qat"], kv_quant_bits=kv),
            TEngine(fx["tapi"], fx["tqat"], kv_quant_bits=kv, device="cpu"))
    return fx["qat_engines"][kv]


def _requests(batch, max_new, gap=2):
    return [Request(uid=i, inputs={k: v[i:i + 1] for k, v in batch.items()},
                    sampling=SamplingParams(max_new_tokens=max_new),
                    arrival=gap * i)
            for i in range(batch["tokens"].shape[0])]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# deploy and wire formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,layout", [(8, "packed"), (4, "packed"),
                                         (8, "bitplane")])
def test_deploy_of_encdec_stacks_equals_reference(fx, bits, layout):
    """The port's ``to_serving_params`` of the carried QAT tree (mixed
    per-WB widths) equals the reference's deploy leaf for leaf, dtypes
    included; both (L, ...) stacks deploy a layer at a time (the same
    payload as the stack converted whole), and the depthwise kernel, the
    norms and the embedding stay f32 leaves."""
    from repro_torch.serve import deploy
    qat = mixed_bitwidths(fx["qat"], np.random.default_rng(3))
    jdep = tree_to_numpy(j_deploy(qat, bits, layout=layout))
    tqat = params_from_numpy(tree_to_numpy(qat), device="cpu")
    tdep = t_deploy(tqat, bits, layout=layout, device="cpu")
    src = dict(_leaves(tqat))
    want = {k: v for k, v in _leaves(jdep)
            if k[-1] not in ("wb_rows", "wb_cols")}
    got, stacks = {}, 0
    for path, leaf in _leaves(tdep):
        if isinstance(leaf, (ServingWeight, BitplaneServingWeight)):
            whole = deploy._convert_layer(src[path], bits, layout)
            stacks += 1
            for f in dataclasses.fields(leaf):
                v = getattr(leaf, f.name)
                if isinstance(v, torch.Tensor):
                    got[path + (f.name,)] = np_of(v)
                    assert torch.equal(v, getattr(whole, f.name)), path
                elif f.name != "spec":
                    got[path + (f.name,)] = v
        else:
            assert leaf.dtype == torch.float32, path
            got[path] = np_of(leaf)
    assert stacks == 8 + 10      # 4 + 2 + 2 a encoder, 4 + 4 + 2 a decoder
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
        else:
            assert tuple(got[k]) == tuple(v) if isinstance(v, tuple) \
                else got[k] == v, k
    assert tdep["enc_layers"]["conv_dw"].shape[1] == 15


# ---------------------------------------------------------------------------
# forward and greedy parity across the backend matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_family_forward_parity(fx, bits):
    """Prefill logits of every backend within 2e-4 of the reference's
    dense prefill on the same deploy; the bit-plane tree composes every
    leaf to the packed tree's weights bit for bit."""
    jp, tp = _trees(fx, bits)
    _, tb = _trees(fx, bits, "bitplane")
    for (path, a), (_, b) in zip(_leaves(tp), _leaves(tb)):
        if isinstance(a, ServingWeight):
            assert torch.equal(qdense(a, torch.float32),
                               qdense(b, torch.float32)), path
    batch = _batch(fx)
    want, _ = JEngine(fx["japi"], jp, backend="dense").prefill(_j(batch))
    for be, tree in (("dense", tp), ("kernel", tp), ("ref", tp),
                     ("dense", tb), ("bitplane", tb), ("ref", tb)):
        got, state = TEngine(fx["tapi"], tree, backend=be,
                             device="cpu").prefill(batch)
        np.testing.assert_allclose(np_of(got), np.asarray(want),
                                   **LOGIT_TOL, err_msg=f"int{bits} {be}")
        assert state["enc_out"].shape == (2, S_ENC, fx["tapi"].cfg.d_model)


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_greedy_decode_token_identical_matrix(fx, bits):
    """Greedy tokens (int8 KV) identical across dense / kernel / ref on the
    packed tree and bitplane on the bit-plane tree, and to the
    reference's."""
    jp, tp = _trees(fx, bits)
    _, tb = _trees(fx, bits, "bitplane")
    batch = _batch(fx)
    want = np.asarray(JEngine(fx["japi"], jp, kv_quant_bits=8,
                              backend="dense").generate(_j(batch),
                                                        max_new=4))
    for be, ab, tree in (("dense", "gather", tp), ("kernel", "fused", tp),
                         ("ref", "ref", tp), ("bitplane", "fused", tb)):
        got = TEngine(fx["tapi"], tree, kv_quant_bits=8, backend=be,
                      attn_backend=ab, device="cpu").generate(batch,
                                                              max_new=4)
        np.testing.assert_array_equal(np_of(got), want,
                                      err_msg=f"int{bits} {be}")


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def _oneshot_want(fx, kv, batch, max_new):
    jeng, teng = _qat_engines(fx, kv)
    want = np.asarray(jeng.generate(_j(batch), max_new=max_new))
    np.testing.assert_array_equal(
        np_of(teng.generate(batch, max_new=max_new)), want)
    return teng, want


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_staggered_requests_match_oneshot(fx, kv_bits):
    """Requests arriving mid-decode (3 slots, 4 requests: slot reuse) in
    the fixed-width cache give the reference's one-shot tokens (the lazy
    state tiles the first request's encoder row across the slots, as
    separate storage)."""
    batch = _batch(fx, b=4)
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
    batch = _batch(fx, b=4)
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
    jeng, teng = _qat_engines(fx, 32)
    batch = _batch(fx)
    p = batch["tokens"].shape[1]
    api, japi = teng.api, jeng.api
    logits, st_s = api.prefill(teng.params, teng._inputs(batch),
                               extra_slots=8)
    jlog, jst = japi.prefill(jeng.params, _j(batch), extra_slots=8)
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


def _request_pairs(fx, specs):
    """The same greedy requests (tokens, frames) for both packages."""
    pairs = []
    for uid, (width, new, arrival, prio) in enumerate(specs):
        inputs = {"tokens": prompt(fx["vocab"], width, 20 + uid),
                  "frames": frames(fx["frames"].shape[-1], S_ENC, 20 + uid)}
        sp = dict(max_new_tokens=new, priority=prio)
        pairs.append((JRequest(uid=uid, inputs=_j(inputs),
                               sampling=JSP(**sp), arrival=arrival),
                      Request(uid=uid, inputs=inputs,
                              sampling=SamplingParams(**sp),
                              arrival=arrival)))
    return pairs


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


# ---------------------------------------------------------------------------
# park / restore
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# refusals, warnings and the launcher
# ---------------------------------------------------------------------------

def test_encoder_length_mismatch_is_refused(fx):
    """Cross-attention has no per-row length mask: inserting a prompt
    whose frames are wider than the live batch's raises the reference's
    ``ValueError``, in ``prefill_at`` and at scheduler admission."""
    jeng, teng = _qat_engines(fx, 32)
    batch = _batch(fx, b=2)
    wide = dict(_batch(fx, b=1), frames=frames(fx["frames"].shape[-1],
                                               S_ENC + 2, 9))
    _, jst = jeng.prefill(_j(batch), extra_slots=4)
    with pytest.raises(ValueError, match="same encoder length"):
        jeng.prefill_at(_j(wide), jst, 0)
    _, tst = teng.prefill(batch, extra_slots=4)
    with pytest.raises(ValueError, match="same encoder length"):
        teng.prefill_at(wide, tst, 0)
    inputs = [{k: v[:1] for k, v in batch.items()}, wide]
    jreqs = [JRequest(uid=i, inputs=_j(x), sampling=JSP(max_new_tokens=3),
                      arrival=0) for i, x in enumerate(inputs)]
    treqs = [Request(uid=i, inputs=x,
                     sampling=SamplingParams(max_new_tokens=3), arrival=0)
             for i, x in enumerate(inputs)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        sched = eng.make_scheduler(reqs, n_slots=2, page_size=4)
        with pytest.raises(ValueError, match="same encoder length"):
            sched.run(reqs)


def test_prefix_cache_is_disabled_with_a_warning(fx):
    """``prefix_cache=True`` warns as the reference does and shares no
    page: two requests with the same tokens and frames make no lookup."""
    teng = engine_pair(fx, 8)[1]
    same = _batch(fx, b=1, p=9)
    reqs = [Request(uid=i, inputs=same,
                    sampling=SamplingParams(max_new_tokens=3), arrival=i)
            for i in range(2)]
    with pytest.warns(UserWarning, match="prefix_cache needs a purely"):
        sched = teng.make_scheduler(reqs, n_slots=2, page_size=4,
                                    prefix_cache=True)
    results = sched.run(reqs)
    assert sched.prefix_cache is None
    assert sched.sched_stats["prefix_lookups"] == 0
    assert sched.sched_stats["prefix_hits"] == 0
    assert results[0].tokens == results[1].tokens


def test_family_refusals(fx):
    """Speculative decoding (``ValueError``), the verify step and the
    train launcher (``NotImplementedError``) refuse the family, naming
    it; the training loss (``encdec_loss``) takes its frames batch."""
    from repro_torch.launch.train import main as train_main
    _, tb = _trees(fx, 8, "bitplane")
    with pytest.raises(ValueError, match="'audio'"):
        TEngine(fx["tapi"], tb, backend="bitplane", speculate_planes=4,
                device="cpu")
    teng = _qat_engines(fx, 32)[1]
    _, state = teng.prefill(_batch(fx), extra_slots=4)
    tok = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        teng.api.verify_step(teng.params, tok, state, 8)
    loss, m = fx["tapi"].loss(fx["tqat"], {
        "tokens": tok, "labels": tok, "frames": torch.zeros((2, 3, 128))})
    assert torch.isfinite(loss) and float(m["aux"]) == 0.0
    with pytest.raises(NotImplementedError, match="'audio'.*frames"):
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "1"])


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
