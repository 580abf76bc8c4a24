"""MoE serving in the port, held against the JAX reference: the companions
of the reference's MoE rows in tests/test_backend_parity.py and
tests/test_serving.py, and the MoE family through the port's deploy,
engine, scheduler, speculative decoding and launcher.

Fixture: ``granite-moe-3b-a800m`` (40 experts top-8 at full width; 4
experts top-2 here) and ``llama4-scout-17b-a16e`` (top-1 plus a shared
expert) at ``tiny(dtype="float32")`` with 9x8 blocks and 8-bit
activations, params from the reference's ``init(PRNGKey(0))``, deployed
by the reference and carried across through numpy.  Prompts come from
``numpy.random.default_rng`` with prompt seed 1 (see
tests/test_torch_slice.py on rounding ties).  Dispatch is the exact
``ragged`` one unless a test sets ``capacity``.

* the port's deploy of the carried QAT tree equals the reference's bit
  for bit on the (L, E, K, N) expert stacks (packed int8 / int4,
  bit-plane); ``router_w`` stays a plain f32 leaf; the streamed bytes are
  the reference's;
* prefill logits within 2e-4 of the reference across the dense / kernel /
  ref / bitplane backends at int8 and int4, the bit-plane compose bit for
  bit the packed one leaf by leaf; greedy tokens identical across the
  backend matrix and to the reference;
* staggered, paged and chunked requests give the one-shot tokens; a
  paged, chunked, prefix-cached, overcommitted trace keeps the
  reference's ledger tick by tick;
* speculative greedy on a bit-plane tree gives the plain greedy tokens;
* capacity dispatch under the scheduler warns as the reference does; the
  launcher serves the family on the CPU; training is refused.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro.serve.deploy import weight_stream_bytes as j_bytes  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import qdense  # noqa: E402
from repro_torch.serve import Request, SamplingParams  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight)
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from repro_torch.serve.deploy import weight_stream_bytes as t_bytes  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (engine_pair, mixed_bitwidths,  # noqa: E402
                                np_of, prompt, request_pair, run_lockstep,
                                tiny_fixture, tree_to_numpy)

torch.set_num_threads(2)
GRANITE, SCOUT = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _fixture(arch):
    fx = tiny_fixture(arch)
    fx["tqat"] = params_from_numpy(tree_to_numpy(fx["qat"]), device="cpu")
    fx["jtrees"], fx["ttrees"] = {}, {}
    return fx


@pytest.fixture(scope="module")
def granite():
    return _fixture(GRANITE)


@pytest.fixture(scope="module")
def scout():
    return _fixture(SCOUT)


@pytest.fixture(params=[GRANITE, SCOUT])
def fx(request, granite, scout):
    return granite if request.param == GRANITE else scout


def _trees(fx, bits, layout="packed"):
    """The reference's deploy of the fixture's QAT tree and its carry
    across, built once."""
    key = (bits, layout)
    if key not in fx["jtrees"]:
        fx["jtrees"][key] = j_deploy(fx["qat"], bits, layout=layout)
        fx["ttrees"][key] = params_from_numpy(
            tree_to_numpy(fx["jtrees"][key]), device="cpu")
    return fx["jtrees"][key], fx["ttrees"][key]


def _tokens(fx, n, seed, b=1):
    return prompt(fx["vocab"], n, seed, b)


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
def test_deploy_of_expert_stacks_equals_reference(fx, bits, layout):
    """The port's ``to_serving_params`` of the carried QAT tree (mixed
    per-WB widths) equals the reference's deploy of the same tree leaf for
    leaf, dtypes included; the expert leaves are (L, E, K, N) stacks and
    the router a plain f32 leaf."""
    qat = mixed_bitwidths(fx["qat"], np.random.default_rng(3))
    jtree = j_deploy(qat, bits, layout=layout)
    jdep = tree_to_numpy(jtree)
    tqat = params_from_numpy(tree_to_numpy(qat), device="cpu")
    tdep = t_deploy(tqat, bits, layout=layout, device="cpu")
    want = dict(_leaves(jdep))
    got = {}
    for path, leaf in _leaves(tdep):
        if isinstance(leaf, (ServingWeight, BitplaneServingWeight)):
            for f in dataclasses.fields(leaf):
                v = getattr(leaf, f.name)
                got[path + (f.name,)] = np_of(v) if isinstance(
                    v, torch.Tensor) else v
        else:
            got[path] = np_of(leaf)
    want = {k: v for k, v in want.items() if k[-1] not in ("wb_rows",
                                                            "wb_cols")}
    got = {k: v for k, v in got.items() if k[-1] != "spec"}
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
        else:
            assert tuple(got[k]) == tuple(v) if isinstance(v, tuple) \
                else got[k] == v, k
    moe = tdep["layers"]["moe"]
    cfg = fx["tapi"].cfg
    assert isinstance(moe["router_w"], torch.Tensor) and \
        moe["router_w"].dtype == torch.float32
    assert moe["expert_up"].shape == (cfg.n_layers, cfg.n_experts,
                                      cfg.d_model, cfg.d_ff)
    assert t_bytes(tdep) == j_bytes(jtree)


def test_deploy_slices_large_leaves_bit_for_bit(granite):
    """A stacked quantized leaf deploys one layer at a time (the
    full-width expert stacks would not fit their f32 temporaries whole):
    the same payload as the whole leaf converted at once, bit for bit, in
    both layouts."""
    from repro_torch.serve import deploy
    qat = {"/".join(p): x for p, x in _leaves(granite["tqat"])}
    for layout in ("packed", "bitplane"):
        sliced = deploy.to_serving_params(granite["tqat"], 4, layout=layout,
                                          device="cpu")
        n = 0
        for pa, a in _leaves(sliced):
            src = qat["/".join(pa)]
            if isinstance(a, torch.Tensor):
                continue
            whole = deploy._convert_layer(src, 4, layout)
            assert type(a) is type(whole) and a.shape == whole.shape, pa
            n += 1
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(whole, f.name)
                if isinstance(va, torch.Tensor):
                    assert va.dtype == vb.dtype and torch.equal(va, vb), \
                        (pa, f.name)
        assert n >= 7, n            # 4 attention and 3 expert stacks


# ---------------------------------------------------------------------------
# forward and greedy parity across the backend matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_family_forward_parity(fx, bits):
    """Prefill logits of every backend within 2e-4 of the reference's
    dense prefill.  The bit-plane tree composes every leaf, expert stacks
    included, to the packed tree's weights bit for bit, and its dense
    logits are the packed tree's within 1e-6 (the reference's
    cross-layout tolerance: int4's compose is a transposed view, so the
    product takes another BLAS path)."""
    jp, tp = _trees(fx, bits)
    _, tb = _trees(fx, bits, "bitplane")
    for (path, a), (_, b) in zip(_leaves(tp), _leaves(tb)):
        if isinstance(a, ServingWeight):
            assert torch.equal(qdense(a, torch.float32),
                               qdense(b, torch.float32)), path
    tok = _tokens(fx, 8, 0, b=2)
    want, _ = JEngine(fx["japi"], jp, backend="dense").prefill(
        {"tokens": jnp.asarray(tok)})
    want = np.asarray(want)
    dense = {}
    for be, tree in (("dense", tp), ("kernel", tp), ("ref", tp),
                     ("dense", tb), ("bitplane", tb), ("ref", tb)):
        got, _ = TEngine(fx["tapi"], tree, backend=be,
                         device="cpu").prefill({"tokens": tok})
        np.testing.assert_allclose(np_of(got), want, **LOGIT_TOL,
                                   err_msg=f"int{bits} {be}")
        if be == "dense":
            dense[tree is tb] = np_of(got)
    np.testing.assert_allclose(dense[True], dense[False], rtol=1e-6,
                               atol=1e-6)


def test_forward_aux_matches_reference(fx):
    """The whole model's forward on the QAT tree: logits within 2e-4 and
    the load-balancing aux summed over the layers within 1e-6 of the
    reference's (the serving forward drops the aux)."""
    from repro.models.transformer import forward as j_forward
    from repro_torch.models.transformer import forward_aux
    tok = _tokens(fx, 8, 0, b=2)
    jl, jaux, _ = j_forward(fx["qat"], fx["japi"].cfg, jnp.asarray(tok))
    tl, taux, _ = forward_aux(fx["tqat"], fx["tapi"].cfg,
                              torch.from_numpy(tok))
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    assert float(taux) > 0


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_greedy_token_identical_matrix(fx, bits):
    """Greedy tokens (int8 KV) identical across dense / kernel / ref on the
    packed tree and bitplane on the bit-plane tree, and to the
    reference's."""
    jp, tp = _trees(fx, bits)
    _, tb = _trees(fx, bits, "bitplane")
    tok = _tokens(fx, 8, 0, b=2)
    want = np.asarray(JEngine(fx["japi"], jp, kv_quant_bits=8,
                              backend="dense").generate(
        {"tokens": jnp.asarray(tok)}, max_new=4))
    for be, ab, tree in (("dense", "gather", tp), ("kernel", "fused", tp),
                         ("ref", "ref", tp), ("bitplane", "fused", tb)):
        got = TEngine(fx["tapi"], tree, kv_quant_bits=8, backend=be,
                      attn_backend=ab, device="cpu").generate(
            {"tokens": tok}, max_new=4)
        np.testing.assert_array_equal(np_of(got), want,
                                      err_msg=f"int{bits} {be}")


def test_capacity_greedy_matches_reference(granite):
    """The capacity dispatch end to end: the kernel wrappers run each
    expert's slice, and the tokens are the reference's under its
    capacity scan."""
    jp, tp = _trees(granite, 8)
    tok = _tokens(granite, 8, 0, b=2)
    jmoe.GROUPED_IMPL["impl"] = tmoe.GROUPED_IMPL["impl"] = "capacity"
    try:
        want = np.asarray(JEngine(granite["japi"], jp, kv_quant_bits=8,
                                  backend="ref").generate(
            {"tokens": jnp.asarray(tok)}, max_new=4))
        got = TEngine(granite["tapi"], tp, kv_quant_bits=8,
                      backend="kernel", attn_backend="fused",
                      device="cpu").generate({"tokens": tok}, max_new=4)
    finally:
        jmoe.GROUPED_IMPL["impl"] = tmoe.GROUPED_IMPL["impl"] = "ragged"
    np.testing.assert_array_equal(np_of(got), want)


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def _requests(batch, max_new, gap=2):
    return [Request(uid=i, inputs={"tokens": batch[i:i + 1]},
                    sampling=SamplingParams(max_new_tokens=max_new),
                    arrival=gap * i) for i in range(batch.shape[0])]


@pytest.mark.parametrize("kv_bits,page,chunk", [(32, 0, 0), (8, 4, 0),
                                                (4, 4, 3)])
def test_staggered_requests_match_oneshot(granite, kv_bits, page, chunk):
    """Requests arriving mid-decode (3 slots, 4 requests: slot reuse),
    contiguous or paged and chunked, give the one-shot tokens; a paged
    pool drains."""
    eng = engine_pair(granite, kv_bits)[1]
    batch = _tokens(granite, 8, 0, b=4)
    oneshot = np_of(eng.generate({"tokens": batch}, max_new=6))
    reqs = _requests(batch, 6)
    sched = eng.make_scheduler(reqs, n_slots=3, page_size=page,
                               prefill_chunk=chunk)
    for i, r in enumerate(sched.run(reqs)):
        assert r.tokens == oneshot[i].tolist(), f"slot parity @req {i}"
        assert r.finish_reason == "length"
    if page:
        assert sched.cache_report()["pages_in_use"] == 0
        assert (sched.tables == 0).all()


@pytest.mark.parametrize("arch,kv_bits,chunk", [(GRANITE, 8, 0),
                                                (GRANITE, 4, 3),
                                                (SCOUT, 8, 3)])
def test_prefix_overcommit_trace_matches_reference(granite, scout, arch,
                                                   kv_bits, chunk):
    """A paged trace with overcommit 1.5 over a pool sized to force
    parking, a shared 9-token prefix on every other request, priorities
    {0, 1, 2}: tokens, ticks, block tables after every tick, stats,
    ``cache_report`` and ``validate()`` as the reference's."""
    fx = granite if arch == GRANITE else scout
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
    assert ts.sched_stats["prefix_hits"] >= 1
    assert ts.prefix_cache is not None
    assert not ts.validate() and ts.allocator.in_use == 0


def test_capacity_dispatch_warns_under_the_scheduler(granite):
    eng = engine_pair(granite, 8)[1]
    reqs = _requests(_tokens(granite, 4, 0, b=1), 2)
    tmoe.GROUPED_IMPL["impl"] = "capacity"
    try:
        with pytest.warns(UserWarning, match="capacity-dropping MoE"):
            eng.make_scheduler(reqs, n_slots=1)
    finally:
        tmoe.GROUPED_IMPL["impl"] = "ragged"


# ---------------------------------------------------------------------------
# speculative decoding on a bit-plane MoE tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,gamma", [(4, 3), (6, 2)])
def test_speculative_greedy_token_identical(granite, k, gamma):
    """Self-speculative decoding on a mixed-width bit-plane granite tree:
    the draft truncates the masks of the (L, E, bits, GR, GC) expert
    stacks as it does the 2-D leaves', and the tokens are plain greedy's."""
    qat = mixed_bitwidths(granite["qat"], np.random.default_rng(0))
    tb = params_from_numpy(tree_to_numpy(j_deploy(qat, 8,
                                                  layout="bitplane")),
                           device="cpu")
    tok = _tokens(granite, 8, 0, b=2)
    plain = TEngine(granite["tapi"], tb, kv_quant_bits=8,
                    backend="bitplane", attn_backend="fused",
                    device="cpu").generate({"tokens": tok}, max_new=8)
    eng = TEngine(granite["tapi"], tb, kv_quant_bits=8, backend="bitplane",
                  attn_backend="fused", speculate_planes=k,
                  draft_gamma=gamma, device="cpu")
    got = eng.generate({"tokens": tok}, max_new=8)
    np.testing.assert_array_equal(np_of(got), np_of(plain))
    assert eng.round_log and sum(r["drafted"] for r in eng.round_log) > 0
    draft = eng.draft_params["layers"]["moe"]["expert_down"]
    full = eng.params["layers"]["moe"]["expert_down"]
    assert draft.planes.data_ptr() == full.planes.data_ptr()
    assert draft.mask.sum() < full.mask.sum()


# ---------------------------------------------------------------------------
# launcher and refusals
# ---------------------------------------------------------------------------

def test_launcher_serves_moe_on_cpu(tmp_path, capsys):
    from repro_torch.launch.serve import main
    stats = tmp_path / "stats.json"
    out = main(["--arch", GRANITE, "--device", "cpu", "--requests",
                "--backend", "kernel", "--attn-backend", "fused",
                "--kv-bits", "8", "--page-size", "4", "--prefill-chunk",
                "3", "--prefix-cache", "--shared-prefix", "9",
                "--overcommit", "1.5", "--n-pages", "12", "--batch", "5",
                "--n-slots", "3", "--max-new", "6", "--validate-every", "2",
                "--stats-out", str(stats)])
    assert all(r.finish_reason == "length" and len(r.tokens) == 6
               for r in out["results"])
    rep = json.loads(stats.read_text())
    assert rep["contract_findings"] == [] and rep["pages_in_use"] == 0
    assert rep["prefix_hits"] >= 1
    assert out["engine"].api.cfg.n_experts == 4
    main(["--arch", SCOUT, "--device", "cpu", "--backend", "bitplane",
          "--attn-backend", "fused", "--kv-bits", "4", "--max-new", "3",
          "--batch", "2"])
    assert "deployed: bitplane int8" in capsys.readouterr().out


def test_training_is_refused(granite):
    """Training was ported: the loss takes the MoE QAT tree (its aux the
    load-balancing term, > 0) and the train launcher builds its trainer
    (tests/test_torch_train_moe.py runs it)."""
    from repro_torch.launch import train as tl
    tok = torch.zeros((1, 4), dtype=torch.int32)
    loss, m = granite["tapi"].loss(granite["tqat"], {"tokens": tok,
                                                     "labels": tok})
    assert torch.isfinite(loss) and float(m["aux"]) > 0
    assert float(loss) == pytest.approx(float(m["ce"] + 0.01 * m["aux"]))
    trainer = tl.make_trainer(tl.build_parser().parse_args(
        ["--arch", GRANITE, "--device", "cpu", "--steps", "1"]))
    assert trainer.state.step == 0
