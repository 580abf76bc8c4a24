"""Serving the vlm (qwen2-vl-2b), ssm (rwkv6-1.6b) and hybrid (zamba2-1.2b)
families through the port, held against the JAX reference: the
companions of the reference's rows for these families in
tests/test_serving.py and tests/test_autotune.py.

Fixture: each architecture at ``tiny(dtype="float32")`` with 9x8 blocks
and 8-bit activations in both packages, the reference's
``init(PRNGKey(0))`` QAT tree, deployed by the reference and carried
across through numpy (``torch_port_helpers.tiny_fixture``).  Prompt
tokens come from ``numpy.random.default_rng`` (prompt seed 1, see
tests/test_torch_slice.py on rounding ties); a qwen2-vl prompt's vision
prefix is ``0.1 * normal`` from numpy.

* the port's deploy of the carried QAT tree (mixed per-WB widths) equals
  the reference's bit for bit: the unstacked 2-D shared block and
  ``vision_proj``, zamba2's N = 16 ``in_B`` / ``in_C`` (a fraction of one
  column block), and the plain float vectors left f32;
* greedy tokens through the port's ``kernel`` / ``fused`` wrappers (and
  ``bitplane`` on a bit-plane deploy) equal the reference's, int8 and int4
  weights, 8 and 4 KV bits where the family has KV;
* staggered (fixed-width), paged and chunked scheduler drives keep the
  reference's ledger tick by tick (qwen2-vl chunked at 3 with its vision
  prefix on the first chunk; rwkv6 and zamba2 insert whole; zamba2 paged
  and overcommitted, parking its recurrent rows with its pages); a vector
  fill index equals a scalar one;
* a zamba2 slot parks and restores bit for bit, in the reference's
  record layout;
* the refusals and warnings are the reference's; the launcher serves each
  family on the CPU.
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
from repro_torch.serve import Request, SamplingParams  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight)
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (mixed_bitwidths, np_of,  # noqa: E402
                                prompt, run_lockstep, tiny_fixture,
                                tree_to_numpy)

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"
ARCHS = (QWEN, RWKV, ZAMBA)
FLOAT_LEAVES = {QWEN: ("bq", "bk", "bv"),
                RWKV: ("decay_a", "decay_b", "bonus_u", "decay_w0"),
                ZAMBA: ("conv1d_w", "a_log", "d_skip", "dt_bias")}
_FIXTURES = {}


def _fx(arch):
    if arch not in _FIXTURES:
        fx = tiny_fixture(arch)
        fx["trees"], fx["kv_engines"] = {}, {}
        _FIXTURES[arch] = fx
    return _FIXTURES[arch]


def _trees(fx, bits, layout="packed"):
    key = (bits, layout)
    if key not in fx["trees"]:
        jt = fx["jdep"] if key == (8, "packed") else \
            j_deploy(fx["qat"], bits, layout=layout)
        fx["trees"][key] = (jt, params_from_numpy(tree_to_numpy(jt),
                                                  device="cpu"))
    return fx["trees"][key]


def _engines(fx, kv, bits=8, layout="packed"):
    """(reference, port) engines over a deploy at KV width ``kv``: the
    reference through its ``ref`` matmuls and ``gather`` attention, the
    port through its ``kernel`` (``bitplane``) / ``fused`` wrappers."""
    key = (kv, bits, layout)
    if key not in fx["kv_engines"]:
        jt, tt = _trees(fx, bits, layout)
        be = "bitplane" if layout == "bitplane" else "kernel"
        fx["kv_engines"][key] = (
            JEngine(fx["japi"], jt, kv_quant_bits=kv, backend="ref",
                    attn_backend="gather"),
            TEngine(fx["tapi"], tt, kv_quant_bits=kv, backend=be,
                    attn_backend="fused", device="cpu"))
    return fx["kv_engines"][key]


def _inputs(fx, width, seed, b=1):
    cfg = fx["tapi"].cfg
    x = {"tokens": prompt(fx["vocab"], width, seed, b)}
    if cfg.family == "vlm":
        x["vision_embeds"] = (0.1 * np.random.default_rng((3, seed))
                              .standard_normal((b, cfg.vision_tokens,
                                                cfg.d_model))
                              ).astype(np.float32)
    return x


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _pairs(fx, specs):
    """The same greedy requests for both packages: (width, max_new,
    arrival, priority) each."""
    out = []
    for uid, (width, new, arrival, prio) in enumerate(specs):
        x = _inputs(fx, width, 30 + uid)
        sp = dict(max_new_tokens=new, priority=prio)
        out.append((JRequest(uid=uid, inputs=_j(x), sampling=JSP(**sp),
                             arrival=arrival),
                    Request(uid=uid, inputs=x, sampling=SamplingParams(**sp),
                            arrival=arrival)))
    return [p[0] for p in out], [p[1] for p in out]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# deploy and wire formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits,layout", [(8, "packed"), (4, "packed"),
                                         (8, "bitplane")])
def test_deploy_equals_reference_bit_for_bit(arch, bits, layout):
    """The port's ``to_serving_params`` of the carried QAT tree (mixed
    per-WB widths) equals the reference's deploy leaf for leaf, dtypes
    included; the unstacked shared block and ``vision_proj`` deploy 2-D,
    and the family's plain vectors stay f32 leaves."""
    fx = _fx(arch)
    qat = mixed_bitwidths(fx["qat"], np.random.default_rng(3))
    want = {k: v for k, v in _leaves(tree_to_numpy(
        j_deploy(qat, bits, layout=layout)))
        if k[-1] not in ("wb_rows", "wb_cols")}
    tdep = t_deploy(params_from_numpy(tree_to_numpy(qat), device="cpu"),
                    bits, layout=layout, device="cpu")
    got, flat = {}, {}
    for path, leaf in _leaves(tdep):
        if isinstance(leaf, (ServingWeight, BitplaneServingWeight)):
            for f in dataclasses.fields(leaf):
                v = getattr(leaf, f.name)
                if isinstance(v, torch.Tensor):
                    got[path + (f.name,)] = np_of(v)
                elif f.name != "spec":
                    got[path + (f.name,)] = v
        else:
            assert leaf.dtype == torch.float32, path
            got[path] = np_of(leaf)
            flat[path[-1]] = leaf
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
        else:
            assert (tuple(got[k]) == tuple(v)) if isinstance(v, tuple) \
                else got[k] == v, k
    assert set(FLOAT_LEAVES[arch]) <= set(flat)
    if arch == ZAMBA:
        wq = tdep["shared_attn"]["wq"]
        assert isinstance(wq, (ServingWeight, BitplaneServingWeight))
        assert tuple(wq.shape) == (256, 128)           # reads 2 x d_model
        assert tuple(tdep["layers"]["in_B"].shape) == (4, 128, 16)
    if arch == QWEN:
        assert tuple(tdep["vision_proj"].shape) == (128, 128)


# ---------------------------------------------------------------------------
# one-shot greedy decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,bits,kv", [
    (QWEN, 8, 8), (QWEN, 4, 4), (RWKV, 8, 32), (RWKV, 4, 32),
    (ZAMBA, 8, 8), (ZAMBA, 4, 4)])
def test_generate_equals_reference(arch, bits, kv):
    """Greedy tokens of the port's packed kernels and fused attention
    equal the reference's ``ref`` / ``gather`` engine's, one batch of
    two prompts (a prompt width the scans take per token)."""
    fx = _fx(arch)
    jeng, teng = _engines(fx, kv, bits)
    x = _inputs(fx, 7, 1, b=2)
    want = np.asarray(jeng.generate(_j(x), max_new=5))
    np.testing.assert_array_equal(np_of(teng.generate(x, max_new=5)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bitplane_generate_equals_reference(arch):
    fx = _fx(arch)
    kv = 32 if arch == RWKV else 8
    jeng, teng = _engines(fx, kv, 8, "bitplane")
    x = _inputs(fx, 8, 2, b=2)
    want = np.asarray(jeng.generate(_j(x), max_new=4))
    np.testing.assert_array_equal(np_of(teng.generate(x, max_new=4)), want)


# ---------------------------------------------------------------------------
# the scheduler, tick by tick
# ---------------------------------------------------------------------------

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
    fx = _fx(arch)
    jeng, teng = _engines(fx, kv)
    jr, tr = _pairs(fx, SPECS)
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


@pytest.mark.parametrize("arch", [QWEN, ZAMBA, RWKV])
def test_vector_index_matches_scalar_decode(arch):
    """Decode steps with a per-slot (B,) index give the scalar index's
    logits bit for bit, and the reference's within 2e-4."""
    fx = _fx(arch)
    jeng, teng = _engines(fx, 32)
    x = _inputs(fx, 8, 4, b=2)
    tv = fx["tapi"].cfg.vision_tokens if arch == QWEN else 0
    api, japi = teng.api, jeng.api
    logits, st_s = api.prefill(teng.params, teng._inputs(x), extra_slots=8)
    _, jst = japi.prefill(jeng.params, _j(x), extra_slots=8)

    def clone(t):
        return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.clone()
    st_v = clone(st_s)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for i in range(3):
        p = tv + 8 + i
        lg_s, st_s = api.decode_step(teng.params, tok, st_s, p, backend="ref")
        lg_v, st_v = api.decode_step(
            teng.params, tok, st_v, torch.full((2,), p, dtype=torch.int32),
            backend="ref")
        jl, jst = japi.decode_step(jeng.params, jnp.asarray(np_of(tok)), jst,
                                   jnp.asarray(p, jnp.int32))
        assert torch.equal(lg_s, lg_v), i
        np.testing.assert_allclose(np_of(lg_s), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4)
        tok = lg_s.argmax(-1)[:, None].to(torch.int32)


# ---------------------------------------------------------------------------
# park / restore
# ---------------------------------------------------------------------------

def test_zamba2_park_restore_roundtrip_bit_identical():
    """Park a mid-decode zamba2 slot (its attention pool pages and its
    mamba rows), overwrite both in place, restore into another slot on
    other pages: everything comes back bit for bit, in the reference's
    record layout (its values within 1e-4: the two packages round the f32
    scans differently), and the restored slot decodes the token it would
    have."""
    fx = _fx(ZAMBA)
    jeng, teng = _engines(fx, 8)
    jr, tr = _pairs(fx, [(6, 8, 0, 0), (3, 8, 0, 0)])
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


def test_fresh_insert_zeroes_the_previous_occupants_rows():
    """A chunk at start 0 zeroes the slot's recurrent rows before its
    forward (views write in place): a prompt inserted into a slot whose
    rows hold garbage gives the tokens of a clean insertion."""
    fx = _fx(RWKV)
    teng = _engines(fx, 32)[1]
    x = _inputs(fx, 6, 5)
    state = teng.init_decode_state(x, n_slots=2, max_len=32)
    clean, _ = teng.prefill_chunk_at(x, state, 1, 0)
    for leaf in state["cache"].values():
        leaf[:, 1] = 3.0
    dirty, state = teng.prefill_chunk_at(x, state, 1, 0)
    assert torch.equal(clean, dirty)
    assert not torch.equal(state["cache"]["wkv"][:, 0],
                           state["cache"]["wkv"][:, 1])


# ---------------------------------------------------------------------------
# refusals, warnings and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_speculation_is_refused_for_recurrent_families(arch):
    """The reference's hybrid speculation guard (tests/test_autotune.py):
    ``speculate_planes`` on a bit-plane tree raises ``ValueError``."""
    fx = _fx(arch)
    _, tb = _trees(fx, 8, "bitplane")
    with pytest.raises(ValueError, match="recurrent state"):
        TEngine(fx["tapi"], tb, backend="bitplane", speculate_planes=2,
                device="cpu")


def test_rwkv6_ignores_page_size_and_kv_bits_with_warnings():
    fx = _fx(RWKV)
    _, tt = _trees(fx, 8)
    with pytest.warns(UserWarning, match="has no effect on family 'ssm'"):
        teng = TEngine(fx["tapi"], tt, kv_quant_bits=8, backend="kernel",
                       device="cpu")
    _, tr = _pairs(fx, SPECS[:2])
    with pytest.warns(UserWarning, match="no KV cache to page"):
        sched = teng.make_scheduler(tr, n_slots=2, page_size=4)
    assert sched.page_size == 0 and not sched.paged
    results = sched.run(tr)
    for r, req in zip(results, tr):
        want = teng.generate(req.inputs, max_new=req.sampling.max_new_tokens)
        assert r.tokens == np_of(want)[0].tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_is_disabled_with_a_warning(arch):
    """qwen2-vl and zamba2 warn as the reference does and share no page;
    rwkv6, whose page size is ignored first, has no paged cache to share
    through and raises the reference's ``ValueError``."""
    fx = _fx(arch)
    teng = _engines(fx, 32)[1]
    _, tr = _pairs(fx, [(9, 3, 0, 0), (9, 3, 1, 0)])
    tr[1].inputs = tr[0].inputs
    if arch == RWKV:
        with pytest.warns(UserWarning, match="no KV cache to page"):
            with pytest.raises(ValueError, match="needs a paged cache"):
                teng.make_scheduler(tr, n_slots=2, page_size=4,
                                    prefix_cache=True)
        return
    with pytest.warns(UserWarning, match="prefix_cache needs a purely"):
        sched = teng.make_scheduler(tr, n_slots=2, page_size=4,
                                    prefix_cache=True)
    results = sched.run(tr)
    assert sched.prefix_cache is None
    assert sched.sched_stats["prefix_lookups"] == 0
    assert results[0].tokens == results[1].tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_training_is_refused(arch):
    """Training was ported: the loss takes a QAT tree of the family (aux
    0, no experts) and the train launcher builds its trainer
    (tests/test_torch_train_families.py runs it)."""
    from repro_torch.launch import train as tl
    fx = _fx(arch)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    tqat = params_from_numpy(tree_to_numpy(fx["qat"]), device="cpu")
    loss, m = fx["tapi"].loss(tqat, {"tokens": tok, "labels": tok})
    assert torch.isfinite(loss) and float(m["aux"]) == 0.0
    trainer = tl.make_trainer(tl.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--steps", "1"]))
    assert trainer.state.step == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_family_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id>`` on the CPU with
    the quantizers off: each request's tokens equal one-shot ``generate``
    on its inputs (paged and chunked where the family allows; a qwen2-vl
    request carries its (1, 16, 128) vision prefix from the seeded
    generator), then the one-shot path through the bit-plane kernel."""
    from repro_torch.launch.serve import main
    args = ["--arch", arch, "--device", "cpu", "--requests", "--backend",
            "kernel", "--attn-backend", "fused", "--act-bits", "32",
            "--batch", "4", "--n-slots", "3", "--prompt-lens", "6,2,9",
            "--max-news", "5,3"]
    if arch != RWKV:
        args += ["--kv-bits", "8", "--page-size", "4", "--prefill-chunk",
                 "3"]
    out = main(args)
    eng = out["engine"]
    for req, res in zip(out["requests"], out["results"]):
        if arch == QWEN:
            ve = req.inputs["vision_embeds"]
            assert ve.shape == (1, 16, 128) and ve.dtype == np.float32
        want = eng.generate(req.inputs, max_new=req.sampling.max_new_tokens)
        assert res.tokens == np_of(want)[0].tolist(), req.uid
    main(["--arch", arch, "--device", "cpu", "--backend", "bitplane",
          "--attn-backend", "fused", "--max-new", "3", "--batch", "2"])
    assert "deployed: bitplane int8" in capsys.readouterr().out
