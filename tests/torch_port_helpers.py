"""Shared helpers for the tests that hold the PyTorch port against the JAX
reference: flatten a JAX param tree into the numpy form that
``repro_torch.bridge.params_from_numpy`` takes, and convert results back."""
import numpy as np
import torch

from repro.core.bitrep import QuantizedTensor
from repro.core.fakequant import FakeQuantTensor
from repro.serve.deploy import BitplaneServingWeight, ServingWeight


def tree_to_numpy(tree):
    """JAX param tree -> nested dicts and lists of numpy arrays; quantized
    leaves become dicts of their arrays plus their static fields, a CNN
    conv's ``ConvMeta`` the port's, and VGG's ``"M"`` stays a string."""
    from repro.models.cnn import ConvMeta
    if isinstance(tree, ConvMeta):
        from repro_torch.models.cnn import ConvMeta as TConvMeta
        return TConvMeta(c_in=tree.c_in, c_out=tree.c_out, k=tree.k)
    if isinstance(tree, str):
        return tree
    if isinstance(tree, list):
        return [tree_to_numpy(v) for v in tree]
    if isinstance(tree, FakeQuantTensor):
        return {"w": np.asarray(tree.w), "scale": np.asarray(tree.scale),
                "bitwidth": np.asarray(tree.bitwidth),
                "shape": tuple(tree.shape), "wb_rows": tree.spec.wb_rows,
                "wb_cols": tree.spec.wb_cols, "n_bits": tree.n_bits}
    if isinstance(tree, QuantizedTensor):
        return {"planes": np.asarray(tree.planes),
                "sign": np.asarray(tree.sign), "scale": np.asarray(tree.scale),
                "mask": np.asarray(tree.mask), "shape": tuple(tree.shape),
                "wb_rows": tree.spec.wb_rows, "wb_cols": tree.spec.wb_cols}
    if isinstance(tree, ServingWeight):
        return {"w_int": np.asarray(tree.w_int),
                "scale": np.asarray(tree.scale), "shape": tuple(tree.shape),
                "wb_rows": tree.spec.wb_rows, "wb_cols": tree.spec.wb_cols,
                "bits": tree.bits}
    if isinstance(tree, BitplaneServingWeight):
        return {"planes": np.asarray(tree.planes),
                "sign": np.asarray(tree.sign), "mask": np.asarray(tree.mask),
                "scale": np.asarray(tree.scale), "shape": tuple(tree.shape),
                "wb_rows": tree.spec.wb_rows, "wb_cols": tree.spec.wb_cols,
                "bits": tree.bits, "tag": tree.tag}
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def np_of(x):
    """A torch tensor or JAX array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor_regime_emulation(x, w, *, split_weight=True):
    """The arithmetic of the weight-matmul kernels' tensor-core regime, in
    plain torch on the CPU: the dequantized f32 weight ``w`` (K, N) as a
    pair of bf16 tiles, hi = bf16(w) and lo = bf16(w - hi); bf16 ``x`` times
    both, or f32 ``x`` split the same way and x_hi*hi + x_hi*lo + x_lo*hi;
    every product exact in f32 and summed in f32.  ``split_weight=False``
    keeps only hi (one bf16 weight), the design the tolerance rules out."""
    bf16, f32 = torch.bfloat16, torch.float32
    w = w.to(f32)
    hi = w.to(bf16)
    lo = (w - hi.to(f32)).to(bf16) if split_weight else torch.zeros_like(hi)
    if x.dtype == bf16:
        xs = [(x, (hi, lo))]
    else:
        x = x.to(f32)
        xh = x.to(bf16)
        xl = (x - xh.to(f32)).to(bf16)
        xs = [(xh, (hi, lo)), (xl, (hi,))]
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=f32)
    for xa, ws in xs:
        for wb in ws:
            y = y + xa.to(f32) @ wb.to(f32)
    return y


# P(bit-width = 0..8) of a block in the mixed bit-plane fixtures: widths
# 6-8 with odds 1/4 each, 0-5 with 1/24 each (a uniform draw clips most
# blocks so hard that the tiny model repeats one token and accepts every
# draft)
BW_PROB = np.array([1] * 6 + [6] * 3) / 24


def mixed_bitwidths(tree, rng):
    """A JAX QAT tree with each block's bit-width drawn from {0..8}."""
    import dataclasses
    import jax.numpy as jnp
    if isinstance(tree, FakeQuantTensor):
        bw = rng.choice(9, size=tree.bitwidth.shape, p=BW_PROB).astype(
            np.float32)
        return dataclasses.replace(tree, bitwidth=jnp.asarray(bw))
    if isinstance(tree, dict):
        return {k: mixed_bitwidths(v, rng) for k, v in tree.items()}
    return tree


def run_lockstep(jsched, tsched, jreqs, treqs, validate=True):
    """Drive the JAX scheduler and the port's tick by tick on the same
    requests, holding after every tick: the tick, which request holds
    which slot, the block tables, and (``validate``) the rules the two
    ``validate()`` report.  At the end: every result field, ``sched_stats``,
    ``spec_stats`` and ``cache_report()``.  Returns the number of ticks."""
    for r in jreqs:
        jsched.submit(r)
    for r in treqs:
        tsched.submit(r)

    def occupancy(s):
        return [None if x is None else x.req.uid for x in s.slots]

    def rules(s):
        return sorted((f.severity, f.rule) for f in s.validate())

    while jsched.waiting or any(x is not None for x in jsched.slots):
        jsched.step()
        tsched.step()
        assert tsched.tick == jsched.tick
        assert occupancy(tsched) == occupancy(jsched), jsched.tick
        assert [getattr(e, "req", e).uid for e in tsched.waiting] == \
            [getattr(e, "req", e).uid for e in jsched.waiting], jsched.tick
        if jsched.paged:
            np.testing.assert_array_equal(tsched.tables, jsched.tables,
                                          err_msg=f"tick {jsched.tick}")
        if validate:
            assert rules(tsched) == rules(jsched), jsched.tick
    assert not tsched.waiting and all(x is None for x in tsched.slots)
    assert tsched.results.keys() == jsched.results.keys()
    for uid, want in jsched.results.items():
        got = tsched.results[uid]
        assert (got.tokens, got.finish_reason, got.prompt_len,
                got.admitted_tick, got.finished_tick) == \
            (want.tokens, want.finish_reason, want.prompt_len,
             want.admitted_tick, want.finished_tick), uid
    assert tsched.sched_stats == jsched.sched_stats
    assert tsched.spec_stats == jsched.spec_stats
    assert tsched.cache_report() == jsched.cache_report()
    return jsched.tick


def frames(d_model, n, seed, b=1):
    """(b, n, d_model) f32 encoder frames, the reference's ``0.1 *
    normal``, from ``numpy.random.default_rng((2, seed))``."""
    return (0.1 * np.random.default_rng((2, seed)).standard_normal(
        (b, n, d_model))).astype(np.float32)


def tiny_fixture(arch="phi3-mini-3.8b"):
    """The scheduler tests' fixture: ``arch`` (phi3 unless named) at
    ``tiny(dtype="float32")`` with 9x8 blocks and 8-bit activations in both
    packages, the reference's ``init(PRNGKey(0))`` QAT tree, its int8
    deploy, and that deploy carried across through numpy.  For an
    encoder-decoder ``arch``, ``frames`` holds four prompts' seeded
    frames of 8 positions (:func:`frames`, seed 0); else None."""
    import jax
    from repro.configs import REGISTRY as JREG
    from repro.models.api import build as jbuild
    from repro.models.common import QuantConfig as JQ
    from repro.serve.deploy import to_serving_params as j_deploy
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import REGISTRY as TREG
    from repro_torch.configs.base import QuantConfig as TQ
    from repro_torch.models.api import build as tbuild
    jcfg = JREG[arch].tiny(dtype="float32").with_quant(
        JQ(mode="fake", n_bits=8, act_bits=8))
    tcfg = TREG[arch].tiny(dtype="float32").with_quant(
        TQ(mode="fake", n_bits=8, act_bits=8))
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    qat = japi.init(jax.random.PRNGKey(0))
    jdep = j_deploy(qat, 8)
    return dict(japi=japi, tapi=tapi, qat=qat, jdep=jdep,
                tdep=params_from_numpy(tree_to_numpy(jdep), device="cpu"),
                vocab=jcfg.vocab, engines={},
                frames=frames(jcfg.d_model, 8, 0, b=4) if jcfg.is_encdec
                else None)


def engine_pair(fx, kv=8):
    """(reference, port) engines over ``tiny_fixture``'s int8 deploy at KV
    width ``kv``, built once: the reference through its ``ref`` matmuls and
    ``gather`` attention, the port through its ``kernel``/``fused``
    wrappers (their plain versions on the CPU)."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve.engine import ServeEngine as TEngine
    if kv not in fx["engines"]:
        fx["engines"][kv] = (
            JEngine(fx["japi"], fx["jdep"], kv_quant_bits=kv, backend="ref",
                    attn_backend="gather"),
            TEngine(fx["tapi"], fx["tdep"], kv_quant_bits=kv,
                    backend="kernel", attn_backend="fused", device="cpu"))
    return fx["engines"][kv]


def request_pair(uid, toks, max_new=4, arrival=0, priority=0):
    """The same greedy request for the reference and for the port."""
    import jax.numpy as jnp
    from repro.serve import Request as JRequest
    from repro.serve import SamplingParams as JSP
    from repro_torch.serve import Request, SamplingParams
    sp = dict(max_new_tokens=max_new, priority=priority)
    return (JRequest(uid=uid, inputs={"tokens": jnp.asarray(toks)},
                     sampling=JSP(**sp), arrival=arrival),
            Request(uid=uid, inputs={"tokens": toks},
                    sampling=SamplingParams(**sp), arrival=arrival))


def prompt(vocab, n, seed, b=1):
    """(b, n) int32 prompt tokens from prompt seed 1 (see
    tests/test_torch_slice.py on rounding ties) and ``seed``."""
    return np.random.default_rng((1, seed)).integers(
        0, vocab, (b, n)).astype(np.int32)


def paged_greedy(eng, tok, max_new, page_size=4):
    """Greedy decode through a paged state of the port's engine: a
    hand-built non-identity table (page 0 reserved), ``prefill_at`` per
    slot, decode with a per-slot (B,) index.  Returns (B, max_new)
    tokens as numpy."""
    b, p = tok.shape
    max_len = p + 64
    state = eng.init_decode_state({"tokens": tok[:1]}, n_slots=b,
                                  max_len=max_len, page_size=page_size)
    nb = -(-max_len // page_size)
    table = np.random.default_rng(5).permutation(
        np.arange(1, 1 + b * nb)).reshape(b, nb).astype(np.int32)
    state = eng.set_tables(state, table)
    first = []
    for s in range(b):
        logits, state = eng.prefill_at({"tokens": tok[s:s + 1]}, state, s)
        first.append(int(logits.argmax(-1)[0]))
    cur = torch.tensor(first, dtype=torch.int32)[:, None]
    outs = [cur[:, 0]]
    index = torch.full((b,), p, dtype=torch.int32)
    for _ in range(max_new - 1):
        logits, state = eng.decode(cur, state, index)
        cur = logits.argmax(-1)[:, None].to(torch.int32)
        outs.append(cur[:, 0])
        index = index + 1
    return torch.stack(outs, 1).numpy()


def jax_deployed(tree):
    """A port param tree with deployed leaves (after the port's
    ``to_serving_params``, which is the reference's bit for bit) as the
    reference's: tensors become JAX arrays, ``ServingWeight`` /
    ``BitplaneServingWeight`` the reference's dataclasses with the same
    static fields.  Lets a test deploy once, in the port, and hand both
    packages the same tree."""
    import jax.numpy as jnp
    from repro.core.blocking import BlockingSpec
    from repro_torch.serve import deploy as tdeploy

    def arr(t):
        return jnp.asarray(t.detach().cpu().numpy())

    def spec(s):
        return BlockingSpec(s.wb_rows, s.wb_cols)
    if isinstance(tree, tdeploy.ServingWeight):
        return ServingWeight(w_int=arr(tree.w_int), scale=arr(tree.scale),
                             shape=tuple(tree.shape), spec=spec(tree.spec),
                             bits=tree.bits)
    if isinstance(tree, tdeploy.BitplaneServingWeight):
        return BitplaneServingWeight(
            planes=arr(tree.planes), sign=arr(tree.sign),
            mask=arr(tree.mask), scale=arr(tree.scale),
            shape=tuple(tree.shape), spec=spec(tree.spec), bits=tree.bits,
            tag=tree.tag)
    if isinstance(tree, dict):
        return {k: jax_deployed(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_deployed(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return arr(tree)
    return tree


def deployed_pairs():
    """``get(arch, bits, layout)`` -> (reference api, port api, (reference
    tree, port tree)) at ``tiny(dtype="float32")`` with 8-bit fake
    quantization (``bits`` 0: the QAT trees): the reference's ``init(PRNGKey(0))`` QAT tree carried
    across once an arch, each deploy made once by the port (bit for bit
    the reference's) and handed to the reference as its own dataclasses
    (:func:`jax_deployed`)."""
    import jax
    from repro.configs import REGISTRY as JREG
    from repro.models.api import build as jbuild
    from repro.models.common import QuantConfig as JQ
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import REGISTRY as TREG
    from repro_torch.configs.base import QuantConfig as TQ
    from repro_torch.models.api import build as tbuild
    from repro_torch.serve.deploy import to_serving_params
    qc = dict(mode="fake", n_bits=8, act_bits=8)
    cache = {}

    def get(arch, bits, layout):
        if arch not in cache:
            jcfg = JREG[arch].tiny(dtype="float32").with_quant(JQ(**qc))
            tcfg = TREG[arch].tiny(dtype="float32").with_quant(TQ(**qc))
            japi = jbuild(jcfg)
            qat = japi.init(jax.random.PRNGKey(0))
            cache[arch] = (japi, tbuild(tcfg), params_from_numpy(
                tree_to_numpy(qat), device="cpu"), {(0, ""): qat})
        japi, tapi, tqat, deps = cache[arch]
        if not bits:                     # the QAT trees themselves
            return japi, tapi, (deps[0, ""], tqat)
        if (bits, layout) not in deps:
            tp = to_serving_params(tqat, bits, layout=layout, device="cpu")
            deps[bits, layout] = (jax_deployed(tp), tp)
        return japi, tapi, deps[bits, layout]
    return get


# --------------------------------------------------------------------------
# the CNN pipeline (tests/test_torch_cnn*.py)
# --------------------------------------------------------------------------

CNN_MODELS = {"resnet": (8, 8), "vgg": (11, 32)}     # depth, image side


def bridged(jp):
    """A reference param tree carried into the port on the CPU."""
    from repro_torch.bridge import params_from_numpy
    return params_from_numpy(tree_to_numpy(jp), device="cpu")


def cnn_images(side, b=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, side, side, 3)).astype(np.float32)


def cnn_jinit(model, qc):
    """The reference's ResNet-8 / VGG-11 from ``PRNGKey(0)``."""
    import jax
    from repro.models import cnn as jcnn
    depth, _ = CNN_MODELS[model]
    init = jcnn.resnet_init if model == "resnet" else jcnn.vgg_init
    return init(jax.random.PRNGKey(0), qc, depth=depth)


# --------------------------------------------------------------------------
# the vlm, ssm and hybrid families' serving (tests/test_torch_families_*.py)
# --------------------------------------------------------------------------

_FAMILY_FIXTURES = {}


def family_fx(arch):
    """``tiny_fixture(arch)`` with caches of its deploys and engines, built
    once a process."""
    if arch not in _FAMILY_FIXTURES:
        fx = tiny_fixture(arch)
        fx["trees"], fx["kv_engines"] = {}, {}
        _FAMILY_FIXTURES[arch] = fx
    return _FAMILY_FIXTURES[arch]


def family_trees(fx, bits, layout="packed"):
    """(reference, port) trees of the reference's deploy at ``bits`` /
    ``layout``, carried across."""
    from repro.serve.deploy import to_serving_params as j_deploy
    from repro_torch.bridge import params_from_numpy
    key = (bits, layout)
    if key not in fx["trees"]:
        jt = fx["jdep"] if key == (8, "packed") else \
            j_deploy(fx["qat"], bits, layout=layout)
        fx["trees"][key] = (jt, params_from_numpy(tree_to_numpy(jt),
                                                  device="cpu"))
    return fx["trees"][key]


def family_engines(fx, kv, bits=8, layout="packed"):
    """(reference, port) engines over a deploy at KV width ``kv``: the
    reference through its ``ref`` matmuls and ``gather`` attention, the
    port through its ``kernel`` (``bitplane``) / ``fused`` wrappers."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve.engine import ServeEngine as TEngine
    key = (kv, bits, layout)
    if key not in fx["kv_engines"]:
        jt, tt = family_trees(fx, bits, layout)
        be = "bitplane" if layout == "bitplane" else "kernel"
        fx["kv_engines"][key] = (
            JEngine(fx["japi"], jt, kv_quant_bits=kv, backend="ref",
                    attn_backend="gather"),
            TEngine(fx["tapi"], tt, kv_quant_bits=kv, backend=be,
                    attn_backend="fused", device="cpu"))
    return fx["kv_engines"][key]


def family_inputs(fx, width, seed, b=1):
    """A prompt of ``width`` tokens; a vlm prompt's vision prefix too."""
    cfg = fx["tapi"].cfg
    x = {"tokens": prompt(fx["vocab"], width, seed, b)}
    if cfg.family == "vlm":
        x["vision_embeds"] = (0.1 * np.random.default_rng((3, seed))
                              .standard_normal((b, cfg.vision_tokens,
                                                cfg.d_model))
                              ).astype(np.float32)
    return x


def jax_inputs(x):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in x.items()}


def family_pairs(fx, specs):
    """The same greedy requests for both packages: (width, max_new,
    arrival, priority) each."""
    from repro.serve import Request as JRequest
    from repro.serve import SamplingParams as JSP
    from repro_torch.serve import Request, SamplingParams
    out = []
    for uid, (width, new, arrival, prio) in enumerate(specs):
        x = family_inputs(fx, width, 30 + uid)
        sp = dict(max_new_tokens=new, priority=prio)
        out.append((JRequest(uid=uid, inputs=jax_inputs(x),
                             sampling=JSP(**sp), arrival=arrival),
                    Request(uid=uid, inputs=x, sampling=SamplingParams(**sp),
                            arrival=arrival)))
    return [p[0] for p in out], [p[1] for p in out]


# --------------------------------------------------------------------------
# the encoder-decoder family's serving (tests/test_torch_encdec_*.py)
# --------------------------------------------------------------------------

_ENCDEC_FIXTURE = {}


def encdec_fixture():
    """``tiny_fixture`` of seamless with its QAT tree carried across and
    caches of deploys and engines, built once a process."""
    if not _ENCDEC_FIXTURE:
        from repro_torch.bridge import params_from_numpy
        fx = tiny_fixture("seamless-m4t-large-v2")
        fx["tqat"] = params_from_numpy(tree_to_numpy(fx["qat"]),
                                       device="cpu")
        fx["jtrees"], fx["ttrees"], fx["qat_engines"] = {}, {}, {}
        _ENCDEC_FIXTURE.update(fx)
    return _ENCDEC_FIXTURE


def encdec_batch(fx, b=2, p=8):
    """{"tokens" (b, p), "frames" (b, S_enc, d)} as numpy."""
    return {"tokens": prompt(fx["vocab"], p, 0, b),
            "frames": fx["frames"][:b]}


def encdec_qat_engines(fx, kv):
    """The reference's engine over its QAT tree (``dense``, as its serving
    tests run the family) and the port's over the carried tree."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve.engine import ServeEngine as TEngine
    if kv not in fx["qat_engines"]:
        fx["qat_engines"][kv] = (
            JEngine(fx["japi"], fx["qat"], kv_quant_bits=kv),
            TEngine(fx["tapi"], fx["tqat"], kv_quant_bits=kv, device="cpu"))
    return fx["qat_engines"][kv]


# --------------------------------------------------------------------------
# the budget autotuner (tests/test_torch_autotune*.py)
# --------------------------------------------------------------------------

_AUTOTUNE_FIXTURE = {}


def autotune_fixture():
    """Tiny phi3 (f32, 9x8 blocks, 8-bit fake quantization with 8-bit
    activations), the reference's ``init(PRNGKey(0))`` deployed to the
    bit-plane layout by the reference at full occupancy and with mixed
    per-block widths, carried across; a prompt batch.  Built once a
    process."""
    if not _AUTOTUNE_FIXTURE:
        import jax
        from repro.configs import REGISTRY as JREG
        from repro.models.api import build as jbuild
        from repro.models.common import QuantConfig as JQ
        from repro.serve.deploy import to_serving_params as j_deploy
        from repro_torch.configs import REGISTRY as TREG
        from repro_torch.configs.base import QuantConfig as TQ
        from repro_torch.models.api import build as tbuild
        arch = "phi3-mini-3.8b"
        jcfg = JREG[arch].tiny(dtype="float32").with_quant(
            JQ(mode="fake", n_bits=8, act_bits=8))
        tcfg = TREG[arch].tiny(dtype="float32").with_quant(
            TQ(mode="fake", n_bits=8, act_bits=8))
        japi, tapi = jbuild(jcfg), tbuild(tcfg)
        qat = japi.init(jax.random.PRNGKey(0))
        jfull = j_deploy(qat, 8, layout="bitplane")
        jmixed = j_deploy(mixed_bitwidths(qat, np.random.default_rng(7)), 8,
                          layout="bitplane")
        tok = np.random.default_rng((1, 3)).integers(0, jcfg.vocab, (2, 8))
        _AUTOTUNE_FIXTURE.update(japi=japi, tapi=tapi, trees={
            "full": (jfull, bridged(jfull)),
            "mixed": (jmixed, bridged(jmixed))},
            batch={"tokens": tok.astype(np.int32)})
    return _AUTOTUNE_FIXTURE


def np_scores(scores):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float64) for k, v in scores.items()}


def same_alloc(got, want, ref=None):
    assert got.total_bytes == want.total_bytes
    assert got.steps_taken == want.steps_taken
    assert got.steps_available == want.steps_available
    assert got.predicted_error == want.predicted_error
    assert got.baseline_error == want.baseline_error
    assert got.occupancies.keys() == want.occupancies.keys()
    for p in want.occupancies:
        np.testing.assert_array_equal(np.asarray(got.occupancies[p]),
                                      np.asarray(want.occupancies[p]),
                                      err_msg=p)


def three_ways(jtree, ttree, scores, budget):
    """(reference, port heap, port sorted) allocations on one score set."""
    from repro.serve.autotune import greedy_allocate as j_allocate
    from repro_torch.serve.autotune import greedy_allocate
    want = j_allocate(jtree, scores, budget)   # float64 numpy, as produced
    tscores = {k: torch.from_numpy(v) for k, v in scores.items()}
    heap = greedy_allocate(ttree, tscores, budget, search="heap")
    fast = greedy_allocate(ttree, tscores, budget)
    same_alloc(heap, want)
    same_alloc(fast, want)
    return want, fast
