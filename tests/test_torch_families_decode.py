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

A vector fill index equals a scalar one; speculation, page size and KV
bits on the recurrent families and the prefix cache are refused or
warned as the reference refuses and warns.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (family_engines, family_fx,  # noqa: E402
                                family_inputs, family_pairs, family_trees,
                                jax_inputs, np_of)

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"
ARCHS = (QWEN, RWKV, ZAMBA)
SPECS = [(6, 5, 0, 0), (3, 4, 0, 1), (9, 6, 1, 0), (4, 3, 2, 1),
         (8, 4, 3, 0)]


@pytest.mark.parametrize("arch", [QWEN, ZAMBA, RWKV])
def test_vector_index_matches_scalar_decode(arch):
    """Decode steps with a per-slot (B,) index give the scalar index's
    logits bit for bit, and the reference's within 2e-4."""
    fx = family_fx(arch)
    jeng, teng = family_engines(fx, 32)
    x = family_inputs(fx, 8, 4, b=2)
    tv = fx["tapi"].cfg.vision_tokens if arch == QWEN else 0
    api, japi = teng.api, jeng.api
    logits, st_s = api.prefill(teng.params, teng._inputs(x), extra_slots=8)
    _, jst = japi.prefill(jeng.params, jax_inputs(x), extra_slots=8)

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


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_speculation_is_refused_for_recurrent_families(arch):
    """The reference's hybrid speculation guard (tests/test_autotune.py):
    ``speculate_planes`` on a bit-plane tree raises ``ValueError``."""
    fx = family_fx(arch)
    _, tb = family_trees(fx, 8, "bitplane")
    with pytest.raises(ValueError, match="recurrent state"):
        TEngine(fx["tapi"], tb, backend="bitplane", speculate_planes=2,
                device="cpu")


def test_rwkv6_ignores_page_size_and_kv_bits_with_warnings():
    fx = family_fx(RWKV)
    _, tt = family_trees(fx, 8)
    with pytest.warns(UserWarning, match="has no effect on family 'ssm'"):
        teng = TEngine(fx["tapi"], tt, kv_quant_bits=8, backend="kernel",
                       device="cpu")
    _, tr = family_pairs(fx, SPECS[:2])
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
    fx = family_fx(arch)
    teng = family_engines(fx, 32)[1]
    _, tr = family_pairs(fx, [(9, 3, 0, 0), (9, 3, 1, 0)])
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
