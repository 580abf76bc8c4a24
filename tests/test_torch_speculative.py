"""Bit-plane serving and self-speculative decoding in the port, held
against the JAX engine.

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")`` with the paper's
9x8 WB geometry and 8-bit activations, as tests/test_torch_slice.py builds
it, but with every block's bit-width drawn from {0..8} (numpy seed 0;
widths 6, 7 and 8 with probability 1/4 each, 0 to 5 with 1/24 each), so
the deployed bit-plane masks are mixed and some blocks are empty.  (A
uniform draw clips most blocks so hard that this random model repeats one
token per row, and every draft is accepted: the rejection path would go
untested.)  The QAT tree crosses through numpy and is deployed by both
packages to ``layout="bitplane"``.

* ``verify_step`` (W = 3 tokens at per-row fill levels) gives the
  reference's logits within 2e-4, the slice tests' tolerance;
* ``ServeEngine(backend="bitplane")`` gives the reference engine's greedy
  tokens for bits {8, 4} with an int8 KV cache, through the kernel
  wrappers and through the plain versions;
* speculative ``generate`` (k, γ) ∈ {(2, 3), (6, 4)} gives the tokens of
  non-speculative decoding, as tests/test_autotune.py holds the reference;
* ``make_draft_params`` shares the deployed payload and truncates the
  masks as the reference does; ``greedy_verify`` accepts as it does.

A note on the prompt: the int8 KV cache and the PACT quantizer round to
integer levels, so a 1-ulp difference between the two frameworks' f32
summation orders can move a value by a level at a rounding tie, and the
greedy tokens of the two packages can part at a near-tied step.  As in
tests/test_torch_slice.py, prompt seed 1 has no such step.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.autotune.speculative import greedy_verify as j_greedy_verify  # noqa: E402
from repro.serve.autotune.speculative import make_draft_params as j_draft  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from repro_torch.serve.autotune.speculative import (greedy_verify,  # noqa: E402
                                                    make_draft_params)
from repro_torch.serve.deploy import BitplaneServingWeight, tree_leaves  # noqa: E402
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (mixed_bitwidths, np_of,  # noqa: E402
                                tree_to_numpy)

torch.set_num_threads(2)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT_SEED = 1
MAX_NEW = 8
KV = 8


@pytest.fixture(scope="module")
def fx():
    jcfg = JREG["phi3-mini-3.8b"].tiny(dtype="float32").with_quant(
        JQ(mode="fake", n_bits=8, act_bits=8))
    tcfg = TREG["phi3-mini-3.8b"].tiny(dtype="float32").with_quant(
        TQ(mode="fake", n_bits=8, act_bits=8))
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    qat = mixed_bitwidths(japi.init(jax.random.PRNGKey(0)),
                           np.random.default_rng(0))
    tqat = params_from_numpy(tree_to_numpy(qat), device="cpu")
    tok = np.random.default_rng(PROMPT_SEED).integers(
        0, jcfg.vocab, (2, 8)).astype(np.int32)
    jdep = {b: j_deploy(qat, b, layout="bitplane") for b in (8, 4)}
    tdep = {b: t_deploy(tqat, b, layout="bitplane", device="cpu")
            for b in (8, 4)}
    want = {b: np.asarray(JEngine(japi, jdep[b], kv_quant_bits=KV,
                                  backend="bitplane").generate(
        {"tokens": jnp.asarray(tok)}, max_new=MAX_NEW)) for b in (8, 4)}
    return dict(japi=japi, tapi=tapi, tqat=tqat, jdep=jdep, tdep=tdep,
                tok=tok, want=want)


@pytest.mark.parametrize("bits", [8, 4])
def test_bitplane_engine_greedy_tokens_match_reference(fx, bits):
    for be, ab in (("bitplane", "fused"), ("kernel", "fused"),
                   ("ref", "ref")):
        eng = TEngine(fx["tapi"], fx["tdep"][bits], kv_quant_bits=KV,
                      backend=be, attn_backend=ab, device="cpu")
        got = eng.generate({"tokens": fx["tok"]}, max_new=MAX_NEW)
        np.testing.assert_array_equal(got.numpy(), fx["want"][bits],
                                      err_msg=be)


def test_verify_step_logits_match_reference(fx):
    """Prefill, then two W=3 verify forwards at per-row fill levels (the
    second over the first's drafted positions), against the reference."""
    tok = fx["tok"]
    p = tok.shape[1]
    verify_toks = np.random.default_rng(9).integers(
        0, fx["tapi"].cfg.vocab, (2, 2, 3)).astype(np.int32)
    idx = [np.array([p, p], np.int32), np.array([p + 2, p + 1], np.int32)]
    jeng = JEngine(fx["japi"], fx["jdep"][8], kv_quant_bits=KV,
                   backend="bitplane", speculate_planes=3)
    teng = TEngine(fx["tapi"], fx["tdep"][8], kv_quant_bits=KV,
                   backend="bitplane", speculate_planes=3, device="cpu")
    _, jstate = jeng.prefill({"tokens": jnp.asarray(tok)}, extra_slots=16)
    _, tstate = teng.prefill({"tokens": tok}, extra_slots=16)
    for vt, ix in zip(verify_toks, idx):
        want, jstate = jeng.verify(jnp.asarray(vt), jstate, jnp.asarray(ix))
        got, tstate = teng.verify(torch.from_numpy(vt), tstate,
                                  torch.from_numpy(ix))
        assert tuple(got.shape) == (2, 3, fx["tapi"].cfg.vocab)
        np.testing.assert_allclose(np_of(got), np.asarray(want),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("k,gamma", [(2, 3), (6, 4)])
def test_speculative_generate_token_identical(fx, k, gamma):
    eng = TEngine(fx["tapi"], fx["tdep"][8], kv_quant_bits=KV,
                  backend="bitplane", attn_backend="fused",
                  speculate_planes=k, draft_gamma=gamma, device="cpu")
    got = eng.generate({"tokens": fx["tok"]}, max_new=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), fx["want"][8])
    toks, logits = eng.speculative_generate({"tokens": fx["tok"]},
                                            max_new=MAX_NEW,
                                            keep_logits=True)
    assert torch.equal(toks, got)
    # each token is the argmax of the full-precision logits kept for it
    assert torch.equal(logits.argmax(-1).T.to(torch.int32), toks)
    log = eng.round_log
    assert sum(r["emitted"] for r in log) == 2 * (MAX_NEW - 1)
    assert all(0 <= r["accepted_drafts"] <= r["drafted"] for r in log)
    assert all(r["gamma"] <= gamma for r in log)
    # drafts are rejected and corrected; with 6 of 8 planes some are
    # accepted too, so both paths of a round run
    accepted = sum(r["accepted_drafts"] for r in log)
    assert accepted < sum(r["drafted"] for r in log)
    assert accepted > 0 or k < 6


def test_make_draft_params_shares_payload_storage(fx):
    dep = fx["tdep"][8]
    draft = make_draft_params(dep, 3)
    jdraft = j_draft(fx["jdep"][8], 3)
    pairs = [(a, b) for a, b in zip(tree_leaves(dep), tree_leaves(draft))
             if isinstance(a, BitplaneServingWeight)]
    assert len(pairs) == 7
    for a, b in pairs:
        for name in ("planes", "sign", "scale"):
            assert getattr(a, name).data_ptr() == getattr(b, name).data_ptr()
        assert not torch.equal(a.mask, b.mask)
    got = np_of(draft["layers"]["mlp"]["w_down"].mask)
    np.testing.assert_array_equal(
        got, np.asarray(jdraft["layers"]["mlp"]["w_down"].mask))


def test_greedy_verify_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 5, 11)).astype(np.float32)
    ref = logits.argmax(-1)
    drafts = rng.integers(0, 11, (4, 4))
    drafts[0] = ref[0, :4]                 # all accepted: a bonus token
    drafts[1, :2] = ref[1, :2]             # two accepted, then a correction
    drafts[1, 2] = (ref[1, 2] + 1) % 11
    drafts[2, 0] = (ref[2, 0] + 1) % 11    # none accepted
    want_acc, want_n = j_greedy_verify(drafts, logits)
    for arg in (logits, ref):              # logits or their argmax
        acc, n = greedy_verify(drafts, arg)
        np.testing.assert_array_equal(n, want_n)
        for a, b in zip(acc, want_acc):
            np.testing.assert_array_equal(a, b)
    assert list(want_n[:3]) == [4, 2, 0]


def test_speculative_guards(fx):
    with pytest.raises(ValueError, match="draft_gamma"):
        TEngine(fx["tapi"], fx["tdep"][8], backend="bitplane",
                speculate_planes=2, draft_gamma=0, device="cpu")
    with pytest.raises(ValueError, match="plane-sliced"):
        TEngine(fx["tapi"], t_deploy(fx["tqat"], 8, device="cpu"),
                backend="kernel", speculate_planes=2, device="cpu")
    with pytest.raises(ValueError, match="speculate_planes"):
        TEngine(fx["tapi"], fx["tdep"][8], speculate_planes=-1,
                device="cpu")
    eng = TEngine(fx["tapi"], fx["tdep"][8], backend="bitplane",
                  device="cpu")
    with pytest.raises(ValueError, match="speculate_planes"):
        eng.verify(torch.zeros((2, 2), dtype=torch.int32), {}, 0)
    with pytest.warns(UserWarning, match="fall back"):
        TEngine(fx["tapi"], t_deploy(fx["tqat"], 8, device="cpu"),
                backend="bitplane", device="cpu")
