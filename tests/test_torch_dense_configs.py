"""The dense architectures that need nothing new in the port, each held
against the JAX reference through the whole model: ``deepseek-7b``
(llama layout), ``starcoder2-15b`` (GELU MLP, qkv bias) and
``gemma2-27b`` (post-norms, attention and logit softcaps, alternating
local / global windows).

Fixture per architecture: ``tiny(dtype="float32")``, 9x8 blocks, 8-bit
activations, the reference's ``init(PRNGKey(0))`` deployed to int8 by the
reference and carried across through numpy.  Prompts of 20 tokens (prompt
seed 1, see tests/test_torch_slice.py): past gemma2's tiny 16-token
window, so its local layers mask.  Prefill logits within 2e-4 of the
reference's (int8 KV); greedy tokens (int8 KV) equal to the reference's
through the kernels' wrappers, contiguous and paged.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (np_of, paged_greedy, prompt,  # noqa: E402
                                tiny_fixture)

torch.set_num_threads(2)
ARCHS = ["deepseek-7b", "starcoder2-15b", "gemma2-27b"]
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
KV, MAX_NEW = 8, 6


@pytest.fixture(scope="module", params=ARCHS)
def fx(request):
    fx = tiny_fixture(request.param)
    fx["tok"] = prompt(fx["vocab"], 20, 0, b=2)
    return fx


def test_config_exercises_its_features(fx):
    cfg = fx["tapi"].cfg
    feature = {"deepseek-7b": cfg.n_kv_heads == cfg.n_heads,
               "starcoder2-15b": cfg.qkv_bias and cfg.mlp_kind == "gelu",
               "gemma2-27b": cfg.use_post_norms and cfg.alt_local_global
               and cfg.attn_softcap > 0 and cfg.logit_softcap > 0
               and 0 < cfg.sliding_window < fx["tok"].shape[1]}
    assert feature[cfg.name]
    assert ("bq" in fx["tdep"]["layers"]["attn"]) == cfg.qkv_bias


def test_prefill_logits_match_reference(fx):
    want, _ = JEngine(fx["japi"], fx["jdep"], kv_quant_bits=KV,
                      backend="ref").prefill(
        {"tokens": jnp.asarray(fx["tok"])})
    for be in ("dense", "kernel", "ref"):
        got, _ = TEngine(fx["tapi"], fx["tdep"], kv_quant_bits=KV,
                         backend=be, device="cpu").prefill(
            {"tokens": fx["tok"]})
        np.testing.assert_allclose(np_of(got), np.asarray(want),
                                   **LOGIT_TOL, err_msg=be)


def test_greedy_tokens_match_reference_contiguous_and_paged(fx):
    want = np.asarray(JEngine(fx["japi"], fx["jdep"], kv_quant_bits=KV,
                              backend="ref", attn_backend="gather").generate(
        {"tokens": jnp.asarray(fx["tok"])}, max_new=MAX_NEW))
    eng = TEngine(fx["tapi"], fx["tdep"], kv_quant_bits=KV,
                  backend="kernel", attn_backend="fused", device="cpu")
    got = eng.generate({"tokens": fx["tok"]}, max_new=MAX_NEW)
    np.testing.assert_array_equal(np_of(got), want)
    np.testing.assert_array_equal(paged_greedy(eng, fx["tok"], MAX_NEW),
                                  want)
