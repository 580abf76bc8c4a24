"""The port's speculative scheduler ticks held against the JAX scheduler,
tick by tick.

Fixture: tests/test_torch_scheduler.py's (``torch_port_helpers.
tiny_fixture``), with every block's bit-width drawn from {0..8}
(``torch_port_helpers.mixed_bitwidths``, numpy seed 0) so the bit-plane
masks are mixed and drafts are both accepted and rejected; the QAT tree
crosses through numpy and each package deploys it to
``layout="bitplane"``.  Both serve through ``backend="bitplane"`` with an
int8 KV cache and ``speculate_planes=6``, ``draft_gamma=3``.

* staggered requests, paged and chunked or in fixed-width slots: the
  reference's greedy tokens, ticks, block tables after every tick,
  ``spec_stats``, ``sched_stats`` and ``cache_report``;
* the tokens are those of non-speculative serving of the same requests.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (mixed_bitwidths, prompt,  # noqa: E402
                                request_pair, run_lockstep, tiny_fixture,
                                tree_to_numpy)

torch.set_num_threads(2)
KV = 8


@pytest.fixture(scope="module")
def fx():
    fx = tiny_fixture()
    qat = mixed_bitwidths(fx["qat"], np.random.default_rng(0))
    fx["jbp"] = j_deploy(qat, 8, layout="bitplane")
    fx["tbp"] = t_deploy(params_from_numpy(tree_to_numpy(qat),
                                           device="cpu"),
                         8, layout="bitplane", device="cpu")
    kw = dict(kv_quant_bits=KV, backend="bitplane", speculate_planes=6,
              draft_gamma=3)
    fx["jeng"] = JEngine(fx["japi"], fx["jbp"], **kw)
    fx["teng"] = TEngine(fx["tapi"], fx["tbp"], attn_backend="fused",
                         device="cpu", **kw)
    return fx


@pytest.mark.parametrize("page,chunk", [(4, 4), (0, 0)])
def test_speculative_trace_matches_reference(fx, page, chunk):
    """Speculative rounds over the live greedy slots, gamma clamped to
    the tightest budget, page lookahead growth: the reference's ledger
    and tokens; the tokens are those of non-speculative serving."""
    pairs = [request_pair(i, prompt(fx["vocab"], w, 20 + i), max_new=new,
                          arrival=arr)
             for i, (w, new, arr) in enumerate([(8, 9, 0), (5, 6, 1),
                                                (11, 8, 1), (3, 4, 4)])]
    jr, tr = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(n_slots=3, max_len=24, page_size=page, prefill_chunk=chunk)
    js = fx["jeng"].make_scheduler(jr, **kw)
    ts = fx["teng"].make_scheduler(tr, record_ticks=True, **kw)
    run_lockstep(js, ts, jr, tr)
    st = ts.spec_stats
    assert st["rounds"] > 0 and 0 < st["accepted_drafts"] < st["drafted"]
    assert sum(r["verify"] > 0 for r in ts.tick_log) == st["rounds"]
    assert all(r["verify"] == r["draft"] + 1 for r in ts.tick_log
               if r["verify"])
    plain = TEngine(fx["tapi"], fx["tbp"], kv_quant_bits=KV,
                    backend="bitplane", attn_backend="fused", device="cpu")
    want = plain.serve(tr, **kw)
    assert [r.tokens for r in want] == [ts.results[r.uid].tokens
                                        for r in tr]
