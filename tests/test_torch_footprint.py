"""The port's call-signature census (``repro_torch.analysis.footprint``
and ``Scheduler.compile_footprint``), held against the JAX reference.

* ``chunk_widths``, ``serve_signatures`` and ``generate_signatures`` are
  pure arithmetic: over a grid of prompt widths, chunk widths, cache
  extents, vision prefixes and families they equal the reference's
  exactly, and ``footprint_findings`` gives the reference's findings.
* ``chunk_widths`` mirrors the port's ``Scheduler._plan_chunks`` chunk
  for chunk (phi3, and qwen2-vl for the vision offset), as
  tests/test_analysis.py holds the reference's.
* The census blowup of tests/test_analysis.py, and
  ``Scheduler.compile_footprint`` on the same submitted request equal to
  the reference scheduler's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import footprint as jfp  # noqa: E402
from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.analysis import (chunk_widths, footprint_findings,  # noqa
                                  generate_signatures, serve_signatures)
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from repro_torch.serve import Request, SamplingParams  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

torch.set_num_threads(2)
QC = dict(mode="fake", n_bits=8, act_bits=8)


def _sigs(sigs):
    return [(s.fn, tuple(s.shape), tuple(s.static), s.format())
            for s in sigs]


def _rules(findings):
    return [(f.severity, f.pass_name, f.rule, f.path, f.message)
            for f in findings]


@pytest.fixture(scope="module")
def engines():
    """Tiny port engines of phi3 and qwen2-vl (seeded port init; the
    census depends on shapes only), chunked at 8."""
    out = {}
    for arch in ("phi3-mini-3.8b", "qwen2-vl-2b"):
        cfg = TREG[arch].tiny(dtype="float32").with_quant(TQ(**QC))
        api = tbuild(cfg)
        out[arch] = ServeEngine(api, api.init(seed=0, device="cpu"),
                                prefill_chunk=8, device="cpu")
    return out


@pytest.mark.parametrize("family", ["decoder", "dense", "vlm", "ssm",
                                    "hybrid"])
def test_chunk_widths_equal_reference(family):
    for p in range(1, 41):
        for chunk in (0, 3, 4, 8, 16):
            for total in (p, p + 5, p + 64, 96):
                for tv in (0, 4):
                    got = chunk_widths(p, chunk, total, tv, family)
                    want = jfp.chunk_widths(p, chunk, total, tv, family)
                    assert got == want, (p, chunk, total, tv, family)


@pytest.mark.parametrize("page,chunk", [(0, 0), (0, 8), (4, 0), (4, 8),
                                        (16, 256)])
def test_serve_signatures_equal_reference(page, chunk):
    for widths in ([8], [5, 9, 13], list(range(5, 17)), [300, 64, 1920]):
        for tv in (0, 4):
            for family in ("dense", "vlm", "hybrid"):
                for max_len in (None, 2048):
                    kw = dict(max_len=max_len, page_size=page,
                              prefill_chunk=chunk, vision_tokens=tv,
                              family=family)
                    got = serve_signatures(widths, 16, 4, **kw)
                    want = jfp.serve_signatures(widths, 16, 4, **kw)
                    assert _sigs(got) == _sigs(want), (widths, kw)
                    for budget in (1, 8):
                        assert _rules(footprint_findings(got, budget)) == \
                            _rules(jfp.footprint_findings(want, budget))


def test_generate_signatures_equal_reference():
    for b, w, new in ((4, 16, 10), (1, 8, 64), (2, 300, 65)):
        got = generate_signatures(batch=b, prompt_width=w, max_new=new)
        assert _sigs(got) == _sigs(jfp.generate_signatures(b, w, new))
    sigs = generate_signatures(batch=4, prompt_width=16, max_new=10)
    assert [s.fn for s in sigs] == ["prefill", "decode"]
    assert sigs[0].static == (64,)                 # 64-rounded headroom
    assert sigs[1].shape == (4, 1)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2-vl-2b"])
def test_chunk_widths_match_scheduler(engines, arch):
    """chunk_widths mirrors the port's Scheduler._plan_chunks chunk for
    chunk (the reference's test, on the port's scheduler)."""
    eng = engines[arch]
    cfg = eng.api.cfg
    tv = cfg.vision_tokens if cfg.family == "vlm" else 0
    for p in (5, 8, 11, 16, 21):
        inputs = {"tokens": np.zeros((1, p), np.int32)}
        if tv:
            inputs["vision_embeds"] = np.zeros((1, tv, cfg.d_model),
                                               np.float32)
        req = Request(uid=0, inputs=inputs,
                      sampling=SamplingParams(max_new_tokens=8))
        sched = eng.make_scheduler([req], n_slots=2)
        plan = sched._plan_chunks(req)
        got = [(b["tokens"].shape[1], start) for b, start, _col in plan]
        want = chunk_widths(p, sched.prefill_chunk, sched.total_len,
                            vision_tokens=tv, family=cfg.family)
        assert got == want, f"p={p}: {got} != {want}"


def test_footprint_census_and_blowup():
    # 12 distinct widths through the monolithic path: 25 signatures
    widths = list(range(5, 17))
    sigs = serve_signatures(widths, max_new=16, n_slots=4)
    assert len(sigs) == 2 * len(widths) + 1
    findings = footprint_findings(sigs, budget=8)
    assert [f.rule for f in findings if f.severity == "error"] == \
        ["recompile-blowup"]
    # the same workload chunked: prompts wider than the chunk all reach
    # the (1, 8) chunk call -> {5,6,7,8}-wide chunks + decode
    sigs = serve_signatures(widths, max_new=16, n_slots=4, prefill_chunk=8)
    assert len(sigs) == 5
    assert not [f for f in footprint_findings(sigs, budget=8)
                if f.severity == "error"]
    assert any(f.rule == "census" for f in findings)


@pytest.mark.parametrize("page,chunk", [(0, 0), (4, 8)])
def test_scheduler_compile_footprint_equals_reference(engines, page, chunk):
    """The port's Scheduler.compile_footprint on a submitted 7-token
    request equals the reference scheduler's, and covers decode at
    (n_slots, 1) and the prompt's width."""
    jcfg = JREG["phi3-mini-3.8b"].tiny(dtype="float32").with_quant(JQ(**QC))
    japi = jbuild(jcfg)
    jparams = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), jparams)
    jeng = JEngine(japi, jparams, page_size=page, prefill_chunk=chunk)
    teng = dataclasses.replace(engines["phi3-mini-3.8b"], page_size=page,
                               prefill_chunk=chunk)
    jreq = JRequest(uid=0, inputs={"tokens": jnp.zeros((1, 7), jnp.int32)},
                    sampling=JSP(max_new_tokens=8))
    treq = Request(uid=0, inputs={"tokens": np.zeros((1, 7), np.int32)},
                   sampling=SamplingParams(max_new_tokens=8))
    jsched = jeng.make_scheduler([jreq], n_slots=2)
    tsched = teng.make_scheduler([treq], n_slots=2)
    jsched.submit(jreq)
    tsched.submit(treq)
    sigs = tsched.compile_footprint()
    assert _sigs(sigs) == _sigs(jsched.compile_footprint())
    assert any(s.fn == "decode" and s.shape == (2, 1) for s in sigs)
    assert any(s.shape[-1] == 7 for s in sigs if s.fn != "decode")
    assert _sigs(tsched.compile_footprint([3, 30])) == \
        _sigs(jsched.compile_footprint([3, 30]))
