"""The port's budget autotuner (``repro_torch.serve.autotune``), held
against the JAX reference (``repro.serve.autotune``).

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")`` with 9x8 blocks,
the reference's ``init(PRNGKey(0))`` deployed to the bit-plane layout by
the reference (full occupancy, and with each block's bit-width drawn from
0..8: mixed occupancies and empty blocks) and carried across through
numpy.

* Sensitivity scores within 1e-12 relative of the reference's for the
  same tree and moments (weight-only and calibrated); the calibration
  moments within 1e-5 (two f32 summation orders).
* The allocator: the vectorized search's occupancies equal the port's
  heap and the reference's, bit for bit, with the same bytes, steps and
  predicted error, over the deployed trees, random trees of random 9x8
  geometry, planted exact ties, scores not monotone along a block's chain,
  and budgets from infeasible (raises) through the bare overhead to full
  (round-trips the deployed tree bit for bit).  Allocations pass BP1-BP3
  and AT1, and a larger budget never predicts a larger error
  (tests/test_autotune.py:104-191).
* ``autotune_params`` with a prompt batch gives the reference's
  occupancies, bytes and gate.
* The launchers: ``repro_torch.launch.train --ckpt-dir`` then
  ``repro_torch.launch.serve --ckpt ... --backend bitplane
  --autotune-budget-bytes B --requests --page-size 16`` on the CPU give
  the reference launcher's greedy tokens from the same checkpoint and
  prompts.
"""
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.core import BlockingSpec as JSpec  # noqa: E402
from repro.core import from_float as j_from_float  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.serve.autotune import autotune_params as j_autotune  # noqa: E402
from repro.serve.autotune import \
    calibrate_activations as j_calibrate  # noqa: E402
from repro.serve.autotune import greedy_allocate as j_allocate  # noqa: E402
from repro.serve.autotune import sensitivity_tree as j_scores  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.analysis.contracts import (  # noqa: E402
    validate_allocation, validate_serving_tree)
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.state import tensor_leaves  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from repro_torch.serve.autotune import (autotune_params,  # noqa: E402
                                        calibrate_activations,
                                        greedy_allocate, sensitivity_tree)
from repro_torch.serve.autotune.allocate import _leaf_bytes  # noqa: E402
from repro_torch.core.state import quant_nodes  # noqa: E402
from repro_torch.serve.deploy import BitplaneServingWeight  # noqa: E402
from repro_torch.serve.deploy import weight_stream_bytes  # noqa: E402
from torch_port_helpers import mixed_bitwidths, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"
SCORE_RTOL = 1e-12
MOMENT_RTOL = 1e-5


def _bridged(tree):
    return params_from_numpy(tree_to_numpy(tree), device="cpu")


@pytest.fixture(scope="module")
def fx():
    jcfg = JREG[ARCH].tiny(dtype="float32").with_quant(
        JQ(mode="fake", n_bits=8, act_bits=8))
    tcfg = TREG[ARCH].tiny(dtype="float32").with_quant(
        TQ(mode="fake", n_bits=8, act_bits=8))
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    qat = japi.init(jax.random.PRNGKey(0))
    jfull = j_deploy(qat, 8, layout="bitplane")
    jmixed = j_deploy(mixed_bitwidths(qat, np.random.default_rng(7)), 8,
                      layout="bitplane")
    tok = np.random.default_rng((1, 3)).integers(0, jcfg.vocab, (2, 8))
    return dict(japi=japi, tapi=tapi, trees={
        "full": (jfull, _bridged(jfull)),
        "mixed": (jmixed, _bridged(jmixed))},
        batch={"tokens": tok.astype(np.int32)})


def _np_scores(scores):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float64) for k, v in scores.items()}


def _same_alloc(got, want, ref=None):
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


def _three_ways(jtree, ttree, scores, budget):
    """(reference, port heap, port sorted) allocations on one score set."""
    want = j_allocate(jtree, scores, budget)   # float64 numpy, as produced
    tscores = {k: torch.from_numpy(v) for k, v in scores.items()}
    heap = greedy_allocate(ttree, tscores, budget, search="heap")
    fast = greedy_allocate(ttree, tscores, budget)
    _same_alloc(heap, want)
    _same_alloc(fast, want)
    return want, fast


def _overhead(ttree):
    leaves = quant_nodes(ttree, BitplaneServingWeight)
    return weight_stream_bytes(ttree) - sum(
        weight_stream_bytes({p: l}) - _leaf_bytes(l, 0, 0)
        for p, l in leaves.items())


@pytest.mark.parametrize("tree", ["full", "mixed"])
def test_weight_only_scores_match_reference(fx, tree):
    jtree, ttree = fx["trees"][tree]
    want = _np_scores(j_scores(jtree))
    got = _np_scores(sensitivity_tree(ttree))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_RTOL, atol=0,
                                   err_msg=k)


def test_calibration_and_calibrated_scores_match_reference(fx):
    jtree, ttree = fx["trees"]["mixed"]
    jact = j_calibrate(fx["japi"], jtree,
                       {"tokens": jnp.asarray(fx["batch"]["tokens"])})
    tact = calibrate_activations(fx["tapi"], ttree, fx["batch"])
    assert tact.keys() == jact.keys()
    for k in jact:
        assert jact[k] is not None and tact[k].dtype == torch.float64
        np.testing.assert_allclose(tact[k].numpy(), jact[k],
                                   rtol=MOMENT_RTOL, err_msg=k)
    # the same moments on both sides: scores within 1e-12
    want = _np_scores(j_scores(jtree, jact))
    got = _np_scores(sensitivity_tree(
        ttree, {k: torch.from_numpy(np.asarray(v)) for k, v in
                jact.items()}))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_RTOL, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("tree", ["full", "mixed"])
def test_allocations_match_reference_across_budgets(fx, tree):
    jtree, ttree = fx["trees"][tree]
    scores = _np_scores(j_scores(jtree))
    full = weight_stream_bytes(ttree)
    floor = _overhead(ttree)
    for budget in (floor, floor + 5, int(full * 0.6), int(full * 0.8),
                   int(full * 0.95), full - 1):
        _, got = _three_ways(jtree, ttree, scores, budget)
        assert got.total_bytes <= budget
        assert got.total_bytes == weight_stream_bytes(got.params)
        assert not [f for f in validate_serving_tree(got.params)
                    if f.severity == "error"]
        assert not validate_allocation(got.params, budget)
    for search in ("sorted", "heap"):
        with pytest.raises(ValueError, match="infeasible"):
            greedy_allocate(ttree, {k: torch.from_numpy(v)
                                    for k, v in scores.items()},
                            floor - 1, search=search)
    with pytest.raises(ValueError, match="infeasible"):
        j_allocate(jtree, scores, floor - 1)


@pytest.mark.parametrize("tree", ["full", "mixed"])
def test_full_budget_round_trips_the_deployed_tree(fx, tree):
    jtree, ttree = fx["trees"][tree]
    full = weight_stream_bytes(ttree)
    alloc = greedy_allocate(ttree, sensitivity_tree(ttree), full)
    assert alloc.total_bytes == full
    assert alloc.steps_taken == alloc.steps_available
    a, b = dict(tensor_leaves(alloc.params)), dict(tensor_leaves(ttree))
    for k in b:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["ties", "non_monotone", "zeros"])
def test_sorted_search_takes_the_heap_order(fx, kind):
    """Scores built to break a naive sort: exact ties within and across
    leaves (a handful of values), ratios rising along a block's chain, and
    all-zero gains (the tie-break order alone)."""
    jtree, ttree = fx["trees"]["mixed"]
    rng = np.random.default_rng({"ties": 1, "non_monotone": 2,
                                 "zeros": 3}[kind])
    base = _np_scores(j_scores(jtree))
    scores = {}
    for k, s in base.items():
        mask = np.asarray(quant_nodes(ttree, BitplaneServingWeight)[k]
                          .mask.numpy(),
                          dtype=np.float64)
        if kind == "ties":
            v = rng.integers(0, 3, s.shape).astype(np.float64)
        elif kind == "non_monotone":
            v = rng.uniform(0, 1, s.shape) * 4.0 ** -np.arange(
                s.shape[-3]).reshape((-1, 1, 1))
        else:
            v = np.zeros(s.shape)
        scores[k] = v * mask
    full = weight_stream_bytes(ttree)
    for frac in (0.5, 0.7, 0.9):
        _three_ways(jtree, ttree, scores, int(full * frac))


@pytest.mark.parametrize("case", range(2))
def test_random_geometry_allocations(case):
    """tests/test_autotune.py's random 9x8 leaves: the reference's
    occupancies, BP2-valid LUTs, and monotone predicted error."""
    rng = np.random.default_rng(100 + case)
    k, n = int(rng.integers(10, 61)), int(rng.integers(8, 49))
    n_bits = int(rng.choice([4, 8]))
    w = jax.random.normal(jax.random.PRNGKey(case), (k, n))
    jtree = j_deploy({"w": j_from_float(w, n_bits, JSpec(9, 8))}, n_bits,
                     layout="bitplane")
    ttree = _bridged(jtree)
    scores = _np_scores(j_scores(jtree))
    full = weight_stream_bytes(ttree)
    errs = []
    for frac in sorted(rng.uniform(0.55, 1.0, 3)):
        budget = int(full * frac)
        _, got = _three_ways(jtree, ttree, scores, budget)
        assert not [f for f in validate_serving_tree(got.params)
                    if f.severity == "error"]
        assert not validate_allocation(got.params, budget)
        errs.append(got.predicted_error)
    assert errs == sorted(errs, reverse=True)


def test_autotune_params_matches_reference(fx):
    """Calibrated end to end on each package's own activations: the
    reference's occupancies, bytes and gate on this draw."""
    jtree, ttree = fx["trees"]["mixed"]
    budget = int(weight_stream_bytes(ttree) * 0.7)
    want = j_autotune(fx["japi"], jtree, budget,
                      batch={"tokens": jnp.asarray(fx["batch"]["tokens"])})
    timings = {}
    got = autotune_params(fx["tapi"], ttree, budget, batch=fx["batch"],
                          timings=timings)
    assert set(timings) == {"calibrate_s", "sensitivity_s", "search_s",
                            "repack_s", "gate_s"}
    assert got.total_bytes == want.total_bytes
    assert got.steps_taken == want.steps_taken
    for p in want.occupancies:
        np.testing.assert_array_equal(got.occupancies[p],
                                      np.asarray(want.occupancies[p]))
    assert got.gate["top1_agreement"] == want.gate["top1_agreement"]
    assert got.gate["ok"] == want.gate["ok"]
    assert got.gate["max_abs_logit_diff"] == pytest.approx(
        want.gate["max_abs_logit_diff"], rel=1e-4)
    full = autotune_params(fx["tapi"], ttree, weight_stream_bytes(ttree),
                           batch=fx["batch"], min_top1_agreement=1.0,
                           require_gate=True)
    assert full.gate["max_abs_logit_diff"] == 0.0


def test_launchers_train_then_serve_autotuned_match_reference(
        tmp_path, capsys, monkeypatch):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as tl
    d = str(tmp_path / "run")
    tl.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq",
             "16", "--batch", "2", "--requant-every", "2", "--ckpt-dir", d])
    budget = "480000"
    flags = ["--arch", ARCH, "--ckpt", d, "--backend", "bitplane",
             "--autotune-budget-bytes", budget, "--requests",
             "--page-size", "16", "--batch", "2", "--prompt-len", "8",
             "--max-new", "5"]
    capsys.readouterr()
    out = tserve.main(flags + ["--device", "cpu", "--seed", "1"])
    printed = capsys.readouterr().out
    assert out["allocation"].total_bytes <= int(budget)
    assert 0 < out["stats"]["peak_host_bytes"] < \
        out["stats"]["dense_tree_bytes"]
    prompts = tserve._prompts(tserve._config(tserve.build_parser().parse_args(
        flags + ["--device", "cpu", "--seed", "1"])),
        tserve.build_parser().parse_args(flags + ["--seed", "1"]))
    tokens = np.concatenate([p["tokens"] for p in prompts])
    monkeypatch.setattr(jserve, "_prompts",
                        lambda cfg, args: {"tokens": jnp.asarray(tokens)})
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    ref = capsys.readouterr().out

    def parse(text):
        toks = dict(re.findall(r"^\[(\d+)\] arrived.*: (\[.*\])$", text,
                               re.M))
        tuned = re.search(r"^autotuned: (\d+) -> (\d+) B/step .*\((\d+)/"
                          r"(\d+) plane", text, re.M).groups()
        return toks, tuned
    assert parse(printed) == parse(ref)
    assert len(parse(ref)[0]) == 2
