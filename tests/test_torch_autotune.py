"""The port's budget autotuner (``repro_torch.serve.autotune``), held
against the JAX reference (``repro.serve.autotune``).

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")`` with 9x8 blocks,
the reference's ``init(PRNGKey(0))`` deployed to the bit-plane layout by
the reference (full occupancy, and with each block's bit-width drawn from
0..8: mixed occupancies and empty blocks) and carried across through
numpy (``torch_port_helpers.autotune_fixture``).

* Sensitivity scores within 1e-12 relative of the reference's for the
  same tree and moments (weight-only and calibrated); the calibration
  moments within 1e-5 (two f32 summation orders).
* The allocator's occupancies equal the port's heap and the reference's,
  bit for bit, with the same bytes, steps and predicted error, over the
  deployed trees and budgets from infeasible (raises) through the bare
  overhead to full (round-trips the deployed tree bit for bit).
  Allocations pass BP1-BP3 and AT1, and a larger budget never predicts a
  larger error (tests/test_autotune.py:104-191).
* ``autotune_params`` with a prompt batch gives the reference's
  occupancies, bytes and gate.
(The search's ties, random geometries and the launchers are in
``tests/test_torch_autotune_search.py``.)
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve.autotune import autotune_params as j_autotune  # noqa: E402
from repro.serve.autotune import \
    calibrate_activations as j_calibrate  # noqa: E402
from repro.serve.autotune import greedy_allocate as j_allocate  # noqa: E402
from repro.serve.autotune import sensitivity_tree as j_scores  # noqa: E402
from repro_torch.analysis.contracts import (  # noqa: E402
    validate_allocation, validate_serving_tree)
from repro_torch.core.state import tensor_leaves  # noqa: E402
from repro_torch.serve.autotune import (autotune_params,  # noqa: E402
                                        calibrate_activations,
                                        greedy_allocate, sensitivity_tree)
from repro_torch.serve.autotune.allocate import _leaf_bytes  # noqa: E402
from repro_torch.core.state import quant_nodes  # noqa: E402
from repro_torch.serve.deploy import BitplaneServingWeight  # noqa: E402
from repro_torch.serve.deploy import weight_stream_bytes  # noqa: E402

torch.set_num_threads(2)
SCORE_RTOL = 1e-12
MOMENT_RTOL = 1e-5


from torch_port_helpers import autotune_fixture, np_scores, three_ways  # noqa: E402


@pytest.fixture(scope="module")
def fx():
    return autotune_fixture()


def _overhead(ttree):
    leaves = quant_nodes(ttree, BitplaneServingWeight)
    return weight_stream_bytes(ttree) - sum(
        weight_stream_bytes({p: l}) - _leaf_bytes(l, 0, 0)
        for p, l in leaves.items())


@pytest.mark.parametrize("tree", ["full", "mixed"])
def test_weight_only_scores_match_reference(fx, tree):
    jtree, ttree = fx["trees"][tree]
    want = np_scores(j_scores(jtree))
    got = np_scores(sensitivity_tree(ttree))
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
    want = np_scores(j_scores(jtree, jact))
    got = np_scores(sensitivity_tree(
        ttree, {k: torch.from_numpy(np.asarray(v)) for k, v in
                jact.items()}))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_RTOL, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("tree", ["full", "mixed"])
def test_allocations_match_reference_across_budgets(fx, tree):
    jtree, ttree = fx["trees"][tree]
    scores = np_scores(j_scores(jtree))
    full = weight_stream_bytes(ttree)
    floor = _overhead(ttree)
    for budget in (floor, floor + 5, int(full * 0.6), int(full * 0.8),
                   int(full * 0.95), full - 1):
        _, got = three_ways(jtree, ttree, scores, budget)
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
