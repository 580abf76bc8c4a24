"""The port's budget autotuner (``repro_torch.serve.autotune``), held
against the JAX reference (``repro.serve.autotune``).

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")`` with 9x8 blocks,
the reference's ``init(PRNGKey(0))`` deployed to the bit-plane layout by
the reference (full occupancy, and with each block's bit-width drawn from
0..8: mixed occupancies and empty blocks) and carried across through
numpy (``torch_port_helpers.autotune_fixture``).

* The vectorized search takes the heap's order on planted exact ties and
  on scores not monotone along a block's chain, and equals the heap and
  the reference on random trees of random 9x8 geometry.
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
from repro.core import BlockingSpec as JSpec  # noqa: E402
from repro.core import from_float as j_from_float  # noqa: E402
from repro.serve.autotune import sensitivity_tree as j_scores  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.analysis.contracts import (  # noqa: E402
    validate_allocation, validate_serving_tree)
from repro_torch.core.state import quant_nodes  # noqa: E402
from repro_torch.serve.deploy import BitplaneServingWeight  # noqa: E402
from repro_torch.serve.deploy import weight_stream_bytes  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"
from torch_port_helpers import autotune_fixture, bridged, np_scores, three_ways  # noqa: E402


@pytest.fixture(scope="module")
def fx():
    return autotune_fixture()


@pytest.mark.parametrize("kind", ["ties", "non_monotone", "zeros"])
def test_sorted_search_takes_the_heap_order(fx, kind):
    """Scores built to break a naive sort: exact ties within and across
    leaves (a handful of values), ratios rising along a block's chain, and
    all-zero gains (the tie-break order alone)."""
    jtree, ttree = fx["trees"]["mixed"]
    rng = np.random.default_rng({"ties": 1, "non_monotone": 2,
                                 "zeros": 3}[kind])
    base = np_scores(j_scores(jtree))
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
        three_ways(jtree, ttree, scores, int(full * frac))


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
    ttree = bridged(jtree)
    scores = np_scores(j_scores(jtree))
    full = weight_stream_bytes(ttree)
    errs = []
    for frac in sorted(rng.uniform(0.55, 1.0, 3)):
        budget = int(full * frac)
        _, got = three_ways(jtree, ttree, scores, budget)
        assert not [f for f in validate_serving_tree(got.params)
                    if f.severity == "error"]
        assert not validate_allocation(got.params, budget)
        errs.append(got.predicted_error)
    assert errs == sorted(errs, reverse=True)


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
