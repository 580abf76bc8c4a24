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

Greedy tokens through the port's ``kernel`` / ``fused`` wrappers (and
``bitplane`` on a bit-plane deploy) equal the reference's, int8 and int4
weights, 8 and 4 KV bits where the family has KV; a fresh insert zeroes
the previous occupant's recurrent rows.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_port_helpers import (family_engines, family_fx,  # noqa: E402
                                family_inputs, jax_inputs, np_of)

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"
ARCHS = (QWEN, RWKV, ZAMBA)


@pytest.mark.parametrize("arch,bits,kv", [
    (QWEN, 8, 8), (QWEN, 4, 4), (RWKV, 8, 32), (RWKV, 4, 32),
    (ZAMBA, 8, 8), (ZAMBA, 4, 4)])
def test_generate_equals_reference(arch, bits, kv):
    """Greedy tokens of the port's packed kernels and fused attention
    equal the reference's ``ref`` / ``gather`` engine's, one batch of
    two prompts (a prompt width the scans take per token)."""
    fx = family_fx(arch)
    jeng, teng = family_engines(fx, kv, bits)
    x = family_inputs(fx, 7, 1, b=2)
    want = np.asarray(jeng.generate(jax_inputs(x), max_new=5))
    np.testing.assert_array_equal(np_of(teng.generate(x, max_new=5)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bitplane_generate_equals_reference(arch):
    fx = family_fx(arch)
    kv = 32 if arch == RWKV else 8
    jeng, teng = family_engines(fx, kv, 8, "bitplane")
    x = family_inputs(fx, 8, 2, b=2)
    want = np.asarray(jeng.generate(jax_inputs(x), max_new=4))
    np.testing.assert_array_equal(np_of(teng.generate(x, max_new=4)), want)


def test_fresh_insert_zeroes_the_previous_occupants_rows():
    """A chunk at start 0 zeroes the slot's recurrent rows before its
    forward (views write in place): a prompt inserted into a slot whose
    rows hold garbage gives the tokens of a clean insertion."""
    fx = family_fx(RWKV)
    teng = family_engines(fx, 32)[1]
    x = family_inputs(fx, 6, 5)
    state = teng.init_decode_state(x, n_slots=2, max_len=32)
    clean, _ = teng.prefill_chunk_at(x, state, 1, 0)
    for leaf in state["cache"].values():
        leaf[:, 1] = 3.0
    dirty, state = teng.prefill_chunk_at(x, state, 1, 0)
    assert torch.equal(clean, dirty)
    assert not torch.equal(state["cache"]["wkv"][:, 0],
                           state["cache"]["wkv"][:, 1])
