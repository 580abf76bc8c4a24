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

The port's deploy of the carried QAT tree (mixed per-WB widths) equals
the reference's bit for bit: the unstacked 2-D shared block and
``vision_proj``, zamba2's N = 16 ``in_B`` / ``in_C`` (a fraction of one
column block), and the plain float vectors left f32.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight)
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from torch_port_helpers import (family_fx, mixed_bitwidths,  # noqa: E402
                                np_of, tree_to_numpy)

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"
ARCHS = (QWEN, RWKV, ZAMBA)
FLOAT_LEAVES = {QWEN: ("bq", "bk", "bv"),
                RWKV: ("decay_a", "decay_b", "bonus_u", "decay_w0"),
                ZAMBA: ("conv1d_w", "a_log", "d_skip", "dt_bias")}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits,layout", [(8, "packed"), (4, "packed"),
                                         (8, "bitplane")])
def test_deploy_equals_reference_bit_for_bit(arch, bits, layout):
    """The port's ``to_serving_params`` of the carried QAT tree (mixed
    per-WB widths) equals the reference's deploy leaf for leaf, dtypes
    included; the unstacked shared block and ``vision_proj`` deploy 2-D,
    and the family's plain vectors stay f32 leaves."""
    fx = family_fx(arch)
    qat = mixed_bitwidths(fx["qat"], np.random.default_rng(3))
    want = {k: v for k, v in _leaves(tree_to_numpy(
        j_deploy(qat, bits, layout=layout)))
        if k[-1] not in ("wb_rows", "wb_cols")}
    tdep = t_deploy(params_from_numpy(tree_to_numpy(qat), device="cpu"),
                    bits, layout=layout, device="cpu")
    got, flat = {}, {}
    for path, leaf in _leaves(tdep):
        if isinstance(leaf, (ServingWeight, BitplaneServingWeight)):
            for f in dataclasses.fields(leaf):
                v = getattr(leaf, f.name)
                if isinstance(v, torch.Tensor):
                    got[path + (f.name,)] = np_of(v)
                elif f.name != "spec":
                    got[path + (f.name,)] = v
        else:
            assert leaf.dtype == torch.float32, path
            got[path] = np_of(leaf)
            flat[path[-1]] = leaf
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
        else:
            assert (tuple(got[k]) == tuple(v)) if isinstance(v, tuple) \
                else got[k] == v, k
    assert set(FLOAT_LEAVES[arch]) <= set(flat)
    if arch == ZAMBA:
        wq = tdep["shared_attn"]["wq"]
        assert isinstance(wq, (ServingWeight, BitplaneServingWeight))
        assert tuple(wq.shape) == (256, 128)           # reads 2 x d_model
        assert tuple(tdep["layers"]["in_B"].shape) == (4, 128, 16)
    if arch == QWEN:
        assert tuple(tdep["vision_proj"].shape) == (128, 128)
