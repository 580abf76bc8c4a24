"""Training of the vlm (qwen2-vl-2b), ssm (rwkv6-1.6b) and hybrid
(zamba2-1.2b) families in the port, held against the JAX reference, and
the abstract input specs of every family.

The specs' shapes and dtypes (``train_batch_spec``, ``decode_state_spec``
and ``decode_token_spec`` on every ``LM_SHAPES`` cell) are the
reference's for every family.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import LM_SHAPES as JSHAPES  # noqa: E402
from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro_torch.configs import LM_SHAPES, REGISTRY  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402

torch.set_num_threads(2)


def _spec_of(tree):
    """{path: (shape, dtype name)} of a spec tree (torch ``meta`` tensors
    or ``jax.ShapeDtypeStruct`` leaves)."""
    if isinstance(tree, torch.Tensor):
        return {"": (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    if isinstance(tree, dict):
        return {f"[{k!r}]{p}": v for k, sub in tree.items()
                for p, v in _spec_of(sub).items()}
    return {"": (tuple(tree.shape), str(np.dtype(tree.dtype)))}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_specs_match_reference(arch):
    """``train_batch_spec``, ``decode_state_spec`` and
    ``decode_token_spec`` for every LM shape cell: the reference's shapes
    and dtypes, every tensor on the ``meta`` device (the registered
    full-width configs, nothing allocated)."""
    japi, tapi = jbuild(JREG[arch]), tbuild(REGISTRY[arch])
    assert [dataclasses.astuple(c) for c in LM_SHAPES] == \
        [dataclasses.astuple(c) for c in JSHAPES]
    for cell, jcell in zip(LM_SHAPES, JSHAPES):
        got = tapi.train_batch_spec(cell)
        assert all(t.device.type == "meta" for t in got.values())
        assert _spec_of(got) == _spec_of(japi.train_batch_spec(jcell))
        small = dataclasses.replace(cell, seq_len=64, global_batch=2)
        jsmall = dataclasses.replace(jcell, seq_len=64, global_batch=2)
        got = tapi.decode_state_spec(small)
        assert all(t.device.type == "meta"
                   for t in jax.tree_util.tree_leaves(got))
        assert _spec_of(got) == _spec_of(japi.decode_state_spec(jsmall))
        assert _spec_of(tapi.decode_token_spec(cell)) == \
            _spec_of(japi.decode_token_spec(jcell))
