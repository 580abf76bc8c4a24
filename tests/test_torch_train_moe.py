"""Training of the MoE family in the port, held against the JAX reference
(shared helpers in ``tests/torch_train_helpers.py``).

* ``grouped_matmul``'s backward against the reference's custom VJP
  (``repro.models.moe._gm_bwd``, both of its ``dw`` branches: the
  ragged-contracting ``ragged_dot_general`` and the one-hot contraction of
  older JAX): ``dx`` and ``dw`` within 1e-5 relative at ragged sizes with
  an empty group and a group larger than the mean.  Where rows trail past
  the groups' sum, the one-hot branch counts them into the last group
  (``jnp.repeat``'s ``total_repeat_length`` pads with the last id), though
  the forward makes nothing of them: there it is held with those rows of
  ``x`` zeroed, which is the true gradient (an MoE layer's groups always
  cover every row, so its training never meets the case).  An empty group's
  ``dw`` and the rows past the groups' sum in ``dx`` exactly 0; ``dx`` and
  ``dw`` in the dtypes of ``x`` and ``w``; no op of the backward makes a
  (G, M, ...) or (M, G, ...) tensor;
* the capacity loop's gradients (a skew that drops tokens, plain and
  fake-quantized stacks) against ``jax.grad`` of the reference's.
(The forward's gradients, the training step and the launcher are in
``tests/test_torch_train_moe_step.py``.)
"""
import dataclasses
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.blocking import BlockingSpec as JSpec  # noqa: E402
from repro.core.fakequant import fq_from_float as j_fq  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_port_helpers import tree_to_numpy  # noqa: E402
from torch_train_helpers import (as_torch, assert_grad_close,  # noqa: E402
                                 loss_weights,
                                 moe_dispatch_back_to_ragged)

torch.set_num_threads(2)
E, D, F_ = 4, 27, 40             # experts, d_model, d_ff (9x8: odd Kp=27)


class _Shapes(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("ragged_contracting", [True, False])
@pytest.mark.parametrize("sizes", [[3, 0, 11, 2], [0, 6, 1, 0],
                                   [4, 4, 4, 0]])
def test_grouped_backward_matches_custom_vjp(sizes, ragged_contracting,
                                             monkeypatch):
    """m = 16 rows: the last two cases leave rows past the groups' sum; a
    group of 11 is larger than the mean of 4."""
    if not ragged_contracting:
        monkeypatch.delattr(jax.lax, "RaggedDotDimensionNumbers")
    rng = np.random.default_rng(2)
    m = 16
    x = rng.standard_normal((m, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F_)).astype(np.float32)
    dy = rng.standard_normal((m, F_)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    jy = jmoe.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    total = int(gs.sum())
    x_in = x.copy()
    if not ragged_contracting:
        x_in[total:] = 0.0            # the one-hot branch's trailing rows
    jdx, jdw, _ = jmoe._gm_bwd((jnp.asarray(x_in), jnp.asarray(w),
                                jnp.asarray(gs)), jnp.asarray(dy))
    tx, tw = as_torch(x, True), as_torch(w, True)
    ty = tmoe.grouped_matmul(tx, tw, as_torch(gs))
    assert_grad_close(ty, jy)
    with _Shapes() as shapes:
        ty.backward(as_torch(dy))
    assert_grad_close(tx.grad, jdx)
    assert_grad_close(tw.grad, jdw)
    dense = [s for s in shapes.shapes
             if len(s) >= 3 and E in s[:2] and m in s[:2]]
    assert not dense, dense
    assert not tx.grad[total:].any()
    for g, size in enumerate(sizes):
        if size == 0:
            assert not tw.grad[g].any(), g


def test_grouped_backward_dtypes():
    """``dx`` takes x's dtype and ``dw`` w's (bf16 x, f32 w: the backward
    casts as the reference's does)."""
    rng = np.random.default_rng(3)
    x = as_torch(rng.standard_normal((10, D)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    w = as_torch(rng.standard_normal((E, D, F_)).astype(np.float32), True)
    y = tmoe._GroupedMatmul.apply(x, w.to(torch.bfloat16), [3, 0, 5, 2])
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert not w.grad[1].any()


@pytest.mark.parametrize("weights", ["plain", "fake"])
def test_capacity_gradients_match_reference(weights):
    """The capacity loop under a skew that drops tokens: the gradients of
    sum(y * r) w.r.t. x and the expert stack (the fake-quantized stack's
    master weight through the STE)."""
    rng = np.random.default_rng(4)
    m, cap = 24, 8
    x = rng.standard_normal((m, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F_)).astype(np.float32)
    gs = np.asarray([3, 14, 0, 7], np.int32)       # expert 1 past capacity
    r = loss_weights((m, F_))

    fq0 = j_fq(jnp.asarray(w), 8, JSpec(9, 8))

    def jw(wa):     # the scale and LUT are leaves of their own, not of w
        return dataclasses.replace(fq0, w=wa) if weights == "fake" else wa

    def jloss(xa, wa):
        y = jmoe.grouped_matmul_capacity(xa, jw(wa), jnp.asarray(gs), cap)
        return jnp.sum(y * r)
    jgx, jgw = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(w))

    tx, tw = as_torch(x, True), as_torch(w, True)
    if weights == "fake":
        fq = params_from_numpy(tree_to_numpy(fq0), device="cpu")
        fq.w = tw
        tws = fq
    else:
        tws = tw
    y = tmoe.grouped_matmul_capacity(tx, tws, gs.tolist(), cap)
    (y * as_torch(r)).sum().backward()
    assert_grad_close(tx.grad, jgx)
    assert_grad_close(tw.grad, jgw)
