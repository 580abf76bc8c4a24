"""Training of the MoE family in the port, held against the JAX reference.

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
  fake-quantized stacks) against ``jax.grad`` of the reference's;
* ``moe_forward``'s gradients, router included, under both dispatches
  (with a shared expert under ``ragged``);
* one training step of granite-moe-3b-a800m and llama4-scout-17b-a16e
  (tiny, f32, fake mode, 8-bit PACT), through
  ``torch_train_helpers``' rules: the loss, ``ce`` and
  ``aux`` (the load-balancing term, > 0), every gradient leaf beside the
  port's float64 gradient, a ``build_train_step`` step, a maintenance of
  the 4-D (L, E, K, N) expert stacks a layer at a time against the
  reference's whole-leaf rule, and the maintained tree's deploy; granite's
  maintenance (requantize and precision adjustment of 5-D bit-plane
  stacks) and deploy also in bit-plane mode, from drifted planes.  The router is a discrete choice: the tests
  record the smallest top-k gap of the step's routing (in router
  probability, the k-th largest less the (k+1)-th) in both packages and
  hold every layer's expert choices equal;
* the launcher trains granite for 2 steps, a maintenance at step 2.
"""
import dataclasses
import types

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
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402
from torch_train_helpers import (check_maintenance,  # noqa: E402
                                 check_one_step, drifted, family_batch,
                                 family_case, leaf_err)

torch.set_num_threads(2)
GRAD_TOL = 1e-5                  # module gradients, relative to the largest
GRANITE, SCOUT = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"
E, D, F_ = 4, 27, 40             # experts, d_model, d_ff (9x8: odd Kp=27)


@pytest.fixture(autouse=True)
def _ragged_default():
    yield
    jmoe.GROUPED_IMPL["impl"] = "ragged"
    tmoe.GROUPED_IMPL["impl"] = "ragged"


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _close(got, want, tol=GRAD_TOL):
    assert leaf_err(got, want) <= tol, leaf_err(got, want)


# ---------------------------------------------------------------------------
# the grouped product's backward
# ---------------------------------------------------------------------------

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
    tx, tw = _t(x, True), _t(w, True)
    ty = tmoe.grouped_matmul(tx, tw, _t(gs))
    _close(ty, jy)
    with _Shapes() as shapes:
        ty.backward(_t(dy))
    _close(tx.grad, jdx)
    _close(tw.grad, jdw)
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
    x = _t(rng.standard_normal((10, D)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    w = _t(rng.standard_normal((E, D, F_)).astype(np.float32), True)
    y = tmoe._GroupedMatmul.apply(x, w.to(torch.bfloat16), [3, 0, 5, 2])
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert not w.grad[1].any()


def _loss_weights(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


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
    r = _loss_weights((m, F_))

    fq0 = j_fq(jnp.asarray(w), 8, JSpec(9, 8))

    def jw(wa):     # the scale and LUT are leaves of their own, not of w
        return dataclasses.replace(fq0, w=wa) if weights == "fake" else wa

    def jloss(xa, wa):
        y = jmoe.grouped_matmul_capacity(xa, jw(wa), jnp.asarray(gs), cap)
        return jnp.sum(y * r)
    jgx, jgw = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(w))

    tx, tw = _t(x, True), _t(w, True)
    if weights == "fake":
        fq = params_from_numpy(tree_to_numpy(fq0), device="cpu")
        fq.w = tw
        tws = fq
    else:
        tws = tw
    y = tmoe.grouped_matmul_capacity(tx, tws, gs.tolist(), cap)
    (y * _t(r)).sum().backward()
    _close(tx.grad, jgx)
    _close(tw.grad, jgw)


def _moe_params(rng, shared):
    p = {"router_w": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
         "expert_gate": rng.standard_normal((E, D, F_)).astype(np.float32),
         "expert_up": rng.standard_normal((E, D, F_)).astype(np.float32),
         "expert_down": rng.standard_normal((E, F_, D)).astype(np.float32)}
    if shared:
        for k, s in (("shared_gate", (D, F_)), ("shared_up", (D, F_)),
                     ("shared_down", (F_, D))):
            p[k] = rng.standard_normal(s).astype(np.float32) * 0.2
    return {k: v * (0.2 if k.startswith("expert") else 1.0)
            for k, v in p.items()}


@pytest.mark.parametrize("impl,shared", [("ragged", True),
                                         ("capacity", False)])
def test_moe_forward_gradients_match_reference(impl, shared):
    """sum(out * r) + aux: the gradients w.r.t. x, the router and every
    expert stack; the smallest top-k gap at this seed is reported and the
    routing is the reference's."""
    jmoe.GROUPED_IMPL["impl"] = impl
    tmoe.GROUPED_IMPL["impl"] = impl
    rng = np.random.default_rng(5)
    p = _moe_params(rng, shared)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    r = _loss_weights((2, 6, D))
    top_k = 2

    def jloss(pp, xa):
        out, aux = jmoe.moe_forward(pp, xa, top_k)
        return jnp.sum(out * r) + aux
    jgp, jgx = jax.grad(jloss, (0, 1))({k: jnp.asarray(v)
                                        for k, v in p.items()},
                                       jnp.asarray(x))
    tp = {k: _t(v, True) for k, v in p.items()}
    tx = _t(x, True)
    out, aux = tmoe.moe_forward(tp, tx, top_k)
    ((out * _t(r)).sum() + aux).backward()
    _close(tx.grad, jgx)
    for k in p:
        _close(tp[k].grad, jgp[k])
    assert tp["router_w"].grad.abs().max() > 0

    probs = torch.softmax(torch.from_numpy(x.reshape(-1, D))
                          @ torch.from_numpy(p["router_w"]), -1)
    srt = torch.sort(probs, -1, descending=True).values
    gap = float((srt[:, top_k - 1] - srt[:, top_k]).min())
    print(f"smallest top-{top_k} gap at seed 5: {gap:.3g}")
    assert gap > 1e-4


# ---------------------------------------------------------------------------
# one training step of each MoE architecture
# ---------------------------------------------------------------------------

class _RefTopK:
    """The reference's ``jax.lax.top_k`` as ``repro.models.moe`` reaches
    it, with each call's chosen experts recorded (a host callback, so it
    records inside the layer scan too)."""

    def __init__(self, calls):
        lax = types.SimpleNamespace(**{n: getattr(jax.lax, n)
                                       for n in dir(jax.lax)
                                       if not n.startswith("_")})
        lax.top_k = self.top_k
        self.lax, self.calls = lax, calls

    def __getattr__(self, name):
        return getattr(jax, name)

    def top_k(self, x, k):
        vals, idx = jax.lax.top_k(x, k)
        jax.debug.callback(lambda i: self.calls.append(np.asarray(i)), idx)
        return vals, idx


def _routes(monkeypatch, japi, tapi, jp, batch):
    """Every layer's expert choices in the reference's loss and in the
    port's, and the smallest top-k gap of the port's router."""
    from torch_train_helpers import bridged, torch_batch
    jcalls, tcalls, gaps = [], [], []
    monkeypatch.setattr(jmoe, "jax", _RefTopK(jcalls))
    jax.jit(japi.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jax.effects_barrier()
    route = tmoe._route

    def traced(xt, router_w, top_k):
        probs, gates, idx = route(xt, router_w, top_k)
        srt = torch.sort(probs, -1, descending=True).values
        if top_k < probs.shape[-1]:
            gaps.append(float((srt[:, top_k - 1] - srt[:, top_k]).min()))
        tcalls.append(idx.numpy())
        return probs, gates, idx
    monkeypatch.setattr(tmoe, "_route", traced)
    with torch.no_grad():
        tapi.loss(bridged(jp), torch_batch(batch))
    monkeypatch.undo()
    return jcalls, tcalls, gaps


@pytest.mark.parametrize("arch", [GRANITE, SCOUT])
def test_one_step_matches_reference(arch, monkeypatch):
    japi, tapi, jp = family_case(arch)
    batch = family_batch(tapi.cfg)
    jcalls, tcalls, gaps = _routes(monkeypatch, japi, tapi, jp, batch)
    print(f"{arch}: smallest top-k gap of the step's routing {min(gaps):.3g}")
    assert len(jcalls) == len(tcalls) == tapi.cfg.n_layers
    for j, t in zip(jcalls, tcalls):
        np.testing.assert_array_equal(np.sort(t, 1), np.sort(j, 1))
    metrics, _ = check_one_step(japi, tapi, jp, batch)
    assert float(metrics["aux"]) > 0


def test_bitplane_maintenance_of_expert_stacks():
    """Bit-plane mode: requantize and precision adjustment of granite's
    (8, L, E, Kp, Np) plane stacks a layer at a time against the
    reference's whole-leaf rule, from drifted planes and cut masks, and
    the deploy of the drifted tree."""
    japi, _, jp = family_case(GRANITE, "bitplane")
    tree = drifted(jp)
    assert tree["layers"]["moe"]["expert_up"].planes.ndim == 5
    check_maintenance(tree)


def test_launcher_trains_moe(capsys):
    """``python -m repro_torch.launch.train --arch granite-moe-3b-a800m``
    on the CPU: 2 steps, a maintenance at step 2, every logged value
    finite and the aux term in the loss."""
    from repro_torch.launch.train import main
    trainer = main(["--arch", GRANITE, "--device", "cpu", "--steps", "2",
                    "--requant-every", "2", "--seq", "16", "--batch", "2"])
    assert [h["step"] for h in trainer.history] == [1, 2]
    for h in trainer.history:
        assert all(np.isfinite(v) for v in h.values()), h
        assert h["aux"] > 0
    assert "ce=" in capsys.readouterr().out
    stack = trainer.state.params["layers"]["moe"]["expert_up"]
    assert stack.w.ndim == 4 and float(stack.bitwidth.max()) <= 8.0
