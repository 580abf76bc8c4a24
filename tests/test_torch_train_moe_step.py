"""Training of the MoE family in the port, held against the JAX reference
(shared helpers in ``tests/torch_train_helpers.py``).

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
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_train_helpers import (as_torch, assert_grad_close,  # noqa: E402
                                 check_maintenance, check_one_step, drifted,
                                 family_batch, family_case, loss_weights,
                                 moe_dispatch_back_to_ragged)

torch.set_num_threads(2)
GRANITE, SCOUT = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"
E, D, F_ = 4, 27, 40             # experts, d_model, d_ff (9x8: odd Kp=27)


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
    r = loss_weights((2, 6, D))
    top_k = 2

    def jloss(pp, xa):
        out, aux = jmoe.moe_forward(pp, xa, top_k)
        return jnp.sum(out * r) + aux
    jgp, jgx = jax.grad(jloss, (0, 1))({k: jnp.asarray(v)
                                        for k, v in p.items()},
                                       jnp.asarray(x))
    tp = {k: as_torch(v, True) for k, v in p.items()}
    tx = as_torch(x, True)
    out, aux = tmoe.moe_forward(tp, tx, top_k)
    ((out * as_torch(r)).sum() + aux).backward()
    assert_grad_close(tx.grad, jgx)
    for k in p:
        assert_grad_close(tp[k].grad, jgp[k])
    assert tp["router_w"].grad.abs().max() > 0

    probs = torch.softmax(torch.from_numpy(x.reshape(-1, D))
                          @ torch.from_numpy(p["router_w"]), -1)
    srt = torch.sort(probs, -1, descending=True).values
    gap = float((srt[:, top_k - 1] - srt[:, top_k]).min())
    print(f"smallest top-{top_k} gap at seed 5: {gap:.3g}")
    assert gap > 1e-4


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
