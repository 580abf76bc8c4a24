"""Training of the vlm (qwen2-vl-2b), ssm (rwkv6-1.6b) and hybrid
(zamba2-1.2b) families in the port, held against the JAX reference, and
the abstract input specs of every family.

* One step of each (tiny, f32, fake mode, 8-bit PACT where the family has
  PACT leaves; chunks of 8 so the 16-position scans run two chunks,
  each recomputed in the backward) through ``torch_train_helpers``'
  rules: the loss, ``ce`` and ``aux`` (0), every gradient leaf beside the
  port's float64 gradient, a ``build_train_step`` step, a maintenance and
  the maintained tree's deploy.  qwen2-vl's batch carries
  ``vision_embeds``: the loss reads the last ``labels.shape[1]``
  positions.  zamba2's shared block runs twice (4 layers, period 2): its
  weights' gradient sums both calls and ``embed`` takes gradient through
  the trunk and through ``emb0``.
* The chunked SSD scan's backward stays finite over a 128-position chunk
  whose decays sum past exp's range, where the reference's reads
  ``0 * inf`` (it masks after the exp) and gives NaN: the port masks
  first, the forward unchanged.
* Remat: with ``remat`` on, each ssm layer and hybrid Mamba-2 layer is
  recomputed in the backward, and the gradients are the plain
  backward's bit for bit (the dense walk's: tests/test_torch_train.py).
* The launcher trains qwen2-vl (text only, as the reference's launcher
  trains it), rwkv6 and zamba2 for 2 steps with a maintenance at step 2.
(The specs are in ``tests/test_torch_train_specs.py``, the batches in
``tests/test_torch_train_batches.py``.)
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core.state import tensor_leaves  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from torch_train_helpers import (bridged, check_one_step,  # noqa: E402
                                 family_batch, family_case, port_grads)

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"
CHUNKS = dict(rwkv_chunk=8, ssm_chunk=8)


@pytest.mark.parametrize("arch", [QWEN, RWKV, ZAMBA])
def test_one_step_matches_reference(arch):
    japi, tapi, jp = family_case(arch, **CHUNKS)
    batch = family_batch(tapi.cfg)
    metrics, errs = check_one_step(japi, tapi, jp, batch)
    assert float(metrics["aux"]) == 0.0
    worst = max(errs, key=lambda k: errs[k][0] or 0.0)
    print(f"{arch}: worst gradient leaf {worst} {errs[worst]}")
    if arch == ZAMBA:
        assert tapi.cfg.n_layers // tapi.cfg.hybrid_attn_every == 2


def test_ssd_chunk_backward_is_finite_past_exp_range():
    """zamba2 at full width meets it on its first step (chunk 128, dt
    ~0.7: the decays above the diagonal sum to ~90 > log(f32 max))."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    rng = np.random.default_rng(0)
    b, L, H, P, N = 1, 128, 2, 4, 3
    xh = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.full((b, L, H), 0.8, np.float32)
    B_, C_ = (rng.standard_normal((b, L, N)).astype(np.float32)
              for _ in range(2))
    h0 = np.zeros((b, H, N, P), np.float32)
    ins = [xh, dt, -dt, B_, C_]

    def jloss(da):
        y, _ = jssm._ssd_chunked(*map(jnp.asarray, ins[:2]), da,
                                 *map(jnp.asarray, ins[3:]),
                                 jnp.asarray(h0), L)
        return jnp.sum(y)
    assert not np.isfinite(np.asarray(jax.grad(jloss)(
        jnp.asarray(ins[2])))).all()
    t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, _ = tssm._ssd_chunked(*t, torch.from_numpy(h0), L)
    y.sum().backward()
    assert all(bool(torch.isfinite(a.grad).all()) for a in t)
    want, _ = jssm._ssd_chunked(*map(jnp.asarray, ins), jnp.asarray(h0), L)
    err = np.abs(y.detach().numpy() - np.asarray(want)).max()
    assert err <= 1e-5 * np.abs(np.asarray(want)).max(), err


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_remat_recomputes_the_same_gradients(arch):
    """Each layer body recomputed in the backward gives the plain
    backward's gradients bit for bit, and the same loss."""
    _, tapi, jp = family_case(arch, **CHUNKS)
    batch = family_batch(tapi.cfg)
    remat = tbuild(dataclasses.replace(tapi.cfg, remat=True))
    (l0, _), g0 = port_grads(tapi, bridged(jp), batch)
    (l1, _), g1 = port_grads(remat, bridged(jp), batch)
    assert torch.equal(l0, l1)
    want = dict(tensor_leaves(g0))
    for path, g in tensor_leaves(g1):
        assert torch.equal(g, want[path]), path


def test_remat_recomputes_each_layer(monkeypatch):
    """With ``remat`` the ssm and hybrid walks hand every layer body to
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` at
    ``transformer.py:254`` and ``:287``), and only with a graph to build;
    the scans' chunks go through it whenever one is built."""
    from repro_torch.models import common
    calls = []
    real = common.checkpoint

    def spy(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)
    monkeypatch.setattr(common, "checkpoint", spy)
    for arch, n in ((RWKV, 2), (ZAMBA, 4)):
        _, tapi, jp = family_case(arch, **CHUNKS)
        batch = family_batch(tapi.cfg)
        remat = tbuild(dataclasses.replace(tapi.cfg, remat=True))
        calls.clear()
        port_grads(remat, bridged(jp), batch)
        assert calls.count("body") == n, (arch, calls)
        # two chunks a layer in the forward, and again in the layer's
        # recompute
        assert calls.count("chunk_step") == 4 * n, (arch, calls)
        calls.clear()
        with torch.no_grad():
            remat.loss(bridged(jp), {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        assert calls == [], (arch, calls)


@pytest.mark.parametrize("arch", [QWEN, RWKV, ZAMBA])
def test_launcher_trains_the_family(arch, capsys):
    from repro_torch.launch.train import main
    trainer = main(["--arch", arch, "--device", "cpu", "--steps", "2",
                    "--requant-every", "2", "--seq", "16", "--batch", "2"])
    assert [h["step"] for h in trainer.history] == [1, 2]
    for h in trainer.history:
        assert all(np.isfinite(v) for v in h.values()), h
        assert h["aux"] == 0.0
    assert "ce=" in capsys.readouterr().out
