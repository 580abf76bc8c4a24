"""Training of the encoder-decoder family (seamless-m4t-large-v2) in the
port, held against the JAX reference.

* ``encdec_loss``: an unmasked mean cross entropy over the decoder's
  logits, aux 0; ``ModelAPI.loss`` dispatches the family to it.
* One step (tiny, f32, fake mode; the family has no PACT leaves) through
  ``torch_train_helpers``' rules: the loss, ``ce`` and ``aux``, every
  gradient leaf (encoder, conformer convolution, decoder, cross-attention
  and the tied embedding) beside the port's float64 gradient, a
  ``build_train_step`` step, a maintenance and the maintained tree's
  deploy.
* Remat: with ``remat`` on, each encoder and decoder layer is recomputed
  in the backward (the reference's ``jax.checkpoint`` at
  ``encdec.py:116`` and ``:157``), and the gradients are the plain
  backward's bit for bit.
* The trainer trains the family on ``lm_batch_for`` batches (frames
  beside the tokens) for 2 steps with a maintenance at step 2.
* The launcher refuses the family before it builds the model, naming it:
  its bigram stream carries no frames.  Beside the refusal, the
  reference's own launcher path fails at the first step: its
  ``encdec_loss`` on the stream's batch raises ``KeyError: 'frames'``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import make_lm_pipeline as j_pipeline  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.core.state import tensor_leaves  # noqa: E402
from repro_torch.data import lm_batch_for  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from torch_train_helpers import (LOSS_TOL, bridged,  # noqa: E402
                                 check_one_step, family_batch, family_case,
                                 port_grads, torch_batch)

torch.set_num_threads(2)
ARCH = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def case():
    japi, tapi, jp = family_case(ARCH)
    return japi, tapi, jp, family_batch(tapi.cfg)


def test_encdec_loss_matches_reference(case):
    """The unmasked mean over every position, through ``ModelAPI.loss``
    and ``encdec_loss`` alike; an explicit cross entropy of the forward's
    logits gives the same value."""
    from repro.models.encdec import encdec_loss as j_loss
    japi, tapi, jp, batch = case
    jl, jm = j_loss(jp, japi.cfg, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    tb = torch_batch(batch)
    with torch.no_grad():
        tl, tm = tapi.loss(bridged(jp), tb)
        tl2, _ = tencdec.encdec_loss(bridged(jp), tapi.cfg, tb)
        logits, _, _ = tencdec.encdec_forward(bridged(jp), tapi.cfg,
                                              tb["frames"], tb["tokens"])
    assert float(tl) == float(tl2)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * float(jl)
    assert float(tm["ce"]) == float(tl) and float(tm["aux"]) == 0.0
    assert float(jm["aux"]) == 0.0
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tb["labels"].reshape(-1).long())
    assert abs(float(ce) - float(tl)) <= 1e-6 * float(tl)


def test_one_step_matches_reference(case):
    japi, tapi, jp, batch = case
    metrics, errs = check_one_step(japi, tapi, jp, batch)
    assert float(metrics["aux"]) == 0.0
    for part in ("enc_layers", "dec_layers", "conv_dw", "cross_attn",
                 "['embed']"):
        assert any(part in p for p in errs), part
    worst = max(errs, key=lambda k: errs[k][0] or 0.0)
    print(f"{ARCH}: worst gradient leaf {worst} {errs[worst]}")


def test_remat_recomputes_the_same_gradients(case, monkeypatch):
    """Both stacks' layers go through ``torch.utils.checkpoint`` with
    ``remat`` (a graph to build), and the gradients and loss are the plain
    backward's bit for bit."""
    from repro_torch.models import common
    _, tapi, jp, batch = case
    calls = []
    real = common.checkpoint

    def spy(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)
    monkeypatch.setattr(common, "checkpoint", spy)
    remat = tbuild(dataclasses.replace(tapi.cfg, remat=True))
    (l0, _), g0 = port_grads(tapi, bridged(jp), batch)
    assert calls == []
    (l1, _), g1 = port_grads(remat, bridged(jp), batch)
    assert calls == ["body"] * (tapi.cfg.enc_layers + tapi.cfg.n_layers)
    assert torch.equal(l0, l1)
    want = dict(tensor_leaves(g0))
    for path, g in tensor_leaves(g1):
        assert torch.equal(g, want[path]), path


def test_trainer_trains_on_frames_batches(case):
    """Two steps of the port's Trainer on ``lm_batch_for`` batches (16
    tokens over 16 frames), a maintenance at step 2: finite losses and
    LUTs that did not grow."""
    _, tapi, jp, _ = case
    cell = ShapeCell("train", 16, 2, "train")
    tr = Trainer(tapi.loss, adamw(weight_decay=0.0), cosine_schedule(2e-3, 2),
                 bridged(jp),
                 TrainerConfig(total_steps=2, log_every=1, requant_interval=2,
                               alpha_round_steps=2, delta_alpha=1e-3))
    data = ((s, lm_batch_for(tapi.cfg, cell, s)) for s in range(2))
    tr.run(data, steps=2)
    assert [h["step"] for h in tr.history] == [1, 2]
    assert all(np.isfinite(h["ce"]) and h["aux"] == 0.0 for h in tr.history)
    bw = tr.state.params["dec_layers"]["mlp"]["w_in"].bitwidth
    assert float(bw.max()) <= 8.0


def test_launcher_refuses_the_family_as_the_reference_fails():
    """The port's launcher refuses before building the model, naming the
    family and the missing frames; the reference's launcher path (its
    loss on the bigram stream's first batch) raises ``KeyError``."""
    from repro.configs import REGISTRY as JREG
    from repro.models.api import build as jbuild
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="'audio'.*frames"):
        main(["--arch", ARCH, "--device", "cpu", "--steps", "1"])
    jcfg = JREG[ARCH].tiny(dtype="float32")
    japi = jbuild(jcfg)
    _, batch = next(j_pipeline(jcfg, 8, 2))
    params = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0)))
    with pytest.raises(KeyError, match="frames"):
        jax.eval_shape(japi.loss, params, batch)
