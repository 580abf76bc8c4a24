"""The port's CNN training (BWQ-A bit-plane mode at 9x8 blocks), held
against the JAX reference on trees carried across by the bridge.

Fixture: ResNet-8 on 8x8 images, the reference's ``resnet_init(
PRNGKey(0))`` in bit-plane mode (9x8 blocks), activations unquantized
(32) or 8-bit PACT (the post-ReLU quantizer and its trainable ``beta``).
Batches are the port's ``SyntheticCIFAR`` draws (the reference draws from
``jax.random``, which torch cannot reproduce), fed to both packages.

* One step: the loss and the group-Lasso regularizer (alpha 1e-3) within
  1e-5 relative, every gradient leaf after ``freeze_mask`` within 1e-4 of
  the leaf's largest magnitude (the frozen ones zero), and the params and
  momentum after the reference trainer's SGD (momentum 0.9, weight decay
  1e-4) within 1e-4.  ``beta``'s gradient sums per-element rounding
  residuals that nearly cancel, so it is held to ``BETA_TOL`` of the
  port's float64 gradient, the reference and the port alike (as
  ``tests/test_torch_train.py`` holds the LM's).
* A maintenance step (requantize + adjust_precision) on the drifted
  planes: planes, masks and bit-width maps equal.
* The trainer: 4 steps of SGD under the cosine schedule from 0.05, with
  maintenance and an alpha round every 2: the loss within 1e-4 relative
  at every step, the same alpha and the same bit-width maps (equal once
  rounded: the weight decay shrinks the frozen masks too, in both
  packages, so the sums part in the last f32 bits).
* ``SyntheticCIFAR``: templates bit for bit; batches a pure function of
  (seed, step); the launcher runs at ``--tiny`` on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import SyntheticCIFAR as JSyntheticCIFAR  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.optim import cosine_schedule as j_cos  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTC  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.step import build_maintenance_step as j_maint  # noqa: E402
from repro.train.step import freeze_mask as j_freeze  # noqa: E402
from repro.train.step import quant_reg_loss as j_reg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.state import (map_tensors, quantized_leaves,  # noqa: E402
                                    tensor_leaves)
from repro_torch.data import SyntheticCIFAR  # noqa: E402
from repro_torch.launch import cifar  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import cosine_schedule as t_cos  # noqa: E402
from repro_torch.optim import sgd as t_sgd  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig, TrainState  # noqa: E402
from repro_torch.train.step import (build_maintenance_step,  # noqa: E402
                                    microbatched_value_and_grad,
                                    quant_reg_loss)
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
ALPHA = 1e-3
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
BETA_TOL = 5e-3
FROZEN = (".mask", ".sign", ".bitwidth", ".scale")


def _qcs(act_bits):
    return (JQ(mode="bitplane", n_bits=8, act_bits=act_bits),
            TQ(mode="bitplane", n_bits=8, act_bits=act_bits))


@pytest.fixture(scope="module")
def jinit():
    cache = {}

    def get(act_bits):
        if act_bits not in cache:
            cache[act_bits] = jcnn.resnet_init(jax.random.PRNGKey(0),
                                               _qcs(act_bits)[0], depth=8)
        return cache[act_bits]
    return get


def _bridged(jp):
    return params_from_numpy(tree_to_numpy(jp), device="cpu")


def _batch(step=0, b=4):
    return SyntheticCIFAR(image=8, batch=b, noise=0.5, seed=0).batch_at(step)


def _jleaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaf_close(got, want, path, tol=LEAF_TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np_of(got) - want).max()) / scale
    assert err <= tol, (path, err)


def _ref_total(qc, batch, alpha=ALPHA):
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def fn(p):
        loss, m = jcnn.cnn_loss(jcnn.resnet_apply, p, jb, qc)
        reg = j_reg(p, jnp.float32(alpha))
        return loss + reg, (m, reg)
    return fn


def _port_total(qc, alpha=ALPHA):
    def fn(p, b):
        reg = quant_reg_loss(p, torch.tensor(alpha, dtype=torch.float32))
        loss, m = cnn.cnn_loss(cnn.resnet_apply, p, b, qc)
        return loss + reg, (m, reg)
    return fn


@pytest.mark.parametrize("act_bits", [32, 8])
def test_one_step_matches_reference(jinit, act_bits):
    jqc, tqc = _qcs(act_bits)
    jp = jinit(act_bits)
    tp = _bridged(jp)
    batch = _batch()
    (jl, (jm, jr)), jg = jax.value_and_grad(
        _ref_total(jqc, batch), has_aux=True)(jp)
    jg = j_freeze(jg)
    (tl, (tm, tr)), tg = microbatched_value_and_grad(_port_total(tqc))(
        tp, batch)
    assert float(tr) > 0
    for got, want in ((tl, jl), (tr, jr)):
        assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    assert float(tm["acc"]) == float(jm["acc"])
    jgl = _jleaves(jg)
    t_leaves = dict(tensor_leaves(tg))
    assert t_leaves.keys() == jgl.keys()
    beta64 = None
    if act_bits < 32:
        p64 = map_tensors(lambda t: t.double() if t.is_floating_point()
                          else t, tp)
        b64 = {"images": batch["images"].double(),
               "labels": batch["labels"]}
        _, g64 = microbatched_value_and_grad(_port_total(tqc))(p64, b64)
        beta64 = g64["beta"].numpy()
    for path, g in t_leaves.items():
        if path.endswith(FROZEN):
            assert not g.any() and not jgl[path].any(), path
        elif path == "['beta']" and beta64 is not None:
            _leaf_close(g, beta64, path, BETA_TOL)
            _leaf_close(jgl[path], beta64, path, BETA_TOL)
        else:
            _leaf_close(g, jgl[path], path)

    # the reference trainer's SGD from the same (reference) gradients
    jopt, topt = j_sgd(momentum=0.9, weight_decay=1e-4), \
        t_sgd(momentum=0.9, weight_decay=1e-4)
    lr = 0.05
    jnew, jst = jax.jit(jopt.update)(jg, jopt.init(jp), jp, jnp.float32(lr))
    tnew = map_tensors(torch.clone, tp)
    tst = topt.init(tnew)
    topt.update(_bridged(jg), tst, tnew, torch.tensor(lr))
    for tree, ref in ((tnew, jnew), (tst["mu"], jst["mu"])):
        ref_leaves = _jleaves(ref)
        for path, p in tensor_leaves(tree):
            _leaf_close(p, ref_leaves[path], path)


def test_maintenance_matches_reference(jinit):
    """Requantize + adjust_precision on planes drifted off binary: planes,
    masks and bit-width maps equal the reference's."""
    jp = jinit(32)
    rng = np.random.default_rng(4)

    def drift(path, x):
        k = jax.tree_util.keystr(path)
        if k.endswith(".planes"):
            return jnp.clip(x + jnp.asarray(rng.uniform(
                -0.6, 0.6, x.shape).astype(np.float32)), 0.0, 1.0)
        return x
    jd = jax.tree_util.tree_map_with_path(drift, jp)
    tstate = TrainState(step=0, params=_bridged(jd), opt_state=None,
                        alpha=torch.tensor(0.0))
    # the reference's step donates its state: hand it copies
    want = j_maint()(JTrainState(
        step=0, params=jax.tree_util.tree_map(jnp.copy, jd), opt_state=None,
        alpha=jnp.float32(0))).params
    got = build_maintenance_step()(tstate).params
    wl = _jleaves(want)
    for path, t in tensor_leaves(got):
        np.testing.assert_array_equal(np_of(t), wl[path], err_msg=path)
    bw = {k: np_of(q.mask.sum(0)) for k, q in quantized_leaves(got).items()}
    assert any((m < 8).any() for m in bw.values())


def test_trainer_matches_reference(jinit):
    """4 steps, maintenance and an alpha round every 2, run a step at a
    time in both packages on the port's batches (SGD, cosine from 0.05)."""
    jqc, tqc = _qcs(32)
    jp = jinit(32)
    tcfg = dict(total_steps=4, log_every=1, requant_interval=2,
                alpha_round_steps=2, delta_alpha=1e-3)
    jt = JTrainer(lambda p, b: jcnn.cnn_loss(jcnn.resnet_apply, p, b, jqc),
                  j_sgd(momentum=0.9, weight_decay=1e-4), j_cos(0.05, 4),
                  jax.tree_util.tree_map(jnp.copy, jp),
                  JTC(ckpt_every=0, **tcfg))
    tt = Trainer(lambda p, b: cnn.cnn_loss(cnn.resnet_apply, p, b, tqc),
                 t_sgd(momentum=0.9, weight_decay=1e-4), t_cos(0.05, 4),
                 _bridged(jp), TrainerConfig(**tcfg))
    batches = [_batch(s) for s in range(4)]
    jdata = ((s, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
             for s, b in enumerate(batches))
    tdata = iter(list(enumerate(batches)))

    def maps(tree, fn):
        return {k: fn(q) for k, q in quantized_leaves(tree).items()}
    from repro.core.state import quantized_leaves as j_qleaves
    for s in range(1, 5):
        jt.run(jdata, steps=s)
        tt.run(tdata, steps=s)
        assert np.float32(float(tt.state.alpha)) == \
            np.float32(jt.state.alpha), s
        assert tt.history[-1]["loss"] == pytest.approx(
            jt.history[-1]["loss"], rel=1e-4)
        if s % 2 == 0:
            jm = {k: np.asarray(q.mask.sum(0))
                  for k, q in j_qleaves(jt.state.params).items()}
            tm = maps(tt.state.params, lambda q: np_of(q.mask.sum(0)))
            assert tm.keys() == jm.keys()
            # SGD's weight decay reaches every float leaf in both packages,
            # the frozen masks too (off 1 by ~1e-5 a step): the maps agree
            # to the last f32 bit or two, and exactly once rounded
            for k in jm:
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6,
                                           err_msg=k)
                np.testing.assert_array_equal(np.rint(tm[k]),
                                              np.rint(jm[k]), err_msg=k)
    assert float(tt.state.alpha) > 0
    # the bit count sums the decayed masks: their last bits part
    assert tt.history[-1]["avg_bitwidth"] == pytest.approx(
        jt.history[-1]["avg_bitwidth"], rel=1e-5)


def test_synthetic_cifar_templates_and_batches():
    for seed in (0, 3):
        j = JSyntheticCIFAR(batch=8, seed=seed)
        t = SyntheticCIFAR(batch=8, seed=seed)
        np.testing.assert_array_equal(t.templates, j.templates)
    t = SyntheticCIFAR(batch=16, noise=0.1)
    b = t.batch_at(0)
    assert b["images"].shape == (16, 32, 32, 3)
    assert b["images"].dtype == torch.float32
    assert b["labels"].dtype == torch.int32
    assert torch.equal(b["images"], t.batch_at(0)["images"])
    assert not torch.equal(b["images"], t.batch_at(1)["images"])
    # the reference's own check: nearest template beats chance
    imgs = b["images"].numpy().reshape(16, -1)
    pred = np.argmax(imgs @ t.templates.reshape(10, -1).T, axis=1)
    assert (pred == b["labels"].numpy()).mean() > 0.5
    # the noise law: the residual's deviation is ``noise``
    big = SyntheticCIFAR(batch=256, noise=0.5, seed=2).batch_at(5)
    gen = SyntheticCIFAR(batch=256, noise=0.5, seed=2)
    resid = big["images"].numpy() - gen.templates[big["labels"].numpy()]
    assert abs(resid.std() - 0.5) < 0.01


def test_launcher_tiny_on_cpu():
    out = cifar.main(["--tiny", "--device", "cpu", "--steps", "4",
                      "--requant-every", "2", "--scheme", "float", "bsq",
                      "bwq"])
    res = out["results"]
    assert set(res) == {"float", "bsq", "bwq"}
    for r in res.values():
        assert all(np.isfinite(r["loss"]))
        assert 0.0 <= r["acc"] <= 1.0
    assert res["float"]["compression_x"] == 1.0
    assert res["bwq"]["compression_x"] > 1.0
    assert out["deployed"] is not None
    assert 0.0 <= res["bwq"]["acc_deployed"] <= 1.0
    assert out["sim"]["bwq_vs_isaac"]["speedup_x"] > 1.0
    assert out["sim"]["bsq_vs_isaac"]["layer_bits"] >= 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cifar.main(["--tiny", "--steps", "1"])


def test_sgd_moves_frozen_leaves_by_weight_decay_alone(jinit):
    """The CIFAR launcher's SGD decays every float leaf, the frozen
    quantization metadata too (as the reference's optimizer does); their
    gradient is zero, so after a train step they equal the optimizer's
    update from a zero gradient, bit for bit (the rule the chip smoke's
    CNN phase holds each step to)."""
    from repro_torch.train import build_train_step
    _, tqc = _qcs(32)
    opt, sched = cifar.optimizer(), cifar.lr_schedule(4)
    state = TrainState.create(_bridged(jinit(32)), opt, 0.0)
    step = build_train_step(
        lambda p, b: cnn.cnn_loss(cnn.resnet_apply, p, b, tqc), opt, sched)
    state, _ = step(state, _batch(0))      # the schedule's lr is 0 at step 0
    frozen = {p: t.clone() for p, t in tensor_leaves(state.params)
              if p.endswith(FROZEN)}
    keys = sorted(frozen)
    mu = dict(tensor_leaves(state.opt_state["mu"]))
    want = [frozen[k].clone() for k in keys]
    opt.update([torch.zeros_like(t) for t in want],
               {"mu": [mu[k].clone() for k in keys]}, want, sched(1))
    state, _ = step(state, _batch(1))
    now = dict(tensor_leaves(state.params))
    for k, w in zip(keys, want):
        assert torch.equal(now[k], w), k
        assert not torch.equal(now[k], frozen[k]), k
