"""The port's BWQ-A training, held against the JAX reference.

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")`` (2 layers, 9x8
blocks), the reference's ``init(PRNGKey(0))`` carried across through
numpy, in fake-quant and bit-plane mode, with activations at 32 (off) and
8 bits.  The batch is a numpy draw from seed ``BATCH_SEED``.

* One step: the loss and the regularizer (alpha 1e-3) within 1e-5
  relative, the gradient norm too, every gradient leaf after
  ``freeze_mask`` within 1e-4 of the leaf's largest magnitude, and, from
  the same gradients, the params and optimizer state after AdamW (with
  and without weight decay) and SGD (plain, and Nesterov with clipping)
  within 1e-4 of each leaf's largest magnitude, and so are the params of
  a second update from the reference's optimizer state carried across
  through numpy; frozen leaves are
  unchanged bit for bit where nothing decays them.  The PACT clip levels
  ``beta_*`` are the exception: their gradient sums per-element rounding
  residuals that nearly cancel (an |x| < beta activation contributes
  q/L - y/b), so two f32 summation orders part by up to ~2e-3 of it
  (measured over batch seeds 1-5: the reference 8e-5 to 1.7e-3 off the
  float64 value, the port 7e-6 to 3e-4).  They are held to ``BETA_TOL``
  of the float64 gradient (the port run in float64), the reference and
  the port alike.
* The trainer: 4 steps, maintenance every 2 and alpha raised by
  ``delta_alpha`` at each, from the same params and batches: the same
  alpha sequence, ``ce`` within 1e-4 relative at every logged step and
  the same bit-width maps after each maintenance; with an ``eval_fn``,
  alpha stops rising once quality leaves its budget; remat recomputes
  the same gradients.
* The data pipeline: the successor table is the reference's; batches are
  pure functions of the step (the walk is drawn by torch, not by
  ``jax.random``; see ``repro_torch.data.synthetic``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import cosine_schedule as j_cos  # noqa: E402
from repro.optim import global_norm as j_gn  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTC  # noqa: E402
from repro.train.step import freeze_mask as j_freeze  # noqa: E402
from repro.train.step import \
    microbatched_value_and_grad as j_mb  # noqa: E402
from repro.train.step import quant_reg_loss as j_reg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.state import map_tensors, tensor_leaves  # noqa: E402
from repro_torch.data import SyntheticLM, make_lm_pipeline  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import cosine_schedule as t_cos  # noqa: E402
from repro_torch.optim import global_norm as t_gn  # noqa: E402
from repro_torch.optim import sgd as t_sgd  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig, TrainState  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402
from repro_torch.train.step import (microbatched_value_and_grad,  # noqa: E402
                                    quant_reg_loss)
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"
BATCH_SEED = 1
ALPHA = 1e-3
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
BETA_TOL = 5e-3
FROZEN = (".mask", ".sign", ".bitwidth", ".scale")


def _cfgs(mode, act_bits):
    return (JREG[ARCH].tiny(dtype="float32").with_quant(
                JQ(mode=mode, n_bits=8, act_bits=act_bits)),
            TREG[ARCH].tiny(dtype="float32").with_quant(
                TQ(mode=mode, n_bits=8, act_bits=act_bits)))


@pytest.fixture(scope="module")
def fx():
    """Per (mode, act_bits): the two APIs and the reference's init, built
    once."""
    cache = {}

    def get(mode, act_bits):
        if (mode, act_bits) not in cache:
            jcfg, tcfg = _cfgs(mode, act_bits)
            japi, tapi = jbuild(jcfg), tbuild(tcfg)
            cache[(mode, act_bits)] = (japi, tapi,
                                       japi.init(jax.random.PRNGKey(0)))
        return cache[mode, act_bits]
    return get


def _bridged(jp):
    return params_from_numpy(tree_to_numpy(jp), device="cpu")


def _batch(vocab, seed=BATCH_SEED, b=2, s=16):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _jleaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaf_close(got, want, path, tol=LEAF_TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np_of(got) - want).max()) / scale
    assert err <= tol, (path, err)


def _port_total(tapi, alpha):
    """The port's train-step objective, built as ``build_train_step``
    builds it (regularizer first)."""
    def fn(p, b):
        reg = quant_reg_loss(p, torch.tensor(alpha, dtype=torch.float32))
        loss, m = tapi.loss(p, b)
        return loss + reg, (m, reg)
    return fn


def _ref_total(japi, alpha, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fn(p):
        loss, m = japi.loss(p, jb)
        reg = j_reg(p, jnp.float32(alpha))
        return loss + reg, (m, reg)
    return fn


def _float64_beta_grads(tapi, jp, batch):
    """The port's gradient of ``beta_*`` in float64 (params, compute and
    batch the same), the anchor of the f32 results."""
    cfg64 = dataclasses.replace(tapi.cfg, dtype="float64")
    p64 = map_tensors(lambda t: t.double() if t.is_floating_point() else t,
                      _bridged(jp))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, g = microbatched_value_and_grad(
        _port_total(tbuild(cfg64), ALPHA))(p64, tb)
    return {k: g["layers"][k].numpy() for k in ("beta_attn", "beta_mlp")}


@pytest.mark.parametrize("act_bits", [32, 8])
@pytest.mark.parametrize("mode", ["fake", "bitplane"])
def test_one_step_matches_reference(fx, mode, act_bits):
    japi, tapi, jp = fx(mode, act_bits)
    tp = _bridged(jp)
    batch = _batch(japi.cfg.vocab)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # eager, as the reference's own tests run it (under jit XLA reorders
    # the regularizer's large f32 sums: 3e-5 relative on the bit-plane one)
    (jl, (jm, jr)), jg = jax.value_and_grad(
        _ref_total(japi, ALPHA, batch), has_aux=True)(jp)
    jg = j_freeze(jg)
    (tl, (tm, tr)), tg = microbatched_value_and_grad(
        _port_total(tapi, ALPHA))(tp, tb)
    assert float(tr) > 0
    for got, want in ((tl, jl), (tr, jr), (tm["ce"], jm["ce"]),
                      (t_gn(tg), j_gn(jg))):
        assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)

    jgl = _jleaves(jg)
    t_leaves = dict(tensor_leaves(tg))
    assert t_leaves.keys() == jgl.keys()
    beta64 = _float64_beta_grads(tapi, jp, batch) if act_bits < 32 else {}
    for path, g in t_leaves.items():
        if path.endswith(FROZEN):
            assert not g.any() and not jgl[path].any(), path
        name = path.split("'")[-2]
        if name in beta64:
            _leaf_close(g, beta64[name], path, BETA_TOL)
            _leaf_close(jgl[path], beta64[name], path, BETA_TOL)
        else:
            _leaf_close(g, jgl[path], path)

    # the optimizers from the same gradients (the reference's, carried
    # across): AdamW's first step divides g by |g| + eps, so where |g| is
    # near eps the gradients' f32 noise alone moves the update by up to lr
    jg_t = params_from_numpy(tree_to_numpy(jg), device="cpu")
    for jopt, topt, wd in ((j_adamw(weight_decay=0.0),
                            t_adamw(weight_decay=0.0), False),
                           (j_adamw(), t_adamw(), True),
                           (j_sgd(), t_sgd(), True),
                           (j_sgd(momentum=0.8, weight_decay=0.0,
                                  nesterov=True, grad_clip=0.5),
                            t_sgd(momentum=0.8, weight_decay=0.0,
                                  nesterov=True, grad_clip=0.5), False)):
        lr = 2e-3
        jnew, jst = jax.jit(jopt.update)(jg, jopt.init(jp), jp,
                                         jnp.float32(lr))
        tnew = map_tensors(torch.clone, tp)
        tst = topt.init(tnew)
        topt.update(map_tensors(torch.clone, jg_t), tst, tnew,
                    torch.tensor(lr, dtype=torch.float32))
        for tree, ref in ((tnew, jnew),) + tuple(
                (tst[k], jst[k]) for k in ("mu", "m", "v") if k in tst):
            ref_leaves = _jleaves(ref)
            for path, p in tensor_leaves(tree):
                _leaf_close(p, ref_leaves[path], path)
        # a second update from the reference's state carried across
        jnew2, _ = jax.jit(jopt.update)(jg, jst, jnew, jnp.float32(lr))
        tnew2 = params_from_numpy(tree_to_numpy(jnew), device="cpu")
        tst2 = params_from_numpy(tree_to_numpy(jst), device="cpu")
        topt.update(map_tensors(torch.clone, jg_t), tst2, tnew2,
                    torch.tensor(lr, dtype=torch.float32))
        assert int(tst2.get("t", 0)) == (2 if "t" in tst2 else 0)
        ref_leaves = _jleaves(jnew2)
        for path, p in tensor_leaves(tnew2):
            _leaf_close(p, ref_leaves[path], path)
        before = dict(tensor_leaves(tp))
        for path, p in tensor_leaves(tnew):
            if path.endswith(FROZEN) and not wd:
                assert torch.equal(p, before[path]), path


def test_train_step_and_microbatches(fx):
    """``build_train_step`` gives the reference's metrics, and the params
    of its own gradients through the optimizer; two microbatches give the
    reference's microbatched loss and gradients."""
    japi, tapi, jp = fx("fake", 8)
    batch = _batch(japi.cfg.vocab, b=4)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = t_adamw()
    state = TrainState.create(_bridged(jp), opt, ALPHA)
    step = build_train_step(tapi.loss, opt, t_cos(2e-3, 10))
    state, metrics = step(state, tb)
    assert state.step == 1 and int(state.opt_state["t"]) == 1
    (jl, (jm, jr)), jg = jax.value_and_grad(
        _ref_total(japi, ALPHA, batch), has_aux=True)(jp)
    jg = j_freeze(jg)
    assert float(metrics["loss"]) == pytest.approx(float(jl), rel=LOSS_TOL)
    assert float(metrics["reg"]) == pytest.approx(float(jr), rel=LOSS_TOL)
    assert float(metrics["grad_norm"]) == pytest.approx(float(j_gn(jg)),
                                                        rel=LOSS_TOL)
    assert float(metrics["lr"]) == float(j_cos(2e-3, 10)(0))
    _, tg = microbatched_value_and_grad(_port_total(tapi, ALPHA))(
        _bridged(jp), tb)
    manual = _bridged(jp)
    opt.update(tg, opt.init(manual), manual, t_cos(2e-3, 10)(0))
    want = dict(tensor_leaves(manual))
    for path, p in tensor_leaves(state.params):
        assert torch.equal(p, want[path]), path
        assert not p.requires_grad

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl2, _), jg2 = j_mb(japi.loss, 2)(jp, jb)
    (tl2, _), tg2 = microbatched_value_and_grad(tapi.loss, 2)(_bridged(jp),
                                                              tb)
    assert float(tl2) == pytest.approx(float(jl2), rel=LOSS_TOL)
    jgl2 = _jleaves(jg2)
    for path, g in tensor_leaves(tg2):
        if "beta" not in path and not path.endswith(FROZEN):
            _leaf_close(g, jgl2[path], path)


@pytest.mark.parametrize("mode", ["fake", "bitplane"])
def test_trainer_matches_reference(fx, mode):
    """4 steps with maintenance and an alpha round every 2, run a step at
    a time in both packages on the port's batches."""
    japi, tapi, jp = fx(mode, 32)
    tcfg = dict(total_steps=4, log_every=1, requant_interval=2,
                alpha_round_steps=2, delta_alpha=1e-3)
    jt = JTrainer(lambda p, b: japi.loss(p, b), j_adamw(weight_decay=0.0),
                  j_cos(2e-3, 4), jax.tree_util.tree_map(jnp.copy, jp),
                  JTC(ckpt_every=0, **tcfg))
    tt = Trainer(tapi.loss, t_adamw(weight_decay=0.0), t_cos(2e-3, 4),
                 _bridged(jp), TrainerConfig(**tcfg))
    gen = SyntheticLM(japi.cfg.vocab, 16, 2, seed=3)
    jdata = ((s, {k: jnp.asarray(v.numpy()) for k, v in gen.batch_at(s)
                  .items()}) for s in range(4))
    tdata = make_lm_pipeline(tapi.cfg, 16, 2, seed=3)

    def maps(tree, fn):
        return {k: fn(v) for k, v in tree["layers"]["attn"].items()}
    bw_j = (lambda q: np.asarray(q.bitwidth)) if mode == "fake" else \
        (lambda q: np.asarray(q.mask.sum(0)))
    bw_t = (lambda q: np_of(q.bitwidth)) if mode == "fake" else \
        (lambda q: np_of(q.mask.sum(0)))
    for s in range(1, 5):
        jt.run(jdata, steps=s)
        tt.run(tdata, steps=s)
        assert np.float32(float(tt.state.alpha)) == \
            np.float32(jt.state.alpha), s
        assert tt.history[-1]["step"] == jt.history[-1]["step"] == s
        assert tt.history[-1]["ce"] == pytest.approx(jt.history[-1]["ce"],
                                                     rel=1e-4)
        if s % 2 == 0:
            jm, tm = maps(jt.state.params, bw_j), maps(tt.state.params, bw_t)
            for k in jm:
                np.testing.assert_array_equal(tm[k], jm[k])
    assert float(tt.state.alpha) > 0
    assert tt.history[-1]["avg_bitwidth"] == pytest.approx(
        jt.history[-1]["avg_bitwidth"], rel=1e-6)


def test_trainer_refuses_checkpoints(fx, tmp_path):
    """The trainer saves and restores checkpoints now; it refuses one that
    does not match its state (another model's, here with no
    quantization), naming the missing and extra leaves."""
    from repro_torch.ckpt import CheckpointMismatchError
    _, tapi, jp = fx("fake", 32)
    d = str(tmp_path)
    other = TREG[ARCH].tiny(dtype="float32").with_quant(TQ(mode="none"))
    stranger = Trainer(tapi.loss, t_adamw(), t_cos(1e-3, 2),
                       tbuild(other).init(seed=0, device="cpu"),
                       TrainerConfig(ckpt_dir=d))
    stranger._save(1)
    stranger.ckpt.wait()
    tr = Trainer(tapi.loss, t_adamw(), t_cos(1e-3, 2), _bridged(jp),
                 TrainerConfig(ckpt_dir=d))
    with pytest.raises(CheckpointMismatchError, match="missing") as ei:
        tr.try_restore()
    assert ".params['layers']['attn']['wq'].bitwidth" in ei.value.missing


def test_synthetic_lm_pipeline():
    """The successor table is the reference's; ``batch_at`` is a pure
    function of the step, labels are the tokens shifted by one, every
    transition is in the table, and a pipeline started at step k resumes
    the sequence."""
    gen = SyntheticLM(512, 24, 3, seed=5)
    np.testing.assert_array_equal(gen.succ, JSyntheticLM(512, 24, 3, 5).succ)
    b0, b0_again, b1 = gen.batch_at(0), gen.batch_at(0), gen.batch_at(1)
    for k in ("tokens", "labels"):
        assert torch.equal(b0[k], b0_again[k])
        assert b0[k].dtype == torch.int32 and b0[k].shape == (3, 24)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    seq = torch.cat([b0["tokens"], b0["labels"][:, -1:]], 1).numpy()
    for row in seq:
        for a, b in zip(row[:-1], row[1:]):
            assert b in gen.succ[a]
    assert not torch.equal(SyntheticLM(512, 24, 3, seed=6).batch_at(0)
                           ["tokens"], b0["tokens"])
    cfg = TREG[ARCH].tiny(dtype="float32")
    it = make_lm_pipeline(cfg, 24, 3, seed=5, start_step=7)
    for want in (7, 8):
        step, b = next(it)
        assert step == want
        assert torch.equal(b["tokens"], SyntheticLM(cfg.vocab, 24, 3, 5)
                           .batch_at(want)["tokens"])


def test_remat_recomputes_the_same_gradients(fx):
    """``cfg.remat`` (each layer recomputed in the backward, as the
    registered full-width configs train) gives the gradients of the plain
    backward bit for bit, and the same loss."""
    _, tapi, jp = fx("fake", 8)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tapi.cfg.vocab).items()}
    plain = microbatched_value_and_grad(_port_total(tapi, ALPHA))
    remat = microbatched_value_and_grad(_port_total(
        tbuild(dataclasses.replace(tapi.cfg, remat=True)), ALPHA))
    (l0, _), g0 = plain(_bridged(jp), tb)
    (l1, _), g1 = remat(_bridged(jp), tb)
    assert torch.equal(l0, l1)
    want = dict(tensor_leaves(g0))
    for path, g in tensor_leaves(g1):
        assert torch.equal(g, want[path]), path


def test_alpha_rounds_stop_when_quality_drops(fx):
    """With an ``eval_fn``, a round raises alpha only while the quality
    stays within ``quality_budget`` of the first round's (Alg. 1's outer
    loop): quality 1.0, 0.995, 0.9 gives two raises, then none."""
    _, tapi, jp = fx("fake", 32)
    quality = iter([1.0, 0.995, 0.9])
    tt = Trainer(tapi.loss, t_adamw(weight_decay=0.0), t_cos(2e-3, 3),
                 _bridged(jp),
                 TrainerConfig(total_steps=3, log_every=1,
                               requant_interval=0, alpha_round_steps=1,
                               delta_alpha=1e-3),
                 eval_fn=lambda p: next(quality))
    alphas = []
    data = make_lm_pipeline(tapi.cfg, 8, 2)
    for s in (1, 2, 3):
        tt.run(data, steps=s)
        alphas.append(float(tt.state.alpha))
    assert alphas == pytest.approx([1e-3, 2e-3, 2e-3])
    assert tt.baseline_quality == 1.0
