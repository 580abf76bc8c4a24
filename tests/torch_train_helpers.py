"""Shared machinery of the tests that hold the port's training of a model
family against the JAX reference (tests/test_torch_train_moe.py,
tests/test_torch_train_encdec.py, tests/test_torch_train_families.py).

A family case is the registered ``arch`` at ``tiny(dtype="float32")``
with 9x8 blocks in both packages, the reference's ``init(PRNGKey(0))``
carried across through numpy, and a numpy-seeded batch of the family's
inputs (a vlm batch's ``vision_embeds``, an enc-dec batch's ``frames``,
both 0.1 x standard normal).  :func:`check_one_step` holds one step of it,
against one jitted call of the reference (:func:`ref_step`):

* ``api.loss``: the loss, ``ce`` and ``aux`` within ``LOSS_TOL``
  relative;
* the gradient of loss + regularizer (alpha ``ALPHA``) after
  ``freeze_mask``: ``ce`` within ``LOSS_TOL``, the port's regularizer
  within ``LOSS_TOL`` of its float64 value and the reference's (jitted:
  XLA reorders its f32 sums) within ``REG_TOL``; every leaf within ``LEAF_TOL`` of the leaf's largest
  reference magnitude (or a witness-set limit the caller names), frozen
  leaves zero in both, PACT ``beta_*`` within ``BETA_TOL`` of the port's
  own float64 gradient (tests/test_torch_train.py has the reason); the
  port's float64 gradient is computed beside every leaf and its error
  reported with any leaf that fails;
* one ``build_train_step`` step through SGD with weight decay 0.1 at a
  constant learning rate of ``LR`` (the frozen metadata decays: an 8-bit
  LUT entry reads 7.9984 after it), the reference's jitted step against
  the port's: metrics within ``LOSS_TOL`` (the regularizer within
  ``REG_TOL``; the bit statistics of the
  float64 sum: the reference's f32 sum of the decayed LUTs is 1.1e-5
  relative off on granite's tree), params within ``LEAF_TOL``;
* one maintenance, of the reference's stepped tree carried across, in
  both packages (:func:`check_maintenance`; a bit-plane tree's through
  :func:`drifted`): LUTs, masks and signs equal, weights, planes and
  scales within 1e-6 of the leaf's largest magnitude;
* the maintained tree deployed to packed int8 in both packages: every
  payload bit for bit, every scale within 1e-6 relative (the reference's
  deploy jitted: XLA folds a scale's division by 255 in another order,
  one f32 ulp).
"""
import dataclasses

import pytest

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import REGISTRY as JREG
from repro.models.api import build as jbuild
from repro.models.common import QuantConfig as JQ
from repro.optim import sgd as j_sgd
from repro.serve.deploy import to_serving_params as j_deploy
from repro.train import TrainState as JTrainState
from repro.train.step import build_maintenance_step as j_maint
from repro.train.step import build_train_step as j_step
from repro.train.step import freeze_mask as j_freeze
from repro.train.step import quant_reg_loss as j_reg
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import REGISTRY as TREG
from repro_torch.configs.base import QuantConfig as TQ
from repro_torch.core.state import map_tensors, tensor_leaves
from repro_torch.models.api import build as tbuild
from repro_torch.optim import sgd as t_sgd
from repro_torch.serve.deploy import to_serving_params as t_deploy
from repro_torch.train import TrainState, build_train_step
from repro_torch.train.step import (build_maintenance_step,
                                    microbatched_value_and_grad,
                                    quant_reg_loss)
from torch_port_helpers import np_of, tree_to_numpy

ALPHA = 1e-3
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
BETA_TOL = 5e-3
MAINT_TOL = 1e-6
REG_TOL = 1e-4
LR = 2e-3
FROZEN = (".mask", ".sign", ".bitwidth", ".scale")
EXACT = (".mask", ".sign", ".bitwidth")


def family_case(arch, mode="fake", act_bits=8, **over):
    """(reference api, port api, reference QAT tree) of ``arch`` tiny in
    f32 with ``over`` applied to both configs."""
    jcfg = JREG[arch].tiny(dtype="float32", **over).with_quant(
        JQ(mode=mode, n_bits=8, act_bits=act_bits))
    tcfg = TREG[arch].tiny(dtype="float32", **over).with_quant(
        TQ(mode=mode, n_bits=8, act_bits=act_bits))
    japi = jbuild(jcfg)
    return japi, tbuild(tcfg), jax.jit(japi.init)(jax.random.PRNGKey(0))


def family_batch(cfg, seed=1, b=2, s=16):
    """Next-token tokens / labels (b, s) from ``default_rng(seed)``, and
    the family's extra inputs from the same generator: a vlm batch's
    (b, vision_tokens, d_model) ``vision_embeds``, an enc-dec batch's
    (b, s, d_model) ``frames``."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    return batch


def bridged(jp):
    return params_from_numpy(tree_to_numpy(jp), device="cpu")


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in batch.items()}


def jleaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def leaf_err(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(np_of(got), np.float64) - want).max()) \
        / scale


def port_total(tapi, alpha=ALPHA):
    """The port's train-step objective, as ``build_train_step`` builds it
    (regularizer first)."""
    def fn(p, b):
        reg = quant_reg_loss(p, torch.tensor(alpha, dtype=torch.float32))
        loss, m = tapi.loss(p, b)
        return loss + reg, (m, reg)
    return fn


def ref_step(japi, jp, batch):
    """One jitted call of the reference: its gradient of loss +
    regularizer after ``freeze_mask``, beside one step of its own
    ``build_train_step`` (the jitted function's body) through SGD with
    weight decay 0.1 at ``LR``.  Returns ((total, (metrics, reg)), grads),
    the stepped params and the step's metrics."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = j_sgd(weight_decay=0.1)
    inner = j_step(japi.loss, jopt, lambda s: jnp.float32(LR)).__wrapped__

    def fn(p):
        loss, m = japi.loss(p, jb)
        reg = j_reg(p, jnp.float32(ALPHA))
        return loss + reg, (m, reg)

    def both(state):
        out, g = jax.value_and_grad(fn, has_aux=True)(state.params)
        new, met = inner(state, jb)
        return (out, j_freeze(g)), new.params, met
    return jax.jit(both)(JTrainState.create(jp, jopt, ALPHA))


def port_grads(tapi, params, batch, alpha=ALPHA):
    return microbatched_value_and_grad(port_total(tapi, alpha))(
        params, torch_batch(batch))


def float64_grads(tapi, jp, batch, alpha=ALPHA):
    """The port's regularizer and gradient leaves in float64 (params,
    compute and float inputs the same)."""
    cfg64 = dataclasses.replace(tapi.cfg, dtype="float64")
    p64 = map_tensors(lambda t: t.double() if t.is_floating_point() else t,
                      bridged(jp))
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in torch_batch(batch).items()}
    (_, (_, reg)), g = microbatched_value_and_grad(
        port_total(tbuild(cfg64), alpha))(p64, b64)
    return float(reg), dict(tensor_leaves(g))


def bit_stats64(jparams):
    """``quant_stats`` of a reference tree in float64: the live bits a
    weight and the compression against f32."""
    from repro.core.bitrep import QuantizedTensor as JQT
    from repro.core.blocking import block_elem_counts
    from repro.train.step import _quant_nodes
    bits = params = 0.0
    for q in _quant_nodes(jparams).values():
        elems = np.asarray(block_elem_counts((q.shape[-2], q.shape[-1]),
                                             q.spec), np.float64)
        bw = np.asarray(q.mask, np.float64).sum(0) if isinstance(q, JQT) \
            else np.asarray(q.bitwidth, np.float64)
        bits += float((bw * elems).sum())
        params += float(np.prod(q.shape))
    return dict(avg_bitwidth=bits / params, compression_x=32 * params / bits)


def check_one_step(japi, tapi, jp, batch, tol=LEAF_TOL):
    """The rules of the module docstring for one step of a family case.
    ``tol`` is a float or a dict of (leaf-name substring -> limit) over
    ``LEAF_TOL`` for the gradient leaves.  Returns the port's loss metrics
    and {path: (err vs the reference, port f32 vs f64, reference vs f64)}
    for every gradient leaf."""
    ((jtot, (jm, jr)), jg), jnew, jmet = ref_step(japi, jp, batch)
    (ttot, (tm, tr)), tg = port_grads(tapi, bridged(jp), batch)
    r64, g64 = float64_grads(tapi, jp, batch)
    # api.loss: the total less the regularizer, ce and aux
    for got, want in ((ttot - tr, jtot - jr), (tm["ce"], jm["ce"]),
                      (tm["aux"], jm["aux"])):
        want = float(want)
        assert abs(float(got) - want) <= LOSS_TOL * abs(want), (got, want)
    # the regularizer against its float64 value: under jit XLA reorders
    # the reference's large f32 sums (3e-5 relative on the bit-plane one,
    # tests/test_torch_train.py), so it is held to REG_TOL there
    assert abs(float(tr) - r64) <= LOSS_TOL * r64, (float(tr), r64)
    assert abs(float(jr) - r64) <= REG_TOL * r64, (float(jr), r64)
    jgl = jleaves(jg)
    t_leaves = dict(tensor_leaves(tg))
    assert t_leaves.keys() == jgl.keys()
    errs = {}
    for path, g in t_leaves.items():
        if path.endswith(FROZEN):
            assert not g.any() and not jgl[path].any(), path
            continue
        wit = (leaf_err(g, g64[path]), leaf_err(jgl[path], g64[path]))
        if "beta_" in path:
            assert max(wit) <= BETA_TOL, (path, wit)
            errs[path] = (None,) + wit
            continue
        limit = tol if isinstance(tol, float) else max(
            [LEAF_TOL] + [v for k, v in tol.items() if k in path])
        err = leaf_err(g, jgl[path])
        errs[path] = (err,) + wit
        assert err <= limit, (path, err, "f64 witness (port, ref):", wit)

    # one build_train_step step of the port against the reference's
    topt = t_sgd(weight_decay=0.1)
    state = TrainState.create(bridged(jp), topt, ALPHA)
    state, tmet = build_train_step(
        tapi.loss, topt, lambda s: torch.tensor(LR, dtype=torch.float32))(
        state, torch_batch(batch))
    for k in ("ce", "aux", "grad_norm"):
        want = float(jmet[k])
        assert abs(float(tmet[k]) - want) <= LOSS_TOL * max(abs(want),
                                                            1e-30), k
    want = float(jmet["reg"])
    assert abs(float(tmet["reg"]) - want) <= REG_TOL * want
    want = float(jmet["loss"] - jmet["reg"])
    assert abs(float(tmet["loss"] - tmet["reg"]) - want) <= \
        LOSS_TOL * abs(want)
    # the bit statistics against their float64 value on the reference's
    # stepped tree: the reference sums ~1e6 live bits a leaf in f32, which
    # after the decay reads 1.1e-5 relative off on granite's tree
    for k, v in bit_stats64(jnew).items():
        assert abs(float(tmet[k]) - v) <= LOSS_TOL * v, (k, float(tmet[k]),
                                                         v, float(jmet[k]))
    ref = jleaves(jnew)
    for path, p in tensor_leaves(state.params):
        assert leaf_err(p, ref[path]) <= LEAF_TOL, path
    bw = [v for k, v in ref.items() if k.endswith(".bitwidth")]
    assert not bw or 7.99 < max(float(v.max()) for v in bw) < 8.0, \
        max(float(v.max()) for v in bw)
    check_maintenance(jnew)
    return tm, errs


def check_maintenance(jparams):
    """One maintenance of the reference tree ``jparams`` in both packages
    (LUTs, masks and signs equal; weights, planes and scales within
    ``MAINT_TOL``), then the int8 deploy of the reference's maintained
    tree in both (payloads bit for bit,
    scales within ``MAINT_TOL``: the reference's deploy is jitted, and XLA
    folds a scale's division by 255 in another order, one f32 ulp)."""
    jm = jax.jit(lambda p: j_maint().__wrapped__(
        JTrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state={},
                    alpha=jnp.float32(0.0))).params)(jparams)
    tm = build_maintenance_step()(TrainState(step=0, params=bridged(jparams),
                                             opt_state={}))
    want = jleaves(jm)
    for path, p in tensor_leaves(tm.params):
        if path.endswith(EXACT):
            np.testing.assert_array_equal(np_of(p), want[path], path)
        else:
            assert leaf_err(p, want[path]) <= MAINT_TOL, path

    jdep = jleaves(jax.jit(lambda p: j_deploy(p, 8, validate=False))(jm))
    tdep = dict(tensor_leaves(t_deploy(bridged(jm), 8, device="cpu")))
    assert tdep.keys() == jdep.keys()
    for path, t in tdep.items():
        if path.endswith(".scale"):
            assert leaf_err(t, jdep[path]) <= MAINT_TOL, path
        else:
            np.testing.assert_array_equal(np_of(t), jdep[path], path)


def drifted(jp, seed=4):
    """A reference bit-plane tree with its planes drifted off binary
    (normal noise of 0.1, clipped at 0) and each block's mask cut to a
    width drawn from 0..8: what maintenance re-quantizes."""
    from repro.core.bitrep import QuantizedTensor as JQT
    rng = np.random.default_rng(seed)

    def drift(x):
        if not isinstance(x, JQT):
            return x
        planes = np.clip(np.asarray(x.planes) + rng.normal(
            scale=0.1, size=x.planes.shape), 0, None).astype(np.float32)
        bw = rng.integers(0, 9, size=x.mask.shape[1:])
        mask = (np.arange(8).reshape((8,) + (1,) * bw.ndim) < bw).astype(
            np.float32)
        return dataclasses.replace(x, planes=jnp.asarray(planes),
                                   mask=jnp.asarray(mask))
    return jax.tree_util.tree_map(drift, jp,
                                  is_leaf=lambda x: isinstance(x, JQT))


# the MoE family's module gradients (tests/test_torch_train_moe*.py)
GRAD_TOL = 1e-5                  # module gradients, relative to the largest


@pytest.fixture(autouse=True)
def moe_dispatch_back_to_ragged():
    """Each test leaves both packages' MoE dispatch on ``ragged``."""
    yield
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jmoe.GROUPED_IMPL["impl"] = "ragged"
    tmoe.GROUPED_IMPL["impl"] = "ragged"


def as_torch(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def assert_grad_close(got, want, tol=GRAD_TOL):
    assert leaf_err(got, want) <= tol, leaf_err(got, want)


def loss_weights(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
