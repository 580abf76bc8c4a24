"""The port's serving contracts (SW, BP, AT) and the checkpoint cold start,
held against the JAX reference.

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")`` with 9x8 blocks
(odd block-padded K: int4 pad nibbles, bit-plane byte-pad rows), the
reference's ``init(PRNGKey(0))`` deployed by the reference and carried
across through numpy.

* ``validate_serving_tree`` gives the reference's (rule, severity, path)
  findings on clean packed and bit-plane trees, on an undeployed tree
  (``SW0`` info), on each planted corruption of tests/test_analysis.py
  (and on a set pad nibble, a set byte-pad row and a NaN scale), and on a
  leaf it cannot read (``SW0``).  ``ServeEngine`` refuses a corrupt tree
  unless ``validate=False``, and warns as the reference's does;
  ``to_serving_params`` validates by default.
* AT1 and AT2 give the reference's findings.
* ``ModelAPI.abstract_params`` is the reference's ``eval_shape`` tree
  (paths, shapes, dtypes) on the ``meta`` device.
* Cold start: ``to_serving_params(path, template=..., stats=...)`` from a
  reference checkpoint is bit for bit the reference's cold start and the
  port's live deploy, packed int8 and int4 and bit-plane, with
  ``0 < peak_host_bytes < dense_tree_bytes``; a ``TrainState`` checkpoint
  streams its params only.
* ``repack_bitplane_leaf`` is the reference's bit for bit.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.ckpt.checkpoint as jck  # noqa: E402
import repro_torch.serve.deploy as tdeploy  # noqa: E402
from repro.analysis.contracts import (  # noqa: E402
    validate_allocation as j_at1, validate_draft_truncation as j_at2,
    validate_serving_tree as j_validate)
from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.serve.autotune import make_draft_params as j_draft  # noqa: E402
from repro.serve.deploy import BitplaneServingWeight as JBP  # noqa: E402
from repro.serve.deploy import ServingWeight as JSW  # noqa: E402
from repro.serve.deploy import repack_bitplane_leaf as j_repack  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro.serve.deploy import weight_stream_bytes as j_wsb  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro_torch.analysis.contracts import (  # noqa: E402
    validate_allocation, validate_draft_truncation, validate_serving_tree)
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointReader  # noqa: E402
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.state import tensor_leaves  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from repro_torch.serve.autotune import make_draft_params  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight, repack_bitplane_leaf,
                                      to_serving_params, weight_stream_bytes)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"


@pytest.fixture(scope="module")
def fx():
    jcfg = JREG[ARCH].tiny(dtype="float32").with_quant(
        JQ(mode="fake", n_bits=8, act_bits=8))
    tcfg = TREG[ARCH].tiny(dtype="float32").with_quant(
        TQ(mode="fake", n_bits=8, act_bits=8))
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    qat = japi.init(jax.random.PRNGKey(0))
    jdep = {(8, "packed"): j_deploy(qat, 8, layout="packed"),
            (4, "packed"): j_deploy(qat, 4, layout="packed"),
            (8, "bitplane"): j_deploy(qat, 8, layout="bitplane")}
    return dict(japi=japi, tapi=tapi, qat=qat, jdep=jdep,
                tqat=params_from_numpy(tree_to_numpy(qat), device="cpu"),
                tdep={k: params_from_numpy(tree_to_numpy(v), device="cpu")
                      for k, v in jdep.items()})


def _f(findings):
    return sorted((f.rule, f.severity, f.path) for f in findings)


def _mutate_first(tree, types, fn):
    """``tree`` with its first leaf of ``types`` (flatten order) replaced
    by ``fn(leaf)``."""
    done = []

    def walk(x):
        if isinstance(x, types):
            if done:
                return x
            done.append(1)
            return fn(x)
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        return x
    out = walk(tree)
    assert done
    return out


def _both(fx, key, jfn, tfn):
    """The reference's and the port's findings on the same corruption."""
    jbad = _mutate_first(fx["jdep"][key], (JSW, JBP), jfn)
    tbad = _mutate_first(fx["tdep"][key], (ServingWeight,
                                           BitplaneServingWeight), tfn)
    return _f(j_validate(jbad)), _f(validate_serving_tree(tbad))


def _jset(arr, index, value):
    return jnp.asarray(arr).at[index].set(value)


def _tset(t, index, value):
    t = t.clone()
    t[index] = value
    return t


@pytest.mark.parametrize("key", [(8, "packed"), (4, "packed"),
                                 (8, "bitplane")])
def test_clean_trees_match_reference(fx, key):
    assert _f(validate_serving_tree(fx["tdep"][key])) == \
        _f(j_validate(fx["jdep"][key])) == []
    ported = to_serving_params(fx["tqat"], key[0], layout=key[1],
                               device="cpu")
    assert _f(validate_serving_tree(ported)) == []


def test_undeployed_tree_is_vacuous(fx):
    assert _f(validate_serving_tree(fx["tqat"])) == \
        _f(j_validate(fx["qat"])) == [("SW0", "info", "<tree>")]


BP_CORRUPTIONS = {
    "trailing-stack-dims": (
        lambda bp: dataclasses.replace(bp, planes=jnp.moveaxis(bp.planes, 0,
                                                               -1)),
        lambda bp: dataclasses.replace(bp, planes=torch.movedim(bp.planes,
                                                                0, -1))),
    "wrong-mask-lut-shape": (
        lambda bp: dataclasses.replace(bp, mask=bp.mask[..., :1]),
        lambda bp: dataclasses.replace(bp, mask=bp.mask[..., :1])),
    "non-binary-mask": (
        lambda bp: dataclasses.replace(bp, mask=bp.mask * 2.0),
        lambda bp: dataclasses.replace(bp, mask=bp.mask * 2.0)),
    "non-monotone-mask": (
        lambda bp: dataclasses.replace(
            bp, mask=bp.mask.at[..., 0, :, :].set(0.0)),
        lambda bp: dataclasses.replace(
            bp, mask=_tset(bp.mask, (..., 0, slice(None), slice(None)),
                           0.0))),
    "truncated-sign-plane": (
        lambda bp: dataclasses.replace(bp, sign=bp.sign[..., :-1, :]),
        lambda bp: dataclasses.replace(bp, sign=bp.sign[..., :-1, :])),
    "byte-pad-row-set": (
        lambda bp: dataclasses.replace(
            bp, sign=_jset(bp.sign, (0, -1, 0), 0x80)),
        lambda bp: dataclasses.replace(
            bp, sign=_tset(bp.sign, (0, -1, 0), 0x80))),
    "nan-scale": (
        lambda bp: dataclasses.replace(
            bp, scale=_jset(bp.scale, (0, 0, 0), np.nan)),
        lambda bp: dataclasses.replace(
            bp, scale=_tset(bp.scale, (0, 0, 0), float("nan")))),
    "occupancy-over-container": (
        lambda bp: dataclasses.replace(bp, bits=4),
        lambda bp: dataclasses.replace(bp, bits=4)),
}


@pytest.mark.parametrize("name", sorted(BP_CORRUPTIONS))
def test_bitplane_corruption_matches_reference(fx, name):
    jfn, tfn = BP_CORRUPTIONS[name]
    want, got = _both(fx, (8, "bitplane"), jfn, tfn)
    assert got == want
    assert [f for f in got if f[1] == "error"], name


PACKED_CORRUPTIONS = {
    "wrong-scale-lut-shape": (8, lambda sw: dataclasses.replace(
        sw, scale=sw.scale[..., :1]), None),
    "wrong-payload-dtype": (8, lambda sw: dataclasses.replace(
        sw, w_int=sw.w_int.astype(jnp.int32)),
        lambda sw: dataclasses.replace(sw, w_int=sw.w_int.to(torch.int32))),
    "trailing-stack-dims": (8, lambda sw: dataclasses.replace(
        sw, w_int=jnp.moveaxis(sw.w_int, 0, -1)),
        lambda sw: dataclasses.replace(sw, w_int=torch.movedim(sw.w_int, 0,
                                                               -1))),
    "int4-pad-nibble-set": (4, lambda sw: dataclasses.replace(
        sw, w_int=_jset(sw.w_int, (0, -1, 0), 0x70)),
        lambda sw: dataclasses.replace(
            sw, w_int=_tset(sw.w_int, (0, -1, 0), 0x70))),
    "unknown-bits": (8, lambda sw: dataclasses.replace(sw, bits=6), None),
    "uninterpretable-shape": (8, lambda sw: dataclasses.replace(
        sw, shape=None), None),
}


@pytest.mark.parametrize("name", sorted(PACKED_CORRUPTIONS))
def test_packed_corruption_matches_reference(fx, name):
    bits, jfn, tfn = PACKED_CORRUPTIONS[name]
    want, got = _both(fx, (bits, "packed"), jfn, tfn or jfn)
    assert got == want
    assert [f for f in got if f[1] == "error"], name


def test_engine_refuses_corrupt_tree_and_warns(fx):
    tapi = fx["tapi"]
    bad = _mutate_first(fx["tdep"][(8, "bitplane")], BitplaneServingWeight,
                        lambda bp: dataclasses.replace(bp,
                                                       mask=bp.mask * 2.0))
    with pytest.raises(ValueError, match="serving contract"):
        ServeEngine(tapi, bad, backend="bitplane", device="cpu")
    eng = ServeEngine(tapi, bad, backend="bitplane", device="cpu",
                      validate=False)
    assert eng.backend == "bitplane"
    with pytest.warns(UserWarning, match="only accelerates deployed"):
        ServeEngine(tapi, fx["tqat"], backend="kernel", device="cpu")
    with pytest.warns(UserWarning, match="fall back"):
        ServeEngine(tapi, fx["tdep"][(8, "packed")], backend="bitplane",
                    device="cpu")


def test_deploy_validates_by_default(fx, monkeypatch):
    real = tdeploy._pack_bitplane

    def broken(*a, **k):
        sw = real(*a, **k)
        return dataclasses.replace(sw, mask=sw.mask * 2.0)
    monkeypatch.setattr(tdeploy, "_pack_bitplane", broken)
    with pytest.raises(ValueError, match="contract-violating"):
        to_serving_params(fx["tqat"], 8, layout="bitplane", device="cpu")
    to_serving_params(fx["tqat"], 8, layout="bitplane", device="cpu",
                      validate=False)


def test_allocation_and_draft_contracts_match_reference(fx):
    jbp, tbp = fx["jdep"][(8, "bitplane")], fx["tdep"][(8, "bitplane")]
    total = weight_stream_bytes(tbp)
    assert total == j_wsb(jbp)
    for budget in (total, total - 1):
        assert _f(validate_allocation(tbp, budget)) == \
            _f(j_at1(jbp, budget))
    assert _f(validate_allocation(tbp, total - 1)) == \
        [("AT1", "error", "<tree>")]
    for k in (1, 3, 9):
        assert _f(validate_draft_truncation(make_draft_params(tbp, k),
                                            tbp)) == \
            _f(j_at2(j_draft(jbp, k), jbp)) == []
    # a copied payload is a warning; a mask that is not a top-k view an
    # error: the same findings in both packages
    jd = _mutate_first(j_draft(jbp, 2), JBP, lambda x: dataclasses.replace(
        x, planes=jnp.array(x.planes), mask=x.mask.at[..., 0, 0, 0].set(
            1.0 - x.mask[..., 0, 0, 0])))
    td = _mutate_first(make_draft_params(tbp, 2), BitplaneServingWeight,
                       lambda x: dataclasses.replace(
                           x, planes=x.planes.clone(),
                           mask=_tset(x.mask, (..., 0, 0, 0),
                                      1.0 - x.mask[..., 0, 0, 0])))
    got = _f(validate_draft_truncation(td, tbp))
    assert got == _f(j_at2(jd, jbp))
    assert {(r, s) for r, s, _ in got} == {("AT2", "warning"),
                                           ("AT2", "error")}


def test_abstract_params_is_the_reference_template(fx):
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(
                fx["japi"].abstract_params())[0]}
    tmpl = fx["tapi"].abstract_params()
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tensor_leaves(tmpl)}
    assert got == want
    assert all(t.device.type == "meta" for _, t in tensor_leaves(tmpl))


def _same_tree(a, b):
    la, lb = dict(tensor_leaves(a)), dict(tensor_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("bits,layout", [(8, "packed"), (4, "packed"),
                                         (8, "bitplane")])
def test_cold_start_matches_reference_and_live_deploy(fx, tmp_path, bits,
                                                      layout):
    p = str(tmp_path / "ck")
    jck.save_tree(fx["qat"], p)
    stats = {}
    got = to_serving_params(p, bits, layout=layout, device="cpu",
                            template=fx["tapi"].abstract_params(),
                            stats=stats)
    assert 0 < stats["peak_host_bytes"] < stats["dense_tree_bytes"]
    assert stats["source"] == p
    jstats = {}
    want = j_deploy(p, bits, layout=layout,
                    template=fx["japi"].abstract_params(), stats=jstats)
    assert {k: stats[k] for k in jstats} == jstats
    _same_tree(got, params_from_numpy(tree_to_numpy(want), device="cpu"))
    _same_tree(got, to_serving_params(fx["tqat"], bits, layout=layout,
                                      device="cpu"))


def test_trainstate_checkpoint_streams_params_only(fx, tmp_path,
                                                   monkeypatch):
    p = str(tmp_path / "ck")
    state = JTrainState.create(fx["qat"], j_sgd(momentum=0.9,
                                                weight_decay=0.0), 0.0)
    jck.save_tree(state, p)
    read, real = [], CheckpointReader.read

    def spy(self, key):
        read.append(key)
        return real(self, key)
    monkeypatch.setattr(CheckpointReader, "read", spy)
    got = to_serving_params(p, 8, layout="bitplane", device="cpu",
                            template=fx["tapi"].abstract_params())
    assert read and all(k.startswith(".params") for k in read)
    _same_tree(got, to_serving_params(fx["tqat"], 8, layout="bitplane",
                                      device="cpu"))


def test_cold_start_needs_a_template(fx, tmp_path):
    with pytest.raises(ValueError, match="template"):
        to_serving_params(str(tmp_path), 8, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_repack_bitplane_leaf_bit_exact(fx, seed):
    """Random occupancies at or below each block's deployed one, on the
    stacked (2, ...) leaves of the tiny tree (odd Kp: byte-pad rows)."""
    rng = np.random.default_rng(seed)
    jtree, ttree = fx["jdep"][(8, "bitplane")], fx["tdep"][(8, "bitplane")]
    for sub, name in (("attn", "wq"), ("mlp", "w_down")):
        jl, tl = jtree["layers"][sub][name], ttree["layers"][sub][name]
        occ = np.asarray(jl.mask).sum(axis=-3)
        new = np.floor(occ * rng.uniform(0, 1, occ.shape))
        new[..., 0, 0] = occ[..., 0, 0]              # full blocks too
        want = j_repack(jl, new)
        got = repack_bitplane_leaf(tl, torch.from_numpy(new))
        for f in ("planes", "sign", "mask", "scale"):
            a, b = np_of(getattr(got, f)), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
    with pytest.raises(ValueError, match="occupancy"):
        repack_bitplane_leaf(tl, torch.from_numpy(occ + 1))
