"""The port's CNN pipeline (``repro_torch.models.cnn``), held against the
JAX reference ``repro.models.cnn`` on trees carried across by the bridge.

Sizes: ResNet-8 on 8x8 images, VGG-11 on 32x32 (five 2x2 pools need 32
pixels), B=2, 9x8 blocks.

* ``conv_to_2d`` / ``conv_from_2d`` and the SAME im2col patches (k in {1,
  3}, stride in {1, 2}, odd and even sides) equal the reference's bit for
  bit: both are pure data moves.
* ``_bn_apply`` within 1e-6 of the reference; forwards in modes none,
  fake and bit-plane (activations at 32 and 8 bits) within ``FWD_TOL`` of
  the largest |logit|.
* Deployed forwards (packed int8 / int4 and bit-plane) through the port's
  ``kernel``, ``ref`` and ``bitplane`` backends (the kernels' plain
  versions on the CPU) against the reference's ``pallas`` (interpret),
  ``ref`` and ``dense`` backends at the rtol / atol 2e-4 of
  ``tests/test_backend_parity.py``; the wire formats bit for bit.
* The tree walkers take lists, VGG's ``"M"`` and ``ConvMeta``;
  ``quantized_leaves`` names equal the reference's letter for letter.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.blocking import conv_from_2d as j_from_2d  # noqa: E402
from repro.core.blocking import conv_to_2d as j_to_2d  # noqa: E402
from repro.core.state import quantized_leaves as j_qleaves  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.models.common import matmul_backend  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.blocking import conv_from_2d, conv_to_2d  # noqa: E402
from repro_torch.core.state import (map_tensors, quant_nodes,  # noqa: E402
                                    quantized_leaves, tensor_leaves)
from repro_torch.kernels.tiling import matmul_plan  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.common import prepare_params  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight, to_serving_params,
                                      tree_leaves, tree_to)
from repro_torch.train.step import freeze_mask  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
FWD_TOL = 1e-5
MODELS = {"resnet": (8, 8), "vgg": (11, 32)}     # depth, image side


def _bridged(jp):
    return params_from_numpy(tree_to_numpy(jp), device="cpu")


def _images(side, b=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, side, side, 3)).astype(np.float32)


def _jinit(model, qc):
    depth, _ = MODELS[model]
    init = jcnn.resnet_init if model == "resnet" else jcnn.vgg_init
    return init(jax.random.PRNGKey(0), qc, depth=depth)


def _apply(model):
    return ((jcnn.resnet_apply, cnn.resnet_apply) if model == "resnet"
            else (jcnn.vgg_apply, cnn.vgg_apply))


def _rel_err(got, want):
    got, want = np_of(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_conv_to_2d_matches_reference():
    w = np.random.default_rng(0).standard_normal((5, 3, 3, 2)).astype(
        np.float32)
    want = np.asarray(j_to_2d(jnp.asarray(w)))
    got = conv_to_2d(torch.from_numpy(w))
    assert got.shape == (18, 5)
    np.testing.assert_array_equal(np_of(got), want)
    np.testing.assert_array_equal(
        np_of(conv_from_2d(got, w.shape)),
        np.asarray(j_from_2d(jnp.asarray(want), w.shape)))
    np.testing.assert_array_equal(np_of(conv_from_2d(got, w.shape)), w)


@pytest.mark.parametrize("side", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_im2col_patches_match_reference(k, stride, side):
    x = np.random.default_rng(k * 10 + stride).standard_normal(
        (2, side, side + 1, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = np_of(cnn.im2col(torch.from_numpy(x), k, stride))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_same_padding_is_asymmetric_at_stride_two():
    # JAX's SAME: 32 -> 16 with k=3, s=2 pads 0 before and 1 after
    assert cnn.same_pads(32, 3, 2) == (0, 1)
    assert cnn.same_pads(32, 1, 2) == (0, 0)
    assert cnn.same_pads(7, 3, 1) == (1, 1)
    assert cnn.same_pads(7, 3, 2) == (1, 1)


def test_bn_apply_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 4, 6)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    want = np.asarray(jcnn._bn_apply({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x)))
    got = cnn._bn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    np.testing.assert_allclose(np_of(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,act_bits", [
    ("none", 32), ("fake", 32), ("fake", 8), ("bitplane", 32),
    ("bitplane", 8)])
@pytest.mark.parametrize("model", ["resnet", "vgg"])
def test_forward_matches_reference(model, mode, act_bits):
    jqc = JQ(mode=mode, n_bits=8, act_bits=act_bits)
    tqc = TQ(mode=mode, n_bits=8, act_bits=act_bits)
    jp = _jinit(model, jqc)
    x = _images(MODELS[model][1])
    japply, tapply = _apply(model)
    want = japply(jp, jnp.asarray(x), jqc)
    got = tapply(_bridged(jp), torch.from_numpy(x), tqc)
    assert got.shape == (2, 10)
    assert _rel_err(got, want) <= FWD_TOL


@pytest.mark.parametrize("model", ["resnet", "vgg"])
def test_init_tree_layout_matches_reference(model):
    """The port's own init builds the reference's tree: the same paths,
    shapes, static fields and quantized-leaf names."""
    qc = TQ(mode="bitplane", n_bits=8, act_bits=8)
    depth, _ = MODELS[model]
    init = cnn.resnet_init if model == "resnet" else cnn.vgg_init
    tp = init(qc, depth=depth, seed=0, device="cpu")
    jp = _jinit(model, JQ(mode="bitplane", n_bits=8, act_bits=8))
    bridged = _bridged(jp)
    assert {p: tuple(t.shape) for p, t in tensor_leaves(tp)} == \
        {p: tuple(t.shape) for p, t in tensor_leaves(bridged)}
    assert list(quantized_leaves(tp)) == list(j_qleaves(jp))
    metas = [x for x in tree_leaves(tp) if isinstance(x, cnn.ConvMeta)]
    assert metas == [x for x in tree_leaves(bridged)
                     if isinstance(x, cnn.ConvMeta)]
    assert cnn.conv_matmuls(tp) == len(metas)
    assert cnn.conv_matmuls(tp) == (7 + 2 if model == "resnet" else 8)


def _deploy_pair(jp, bits, layout):
    jd = j_deploy(jp, bits, layout=layout)
    return jd, _bridged(jd)


@pytest.mark.parametrize("bits", [8, 4])
def test_deployed_forward_matches_reference_backends(bits):
    """Mirror of ``tests/test_backend_parity.py::test_cnn_forward_parity``
    across the packages: ResNet-8, fake-mode tree, 9x8 blocks."""
    jqc = JQ(mode="fake", n_bits=8)
    tqc = TQ(mode="fake", n_bits=8)
    jp = _jinit("resnet", jqc)
    x = _images(8)
    jsp, tsp = _deploy_pair(jp, bits, "packed")
    jbp, tbp = _deploy_pair(jp, bits, "bitplane")
    # the port's own deploy of the bridged QAT tree: the same wire bytes
    for jd, layout in ((jsp, "packed"), (jbp, "bitplane")):
        mine = to_serving_params(_bridged(jp), bits, layout=layout,
                                 device="cpu")
        for (p, a), (q, b) in zip(tensor_leaves(mine),
                                  tensor_leaves(_bridged(jd))):
            assert p == q
            np.testing.assert_array_equal(np_of(a), np_of(b), err_msg=p)
    want = {}
    for be, p in (("dense", jsp), ("pallas", jsp), ("ref", jsp),
                  ("bitplane", jbp)):
        with matmul_backend(be):
            want[be] = np.asarray(jcnn.resnet_apply(p, jnp.asarray(x), jqc))
    xt = torch.from_numpy(x)
    for be, p in (("kernel", tsp), ("ref", tsp), ("dense", tsp),
                  ("bitplane", tbp), ("kernel", tbp), ("ref", tbp)):
        got = np_of(cnn.resnet_apply(p, xt, tqc, be))
        for jbe, ref in want.items():
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4,
                                       err_msg=f"int{bits} {be} vs {jbe}")


def test_deployed_vgg_matches_reference():
    """VGG-11 (bit-plane tree, 8-bit PACT) deployed int8 and bit-plane:
    the port's kernel backends against the reference's ``ref``."""
    jqc = JQ(mode="bitplane", n_bits=8, act_bits=8)
    tqc = TQ(mode="bitplane", n_bits=8, act_bits=8)
    jp = _jinit("vgg", jqc)
    x = _images(32)
    for layout, be in (("packed", "kernel"), ("bitplane", "bitplane")):
        jd, td = _deploy_pair(jp, 8, layout)
        with matmul_backend("ref"):
            want = np.asarray(jcnn.vgg_apply(jd, jnp.asarray(x), jqc))
        got = cnn.vgg_apply(td, torch.from_numpy(x), tqc, be)
        np.testing.assert_allclose(np_of(got), want, rtol=2e-4, atol=2e-4,
                                   err_msg=layout)


def test_list_tree_walkers_and_bridge_round_trip():
    jqc = JQ(mode="bitplane", n_bits=8, act_bits=8)
    jp = _jinit("vgg", jqc)
    tp = _bridged(jp)
    layers = tp["layers"]
    assert isinstance(layers, list) and layers[1] == "M"
    assert isinstance(layers[0]["conv"]["meta"], cnn.ConvMeta)
    # tensor leaves: the reference's flatten order and keystr paths (its
    # flatten also yields the "M" strings as leaves)
    arrays = [(jax.tree_util.keystr(p), a) for p, a in
              jax.tree_util.tree_flatten_with_path(jp)[0]
              if not isinstance(a, str)]
    assert [p for p, _ in tensor_leaves(tp)] == [p for p, _ in arrays]
    for (p, t), (_, a) in zip(tensor_leaves(tp), arrays):
        np.testing.assert_array_equal(np_of(t), np.asarray(a), err_msg=p)
    # map_tensors keeps lists, "M" and ConvMeta (the same object)
    twice = map_tensors(lambda t: t * 2, tp)
    assert twice["layers"][1] == "M"
    assert twice["layers"][0]["conv"]["meta"] is layers[0]["conv"]["meta"]
    assert torch.equal(twice["head_w"], tp["head_w"] * 2)
    summed = map_tensors(lambda a, b: a + b, tp, tp)
    assert torch.equal(summed["layers"][0]["bn"]["scale"],
                       2 * tp["layers"][0]["bn"]["scale"])
    # quantized nodes, prepare_params, freeze_mask, tree_to
    assert list(quant_nodes(tp)) == list(j_qleaves(jp))
    prepped = prepare_params(tp)
    assert isinstance(prepped["layers"][0]["conv"]["qt"], torch.Tensor)
    assert prepped["layers"][1] == "M"
    frozen = freeze_mask(map_tensors(torch.ones_like, tp))
    qt = frozen["layers"][0]["conv"]["qt"]
    assert not qt.mask.any() and not qt.sign.any() and qt.planes.all()
    assert frozen["layers"][1] == "M" and frozen["head_w"].all()
    moved = tree_to(tp, "cpu")
    assert moved["layers"][1] == "M" and isinstance(
        moved["layers"][0]["conv"]["meta"], cnn.ConvMeta)
    # deployed trees keep the list, "M" and ConvMeta
    dep = to_serving_params(tp, 8, device="cpu")
    assert isinstance(dep["layers"][0]["conv"]["qt"], ServingWeight)
    assert dep["layers"][1] == "M"
    bp = to_serving_params(tp, 8, layout="bitplane", device="cpu")
    assert isinstance(bp["layers"][0]["conv"]["qt"], BitplaneServingWeight)
    assert bp["layers"][0]["conv"]["meta"] == layers[0]["conv"]["meta"]


def test_quantized_leaf_names_match_reference():
    jqc = JQ(mode="bitplane", n_bits=8, act_bits=8)
    jp = _jinit("resnet", jqc)
    names = list(quantized_leaves(_bridged(jp)))
    assert names == list(j_qleaves(jp))
    assert names[0] == "['blocks'][0]['conv1']['qt']"
    assert names[-1] == "['stem']['qt']"


def test_port_init_draws_on_its_generator():
    qc = TQ(mode="fake", n_bits=8)
    a = cnn.resnet_init(qc, depth=8, seed=1, device="cpu")
    b = cnn.resnet_init(qc, depth=8, seed=1, device="cpu")
    c = cnn.resnet_init(qc, depth=8, seed=2, device="cpu")
    for (p, x), (_, y) in zip(tensor_leaves(a), tensor_leaves(b)):
        assert torch.equal(x, y), p
    assert not torch.equal(a["head_w"], c["head_w"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.resnet_init(qc, depth=8)


def test_matmul_plan_refuses_a_grid_past_the_cap():
    """The tensor regime's row tiles go on grid.y (at most 65,535): the
    largest CNN product (M = 131,072 at B=128) fits, one past the cap is
    refused rather than wrapped."""
    plan = matmul_plan(128 * 32 * 32, 576, 64, unit=1, wbr=9)
    assert plan.regime == "tensor" and plan.tiles_m == 1024
    assert plan.tiles_m * plan.rows >= 131072
    with pytest.raises(ValueError, match="65535"):
        matmul_plan(65535 * 128 + 1, 27, 16, unit=8, wbr=9)


def test_cnn_loss_matches_reference():
    jqc = JQ(mode="bitplane", n_bits=8, act_bits=32)
    tqc = dataclasses.replace(TQ(), mode="bitplane", n_bits=8)
    jp = _jinit("resnet", jqc)
    x = _images(8, b=4)
    labels = np.array([0, 3, 9, 3], np.int32)
    jl, jm = jcnn.cnn_loss(jcnn.resnet_apply, jp,
                           {"images": jnp.asarray(x),
                            "labels": jnp.asarray(labels)}, jqc)
    tl, tm = cnn.cnn_loss(cnn.resnet_apply, _bridged(jp),
                          {"images": torch.from_numpy(x),
                           "labels": torch.from_numpy(labels)}, tqc)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tm["acc"]) == float(jm["acc"])
