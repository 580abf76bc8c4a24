"""The port's CNN pipeline (``repro_torch.models.cnn``), held against the
JAX reference ``repro.models.cnn`` on trees carried across by the bridge
(ResNet-8 on 8x8 images, VGG-11 on 32x32: five 2x2 pools need 32 pixels;
B=2, 9x8 blocks; helpers in ``tests/torch_port_helpers.py``).

* ``_bn_apply`` within 1e-6 of the reference; the loss within 1e-6.
* The port's own init builds the reference's tree; ``quantized_leaves``
  names equal the reference's letter for letter; the init draws on its
  own generator; the matmul plan refuses a grid past the cap.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.state import quantized_leaves as j_qleaves  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.state import (quantized_leaves,  # noqa: E402
                                    tensor_leaves)
from repro_torch.kernels.tiling import matmul_plan  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serve.deploy import tree_leaves  # noqa: E402
from torch_port_helpers import (bridged, cnn_images, cnn_jinit,  # noqa: E402
                                CNN_MODELS, np_of)

torch.set_num_threads(2)


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


@pytest.mark.parametrize("model", ["resnet", "vgg"])
def test_init_tree_layout_matches_reference(model):
    """The port's own init builds the reference's tree: the same paths,
    shapes, static fields and quantized-leaf names."""
    qc = TQ(mode="bitplane", n_bits=8, act_bits=8)
    depth, _ = CNN_MODELS[model]
    init = cnn.resnet_init if model == "resnet" else cnn.vgg_init
    tp = init(qc, depth=depth, seed=0, device="cpu")
    jp = cnn_jinit(model, JQ(mode="bitplane", n_bits=8, act_bits=8))
    carried = bridged(jp)
    assert {p: tuple(t.shape) for p, t in tensor_leaves(tp)} == \
        {p: tuple(t.shape) for p, t in tensor_leaves(carried)}
    assert list(quantized_leaves(tp)) == list(j_qleaves(jp))
    metas = [x for x in tree_leaves(tp) if isinstance(x, cnn.ConvMeta)]
    assert metas == [x for x in tree_leaves(carried)
                     if isinstance(x, cnn.ConvMeta)]
    assert cnn.conv_matmuls(tp) == len(metas)
    assert cnn.conv_matmuls(tp) == (7 + 2 if model == "resnet" else 8)


def test_quantized_leaf_names_match_reference():
    jqc = JQ(mode="bitplane", n_bits=8, act_bits=8)
    jp = cnn_jinit("resnet", jqc)
    names = list(quantized_leaves(bridged(jp)))
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
    jp = cnn_jinit("resnet", jqc)
    x = cnn_images(8, b=4)
    labels = np.array([0, 3, 9, 3], np.int32)
    jl, jm = jcnn.cnn_loss(jcnn.resnet_apply, jp,
                           {"images": jnp.asarray(x),
                            "labels": jnp.asarray(labels)}, jqc)
    tl, tm = cnn.cnn_loss(cnn.resnet_apply, bridged(jp),
                          {"images": torch.from_numpy(x),
                           "labels": torch.from_numpy(labels)}, tqc)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tm["acc"]) == float(jm["acc"])
