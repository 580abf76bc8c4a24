"""The port's CNN pipeline (``repro_torch.models.cnn``), held against the
JAX reference ``repro.models.cnn`` on trees carried across by the bridge
(ResNet-8 on 8x8 images, VGG-11 on 32x32: five 2x2 pools need 32 pixels;
B=2, 9x8 blocks; helpers in ``tests/torch_port_helpers.py``).

* Deployed forwards (packed int8 / int4 and bit-plane) through the port's
  ``kernel``, ``ref`` and ``bitplane`` backends (the kernels' plain
  versions on the CPU) against the reference's ``pallas`` (interpret),
  ``ref`` and ``dense`` backends at the rtol / atol 2e-4 of
  ``tests/test_backend_parity.py``; the wire formats bit for bit.
* The tree walkers take lists, VGG's ``"M"`` and ``ConvMeta``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.state import quantized_leaves as j_qleaves  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.models.common import matmul_backend  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.state import (map_tensors, quant_nodes,  # noqa: E402
                                    tensor_leaves)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.common import prepare_params  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight, to_serving_params,
                                      tree_to)
from repro_torch.train.step import freeze_mask  # noqa: E402
from torch_port_helpers import (bridged, cnn_images, cnn_jinit,  # noqa: E402
                                np_of)

torch.set_num_threads(2)


def _deploy_pair(jp, bits, layout):
    jd = j_deploy(jp, bits, layout=layout)
    return jd, bridged(jd)


@pytest.fixture(scope="module")
def resnet_fake():
    """The reference's fake-mode ResNet-8 and its images, drawn once for
    both widths' deployed drives."""
    return cnn_jinit("resnet", JQ(mode="fake", n_bits=8)), cnn_images(8)


@pytest.mark.parametrize("bits", [8, 4])
def test_deployed_forward_matches_reference_backends(resnet_fake, bits):
    """Mirror of ``tests/test_backend_parity.py::test_cnn_forward_parity``
    across the packages: ResNet-8, fake-mode tree, 9x8 blocks."""
    jqc = JQ(mode="fake", n_bits=8)
    tqc = TQ(mode="fake", n_bits=8)
    jp, x = resnet_fake
    jsp, tsp = _deploy_pair(jp, bits, "packed")
    jbp, tbp = _deploy_pair(jp, bits, "bitplane")
    # the port's own deploy of the bridged QAT tree: the same wire bytes
    for jd, layout in ((jsp, "packed"), (jbp, "bitplane")):
        mine = to_serving_params(bridged(jp), bits, layout=layout,
                                 device="cpu")
        for (p, a), (q, b) in zip(tensor_leaves(mine),
                                  tensor_leaves(bridged(jd))):
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
    jp = cnn_jinit("vgg", jqc)
    x = cnn_images(32)
    for layout, be in (("packed", "kernel"), ("bitplane", "bitplane")):
        jd, td = _deploy_pair(jp, 8, layout)
        with matmul_backend("ref"):
            want = np.asarray(jcnn.vgg_apply(jd, jnp.asarray(x), jqc))
        got = cnn.vgg_apply(td, torch.from_numpy(x), tqc, be)
        np.testing.assert_allclose(np_of(got), want, rtol=2e-4, atol=2e-4,
                                   err_msg=layout)


def test_list_tree_walkers_and_bridge_round_trip():
    jqc = JQ(mode="bitplane", n_bits=8, act_bits=8)
    jp = cnn_jinit("vgg", jqc)
    tp = bridged(jp)
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
