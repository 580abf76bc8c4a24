"""The port's CNN pipeline (``repro_torch.models.cnn``), held against the
JAX reference ``repro.models.cnn`` on trees carried across by the bridge
(ResNet-8 on 8x8 images, VGG-11 on 32x32: five 2x2 pools need 32 pixels;
B=2, 9x8 blocks; helpers in ``tests/torch_port_helpers.py``).

``conv_to_2d`` / ``conv_from_2d`` and the SAME im2col patches (k in {1,
3}, stride in {1, 2}, odd and even sides) equal the reference's bit for
bit: both are pure data moves.  (The forwards are in
``test_torch_cnn_forward.py``, the deployed forwards in
``test_torch_cnn_deploy.py``, the trees and the loss in
``test_torch_cnn_tree.py``.)
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.blocking import conv_from_2d as j_from_2d  # noqa: E402
from repro.core.blocking import conv_to_2d as j_to_2d  # noqa: E402
from repro_torch.core.blocking import conv_from_2d, conv_to_2d  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from torch_port_helpers import np_of  # noqa: E402

torch.set_num_threads(2)


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
