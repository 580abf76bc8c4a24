"""The port's CNN pipeline (``repro_torch.models.cnn``), held against the
JAX reference ``repro.models.cnn`` on trees carried across by the bridge
(ResNet-8 on 8x8 images, VGG-11 on 32x32: five 2x2 pools need 32 pixels;
B=2, 9x8 blocks; helpers in ``tests/torch_port_helpers.py``).

Forwards in modes none, fake and bit-plane (activations at 32 and 8
bits) within ``FWD_TOL`` of the largest |logit|.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from torch_port_helpers import (bridged, cnn_images, cnn_jinit,  # noqa: E402
                                CNN_MODELS, np_of)

torch.set_num_threads(2)
FWD_TOL = 1e-5


def _apply(model):
    return ((jcnn.resnet_apply, cnn.resnet_apply) if model == "resnet"
            else (jcnn.vgg_apply, cnn.vgg_apply))


def _rel_err(got, want):
    got, want = np_of(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode,act_bits", [
    ("none", 32), ("fake", 32), ("fake", 8), ("bitplane", 32),
    ("bitplane", 8)])
@pytest.mark.parametrize("model", ["resnet", "vgg"])
def test_forward_matches_reference(model, mode, act_bits):
    jqc = JQ(mode=mode, n_bits=8, act_bits=act_bits)
    tqc = TQ(mode=mode, n_bits=8, act_bits=act_bits)
    jp = cnn_jinit(model, jqc)
    x = cnn_images(CNN_MODELS[model][1])
    japply, tapply = _apply(model)
    want = japply(jp, jnp.asarray(x), jqc)
    got = tapply(bridged(jp), torch.from_numpy(x), tqc)
    assert got.shape == (2, 10)
    assert _rel_err(got, want) <= FWD_TOL
