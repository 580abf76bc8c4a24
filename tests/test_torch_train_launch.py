"""The port's train launcher and the deploy of a bit-plane-mode tree.

* ``python -m repro_torch.launch.train`` (``main``) trains tiny phi3 on
  the CPU, logging finite values; its weight-block geometry follows the
  serve launcher's rule (tiny: the reference launcher's 9x8; ``--no-tiny``:
  the registered 8x128), and flags the port lacks are refused.
* A ``QuantizedTensor`` tree (the reference's bit-plane-mode init, with
  drifted planes and mixed masks) deploys to the packed (int8, int4) and
  bit-plane layouts equal to the reference's ``to_serving_params`` bit
  for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.core.bitrep import QuantizedTensor as JQT  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch import train as tl  # noqa: E402
from repro_torch.serve.deploy import \
    to_serving_params as t_deploy  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"


def test_launcher_trains_on_cpu(capsys):
    """4 steps of fake-mode QAT with maintenance and an alpha round at
    steps 2 and 4: every logged value is finite, the loss includes a
    regularizer once alpha is raised, and precision only drops."""
    trainer = tl.main(["--arch", ARCH, "--steps", "4", "--device", "cpu",
                       "--requant-every", "2", "--seq", "32", "--batch",
                       "2"])
    hist = trainer.history
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    for h in hist:
        assert all(np.isfinite(v) for v in h.values()), h
    assert hist[0]["reg"] == 0.0 and hist[-1]["reg"] > 0
    assert float(trainer.state.alpha) == pytest.approx(2e-3)
    assert hist[-1]["avg_bitwidth"] <= hist[0]["avg_bitwidth"] <= 8.0
    assert trainer.state.step == 4
    assert "ce=" in capsys.readouterr().out


def test_launcher_bitplane_mode_and_depth():
    """Bit-plane mode with the depth cut to 1 layer: the trained tree is
    ``QuantizedTensor`` leaves whose planes are exact binary after the
    maintenance step."""
    trainer = tl.main(["--arch", ARCH, "--steps", "2", "--device", "cpu",
                       "--requant-every", "2", "--seq", "16", "--batch",
                       "2", "--quant-mode", "bitplane", "--layers", "1"])
    wq = trainer.state.params["layers"]["attn"]["wq"]
    assert type(wq).__name__ == "QuantizedTensor"
    assert wq.planes.shape[1] == 1
    assert set(torch.unique(wq.planes).tolist()) <= {0.0, 1.0}
    assert all(np.isfinite(h["ce"]) for h in trainer.history)


def test_launcher_geometry_and_flags():
    """Tiny takes 9x8 blocks, ``--no-tiny`` the registered 8x128 (the
    reference launcher's full width takes 9x8: a recorded divergence);
    ``--quant-mode none`` turns quantization off; ``--ckpt-dir`` is taken
    (tests/test_torch_ckpt.py drives it), and so are the reference's
    ``--mesh`` and the port's ``--mesh-shape`` (tests/
    test_torch_sharded_train.py drives them); ``--mesh single`` without a
    process group of 256 ranks fails with ``make_mesh``'s error."""
    parse = tl.build_parser().parse_args
    tiny = tl.config(parse(["--arch", ARCH]))
    full = tl.config(parse(["--arch", ARCH, "--no-tiny", "--act-bits",
                            "6"]))
    assert (tiny.quant.wb_rows, tiny.quant.wb_cols) == (9, 8)
    assert (full.quant.wb_rows, full.quant.wb_cols) == (8, 128)
    assert full.n_layers == 32 and full.d_model == 3072 and full.remat
    assert full.quant.act_bits == 6 and full.quant.mode == "fake"
    jtiny = JREG[ARCH].tiny(dtype="float32").with_quant(
        JQ(mode="fake", n_bits=8, act_bits=8))
    for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab", "remat"):
        assert getattr(tiny, f) == getattr(jtiny, f), f
    assert not tl.config(parse(["--arch", ARCH, "--quant-mode",
                                "none"])).quant.enabled
    assert tl.config(parse(["--arch", ARCH, "--layers", "1"])).n_layers == 1
    assert parse(["--arch", ARCH, "--ckpt-dir", "run"]).ckpt_dir == "run"
    assert parse(["--arch", ARCH]).ckpt_dir is None
    assert parse(["--arch", ARCH]).mesh == "none"
    assert parse(["--arch", ARCH, "--mesh", "single"]).mesh == "single"
    assert parse(["--arch", ARCH, "--mesh-shape", "2,1"]).mesh_shape == \
        "2,1"
    with pytest.raises(SystemExit):
        parse(["--arch", ARCH, "--mesh", "pod"])
    with pytest.raises(RuntimeError, match="initialized process group"):
        tl.make_mesh_of(parse(["--arch", ARCH, "--mesh", "single",
                               "--device", "cpu"]))


def _drifted_qat():
    """The reference's bit-plane-mode tiny init with planes drifted off
    binary and each block's mask cut to a width drawn from 0..8."""
    cfg = JREG[ARCH].tiny(dtype="float32").with_quant(
        JQ(mode="bitplane", n_bits=8, act_bits=8))
    qat = jbuild(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)

    def drift(x):
        if not isinstance(x, JQT):
            return x
        planes = np.clip(np.asarray(x.planes) + rng.normal(
            scale=0.1, size=x.planes.shape), 0, None).astype(np.float32)
        bw = rng.integers(0, 9, size=x.mask.shape[1:])
        mask = (np.arange(8).reshape((8,) + (1,) * bw.ndim) < bw).astype(
            np.float32)
        return JQT(planes=jnp.asarray(planes), sign=x.sign, scale=x.scale,
                   mask=jnp.asarray(mask), shape=x.shape, spec=x.spec)
    return jax.tree_util.tree_map(drift, qat,
                                  is_leaf=lambda x: isinstance(x, JQT))


@pytest.mark.parametrize("bits,layout", [(8, "packed"), (4, "packed"),
                                         (8, "bitplane")])
def test_quantized_tensor_deploy_bit_exact(bits, layout):
    qat = _drifted_qat()
    want = tree_to_numpy(j_deploy(qat, bits, layout=layout))
    got = t_deploy(params_from_numpy(tree_to_numpy(qat), device="cpu"),
                   bits, layout=layout, device="cpu")

    def walk(w, g, path=""):
        if isinstance(w, dict) and "shape" not in w:
            assert w.keys() == g.keys(), path
            for k in w:
                walk(w[k], g[k] if isinstance(g, dict) else getattr(g, k),
                     f"{path}/{k}")
            return
        if isinstance(w, dict):
            assert tuple(g.shape) == tuple(w["shape"]), path
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(np_of(getattr(g, k)), v,
                                                  err_msg=f"{path}.{k}")
            return
        np.testing.assert_array_equal(np_of(g), w, err_msg=path)
    walk(want, got)
