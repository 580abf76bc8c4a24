"""The port's bit-plane layout and its two new kernels, held against the
JAX reference on the CPU.

* ``pack_bits`` / ``unpack_bits``, ``truncate_mask_topk`` and the
  deployed bit-plane wire format (planes, sign, mask, scale) are
  bit-exact, for bits {8, 4} x WB {9x8, 8x128} with per-block bit-widths
  drawn from {0..8} (empty blocks included);
* ``bitplane_matmul`` on a CPU tensor (its plain version) matches the JAX
  kernel in interpret mode and the JAX oracle within 1e-5 (f32 sums in
  another order), over both scale modes, odd block-padded K under 9x8
  (27 rows packed into 32), x narrower than K, ragged N and truncated
  (draft) masks;
* ``pact_quant`` matches ``pact_quant_pallas`` in interpret mode within
  1e-6 in f32 (the last f32 bit can differ) and bit for bit in bf16;
* ``qmatmul`` over every backend x leaf representation matches the
  reference's dispatch, the packed-under-``bitplane`` dense fallback
  included.

The CUDA kernels themselves run only on a card: the tests marked ``cuda``
compare them with their plain versions there and skip elsewhere.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.blocking import BlockingSpec  # noqa: E402
from repro.core.fakequant import fq_from_float  # noqa: E402
from repro.kernels.bitplane_matmul import bitplane_matmul as j_bitplane  # noqa: E402
from repro.kernels.ops import truncate_mask_topk as j_trunc  # noqa: E402
from repro.kernels.pact_kernel import pact_quant_pallas  # noqa: E402
from repro.kernels.ref import bitplane_matmul_ref as j_bitplane_ref  # noqa: E402
from repro.kernels.ref import pack_bits as j_pack_bits  # noqa: E402
from repro.kernels.ref import unpack_bits as j_unpack_bits  # noqa: E402
from repro.models.common import qmatmul as j_qmatmul  # noqa: E402
from repro.serve import deploy as jd  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels.bitplane_matmul import bitplane_matmul  # noqa: E402
from repro_torch.kernels.ops import truncate_mask_topk  # noqa: E402
from repro_torch.kernels.pact_kernel import pact_quant  # noqa: E402
from repro_torch.kernels.ref import (bitplane_matmul_ref, pack_bits,  # noqa: E402
                                     pact_quant_ref, unpack_bits)
from repro_torch.models.common import MATMUL_BACKENDS, qmatmul  # noqa: E402
from repro_torch.serve import deploy as td  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# (K, N, wbr, wbc): 9x8 with an odd block-padded K (27 rows packed into
# 32), and 8x128 with N padded from 200 to 256
GEOM = {"9x8": (27, 44, 9, 8), "8x128": (64, 200, 8, 128)}


def _qat_leaf(k, n, wbr, wbc):
    """A JAX FakeQuantTensor of a random stacked (2, k, n) weight whose
    per-block bit-widths are drawn from {0..8}."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, k, n)).astype(np.float32)
    fq = fq_from_float(jnp.asarray(w), 8, BlockingSpec(wbr, wbc))
    bw = rng.integers(0, 9, fq.bitwidth.shape).astype(np.float32)
    return dataclasses.replace(fq, bitwidth=jnp.asarray(bw))


@functools.lru_cache(maxsize=None)
def _stacked(geom, bits):
    """(QAT tree, the JAX deploy, the port's deploy of the same QAT tree)
    of one stacked leaf.  Cached: the JAX deploy compiles once per shape,
    which dominates the run time."""
    qat = {"w": _qat_leaf(*GEOM[geom])}
    jtree = jd.to_serving_params(qat, bits, layout="bitplane",
                                 validate=False)
    ttree = td.to_serving_params(
        params_from_numpy(tree_to_numpy(qat), device="cpu"), bits,
        layout="bitplane", device="cpu")
    return qat, jtree, ttree


def test_pack_unpack_bits_bit_exact():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, 24, 10)).astype(np.uint8)
    packed = j_pack_bits(jnp.asarray(bits))
    np.testing.assert_array_equal(np_of(pack_bits(_t(bits))),
                                  np.asarray(packed))
    raw = rng.integers(0, 256, (2, 5, 7)).astype(np.uint8)
    got = unpack_bits(_t(raw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np_of(got),
                                  np.asarray(j_unpack_bits(jnp.asarray(raw))))
    np.testing.assert_array_equal(np_of(pack_bits(got)), raw)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("geom", ["9x8", "8x128"])
def test_bitplane_deployment_bit_identical(bits, geom):
    """A stacked (2, K, N) leaf with mixed bit-widths (0 included) deploys
    to the reference's planes, sign, mask and scale, bit for bit, and its
    stream bytes and composed weights equal the reference's."""
    qat, jtree, ttree = _stacked(geom, bits)
    j, t = jtree["w"], ttree["w"]
    assert isinstance(t, td.BitplaneServingWeight)
    for name, dt in (("planes", torch.uint8), ("sign", torch.uint8),
                     ("mask", torch.float32), ("scale", torch.float32)):
        got = getattr(t, name)
        assert got.dtype == dt, name
        np.testing.assert_array_equal(np_of(got), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.shape == j.shape and t.bits == bits
    assert float(np_of(t.mask).sum(axis=-3).min()) == 0.0   # empty blocks
    assert td.bitplane_stream_bytes(t) == jd.bitplane_stream_bytes(j)
    assert td.weight_stream_bytes(ttree) == jd.weight_stream_bytes(jtree)
    # the bridge carries a deployed bit-plane leaf across unchanged
    back = params_from_numpy(tree_to_numpy(jtree), device="cpu")["w"]
    assert torch.equal(back.planes, t.planes) and back.spec == t.spec
    # composed weights: the reference's, and the packed layout's exactly
    want = np.asarray(jd.bitplane_serving_compose(j, jnp.float32))
    got = td.bitplane_serving_compose(t, torch.float32)
    np.testing.assert_array_equal(np_of(got), want)
    packed = td.to_serving_params(
        params_from_numpy(tree_to_numpy(qat), device="cpu"), bits,
        device="cpu")["w"]
    assert torch.equal(td.serving_compose(packed, torch.float32), got)
    assert torch.equal(td.bitplane_serving_compose(t.layer(1),
                                                   torch.float32), got[1])


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="layout"):
        td.to_serving_params({}, 8, layout="planes", device="cpu")


@pytest.mark.parametrize("k", [0, 1, 3, 8])
def test_truncate_mask_topk_exact(k):
    rng = np.random.default_rng(k)
    occ = rng.integers(0, 9, (2, 5, 6))
    mask = (np.arange(8)[None, :, None, None] < occ[:, None]).astype(
        np.float32)
    want = np.asarray(j_trunc(jnp.asarray(mask), k))
    np.testing.assert_array_equal(np_of(truncate_mask_topk(_t(mask), k)),
                                  want)


def test_truncate_mask_topk_rejects_negative_k():
    with pytest.raises(ValueError, match="k must be"):
        truncate_mask_topk(torch.ones((8, 2, 2)), -1)


def _layer_operands(geom, bits, draft=0):
    """Layer 1 of a deployed stacked bit-plane leaf (JAX arrays), masks
    optionally truncated to the top ``draft`` planes."""
    sw = _stacked(geom, bits)[1]["w"]
    mask = j_trunc(sw.mask[1], draft) if draft else sw.mask[1]
    return sw.planes[1], sw.sign[1], mask, sw.scale[1]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("geom,k_x,draft", [
    ("8x128", None, 0),
    ("8x128", 60, 3),              # x narrower than K, draft masks
    ("9x8", 25, 0),
    ("9x8", None, 2),
])
@pytest.mark.parametrize("m", [1, 20])
def test_bitplane_matmul_plain_matches_jax_ref(bits, geom, k_x, draft, m):
    k, _, wbr, wbc = GEOM[geom]
    planes, sign, mask, scale = _layer_operands(geom, bits, draft)
    x = np.random.default_rng(m).standard_normal(
        (m, k if k_x is None else k_x)).astype(np.float32)
    want = np.asarray(j_bitplane_ref(jnp.asarray(x), planes, sign, mask,
                                     scale, wbr, wbc))
    got = bitplane_matmul(_t(x), _t(planes), _t(sign), _t(mask), _t(scale),
                          wbr=wbr, wbc=wbc)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(np_of(got), want, **TOL)


@pytest.mark.parametrize("per_layer", [False, True])
def test_bitplane_matmul_plain_matches_jax_kernel(per_layer):
    """Against the JAX Pallas kernel itself (interpret mode): 9x8 blocks,
    odd block-padded K, x narrower than K, draft masks; and the per-layer
    scalar scale over random planes with a ragged N slice."""
    rng = np.random.default_rng(7)
    if per_layer:
        wbr, wbc, n = 8, 128, 100
        planes = rng.integers(0, 256, (4, 32, 128)).astype(np.uint8)
        sign = rng.integers(0, 256, (32, 128)).astype(np.uint8)
        occ = rng.integers(0, 5, (32, 1))
        mask = (np.arange(4)[:, None, None] < occ).astype(np.float32)
        scale = np.array([0.7], np.float32)
        x = rng.standard_normal((4, 256)).astype(np.float32)
        want = np.asarray(j_bitplane(
            jnp.asarray(x), jnp.asarray(planes[:, :, :n]),
            jnp.asarray(sign[:, :n]), jnp.asarray(mask), jnp.asarray(scale),
            n_bits=4, wbr=wbr, wbc=wbc))
        oracle = np.asarray(j_bitplane_ref(
            jnp.asarray(x), jnp.asarray(planes), jnp.asarray(sign),
            jnp.asarray(mask), jnp.asarray(scale[0]), wbr, wbc))[:, :n]
        np.testing.assert_allclose(want, oracle, **TOL)
        planes, sign = planes[:, :, :n], sign[:, :n]
    else:
        wbr, wbc = 9, 8
        planes, sign, mask, scale = (np.asarray(a) for a in _layer_operands(
            "9x8", 8, draft=5))
        x = rng.standard_normal((5, 25)).astype(np.float32)
        want = np.asarray(j_bitplane(
            jnp.asarray(x), jnp.asarray(planes), jnp.asarray(sign),
            jnp.asarray(mask), jnp.asarray(scale), n_bits=8, wbr=wbr,
            wbc=wbc))
    got = bitplane_matmul(_t(x), _t(planes), _t(sign), _t(mask), _t(scale),
                          wbr=wbr, wbc=wbc)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(np_of(got), want, **TOL)


def test_bitplane_matmul_geometry_errors():
    planes, sign, mask, scale = (_t(a) for a in _layer_operands("8x128", 8))
    with pytest.raises(ValueError, match="geometry"):
        bitplane_matmul(torch.zeros((2, 65)), planes, sign, mask, scale)
    with pytest.raises(ValueError, match="geometry"):
        bitplane_matmul(torch.zeros((2, 64)), planes, sign[:, :64], mask,
                        scale)
    with pytest.raises(ValueError, match="geometry"):        # N > grid
        bitplane_matmul(torch.zeros((2, 64)), planes, sign, mask[..., :1],
                        scale[:, :1])
    with pytest.raises(ValueError, match="planes"):
        bitplane_matmul(torch.zeros((2, 64)), planes[:4], sign, mask, scale)


@pytest.mark.parametrize("act_bits", [2, 4, 8])
def test_pact_quant_plain_matches_jax_kernel(act_bits):
    """f32 within 1e-6; rows (37) that fill no tile of the JAX kernel."""
    x = (np.random.default_rng(act_bits).standard_normal((37, 96))
         * 2).astype(np.float32)
    x[0, :3] = [1.3, -5.0, 0.0]
    beta = np.array([1.3], np.float32)
    want = np.asarray(pact_quant_pallas(jnp.asarray(x), jnp.asarray(beta),
                                        act_bits=act_bits))
    got = pact_quant(_t(x), _t(beta), act_bits=act_bits)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=1e-6)


def test_pact_quant_computes_in_x_dtype():
    """bf16 in, bf16 out, every operation rounded to bf16 as on the TPU:
    equal to the JAX kernel in bf16."""
    x = (np.random.default_rng(1).standard_normal((16, 64)) * 2).astype(
        np.float32)
    beta = np.array([1.1], np.float32)
    want = np.asarray(pact_quant_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(beta),
        act_bits=8).astype(jnp.float32))
    got = pact_quant(_t(x).to(torch.bfloat16), _t(beta), act_bits=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, pact_quant_ref(_t(x).to(torch.bfloat16),
                                           _t(beta), 8))
    with pytest.raises(ValueError, match="act_bits"):
        pact_quant(_t(x), _t(beta), act_bits=1)


def test_cpu_tensors_launch_no_bitplane_or_pact_kernel():
    tk.reset_launch_counts()
    planes, sign, mask, scale = (_t(a) for a in _layer_operands("8x128", 8))
    bitplane_matmul(torch.ones((2, 64)), planes, sign, mask, scale)
    pact_quant(torch.ones((2, 3)), torch.tensor([1.0]))
    assert set(tk.launch_counts().values()) == {0}


# ------------------------------------------------------------ qmatmul matrix

@pytest.fixture(scope="module")
def leaves():
    """Layer 1 of one stacked (2, 27, 44) weight under the 9x8 geometry in
    every representation, JAX and port side by side."""
    qat = _stacked("9x8", 8)[0]
    tq = params_from_numpy(tree_to_numpy(qat), device="cpu")

    def layer(jw, tw):
        return jax.tree_util.tree_map(lambda a: a[1], jw), tw.layer(1)

    w = np.random.default_rng(5).standard_normal((27, 44)).astype(np.float32)
    out = {"plain": (jnp.asarray(w), _t(w)),
           "fakequant": layer(qat["w"], tq["w"])}
    for bits in (8, 4):
        out[f"packed{bits}"] = layer(
            jd.to_serving_params(qat, bits, validate=False)["w"],
            td.to_serving_params(tq, bits, device="cpu")["w"])
        _, jb, tb = _stacked("9x8", bits)
        out[f"bitplane{bits}"] = layer(jb["w"], tb["w"])
    return out


@pytest.mark.filterwarnings("ignore:qmatmul")
@pytest.mark.parametrize("backend", MATMUL_BACKENDS)
@pytest.mark.parametrize("leaf", ["plain", "fakequant", "packed8", "packed4",
                                  "bitplane8", "bitplane4"])
def test_qmatmul_backend_leaf_matrix_matches_reference(leaves, backend, leaf):
    jw, tw = leaves[leaf]
    x = np.random.default_rng(2).standard_normal((2, 3, 27)).astype(
        np.float32)
    jbe = "pallas" if backend == "kernel" else backend
    want = np.asarray(j_qmatmul(jnp.asarray(x), jw, backend=jbe))
    got = qmatmul(_t(x), tw, backend)
    assert tuple(got.shape) == want.shape == (2, 3, 44)
    np.testing.assert_allclose(np_of(got), want, **TOL)
    if backend == "bitplane" and leaf.startswith("packed"):
        # the fallback is the dense dequant dot, bit for bit
        assert torch.equal(got, qmatmul(_t(x), tw, "dense"))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 7, 40])
def test_bitplane_matmul_kernel_matches_plain_on_card(cuda_device, bits, m):
    torch.backends.cuda.matmul.allow_tf32 = False
    planes, sign, mask, scale = (_t(a).to(cuda_device) for a in
                                 _layer_operands("9x8", bits, draft=3))
    x = torch.randn((m, 25), device=cuda_device)
    before = bitplane_matmul.launches
    got = bitplane_matmul(x, planes, sign, mask, scale, wbr=9, wbc=8)
    torch.cuda.synchronize()
    assert bitplane_matmul.launches == before + 1
    want = bitplane_matmul_ref(x, planes, sign, mask, scale, 9, 8)
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pact_quant_kernel_matches_plain_on_card(cuda_device, dtype):
    x = (torch.randn((515, 96), device=cuda_device) * 2).to(
        getattr(torch, dtype))
    beta = torch.tensor([1.3], device=cuda_device)
    got = pact_quant(x, beta, act_bits=4)
    torch.cuda.synchronize()
    want = pact_quant_ref(x, beta, 4)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=1e-6)
    assert math.isfinite(float(got.float().abs().max()))
