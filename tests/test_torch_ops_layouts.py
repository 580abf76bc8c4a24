"""``repro_torch.kernels.ops`` against ``repro.kernels.ops``: the
kernel-ready layouts of a trained ``QuantizedTensor`` and the dense calls
on them.

* ``to_bitplane_layout`` and ``to_packed_layout`` (int8 and int4) of a
  re-quantized matrix with mixed per-block widths (8x128 and 9x8 blocks,
  widths 0-8): every field bit for bit the reference's: the uint8 planes
  and sign, the int8 or nibble ``w_int``, the f32 mask and scales;
* ``bwq_dense_bitplane`` / ``bwq_dense_packed`` on a CPU ``x``: within
  1e-5 relative of the reference's calls (its Pallas kernels in
  interpret mode) and of the dequantized weight's product; they run the
  plain versions without a launch; a tensor on another device raises;
* the layouts refuse what the reference refuses: a stacked matrix, and
  a bit count other than 8 and 4.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.bitrep import from_float as j_from_float  # noqa: E402
from repro.core.blocking import BlockingSpec as JSpec  # noqa: E402
from repro.core.precision import adjust_precision as j_adjust  # noqa: E402
from repro.core.quantize import requantize as j_requantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.bitrep import compose  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
DENSE_TOL = 1e-5
CASES = ((256, 384, 8, 128), (72, 48, 9, 8), (64, 40, 8, 8))


def _qt(k, n, wbr, wbc, seed=0):
    """A re-quantized, precision-adjusted reference matrix whose blocks
    have widths drawn from 0..8 (magnitudes cut to each block's width)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    qt = j_from_float(jnp.asarray(w), 8, JSpec(wbr, wbc))
    bw = rng.integers(0, 9, size=qt.mask.shape[1:])
    mask = (np.arange(8)[:, None, None] < bw).astype(np.float32)
    qt = dataclasses.replace(qt, mask=jnp.asarray(mask))
    return j_adjust(j_requantize(qt))


def _port(qt):
    return params_from_numpy(tree_to_numpy(qt), device="cpu")


@pytest.mark.parametrize("k,n,wbr,wbc", CASES)
def test_bitplane_layout_bit_for_bit(k, n, wbr, wbc):
    qt = _qt(k, n, wbr, wbc)
    want, got = jops.to_bitplane_layout(qt), tops.to_bitplane_layout(_port(qt))
    for name in ("planes_packed", "sign_packed", "mask", "scale"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(np_of(g), w, name)
    assert (got.n_bits, got.wbr, got.wbc) == (want.n_bits, want.wbr,
                                              want.wbc)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n,wbr,wbc", CASES)
def test_packed_layout_bit_for_bit(k, n, wbr, wbc, bits):
    qt = _qt(k, n, wbr, wbc, seed=1)
    want = jops.to_packed_layout(qt, bits)
    got = tops.to_packed_layout(_port(qt), bits)
    for name in ("w_int", "scale"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(np_of(g), w, name)
    assert (got.bits, got.wbr, got.wbc) == (want.bits, want.wbr, want.wbc)


@pytest.mark.parametrize("m", [1, 5, 24])
@pytest.mark.parametrize("k,n,wbr,wbc", CASES[:2])
def test_dense_calls_match_reference(k, n, wbr, wbc, m):
    """y = x @ W from both layouts: the reference's interpreted kernels
    and the dequantized weight's product; the port's CPU calls launch no
    kernel."""
    qt = _qt(k, n, wbr, wbc, seed=2)
    tq = _port(qt)
    x = np.random.default_rng(3).standard_normal((m, k)).astype(np.float32)
    tx = torch.from_numpy(x)
    dense = np_of(tx @ compose(tq))
    tk.reset_launch_counts()
    runs = [(jops.bwq_dense_bitplane(jnp.asarray(x),
                                     jops.to_bitplane_layout(qt),
                                     interpret=True),
             tops.bwq_dense_bitplane(tx, tops.to_bitplane_layout(tq)))]
    for bits in (8, 4):
        runs.append((jops.bwq_dense_packed(jnp.asarray(x),
                                           jops.to_packed_layout(qt, bits),
                                           interpret=True),
                     tops.bwq_dense_packed(tx, tops.to_packed_layout(tq,
                                                                     bits))))
    assert not any(tk.launch_counts().values())
    scale = np.abs(dense).max()
    for i, (want, got) in enumerate(runs):
        assert got.dtype == torch.float32 and got.shape == (m, n)
        err = np.abs(np_of(got) - np.asarray(want)).max() / scale
        assert err <= DENSE_TOL, (i, err)
    # the bit-plane layout holds every block at its own width: exact
    err = np.abs(np_of(runs[0][1]) - dense).max() / scale
    assert err <= DENSE_TOL, err


def test_refusals():
    qt = _qt(72, 48, 9, 8)
    stacked = dataclasses.replace(
        _port(qt), planes=_port(qt).planes[:, None],
        sign=_port(qt).sign[None])
    with pytest.raises(ValueError, match="one matrix"):
        tops.to_bitplane_layout(stacked)
    with pytest.raises(ValueError):
        tops.to_packed_layout(_port(qt), 6)
    layout = tops.to_packed_layout(_port(qt), 8)
    # a tensor on another device than cuda, cpu or meta (a ``meta``
    # tensor takes the plain version's shape path: the dry run's)
    class _Elsewhere(torch.Tensor):
        @property
        def device(self):
            return torch.device("xpu")
    elsewhere = torch.Tensor._make_subclass(_Elsewhere, torch.zeros((2, 72)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.bwq_dense_packed(elsewhere, layout)
