"""The launch plan and the numerics of the two weight-matmul kernels
(``packed_matmul``, ``bitplane_matmul``), checked on the CPU.

* ``kernels.tiling.matmul_plan``: for the phi3 projection shapes and for
  9x8 / ragged geometry at M in {1, 4, 8, 16, 17, 20, 512}, its K slices
  partition [0, kend) exactly, start on WB-row, nibble-pair and byte-row
  boundaries (and on 32-row tiles in the tensor regime; a stream slice
  cuts a WB taller than the x stage on a unit boundary), fit the stream
  regime's x stage at any WB height, and decode
  shapes launch at least two waves (264 blocks) on 132 SMs;
* the tensor-core regime's arithmetic (each dequantized weight as two bf16
  terms hi + lo, bf16 x times both, f32 x split into two terms as well,
  f32 sums), emulated in plain torch, agrees with the JAX package's
  ``packed_matmul`` and ``bitplane_matmul`` (Pallas in interpret mode, as
  the JAX tests run them) within the card's tolerance, 1e-4 of the
  largest output, over int8 / int4, 8 and 4 planes, draft masks, 9x8 and
  8x128 blocks; and one bf16 term alone is outside it at K = 3072.

The CUDA kernels themselves run only on a card (``chip_smoke.py``'s
kernel phase holds them to their plain versions in both regimes).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.blocking import BlockingSpec  # noqa: E402
from repro.core.fakequant import fq_from_float  # noqa: E402
from repro.kernels.bitplane_matmul import bitplane_matmul as j_bitplane  # noqa: E402
from repro.kernels.ops import truncate_mask_topk as j_trunc  # noqa: E402
from repro.kernels.packed_matmul import packed_matmul as j_packed  # noqa: E402
from repro.kernels.ref import packed_matmul_ref as j_packed_ref  # noqa: E402
from repro.serve.deploy import to_serving_params  # noqa: E402
from repro_torch.kernels.ref import (bitplane_matmul_ref,  # noqa: E402
                                     packed_matmul_ref)
from repro_torch.kernels.tiling import (BLOCK_K, N_SMS, STREAM_MAX_M,  # noqa: E402
                                        STREAM_ROWS, X_STAGE, matmul_plan,
                                        splitk_scratch)
from torch_port_helpers import np_of, tensor_regime_emulation  # noqa: E402

torch.set_num_threads(2)
TOL_REL = 1e-4               # chip_smoke.PM_TOL_REL / BM_TOL_REL
PHI3 = ((3072, 3072), (3072, 8192), (8192, 3072))
MS = (1, 4, 8, 16, 17, 20, 512)
UNITS = {"int8": 1, "int4": 2, "bitplane": 8}


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("fmt", sorted(UNITS))
@pytest.mark.parametrize("kend,n,wbr", [
    *((k, n, 8) for k, n in PHI3),
    (27, 44, 9),             # 9x8 blocks, odd block-padded K
    (25, 44, 9),             # x narrower than K
    (63, 41, 9),             # ragged N
    (3072, 100, 8),          # N not a multiple of the 128-column tile
    (30, 20, 3),             # 3x5 blocks: a byte row spans three WB rows
    (3072, 3072, 3072),      # whole-layer blocks taller than the x stage
    (8192, 3072, 3072),      # ... K past one block
    (4608, 1000, 4608),      # ... a block of 4608 rows, ragged N
    (9216, 3072, 4608),      # ... two of them
])
@pytest.mark.parametrize("m", MS)
def test_plan_partitions_k_on_aligned_boundaries(fmt, kend, n, wbr, m):
    unit = UNITS[fmt]
    plan = matmul_plan(m, kend, n, unit=unit, wbr=wbr)
    assert plan.regime == ("stream" if m <= STREAM_MAX_M else "tensor")
    ranges = plan.k_ranges(kend)
    assert len(ranges) == plan.ksplit
    assert ranges[0][0] == 0 and ranges[-1][1] == kend
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                        # contiguous, no overlap
    assert all(a < b for a, b in ranges)       # no empty slice
    align = math.lcm(unit, wbr)
    if plan.regime == "stream" and align * STREAM_ROWS > X_STAGE:
        # a WB row taller than the x stage: slices cut the block on units
        align = unit
    if plan.regime == "tensor":
        align = math.lcm(align, BLOCK_K)
        assert plan.rows in (32, 128) and plan.rows >= min(m, 128)
        assert plan.tiles_m == -(-m // plan.rows)
    else:
        assert plan.rows == STREAM_ROWS
        assert plan.tiles_m == -(-m // STREAM_ROWS)
        # the stream kernel stages its slice of x once, zero-padded to 8
        assert -(-min(plan.kchunk, kend) // 8) * 8 * plan.rows <= X_STAGE
    assert all(a % align == 0 for a, _ in ranges)
    assert plan.tiles_n == -(-n // 128)


@pytest.mark.parametrize("fmt", sorted(UNITS))
@pytest.mark.parametrize("k,n", PHI3)
@pytest.mark.parametrize("m", [m for m in MS if m <= STREAM_MAX_M])
def test_decode_plans_fill_two_waves(fmt, k, n, m):
    plan = matmul_plan(m, k, n, unit=UNITS[fmt], wbr=8)
    assert plan.regime == "stream"
    assert plan.blocks >= 2 * N_SMS
    # no more than the alignment forces past the resident wave
    assert plan.blocks < 2 * N_SMS + 2 * plan.tiles_n * plan.tiles_m


@pytest.mark.parametrize("k,n", PHI3)
@pytest.mark.parametrize("m", [17, 20, 24, 512])
def test_tensor_plans_stay_within_two_blocks_an_sm(k, n, m):
    plan = matmul_plan(m, k, n, unit=1, wbr=8)
    assert plan.regime == "tensor"
    assert plan.blocks <= 2 * N_SMS or plan.ksplit == 1


def test_splitk_scratch_caches_and_grows():
    dev = torch.device("cpu")
    one = matmul_plan(512, 3072, 8192, unit=1, wbr=8)
    assert one.ksplit == 1 and splitk_scratch(dev, one, 512, 8192) == (0, 0)
    small = matmul_plan(4, 3072, 3072, unit=1, wbr=8)
    big = matmul_plan(4, 8192, 8192, unit=1, wbr=8)
    a = splitk_scratch(dev, small, 4, 3072)
    assert a == splitk_scratch(dev, small, 4, 3072)      # cached
    b = splitk_scratch(dev, big, 4, 8192)
    assert b[0] != 0 and b[1] != 0
    assert splitk_scratch(dev, small, 4, 3072) == b      # the grown pair


@pytest.mark.parametrize("name,key", [
    ("packed_matmul", (torch.device("cpu"), 1, 3072, 4, 3072, 8, 3072, 24,
                       8, 128)),
    ("bitplane_matmul", (torch.device("cpu"), 1, 8192, 20, 8192, 8, 1024,
                         24, 1, 3072, 8, 128, 1024 * 3072)),
])
def test_launch_args_are_built_once_per_call_shape(name, key):
    """The wrappers pack a call shape's plan and scratch into the launch
    struct once; later calls of that shape reuse it."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    addr = mod._args(key)
    assert mod._args(key) == addr
    st = mod._ARGS[key][1]
    m, kend, n = key[3], key[4], key[-4] if name == "bitplane_matmul" \
        else key[6]
    plan = matmul_plan(m, kend, n, unit=8 if name == "bitplane_matmul"
                       else 1, wbr=8)
    assert (st.regime, st.rows, st.ksplit, st.kchunk) == (
        int(plan.regime == "tensor"), plan.rows, plan.ksplit, plan.kchunk)
    assert (st.ws != 0) == (plan.ksplit > 1)
    other = key[:3] + (m + 1,) + key[4:]
    assert mod._args(other) != addr


# ------------------------------------------------------------- numerics

def _packed(m, k, n, bits, wbr, wbc, k_x=None, seed=0):
    """A JAX deploy of a random weight; x with k_x (<= k) columns."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    fq = fq_from_float(jnp.asarray(w), 8, BlockingSpec(wbr, wbc))
    sw = to_serving_params({"w": fq}, bits)["w"]
    x = rng.standard_normal((m, k if k_x is None else k_x)).astype(
        np.float32)
    return x, np.asarray(sw.w_int), np.asarray(sw.scale)


def _dequant_packed(w_int, scale, bits, wbr, wbc):
    """The kernels' dequantized weight fl(q * s), (K, N), via the plain
    version on an identity x (exact in f32)."""
    k = scale.shape[0] * wbr
    eye = torch.eye(k)
    return packed_matmul_ref(eye, torch.from_numpy(np.array(w_int)),
                             torch.from_numpy(np.array(scale)), bits, wbr,
                             wbc)


def _emulate(x, w):
    """x (M, k_x) numpy f32 or a torch bf16 tensor, w (K, N) f32."""
    xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
    xt = torch.nn.functional.pad(xt, (0, w.shape[0] - xt.shape[1]))
    return np_of(tensor_regime_emulation(xt, w))


def _within(got, want):
    err = float(np.abs(got - want).max())
    tol = TOL_REL * float(np.abs(want).max())
    return err, tol


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("wbr,wbc,k,n,k_x", [
    (8, 128, 256, 256, None),
    (9, 8, 27, 44, 25),            # paper geometry, odd block-padded K
])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_tensor_regime_arithmetic_matches_jax_packed_kernel(bits, wbr, wbc,
                                                            k, n, k_x, xdt):
    x, w_int, scale = _packed(20, k, n, bits, wbr, wbc, k_x, seed=bits)
    if xdt == "bfloat16":           # the kernel reads bf16 x as given
        x = np_of(torch.from_numpy(x).to(torch.bfloat16).float())
    want = np.asarray(j_packed(jnp.asarray(x), jnp.asarray(w_int),
                               jnp.asarray(scale), bits=bits, wbr=wbr,
                               wbc=wbc))
    w = _dequant_packed(w_int, scale, bits, wbr, wbc)
    xin = torch.from_numpy(x).to(torch.bfloat16) if xdt == "bfloat16" else x
    err, tol = _within(_emulate(xin, w), want)
    assert err <= tol, (err, tol)


def _bitplane(k, n, n_bits, wbr, wbc, seed):
    """Random planes, sign, mixed occupancy masks (0..n_bits live planes a
    block, some empty) and a per-WB scale."""
    rng = np.random.default_rng(seed)
    gr, gc = -(-k // wbr), -(-n // wbc)
    rows8 = -(-gr * wbr // 8)
    planes = rng.integers(0, 256, (n_bits, rows8, gc * wbc)).astype(np.uint8)
    sign = rng.integers(0, 256, (rows8, gc * wbc)).astype(np.uint8)
    occ = rng.integers(0, n_bits + 1, (gr, gc))
    mask = (np.arange(n_bits)[:, None, None] < occ).astype(np.float32)
    scale = (rng.random((gr, gc)) * 1e-2 + 1e-3).astype(np.float32)
    return planes, sign, mask, scale


@pytest.mark.parametrize("n_bits,draft", [(8, 0), (8, 5), (4, 0), (4, 2)])
@pytest.mark.parametrize("wbr,wbc,k,n,k_x", [
    (8, 128, 256, 256, None),
    (9, 8, 63, 44, 60),            # Kp 63 packed into 64 rows, narrow x
])
def test_tensor_regime_arithmetic_matches_jax_bitplane_kernel(n_bits, draft,
                                                              wbr, wbc, k, n,
                                                              k_x):
    planes, sign, mask, scale = _bitplane(k, n, n_bits, wbr, wbc,
                                          seed=n_bits + draft)
    if draft:
        mask = np.asarray(j_trunc(jnp.asarray(mask), draft))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20, k if k_x is None else k_x)).astype(
        np.float32)
    want = np.asarray(j_bitplane(jnp.asarray(x), jnp.asarray(planes),
                                 jnp.asarray(sign), jnp.asarray(mask),
                                 jnp.asarray(scale), n_bits=n_bits, wbr=wbr,
                                 wbc=wbc))
    kp = mask.shape[-2] * wbr
    w = bitplane_matmul_ref(torch.eye(kp), *(torch.from_numpy(a) for a in
                                             (planes, sign, mask, scale)),
                            wbr, wbc)
    err, tol = _within(_emulate(x, w), want)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("bits", [8, 4])
def test_one_bf16_weight_term_is_outside_the_tolerance_at_k3072(bits):
    """The negative control: at a phi3 fan-in, rounding each dequantized
    weight to one bf16 misses the 1e-4 limit by an order of magnitude,
    while the hi/lo pair stays well inside it (reference: the JAX oracle,
    f32)."""
    x, w_int, scale = _packed(4, 3072, 256, bits, 8, 128, seed=11)
    want = np.asarray(j_packed_ref(jnp.asarray(x), jnp.asarray(w_int),
                                   jnp.asarray(scale), bits, 8, 128))
    w = _dequant_packed(w_int, scale, bits, 8, 128)
    xt = torch.from_numpy(x)
    one = np_of(tensor_regime_emulation(xt, w, split_weight=False))
    two = np_of(tensor_regime_emulation(xt, w))
    err1, tol = _within(one, want)
    err2, _ = _within(two, want)
    assert err1 > 5 * tol, (err1, tol)
    assert err2 < 0.1 * tol, (err2, tol)


def test_emulation_reads_bf16_x_without_splitting_it():
    """bf16 x takes two products (x*hi + x*lo): splitting an x that is
    already bf16 would add a zero term."""
    w = torch.randn(64, 32)
    x = torch.randn(5, 64).to(torch.bfloat16)
    a = tensor_regime_emulation(x, w)
    b = tensor_regime_emulation(x.float(), w)
    assert torch.equal(a, b)
