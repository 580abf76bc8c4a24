"""The port's two kernels, held against the JAX reference on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version, so
these tests check the plain versions against the JAX kernels (Pallas in
interpret mode, one case each: it is slow on the CPU) and against the JAX
oracles in ``repro.kernels.ref`` across the geometry the serving path
hits.  Tolerances: 1e-5 absolute and relative, as the reference's own
kernel tests use; both sides accumulate in f32 in different orders.

The CUDA kernels themselves run only on a card: the tests marked ``cuda``
compare them with their plain versions there and skip elsewhere.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.blocking import BlockingSpec  # noqa: E402
from repro.core.fakequant import fq_from_float  # noqa: E402
from repro.kernels.packed_matmul import packed_matmul as j_packed  # noqa: E402
from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro.kernels.ref import packed_matmul_ref as j_packed_ref  # noqa: E402
from repro.kernels.ref import paged_attention_ref as j_paged_ref  # noqa: E402
from repro.models.attention import quantize_kv as j_qkv  # noqa: E402
from repro.serve.deploy import to_serving_params  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels.packed_matmul import packed_matmul  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ref import packed_matmul_ref, paged_attention_ref  # noqa: E402
from torch_port_helpers import np_of  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed_case(m, k, n, bits, wbr, wbc, k_x=None, seed=0):
    """Deployed (w_int, scale) of a random (k, n) weight, via the JAX
    deployment, and an x with ``k_x`` (<= k) columns."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    fq = fq_from_float(jnp.asarray(w), 8, BlockingSpec(wbr, wbc))
    sw = to_serving_params({"w": fq}, bits)["w"]
    x = rng.standard_normal((m, k if k_x is None else k_x)).astype(
        np.float32)
    return x, np.asarray(sw.w_int), np.asarray(sw.scale), sw.shape[-1]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("wbr,wbc,k,n,k_x", [
    (8, 128, 64, 384, None),       # TPU-aligned geometry
    (8, 128, 72, 200, 70),         # ragged N, x narrower than K
    (9, 8, 27, 44, 25),            # paper geometry, odd block-padded K
    (9, 8, 45, 30, None),
])
@pytest.mark.parametrize("m", [1, 5, 16, 33])
def test_packed_matmul_plain_matches_jax_ref(bits, wbr, wbc, k, n, k_x, m):
    x, w_int, scale, n_true = _packed_case(m, k, n, bits, wbr, wbc, k_x)
    want = np.asarray(j_packed_ref(jnp.asarray(x), jnp.asarray(w_int),
                                   jnp.asarray(scale), bits, wbr, wbc))
    got = packed_matmul(_t(x), _t(w_int), _t(scale), bits=bits, wbr=wbr,
                        wbc=wbc)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(np_of(got), want, **TOL)
    assert n_true <= got.shape[1]


@pytest.mark.parametrize("bits", [8, 4])
def test_packed_matmul_plain_matches_jax_kernel(bits):
    """One case against the JAX Pallas kernel itself (interpret mode):
    9x8 geometry, odd block-padded K, x narrower than K, M=5."""
    x, w_int, scale, _ = _packed_case(5, 27, 44, bits, 9, 8, k_x=25, seed=1)
    want = np.asarray(j_packed(jnp.asarray(x), jnp.asarray(w_int),
                               jnp.asarray(scale), bits=bits, wbr=9, wbc=8))
    got = packed_matmul(_t(x), _t(w_int), _t(scale), bits=bits, wbr=9,
                        wbc=8)
    np.testing.assert_allclose(np_of(got), want, **TOL)


def test_packed_matmul_geometry_errors():
    x, w_int, scale, _ = _packed_case(2, 16, 128, 8, 8, 128)
    with pytest.raises(ValueError, match="geometry"):
        packed_matmul(torch.zeros((2, 17)), _t(w_int), _t(scale), bits=8)
    with pytest.raises(ValueError, match="geometry"):
        packed_matmul(_t(x), _t(w_int)[:, :64], _t(scale), bits=8)


def _pool_case(b, kv, g, dh, page, nb, bits, seed=0):
    """Random page pool, quantized by the JAX ``quantize_kv``, with a
    shuffled block table and ragged fill levels."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * nb
    q = rng.standard_normal((b, kv, g, dh)).astype(np.float32)
    kf = rng.standard_normal((n_pages, page, kv, dh)).astype(np.float32)
    vf = rng.standard_normal((n_pages, page, kv, dh)).astype(np.float32)
    if bits < 32:
        kq, ks = (np.array(a) for a in j_qkv(jnp.asarray(kf), bits))
        vq, vs = (np.array(a) for a in j_qkv(jnp.asarray(vf), bits))
    else:
        kq, vq, ks, vs = kf, vf, None, None
    table = rng.permutation(np.arange(1, n_pages)).reshape(b, nb).astype(
        np.int32)
    kv_len = rng.integers(1, nb * page + 1, (b,)).astype(np.int32)
    return q, kq, vq, ks, vs, table, kv_len


def _both(case, **kw):
    jargs = [None if a is None else jnp.asarray(a) for a in case]
    targs = [None if a is None else _t(a) for a in case]
    want = np.asarray(j_paged_ref(*jargs, **kw))
    got = paged_attention(*targs, **kw)
    return got, want


@pytest.mark.parametrize("bits,g,window,softcap,page,dh", [
    (8, 1, None, 0.0, 4, 16),
    (8, 4, None, 0.0, 5, 24),       # GQA, odd page, dh not a power of two
    (4, 2, None, 0.0, 4, 24),       # nibble-packed int4 in the loop
    (32, 2, None, 0.0, 3, 16),      # float pool
    (8, 2, 5, 30.0, 4, 16),         # sliding window + softcap
    (4, 4, 3, 20.0, 7, 12),
])
def test_paged_attention_plain_matches_jax_ref(bits, g, window, softcap,
                                               page, dh):
    case = _pool_case(2, 3, g, dh, page, 3, bits, seed=bits + g + page)
    got, want = _both(case, window=window, softcap=softcap)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(np_of(got), want, **TOL)


def test_paged_attention_plain_matches_jax_kernel():
    """One case against the JAX Pallas kernel (interpret mode): GQA,
    window and softcap over an int8 pool with a shuffled table."""
    case = _pool_case(2, 2, 2, 16, 4, 3, 8, seed=7)
    jargs = [jnp.asarray(a) for a in case]
    want = np.asarray(j_paged(*jargs, window=5, softcap=30.0))
    got = paged_attention(*[_t(a) for a in case], window=5, softcap=30.0)
    np.testing.assert_allclose(np_of(got), want, **TOL)


def test_paged_attention_trash_page_stays_inert():
    """Blocks past a slot's fill level may point at stale pages or at the
    trash page 0: both are masked alike."""
    q, kq, vq, ks, vs, table, _ = _pool_case(1, 2, 2, 8, 4, 3, 8, seed=3)
    kv_len = np.array([4], np.int32)              # only block 0 is live
    trash = table.copy()
    trash[0, 1:] = 0
    args = [_t(a) for a in (q, kq, vq, ks, vs)]
    a = paged_attention(*args, _t(table), _t(kv_len))
    t = paged_attention(*args, _t(trash), _t(kv_len))
    np.testing.assert_allclose(np_of(a), np_of(t), atol=1e-6)


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    tk.reset_launch_counts()
    x, w_int, scale, _ = _packed_case(3, 16, 128, 4, 8, 128)
    y = packed_matmul(_t(x), _t(w_int), _t(scale), bits=4)
    np.testing.assert_array_equal(
        np_of(y), np_of(packed_matmul_ref(_t(x), _t(w_int), _t(scale), 4)))
    case = [_t(a) for a in _pool_case(1, 2, 1, 8, 4, 2, 8)]
    np.testing.assert_array_equal(np_of(paged_attention(*case)),
                                  np_of(paged_attention_ref(*case)))
    assert tk.launch_counts() == {"packed_matmul": 0, "paged_attention": 0,
                                  "bitplane_matmul": 0, "pact_quant": 0}


def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """A kernel's library is named by its source, the shared headers
    ``csrc/*.cuh`` and the flags: editing a header must not load a stale
    library."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build.library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert build.library_path("k").parent == build.BUILD_DIR


@pytest.mark.parametrize("name,struct", [
    ("packed_matmul", "PackedArgs"), ("bitplane_matmul", "BitplaneArgs")])
def test_launch_declarations_mirror_the_cuda_source(name, struct):
    """Each matmul wrapper's ctypes view of its launch function (argument
    count) and of the launch-argument struct (field order and C types)
    matches the CUDA source, which is compiled only on a card."""
    import ctypes
    import importlib
    import re
    from repro_torch.kernels import build
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    src = (build.CSRC / f"{name}.cu").read_text()
    params = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)
    assert params and len(params.group(1).split(",")) == len(mod._ARGTYPES)
    body = re.search(rf"struct {struct} \{{([^}}]*)\}};", src).group(1)
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "void*": ctypes.c_void_p}
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if decl:
            kind = next(k for k in ctype if decl.startswith(k + " "))
            fields += [(f.strip(), ctype[kind])
                       for f in decl[len(kind):].split(",")]
    assert fields == list(mod._Args._fields_)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 7, 40])
def test_packed_matmul_kernel_matches_plain_on_card(cuda_device, bits, m):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w_int, scale, _ = _packed_case(m, 45, 44, bits, 9, 8, k_x=43)
    args = [_t(a).to(cuda_device) for a in (x, w_int, scale)]
    before = packed_matmul.launches
    got = packed_matmul(*args, bits=bits, wbr=9, wbc=8)
    torch.cuda.synchronize()
    assert packed_matmul.launches == before + 1
    want = packed_matmul_ref(*args, bits, 9, 8)
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4, 32])
def test_paged_attention_kernel_matches_plain_on_card(cuda_device, bits):
    torch.backends.cuda.matmul.allow_tf32 = False
    case = _pool_case(3, 2, 4, 24, 5, 3, bits, seed=11)
    args = [None if a is None else _t(a).to(cuda_device) for a in case]
    got = paged_attention(*args, window=7, softcap=25.0)
    torch.cuda.synchronize()
    want = paged_attention_ref(*args, window=7, softcap=25.0)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-4,
                               atol=1e-5)
    assert math.isfinite(float(got.abs().max()))
