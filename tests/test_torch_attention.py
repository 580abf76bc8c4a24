"""Attention edge cases of the port, held against ``repro.models.attention``
(mirrors tests/test_paged_attention.py's unit cases).

* ``page_coords`` past the table end: the reference's gather fills the
  page id with INT32_MIN and its scatter drops that write; the port must
  drop it too, never clamp it into the last block;
* trash-page routing, scalar vs (B,) fill levels, ``paged_gather`` layout;
* ``_cache_write`` clamps its start like ``dynamic_update_slice``;
* ``quantize_kv`` int8/int4 is bit-exact, ``dequantize_kv`` exact;
* the plain and blockwise attention cores match the reference (1e-5).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from torch_port_helpers import np_of  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_page_coords_past_table_end_is_dropped_not_clamped():
    table = np.array([[7, 9]], np.int32)               # nb=2, page=4: T=8
    jp, jo = ja.page_coords(jnp.asarray(table), 7, seq=2, page=4)
    tp, to = ta.page_coords(_t(table), 7, seq=2, page=4)
    assert np.asarray(jp).tolist() == [[9, -2 ** 31]]
    np.testing.assert_array_equal(np_of(tp), np.asarray(jp))
    np.testing.assert_array_equal(np_of(to), np.asarray(jo))
    # the write through these coordinates lands only at (9, 3): the
    # reference drops the past-the-end entry, and so must the port
    vals = np.array([[1.0, 2.0]], np.float32)
    jpool = jnp.zeros((10, 4), jnp.float32).at[jp, jo].set(vals)
    tpool = torch.zeros((10, 4))
    ta.paged_write(tpool, tp, to, _t(vals))
    np.testing.assert_array_equal(np_of(tpool), np.asarray(jpool))
    assert float(tpool.sum()) == 1.0 and float(tpool[9, 3]) == 1.0


def test_paged_write_drops_past_end_without_touching_trash_page():
    """Per-slot fill levels, (KV, dh) entries, a trash page holding data:
    the dropped writes leave page 0 as it was, as the reference does."""
    rng = np.random.default_rng(1)
    table = np.array([[3, 1], [2, 4]], np.int32)         # nb=2, page=4
    pool = rng.standard_normal((5, 4, 2, 3)).astype(np.float32)
    vals = rng.standard_normal((2, 3, 2, 3)).astype(np.float32)
    idx = np.array([6, 2], np.int32)                     # row 0 runs past
    jp, jo = ja.page_coords(jnp.asarray(table), jnp.asarray(idx), seq=3,
                            page=4)
    want = np.asarray(jnp.asarray(pool).at[jp, jo].set(vals))
    tp, to = ta.page_coords(_t(table), _t(idx), seq=3, page=4)
    tpool = _t(pool)
    ta.paged_write(tpool, tp, to, _t(vals))
    np.testing.assert_array_equal(np_of(tpool), want)
    np.testing.assert_array_equal(np_of(tpool[0]), pool[0])


def test_page_coords_basic_and_scalar_vs_vector():
    table = np.array([[3, 1], [2, 5]], np.int32)
    for idx in ([0, 5], 3, [3, 3]):
        jidx = jnp.asarray(idx) if isinstance(idx, list) else idx
        tidx = torch.tensor(idx) if isinstance(idx, list) else idx
        jp, jo = ja.page_coords(jnp.asarray(table), jidx, seq=2, page=4)
        tp, to = ta.page_coords(_t(table), tidx, seq=2, page=4)
        np.testing.assert_array_equal(np_of(tp), np.asarray(jp))
        np.testing.assert_array_equal(np_of(to), np.asarray(jo))
    sp, so = ta.page_coords(_t(table), 3, seq=2, page=4)
    vp, vo = ta.page_coords(_t(table), torch.tensor([3, 3]), seq=2, page=4)
    assert torch.equal(sp, vp) and torch.equal(so, vo)


def test_page_coords_trash_page_for_unallocated_blocks():
    tp, _ = ta.page_coords(torch.zeros((1, 3), dtype=torch.int32), 5, seq=3,
                           page=4)
    assert tp.tolist() == [[0, 0, 0]]


def test_paged_gather_layout():
    pool = np.arange(5 * 2 * 3, dtype=np.float32).reshape(5, 2, 3)
    table = np.array([[2, 0], [4, 1]], np.int32)
    np.testing.assert_array_equal(
        np_of(ta.paged_gather(_t(pool), _t(table))),
        np.asarray(ja.paged_gather(jnp.asarray(pool), jnp.asarray(table))))


@pytest.mark.parametrize("idx", [0, 2, 5, 9, [0, 5], [6, 1]])
def test_cache_write_clamps_start_like_reference(idx):
    """Writing 3 values at start 5 into a length-6 row writes 3..5."""
    buf = np.zeros((2, 6, 2), np.float32)
    upd = np.random.default_rng(0).standard_normal((2, 3, 2)).astype(
        np.float32)
    jidx = jnp.asarray(idx, jnp.int32)
    want = np.asarray(ja._cache_write(jnp.asarray(buf), jnp.asarray(upd),
                                      jidx))
    tbuf = _t(buf)
    ta._cache_write(tbuf, _t(upd), torch.tensor(idx) if isinstance(
        idx, list) else idx)
    np.testing.assert_array_equal(np_of(tbuf), want)
    if idx == 5:
        np.testing.assert_array_equal(want[:, 3:], upd)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_bit_exact(bits):
    x = np.random.default_rng(bits).standard_normal((2, 5, 3, 24)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                       # all-zero row: the 1e-6 floor
    jq, js = ja.quantize_kv(jnp.asarray(x), bits)
    tq, ts = ta.quantize_kv(_t(x), bits)
    assert tq.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(np_of(tq), np.asarray(jq))
    np.testing.assert_array_equal(np_of(ts), np.asarray(js))
    np.testing.assert_array_equal(
        np_of(ta.dequantize_kv(tq, ts, torch.float32)),
        np.asarray(ja.dequantize_kv(jq, js, jnp.float32)))
    assert ta.cache_bits({"k": tq}) == bits


def _qkv(b, s, t, h, kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, t, kv, dh)).astype(np.float32),
            rng.standard_normal((b, t, kv, dh)).astype(np.float32))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 20.0)])
def test_attention_core_matches_reference(window, softcap):
    q, k, v = _qkv(2, 6, 9, 4, 2, 8)
    qp = np.tile(np.arange(3, 9, dtype=np.int32), (2, 1))
    kp = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    kv_len = np.array([9, 7], np.int32)
    want = ja.attention_core(*map(jnp.asarray, (q, k, v, qp, kp)),
                             window=window, attn_softcap=softcap,
                             kv_len=jnp.asarray(kv_len))
    got = ta.attention_core(*map(_t, (q, k, v, qp, kp)), window=window,
                            attn_softcap=softcap, kv_len=_t(kv_len))
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_blockwise_attention_core_matches_reference():
    q, k, v = _qkv(1, 8, 12, 4, 2, 8, seed=1)
    qp = np.arange(4, 12, dtype=np.int32)[None]
    kp = np.arange(12, dtype=np.int32)[None]
    kw = dict(window=5, attn_softcap=15.0, kv_len=None, q_block=4,
              kv_block=4)
    want = ja.blockwise_attention_core(*map(jnp.asarray, (q, k, v, qp, kp)),
                                       **kw)
    got = ta.blockwise_attention_core(*map(_t, (q, k, v, qp, kp)), **kw)
    np.testing.assert_allclose(np_of(got), np.asarray(jax.device_get(want)),
                               rtol=1e-5, atol=1e-5)
    plain = ta.attention_core(*map(_t, (q, k, v, qp, kp)), window=5,
                              attn_softcap=15.0)
    np.testing.assert_allclose(np_of(got), np_of(plain), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["fused", "ref"])
def test_paged_attn_serves_contiguous_pool_view(backend):
    """The contiguous cache reaches the decode kernel as an identity-table
    pool view; the result equals the reference's ``paged_attn``."""
    rng = np.random.default_rng(2)
    b, t, kv, dh, page = 2, 12, 2, 8, 4
    q = rng.standard_normal((b, 1, 4, dh)).astype(np.float32)
    cache = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    kq, ks = (np.array(a) for a in ja.quantize_kv(jnp.asarray(cache), 8))
    ident = np.arange(b * t // page, dtype=np.int32).reshape(b, -1)
    kv_len = np.array([12, 5], np.int32)
    jstore = {"k": ja._as_pool(jnp.asarray(kq), page),
              "v": ja._as_pool(jnp.asarray(kq), page),
              "k_scale": ja._as_pool(jnp.asarray(ks), page),
              "v_scale": ja._as_pool(jnp.asarray(ks), page)}
    tstore = {n: ta._as_pool(_t(a), page) for n, a in
              (("k", kq), ("v", kq), ("k_scale", ks), ("v_scale", ks))}
    want = ja.paged_attn(jnp.asarray(q), jstore, jnp.asarray(ident),
                         jnp.asarray(kv_len), backend="ref")
    got = ta.paged_attn(_t(q), tstore, _t(ident), _t(kv_len),
                        backend=backend)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
