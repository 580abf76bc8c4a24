"""The launch plan and the arithmetic of the split-KV decode attention
kernel (``paged_attention``), checked on the CPU.

* ``kernels.tiling.attention_plan``: its splits tile the table capacity
  [0, nb * page) exactly and number a power of two up to 32; a capacity
  of at most 1024 positions (the smoke's decode cache) is walked unsplit,
  one CTA a KV head; longer ones group the most KV heads (4, 2 or 1) that
  divide KV and fit, in 8 splits at the smoke's long shapes (256 CTAs,
  one wave of two an SM) and one split where B * KV / heads alone fills
  that wave (264 CTAs on 132 SMs); the shared memory stays within the
  card's; the constants mirror the CUDA source.
* An emulation of the kernel's partition and combine, in the plan's split,
  sub-chunk and warp order (each split's valid range cut by kv_len and
  the window, each warp's online softmax over its share of the
  sub-chunks, the warps and then the splits weighted by exp(m_i - max m)
  with empty ones at weight 0), agrees with
  ``paged_attention_ref`` and the JAX package's ``paged_attention_ref``
  within 1e-5, as the reference's own kernel tests hold, and with the JAX
  Pallas kernel (interpret mode, one case): empty leading and trailing
  splits, trash-page tails, pages of 16 and 96, G=4 with softcap, int8,
  int4 and float pools.

The CUDA kernel itself runs only on a card (``chip_smoke.py``'s kernel
phase holds it to its plain version, ``tests/test_torch_kernels.py`` has
the ``cuda``-marked case).
"""
import math
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro.kernels.ref import paged_attention_ref as j_paged_ref  # noqa: E402
from repro.models.attention import quantize_kv as j_qkv  # noqa: E402
from repro_torch.core.quantize import unpack_int4  # noqa: E402
from repro_torch.kernels import build, tiling  # noqa: E402
from repro_torch.kernels.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.tiling import (ATTN_WARP_POSITIONS,  # noqa: E402
                                        ATTN_WARPS, MAX_SMEM, N_SMS,
                                        attention_plan)
from torch_port_helpers import np_of  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -2.0e38


# ------------------------------------------------------------------ plan

# (b, kvh, g, dh, page, nb, bits): the smoke's decode and long shapes
# (contiguous identity views and 16-token pools), GQA, the CPU tests'
# small pools, a wide batch, dh 256 f32, page 1
PLAN_SHAPES = [
    (4, 32, 1, 96, 96, 2, 8), (4, 32, 1, 96, 96, 2, 4),
    (4, 32, 1, 96, 128, 9, 8), (4, 32, 1, 96, 128, 33, 8),
    (4, 32, 1, 96, 128, 33, 4), (4, 32, 1, 96, 128, 33, 16),
    (4, 32, 1, 96, 128, 33, 32), (4, 32, 1, 96, 16, 264, 8),
    (4, 8, 4, 96, 16, 6, 8), (4, 8, 4, 96, 128, 33, 4),
    (3, 2, 4, 24, 5, 3, 8), (2, 2, 2, 16, 4, 3, 4), (1, 1, 1, 8, 3, 1, 32),
    (64, 32, 1, 96, 16, 264, 8), (9, 32, 1, 96, 128, 2, 8),
    (1, 1, 8, 256, 1, 4096, 32), (2, 4, 8, 256, 16, 100, 16),
]


def _fits(shape, heads):
    try:
        attention_plan(*shape, heads=heads)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_attention_plan_tiles_the_capacity(shape):
    b, kvh, g, dh, page, nb, bits = shape
    plan = attention_plan(*shape)
    cap = nb * page
    assert plan.splits in (1, 2, 4, 8, 16, 32)
    # short capacities: one head a CTA; else the largest head group that
    # divides KV and fits
    if nb * page <= tiling.ATTN_SHORT:
        assert (plan.heads, plan.splits) == (1, 1)
    else:
        assert plan.heads == next(h for h in (4, 2, 1)
                                  if kvh % h == 0 and _fits(shape, h))
    wph = ATTN_WARPS // plan.heads
    assert plan.chunk % wph == 0 and plan.chunk // wph in ATTN_WARP_POSITIONS
    ranges = plan.ranges(cap)
    assert len(ranges) == plan.splits
    covered = []
    for lo, hi in ranges:
        assert 0 <= lo <= hi <= cap
        covered.extend(range(lo, hi))
    assert covered == list(range(cap))          # exactly once, in order
    # table entries a split may straddle, and shared memory within the card
    assert plan.n_tab >= -(-plan.split_len // page) + 1
    assert plan.smem <= MAX_SMEM
    # more splits only while the CTAs fit one wave of two an SM
    if plan.splits > 1:
        assert b * kvh // plan.heads * plan.splits <= 2 * N_SMS


@pytest.mark.parametrize("bits", [8, 4, 16, 32])
def test_attention_plan_walks_a_short_capacity_unsplit(bits):
    """The smoke's decode cache (t = 192, page 96): one CTA a KV head, no
    split (no combine), one sub-chunk where the card's shared memory holds
    it (int8, int4) and the fewest it can otherwise."""
    plan = attention_plan(4, 32, 1, 96, 96, 2, bits)
    assert (plan.heads, plan.splits, plan.split_len) == (1, 1, 192)
    assert plan.chunk == (256 if bits in (8, 4) else plan.chunk)
    assert plan.smem <= MAX_SMEM
    assert attention_plan(4, 32, 1, 96, 64, 16, bits).splits == 1   # 1024


@pytest.mark.parametrize("shape", [(4, 32, 1, 96, 128, 9, 8),
                                   (4, 32, 1, 96, 128, 9, 4),
                                   (4, 32, 1, 96, 128, 33, 8),
                                   (4, 32, 1, 96, 16, 264, 8)], ids=str)
def test_attention_plan_at_the_smoke_long_shapes(shape):
    """Past 1024 positions: groups of 4 KV heads, 8 splits, 256 CTAs (one
    wave of two an SM; 16 splits would be two), each taking 4 heads'
    contiguous rows."""
    b, kvh = shape[:2]
    plan = attention_plan(*shape)
    assert (plan.heads, plan.splits) == (4, 8)
    assert b * kvh // plan.heads * plan.splits == 256


@pytest.mark.parametrize("b,kvh", [(64, 32), (33, 32), (132, 8), (264, 1)])
def test_attention_plan_takes_one_split_when_slots_fill_two_waves(b, kvh):
    plan = attention_plan(b, kvh, 1, 96, 16, 264, 8)      # 4224 positions
    assert b * kvh // plan.heads >= 2 * N_SMS and plan.splits == 1


def test_attention_plan_keeps_splits_at_least_min_split_long():
    # forced into the long regime (heads given): 15 positions are too few
    # to split, 48 make 2 splits of 24, 64 make 4 of 16; a sub-chunk no
    # longer than a split needs (KV 1: 8 warps a head)
    assert attention_plan(1, 1, 1, 16, 5, 3, 8, heads=1).splits == 1
    plan = attention_plan(1, 1, 1, 16, 16, 3, 8, heads=1)
    assert (plan.splits, plan.split_len, plan.chunk) == (2, 24, 32)
    plan = attention_plan(1, 1, 1, 16, 16, 4, 8, heads=1)
    assert (plan.splits, plan.split_len, plan.chunk) == (4, 16, 32)


@pytest.mark.parametrize("kw,match", [
    (dict(g=9), "G <= 8"), (dict(dh=257), "dh <= 256"),
    (dict(bits=4, dh=15), "bits"), (dict(bits=6), "bits"),
    (dict(page=1, nb=1 << 23), "shared"),
    (dict(splits=33), "splits"), (dict(chunk=48), "chunk"),
    (dict(heads=3), "heads"), (dict(kvh=6, heads=4), "heads"),
])
def test_attention_plan_raises_beyond_the_kernel_limits(kw, match):
    shape = dict(b=1, kvh=1, g=1, dh=16, page=16, nb=4, bits=8)
    forced = {k: kw.pop(k) for k in ("splits", "chunk", "heads") if k in kw}
    shape.update(kw)
    with pytest.raises(ValueError, match=match):
        attention_plan(*shape.values(), **forced)


def test_attention_plan_depends_on_no_device_tensor():
    """The plan takes host shapes only, and is cached per shape: kv_len
    (a device tensor) never reaches it."""
    import inspect
    params = list(inspect.signature(attention_plan).parameters)
    assert params == ["b", "kvh", "g", "dh", "page", "nb", "bits", "splits",
                      "chunk", "heads", "stages", "warps"]
    assert attention_plan(4, 32, 1, 96, 96, 2, 8) is \
        attention_plan(4, 32, 1, 96, 96, 2, 8)


def test_attention_constants_mirror_the_cuda_source():
    src = (build.CSRC / "paged_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxG") == tiling.ATTN_MAX_G
    assert const("kMaxDh") == tiling.ATTN_MAX_DH
    assert const("kMaxHeads") == tiling.ATTN_MAX_HEADS
    assert const("kMaxSplits") == tiling.ATTN_MAX_SPLITS
    assert const("kMaxSmem") == tiling.MAX_SMEM
    assert const("kPPitch") == 8
    for macro, value in (("PA_STAGES", tiling.ATTN_STAGES),
                         ("PA_WARPS", tiling.ATTN_WARPS)):
        assert int(re.search(rf"#define {macro} (\d+)", src).group(1)) \
            == value


# ------------------------------------------------------------- emulation

def _dequant(leaf, scale, bits):
    if bits == 4:
        leaf = unpack_int4(leaf, axis=-1)
    x = leaf.to(torch.float32)
    return x if scale is None else x * scale[..., None]


def split_kv_emulation(q, kq, vq, ks, vs, table, kv_len, *, plan,
                       window=None, softcap=0.0):
    """The kernel's partition and combine in plain torch, f32.  For each
    slot and KV head: each split of ``plan.ranges`` keeps its valid
    positions [max(p0, lo), min(p1, kv_len)) and walks them in sub-chunks
    of ``plan.chunk``; the head's 8 / ``plan.heads`` warps each take their
    share of every sub-chunk (``chunk * heads / 8`` positions) with an
    online softmax of their own (scores from the integer rows, then the K
    scale and 1/sqrt(dh), then the softcap; the V scale folded into p).
    The warps, then the splits, are combined in order, each weighted by
    exp(m_i - max m) where l_i > 0 and by 0 where it saw no position."""
    b, kvh, g, dh = q.shape
    bits = {torch.int8: 8, torch.uint8: 4}.get(kq.dtype, 32)
    page, nb = kq.shape[1], table.shape[1]
    cap = nb * page
    wph = ATTN_WARPS // plan.heads
    pw = plan.chunk // wph
    out = torch.zeros((b, kvh, g, dh), dtype=torch.float32)
    win = int(window or 0)

    def combine(parts):
        live = [pt for pt in parts if bool((pt[1] > 0).all())]
        mx = torch.stack([pt[0] for pt in live]).max(dim=0).values \
            if live else torch.full((g,), NEG_INF)
        acc = torch.zeros((g, dh))
        den = torch.zeros(g)
        for m, l, a in parts:
            w = torch.where(l > 0, torch.exp(m - mx), torch.zeros(g))
            acc = acc + w[:, None] * a
            den = den + w * l
        return mx, den, acc

    for bi in range(b):
        ln = int(kv_len[bi])
        lo = max(0, ln - win) if win > 0 else 0
        for h in range(kvh):
            qh = q[bi, h].to(torch.float32)                   # (g, dh)
            splits = []
            for p0, p1 in plan.ranges(cap):
                a, e = max(p0, lo), min(p1, ln)
                warps = []
                for part in range(wph):
                    m = torch.full((g,), NEG_INF)
                    l = torch.zeros(g)
                    acc = torch.zeros((g, dh))
                    for start in range(a, e, plan.chunk):
                        w0 = start + part * pw
                        w1 = min(w0 + pw, start + plan.chunk, e)
                        if w1 <= w0:
                            continue
                        pos = torch.arange(w0, w1)
                        pid = table[bi, pos // page].long()
                        off = pos % page
                        k = _dequant(kq[pid, off, h], None, bits)
                        v = _dequant(vq[pid, off, h], None, bits)
                        s = qh @ k.T                          # (g, n)
                        if ks is not None:
                            s = s * ks[pid, off, h]
                        s = s * (1.0 / math.sqrt(dh))
                        if softcap:
                            s = softcap * torch.tanh(s / softcap)
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        p = torch.exp(s - m_new[:, None])
                        corr = torch.exp(m - m_new)
                        l = l * corr + p.sum(dim=1)
                        pv = p * vs[pid, off, h] if vs is not None else p
                        acc = acc * corr[:, None] + pv @ v
                        m = m_new
                    warps.append((m, l, acc))
                splits.append(combine(warps))
            _, den, acc = combine(splits)
            out[bi, h] = acc / torch.clamp(den, min=1e-30)[:, None]
    return out


def _pool(b, kvh, g, dh, page, nb, bits, kv_len, *, trash=False, seed=0):
    """Random pool quantized by the JAX ``quantize_kv``, a shuffled table,
    and with ``trash`` the blocks past each fill level routed to page 0."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * nb
    q = rng.standard_normal((b, kvh, g, dh)).astype(np.float32)
    kf = rng.standard_normal((n_pages, page, kvh, dh)).astype(np.float32)
    vf = rng.standard_normal((n_pages, page, kvh, dh)).astype(np.float32)
    if bits < 32:
        kq, ks = (np.array(a) for a in j_qkv(jnp.asarray(kf), bits))
        vq, vs = (np.array(a) for a in j_qkv(jnp.asarray(vf), bits))
    else:
        kq, vq, ks, vs = kf, vf, None, None
    table = rng.permutation(np.arange(1, n_pages)).reshape(b, nb).astype(
        np.int32)
    kv_len = np.asarray(kv_len, np.int32)
    if trash:
        live = -(-kv_len // page)
        table = np.where(np.arange(nb)[None, :] < live[:, None], table, 0)
    return q, kq, vq, ks, vs, table.astype(np.int32), kv_len


# (name, bits, g, dh, page, nb, kv_len, window, softcap, trash)
EMU_CASES = [
    ("trailing empty", 8, 1, 16, 16, 8, [128, 5], None, 0.0, False),
    ("leading empty", 4, 4, 16, 16, 8, [100, 128], 20, 30.0, False),
    ("page 96", 8, 1, 24, 96, 2, [144, 1], None, 0.0, False),
    ("page 96 window", 4, 2, 24, 96, 2, [150, 96], 50, 0.0, False),
    ("trash tails", 8, 4, 16, 16, 8, [37, 64], None, 20.0, True),
    ("float pool", 32, 2, 12, 16, 6, [96, 50], 33, 0.0, True),
]
# forced (splits, heads, chunk), and the plan's own choice
EMU_PLANS = [None, (1, 1, 32), (4, 2, 32), (8, 2, 64), (2, 1, 64)]


@pytest.mark.parametrize("plan_kw", EMU_PLANS, ids=str)
@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: c[0])
def test_split_kv_emulation_matches_the_plain_versions(case, plan_kw):
    name, bits, g, dh, page, nb, lens, window, softcap, trash = case
    arrs = _pool(2, 2, g, dh, page, nb, bits, lens, trash=trash,
                 seed=len(name))
    forced = {} if plan_kw is None else dict(
        splits=plan_kw[0], heads=plan_kw[1], chunk=plan_kw[2])
    plan = attention_plan(2, 2, g, dh, page, nb, bits, **forced)
    t_args = [None if a is None else torch.from_numpy(np.array(a))
              for a in arrs]
    got = split_kv_emulation(*t_args, plan=plan, window=window,
                             softcap=softcap)
    want = paged_attention_ref(*t_args, window=window, softcap=softcap)
    np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
    j_args = [None if a is None else jnp.asarray(a) for a in arrs]
    j_want = np.asarray(j_paged_ref(*j_args, window=window, softcap=softcap))
    np.testing.assert_allclose(np_of(got), j_want, **TOL)


def test_split_kv_emulation_matches_the_jax_kernel():
    """One case against the JAX Pallas kernel (interpret mode): int8, GQA,
    window and softcap over 16-token pages with trash-page tails, in 4
    splits of which the first is emptied by the window."""
    arrs = _pool(2, 2, 4, 16, 16, 8, 8, [120, 70], trash=True, seed=3)
    plan = attention_plan(2, 2, 4, 16, 16, 8, 8, splits=4, heads=2,
                          chunk=16)
    t_args = [torch.from_numpy(np.array(a)) for a in arrs]
    got = split_kv_emulation(*t_args, plan=plan, window=60, softcap=30.0)
    want = np.asarray(j_paged(*[jnp.asarray(a) for a in arrs], window=60,
                              softcap=30.0))
    np.testing.assert_allclose(np_of(got), want, **TOL)


def test_split_kv_emulation_gives_zero_when_no_position_is_valid():
    """kv_len 0: every split is empty, each weighs 0, and the output is 0
    (the kernel's answer, as the one it replaces gave)."""
    arrs = _pool(1, 2, 2, 16, 16, 4, 8, [0], seed=5)
    plan = attention_plan(1, 2, 2, 16, 16, 4, 8, splits=4)
    t_args = [torch.from_numpy(np.array(a)) for a in arrs]
    got = split_kv_emulation(*t_args, plan=plan)
    assert float(got.abs().max()) == 0.0
