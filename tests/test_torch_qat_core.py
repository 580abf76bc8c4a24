"""The port's quantization-aware-training core, held against the JAX
reference on the same numpy inputs.

* Bit for bit: ``from_float``, ``compose_int`` (of drifted planes too),
  ``requantize``,
  ``adjust_precision`` (the masks), ``fq_maintenance`` (the LUT and the
  snapped ``w``), ``pack``, and the counts ``bitwidths``,
  ``layer_bit_count``, ``fq_live_bits``, ``quant_summary``.  The
  maintenance inputs plant blocks whose largest magnitude is exactly
  2^k - 1 and 2^k, where ``ceil(log2(max + 1))`` is at its edge.
* Gradient ties: ``jax.grad`` against torch autograd, to 1e-6 of the
  gradient's largest magnitude, on inputs planted with w = +-0, q = 0,
  q = cap, beta = 1e-6 and x = +-beta.  There torch's own ``abs`` (0 at
  +-0, where the reference passes 1) and ``clamp`` (1 at a tie, where the
  reference's ``clip``/``maximum`` pass 0.5) would differ; the port
  mirrors the reference (``core.quantize.abs_``, ``maximum``, ``clip``).
"""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitrep as jb  # noqa: E402
from repro.core import fakequant as jf  # noqa: E402
from repro.core import group_lasso as jgl  # noqa: E402
import repro.core.pact  # noqa: E402,F401
from repro.core import precision as jprec  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.blocking import BlockingSpec as JSpec  # noqa: E402
from repro_torch.core import bitrep as tb  # noqa: E402
from repro_torch.core import fakequant as tf  # noqa: E402
from repro_torch.core import group_lasso as tgl  # noqa: E402
from repro_torch.core import pact as tpact  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.core.blocking import BlockingSpec as TSpec  # noqa: E402
from torch_port_helpers import np_of  # noqa: E402

torch.set_num_threads(2)
# repro.core re-exports the function ``pact`` over its submodule's name
jpact = sys.modules["repro.core.pact"]
GRAD_TOL = 1e-6
GEOMETRIES = [(9, 8), (8, 16)]


def _eq(a, b):
    np.testing.assert_array_equal(np_of(a), np_of(b))


def _w(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.1).astype(
        np.float32)


def _qt_pair(planes, sign, scale, mask, shape, wbr, wbc):
    """The same QuantizedTensor in both packages, from numpy arrays."""
    j = jb.QuantizedTensor(planes=jnp.asarray(planes), sign=jnp.asarray(sign),
                           scale=jnp.asarray(scale), mask=jnp.asarray(mask),
                           shape=tuple(shape), spec=JSpec(wbr, wbc))
    t = tb.QuantizedTensor(planes=torch.tensor(planes),
                           sign=torch.tensor(sign),
                           scale=torch.tensor(scale), mask=torch.tensor(mask),
                           shape=tuple(shape), spec=TSpec(wbr, wbc))
    return j, t


def _drifted(shape, wbr, wbc, seed, per_block=False):
    """A stacked QuantizedTensor pair whose planes drifted off binary (as
    QAT leaves them) and whose masks are prefix masks of mixed widths,
    some blocks empty; block (0, 0) of every layer keeps all 8 planes live
    with the top three at zero, so precision adjustment prunes it."""
    rng = np.random.default_rng(seed)
    j0 = jb.from_float(jnp.asarray(_w(shape, seed)), 8, JSpec(wbr, wbc),
                       per_block_scale=per_block)
    planes = np.asarray(j0.planes) + rng.normal(
        scale=0.2, size=j0.planes.shape).astype(np.float32)
    planes = np.clip(planes, 0.0, None).astype(np.float32)
    bw = rng.integers(0, 9, size=j0.mask.shape[1:])
    bw[..., 0, 0] = 8
    planes[5:, ..., :wbr, :wbc] = 0.0
    mask = (np.arange(8).reshape((8,) + (1,) * bw.ndim) < bw).astype(
        np.float32)
    return _qt_pair(planes, np.asarray(j0.sign), np.asarray(j0.scale), mask,
                    shape, wbr, wbc)


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("wbr,wbc", GEOMETRIES)
def test_from_float_compose_int_bit_exact(wbr, wbc, per_block):
    """``from_float`` (planes, sign, scale, mask) and ``compose_int`` /
    ``compose`` of its exact-binary planes are the reference's bit for
    bit, for a stacked (2, 40, 56) leaf."""
    w = _w((2, 40, 56), 0)
    j = jb.from_float(jnp.asarray(w), 8, JSpec(wbr, wbc),
                      per_block_scale=per_block)
    t = tb.from_float(torch.tensor(w), 8, TSpec(wbr, wbc),
                      per_block_scale=per_block)
    for f in ("planes", "sign", "scale", "mask"):
        _eq(getattr(t, f), getattr(j, f))
    assert t.shape == j.shape and t.n_bits == j.n_bits
    _eq(tb.compose_int(t), jb.compose_int(j))
    _eq(tb.compose(t), jb.compose(j))
    _eq(tb.bitwidths(t), jb.bitwidths(j))
    assert tb.param_count(t) == jb.param_count(j)
    assert float(tb.live_bits(t)) == float(jb.live_bits(j))


@pytest.mark.parametrize("wbr,wbc", GEOMETRIES)
def test_requantize_adjust_pack_bit_exact(wbr, wbc):
    """On drifted planes with mixed prefix masks: ``compose_int`` and
    ``requantize`` planes, ``adjust_precision`` masks (monotone, never
    above the old), ``pack``'s values and LUT, and the bit counts equal the
    reference's."""
    j, t = _drifted((2, 40, 56), wbr, wbc, 3)
    _eq(tb.compose_int(t), jb.compose_int(j))
    _eq(tb.compose(t), jb.compose(j))
    jr, tr = jq.requantize(j), tq.requantize(t)
    _eq(tr.planes, jr.planes)
    ja, ta = jprec.adjust_precision(jr), tprec.adjust_precision(tr)
    _eq(ta.mask, ja.mask)
    assert (np_of(ta.mask) <= np_of(t.mask)).all()
    assert (np_of(ta.mask) < np_of(t.mask)).any()       # something pruned
    jp, tp = jq.pack(ja), tq.pack(ta)
    _eq(tp.values, jp.values)
    _eq(tp.bitwidth, jp.bitwidth)
    assert tp.values.dtype == torch.int16
    _eq(tq.unpack_to_float(tp, ta.spec), jq.unpack_to_float(jp, ja.spec))
    _eq(tgl.layer_bit_count(ta), jgl.layer_bit_count(ja))
    _eq(tb.bitwidths(ta), jb.bitwidths(ja))


def test_requantize_rescale_per_block():
    """The optional per-block rescale refits the scale as the
    reference's."""
    j, t = _drifted((40, 56), 9, 8, 4, per_block=True)
    _eq(tq.requantize(t, rescale=True).scale,
        jq.requantize(j, rescale=True).scale)


def _edge_fq(wbr, wbc, seed):
    """A stacked FakeQuantTensor (2, 36, 48) whose blocks' largest grid
    magnitude is 2^k - 1 or 2^k for k = 0..7 (plus all-zero blocks), with
    a LUT of mixed widths that caps some of them."""
    rng = np.random.default_rng(seed)
    spec = JSpec(wbr, wbc)
    gr, gc = spec.grid(36, 48)
    q = np.zeros((2, gr * wbr, gc * wbc), np.float32)
    tops = [0] + [2 ** k - 1 for k in range(1, 9)] + [2 ** k for k in range(8)]
    for li in range(2):
        for g in range(gr):
            for h in range(gc):
                top = tops[rng.integers(len(tops))]
                blk = rng.integers(0, top + 1, size=(wbr, wbc))
                blk.flat[rng.integers(wbr * wbc)] = top
                q[li, g * wbr:(g + 1) * wbr, h * wbc:(h + 1) * wbc] = blk
    scale = np.array([0.7, 1.3], np.float32)
    sign = np.where(rng.random(q.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    w = (sign * q * (scale[:, None, None] / 255.0))[:, :36, :48]
    w = w + rng.normal(scale=1e-3, size=w.shape).astype(np.float32) * (
        q[:, :36, :48] > 0)
    bw = rng.integers(0, 9, size=(2, gr, gc)).astype(np.float32)
    bw[rng.random(bw.shape) < 0.5] = 8.0
    j = jf.FakeQuantTensor(w=jnp.asarray(w), scale=jnp.asarray(scale),
                           bitwidth=jnp.asarray(bw), shape=w.shape,
                           spec=spec, n_bits=8)
    t = tf.FakeQuantTensor(w=torch.tensor(w), scale=torch.tensor(scale),
                           bitwidth=torch.tensor(bw), shape=w.shape,
                           spec=TSpec(wbr, wbc), n_bits=8)
    return j, t


@pytest.mark.parametrize("wbr,wbc", GEOMETRIES)
def test_fq_maintenance_bit_exact_at_log2_edges(wbr, wbc):
    """``fq_maintenance``'s snapped ``w`` and new LUT, ``fq_compose`` and
    ``fq_live_bits`` equal the reference's bit for bit, with blocks at
    every ``ceil(log2(max + 1))`` edge; the LUT never grows."""
    j, t = _edge_fq(wbr, wbc, 5)
    jm, tm = jf.fq_maintenance(j), tf.fq_maintenance(t)
    _eq(tm.w, jm.w)
    _eq(tm.bitwidth, jm.bitwidth)
    assert (np_of(tm.bitwidth) <= np_of(t.bitwidth)).all()
    assert len(np.unique(np_of(tm.bitwidth))) == 9       # every width 0..8
    _eq(tf.fq_compose(t), jf.fq_compose(j))
    _eq(tf.fq_live_bits(tm), jf.fq_live_bits(jm))
    # a second maintenance changes nothing: w is on its grid
    _eq(tf.fq_maintenance(tm).w, tm.w)


def test_quant_summary_and_maps():
    """``quant_summary``, ``per_layer_bitwidth_maps``, ``quantized_leaves``
    and ``map_quantized`` over a mixed tree agree with the reference's."""
    j1, t1 = _drifted((2, 40, 56), 9, 8, 6)
    j2, t2 = _drifted((40, 24), 8, 16, 7)
    jf1, tf1 = _edge_fq(9, 8, 8)
    jtree = {"a": {"w": j1, "f": jf1}, "b": j2, "x": jnp.ones(3)}
    ttree = {"a": {"w": t1, "f": tf1}, "b": t2, "x": torch.ones(3)}
    js, ts = jstate.quant_summary(jtree), tstate.quant_summary(ttree)
    assert ts == pytest.approx(js, rel=0, abs=0)
    jm, tm = jstate.per_layer_bitwidth_maps(jtree), \
        tstate.per_layer_bitwidth_maps(ttree)
    assert list(tm) == list(jm)
    for k in jm:
        _eq(tm[k], jm[k])
    mapped = tstate.map_quantized(tprec.adjust_precision, ttree)
    assert mapped["a"]["f"] is tf1 and mapped["x"] is ttree["x"]
    _eq(mapped["b"].mask, jprec.adjust_precision(j2).mask)
    assert tgl.model_compression_ratio(tstate.quantized_leaves(ttree)
                                       .values()) == \
        jgl.model_compression_ratio(jstate.quantized_leaves(jtree).values())


def test_ste_round_forward_is_the_reference_expression():
    """``x + (round(x) - x)`` in f32 and bf16, ties included."""
    x = np.concatenate([np.arange(-4, 4.5, 0.5),
                        np.random.default_rng(0).normal(size=64) * 40]
                       ).astype(np.float32)
    _eq(tq.ste_round(torch.tensor(x)), jq.ste_round(jnp.asarray(x)))
    xb = torch.tensor(x).to(torch.bfloat16)
    got = tq.ste_round(xb).float()
    want = jq.ste_round(jnp.asarray(x).astype(jnp.bfloat16)).astype(
        jnp.float32)
    _eq(got, want)


# ---------------------------------------------------------------------------
# gradients at ties
# ---------------------------------------------------------------------------

def _grads(jfn, tfn, args, wrt):
    """Gradients of sum(f(*args) * R) (R a fixed random cotangent) with
    respect to the args at positions ``wrt``, by ``jax.grad`` and by torch
    autograd."""
    out = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    r = np.random.default_rng(9).normal(size=out.shape).astype(np.float32)

    def jloss(*xs):
        full = [jnp.asarray(a) for a in args]
        for i, x in zip(wrt, xs):
            full[i] = x
        return jnp.sum(jfn(*full) * r)
    jg = jax.grad(jloss, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(args[i]) for i in wrt])
    targs = [torch.tensor(a) for a in args]
    for i in wrt:
        targs[i].requires_grad_(True)
    (tfn(*targs) * torch.tensor(r)).sum().backward()
    return [(np.asarray(g), targs[i].grad.numpy()) for g, i in zip(jg, wrt)]


def _close(pairs):
    for j, t in pairs:
        scale = max(np.abs(j).max(), 1e-30)
        assert np.abs(t - j).max() <= GRAD_TOL * scale, (j, t)


def _tie_fq():
    """w (2, 18, 16) at 9x8 with planted +-0, values rounding to q = 0,
    values exactly on the cap of their block (q == cap), saturated values
    and interior values."""
    rng = np.random.default_rng(1)
    scale = np.array([1.0, 0.5], np.float32)
    bw = rng.integers(1, 9, size=(2, 2, 2)).astype(np.float32)
    cap = 2.0 ** bw - 1
    w = (rng.normal(size=(2, 18, 16)) * 0.3).astype(np.float32)
    for li in range(2):
        for g in range(2):
            for h in range(2):
                blk = w[li, g * 9:(g + 1) * 9, h * 8:(h + 1) * 8]
                c = cap[li, g, h]
                blk[0, 0] = 0.0
                blk[0, 1] = -0.0
                blk[0, 2] = 1e-4 * scale[li]                 # q rounds to 0
                blk[0, 3] = c * scale[li] / 255.0            # q == cap
                blk[0, 4] = -c * scale[li] / 255.0
                blk[0, 5] = (c + 3) * scale[li] / 255.0      # saturated
    return w, scale, bw


def test_grad_ties_fq_compose_and_group_lasso():
    """``fq_compose`` and ``fq_group_lasso``: d/dw at w = +-0, q = 0,
    q = cap, saturation; blocks with bit-width 0 (not alive) included."""
    w, scale, bw = _tie_fq()
    bw[0, 0, 0] = 0.0
    spec_j, spec_t = JSpec(9, 8), TSpec(9, 8)

    def jfq(w):
        return jf.FakeQuantTensor(w=w, scale=jnp.asarray(scale),
                                  bitwidth=jnp.asarray(bw), shape=w.shape,
                                  spec=spec_j)

    def tfq(w):
        return tf.FakeQuantTensor(w=w, scale=torch.tensor(scale),
                                  bitwidth=torch.tensor(bw),
                                  shape=tuple(w.shape), spec=spec_t)
    pairs = _grads(lambda w: jf.fq_compose(jfq(w)),
                   lambda w: tf.fq_compose(tfq(w)), [w], [0])
    j, t = pairs[0]
    assert (j[0, 0, :2] != 0).all()      # the reference passes +-0 through
    _close(pairs)
    _close(_grads(lambda w: jf.fq_group_lasso(jfq(w)),
                  lambda w: tf.fq_group_lasso(tfq(w)), [w], [0]))


def test_grad_ties_compose_and_wb_group_lasso():
    """``compose`` (d/dplanes, d/dscale) and ``wb_group_lasso``
    (d/dplanes) on drifted planes with exact zeros and masked-out
    blocks."""
    j, _ = _drifted((2, 18, 16), 9, 8, 2)
    planes = np.asarray(j.planes).copy()
    planes[:, 0, :9, :8] = 0.0                  # an all-zero block
    sign, scale, mask = (np.asarray(j.sign), np.asarray(j.scale),
                         np.asarray(j.mask))
    spec_j, spec_t = JSpec(9, 8), TSpec(9, 8)

    def jqt(p, s):
        return jb.QuantizedTensor(planes=p, sign=jnp.asarray(sign), scale=s,
                                  mask=jnp.asarray(mask), shape=(2, 18, 16),
                                  spec=spec_j)

    def tqt(p, s):
        return tb.QuantizedTensor(planes=p, sign=torch.tensor(sign),
                                  scale=s, mask=torch.tensor(mask),
                                  shape=(2, 18, 16), spec=spec_t)
    _close(_grads(lambda p, s: jb.compose(jqt(p, s)),
                  lambda p, s: tb.compose(tqt(p, s)), [planes, scale],
                  [0, 1]))
    _close(_grads(lambda p, s: jgl.wb_group_lasso(jqt(p, s)),
                  lambda p, s: tgl.wb_group_lasso(tqt(p, s)),
                  [planes, scale], [0]))


@pytest.mark.parametrize("beta", [2.0, 1e-6, 0.0])
@pytest.mark.parametrize("act_bits", [8, 4, 32])
def test_grad_ties_pact(beta, act_bits):
    """``pact_sym_quant`` and ``pact_quant``: d/dx and d/dbeta at x = +-0,
    x = +-beta, beyond the clip, and beta at (and below) the 1e-6 floor."""
    x = np.random.default_rng(2).normal(size=(6, 16)).astype(np.float32) * 3
    x[0, :6] = [0.0, -0.0, beta, -beta, 2 * beta + 1, -2 * beta - 1]
    # beta broadcast to x's shape: d/dbeta per element (a scalar beta's
    # gradient sums terms that cancel, and the sum's order is not the
    # reference's)
    b = np.full(x.shape, beta, np.float32)
    for jfn, tfn in ((jpact.pact_sym_quant, tpact.pact_sym_quant),
                     (jpact.pact_quant, tpact.pact_quant)):
        _close(_grads(lambda x, b: jfn(x, b, act_bits),
                      lambda x, b: tfn(x, b, act_bits), [x, b], [0, 1]))


def test_grad_quantize_signed():
    """``quantize_signed`` with its max-|x| scale (ties at the max split
    evenly) and with a given scale at x = +-scale."""
    x = np.random.default_rng(3).normal(size=(5, 8)).astype(np.float32)
    x[0, 0], x[1, 1] = 2.5, -2.5                # tied largest magnitude
    _close(_grads(lambda x: jpact.quantize_signed(x, 8),
                  lambda x: tpact.quantize_signed(x, 8), [x], [0]))
    s = np.float32(1.0)
    x[2, :2] = [1.0, -1.0]
    _close(_grads(lambda x, s: jpact.quantize_signed(x, 4, s),
                  lambda x, s: tpact.quantize_signed(x, 4, s), [x, s],
                  [0, 1]))


def test_no_grad_paths_match_tracked_values():
    """Without a gradient to track, ``abs_``/``maximum``/``clip`` take
    torch's plain ops; the values are the same as the tracked ops'."""
    x = torch.tensor([-2.0, -0.0, 0.0, 1e-7, 3.0])
    cap = torch.tensor([1.0, 1.0, 1.0, 1.0, 2.0])
    plain = (tq.abs_(x), tq.maximum(x, 1e-6), tq.clip(x, 0.0, cap),
             tq.clip(x, -1.0, 1.0))
    xt = x.clone().requires_grad_(True)
    tracked = (tq.abs_(xt), tq.maximum(xt, 1e-6), tq.clip(xt, 0.0, cap),
               tq.clip(xt, -1.0, 1.0))
    for a, b in zip(plain, tracked):
        assert a.grad_fn is None and b.grad_fn is not None
        _eq(a, b.detach())


def test_quantized_tensor_layer_and_to():
    """``layer(i)`` slices the layer axis behind the bit axis (views) and
    ``to`` moves every tensor."""
    _, t = _drifted((3, 18, 16), 9, 8, 1)
    lay = t.layer(1)
    _eq(lay.planes, t.planes[:, 1])
    _eq(lay.mask, t.mask[:, 1])
    assert lay.shape == (18, 16) and lay.scale.ndim == 0
    assert lay.planes.data_ptr() == t.planes[:, 1].data_ptr()
    moved = dataclasses.replace(t).to("cpu")
    _eq(moved.planes, t.planes)
