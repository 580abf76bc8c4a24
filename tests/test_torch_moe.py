"""The port's MoE module (``repro_torch.models.moe``) against the JAX
reference's single-device path (``repro.models.moe``).

Inputs are made with numpy from a seed and fed to both; reference weight
stacks cross through numpy (``repro_torch.bridge.params_from_numpy``).
Integer arithmetic (capacities, routing, group sizes) is held exact,
products within 1e-5, the MoE forward within 2e-4 and its aux loss
within 1e-6:

* ``_capacity`` over a grid of (tokens, experts);
* ``grouped_matmul`` against ``jax.lax.ragged_dot``, empty groups and a
  short tail included, and a row's bits alone equal to its bits in a
  group (the scheduler's staggered and one-shot runs route a request's
  tokens among different neighbours);
* ``grouped_matmul_capacity`` on f32, FakeQuant, packed int8 / int4 (9x8
  blocks: odd block-padded K) and bit-plane stacks, with a forced skew
  that drops tokens; under a deployed stack the loop makes 3 x E
  kernel-wrapper calls a layer and never hands ``qmatmul`` a 3-D stack;
* ``moe_forward`` under both dispatches, with and without a shared
  expert, on plain and deployed weights;
* top-k ties: equal router probabilities choose the experts
  ``jax.lax.top_k`` chooses (the lower id first).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.blocking import BlockingSpec as JSpec  # noqa: E402
from repro.core.fakequant import fq_from_float as j_fq  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import matmul_backend  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
MM_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
E, D, F_ = 4, 27, 40           # experts, d_model, d_ff (9x8: odd Kp=27)


@pytest.fixture(autouse=True)
def _ragged_default():
    """Every test starts and ends with the default dispatch in both
    packages."""
    yield
    jmoe.GROUPED_IMPL["impl"] = "ragged"
    tmoe.GROUPED_IMPL["impl"] = "ragged"


def _impl(name):
    jmoe.GROUPED_IMPL["impl"] = name
    tmoe.GROUPED_IMPL["impl"] = name


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _groups(rng, m, e, skew=False):
    """Sorted expert ids of ``m`` rows -> (E,) int32 group sizes; a skew
    sends most rows to expert 1 (past any capacity) and none to 2."""
    p = np.array([0.1, 0.8, 0.0, 0.1]) if skew else np.full(e, 1.0 / e)
    ids = rng.choice(e, size=m, p=p[:e] / p[:e].sum())
    return np.bincount(ids, minlength=e).astype(np.int32)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 33, 64, 100, 208, 4096])
def test_capacity_matches_reference(m):
    for e in (1, 4, 16, 40):
        for factor in (1.0, 2.0, 1.25):
            jmoe.GROUPED_IMPL["capacity_factor"] = factor
            tmoe.GROUPED_IMPL["capacity_factor"] = factor
            try:
                assert tmoe._capacity(m, e) == jmoe._capacity(m, e), (m, e)
            finally:
                jmoe.GROUPED_IMPL["capacity_factor"] = 2.0
                tmoe.GROUPED_IMPL["capacity_factor"] = 2.0


@pytest.mark.parametrize("sizes", [[3, 0, 5, 2], [0, 0, 10, 0], [1, 1, 1, 1],
                                   [4, 0, 0, 3]])
def test_grouped_matmul_matches_ragged_dot(sizes):
    """Empty groups produce nothing; rows past the groups' sum (the last
    case leaves 3) are zero, as ``ragged_dot`` leaves them."""
    rng = np.random.default_rng(0)
    m = 10
    x = rng.standard_normal((m, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F_)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(gs)))
    got = tmoe.grouped_matmul(_t(x), _t(w), _t(gs))
    np.testing.assert_allclose(np_of(got), want, **MM_TOL)
    assert got.shape == (m, F_) and got.dtype == torch.float32
    np.testing.assert_array_equal(np_of(tmoe.grouped_matmul(_t(x), _t(w),
                                                            sizes)),
                                  np_of(got))


@pytest.mark.parametrize("k,n", [(128, 256), (256, 128), (27, 40)])
def test_grouped_matmul_rows_are_independent(k, n):
    """Each row's output has the same bits multiplied alone (a group of
    one) as in a group of any other size: no row depends on how many
    rows share its expert."""
    rng = np.random.default_rng(1)
    w = _t(rng.standard_normal((3, k, n)).astype(np.float32))
    x = _t(rng.standard_normal((70, k)).astype(np.float32))
    for sizes in ([1, 69, 0], [2, 34, 34], [33, 1, 36], [70, 0, 0]):
        y = tmoe.grouped_matmul(x, w, sizes)
        start = 0
        for g, size in enumerate(sizes):
            for r in (start, start + size - 1):
                if size == 0:
                    continue
                alone = tmoe.grouped_matmul(x[r:r + 1], w[g:g + 1], [1])
                assert torch.equal(alone[0], y[r]), (sizes, g, r)
            start += size


def _stack(kind, rng, shape=(E, D, F_)):
    """An (E, K, N) expert stack in both packages: plain f32, FakeQuant
    (mixed per-WB widths), packed int8 / int4 or bit-plane (9x8 blocks)."""
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                    / np.sqrt(shape[-2]))
    if kind == "f32":
        return w, _t(w)
    fq = j_fq(w, 8, JSpec(9, 8))
    bw = rng.choice(9, size=fq.bitwidth.shape,
                    p=np.array([1] * 6 + [6] * 3) / 24).astype(np.float32)
    fq = dataclasses.replace(fq, bitwidth=jnp.asarray(bw))
    if kind == "fake":
        jw = fq
    else:
        bits = 4 if kind == "int4" else 8
        layout = "bitplane" if kind == "bitplane" else "packed"
        jw = j_deploy({"w": fq}, bits, layout=layout)["w"]
    return jw, params_from_numpy(tree_to_numpy({"w": jw}), device="cpu")["w"]


KINDS = ["f32", "fake", "int8", "int4", "bitplane"]


def _jax_backend(kind):
    return "bitplane" if kind == "bitplane" else "ref"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("skew", [False, True])
def test_grouped_matmul_capacity_matches_reference(kind, skew):
    """The capacity loop on every stack kind; the skewed routing sends
    more rows to one expert than its capacity holds, and those rows come
    back zero in both packages."""
    rng = np.random.default_rng(2)
    m = 24
    jw, tw = _stack(kind, rng)
    gs = _groups(rng, m, E, skew)
    cap = jmoe._capacity(m, E)
    assert tmoe._capacity(m, E) == cap
    if skew:
        assert gs.max() > cap
    x = rng.standard_normal((m, D)).astype(np.float32)
    with matmul_backend(_jax_backend(kind)):
        want = np.asarray(jmoe.grouped_matmul_capacity(
            jnp.asarray(x), jw, jnp.asarray(gs), cap))
    for be in ("kernel", "ref"):
        got = tmoe.grouped_matmul_capacity(_t(x), tw, _t(gs), cap, be)
        np.testing.assert_allclose(np_of(got), want, **MM_TOL,
                                   err_msg=f"{kind} {be}")
    if skew:
        start = int(gs[0])
        dropped = slice(start + cap, start + int(gs[1]))
        assert not np_of(got)[dropped].any() and not want[dropped].any()


@pytest.mark.parametrize("kind", ["int8", "int4", "bitplane"])
def test_capacity_runs_one_kernel_call_per_expert(kind, monkeypatch):
    """Under ``capacity`` a deployed MoE layer calls its kernel wrapper
    3 x E times (gate, up and down for every expert, empty groups
    included), each on a 2-D expert slice, and ``qmatmul`` never sees a
    3-D stack."""
    rng = np.random.default_rng(3)
    p = {n: _stack(kind, rng, shp)[1] for n, shp in (
        ("expert_gate", (E, D, F_)), ("expert_up", (E, D, F_)),
        ("expert_down", (E, F_, D)))}
    p["router_w"] = _t(rng.standard_normal((D, E)).astype(np.float32))
    name = "bitplane_matmul" if kind == "bitplane" else "packed_matmul"
    calls = []
    wrapper = getattr(tcommon, name)
    monkeypatch.setattr(tcommon, name, lambda *a, **k: (
        calls.append(a[1].ndim), wrapper(*a, **k))[1])
    qmatmul = tmoe.qmatmul

    def two_d_only(x, w, backend="dense"):
        payload = w.sign if kind == "bitplane" else w.w_int
        assert payload.ndim == 2, payload.shape
        return qmatmul(x, w, backend)
    monkeypatch.setattr(tmoe, "qmatmul", two_d_only)
    x = _t(rng.standard_normal((2, 5, D)).astype(np.float32))
    _impl("capacity")
    tmoe.moe_forward(p, x, 2, "kernel")
    assert len(calls) == 3 * E
    calls.clear()
    _impl("ragged")
    tmoe.moe_forward(p, x, 2, "kernel")
    assert calls == []         # the ragged product is plain torch


def _moe_params(kind, shared, rng):
    jp, tp = {}, {}
    shapes = [("expert_gate", (E, D, F_)), ("expert_up", (E, D, F_)),
              ("expert_down", (E, F_, D))]
    if shared:
        shapes += [("shared_gate", (D, F_)), ("shared_up", (D, F_)),
                   ("shared_down", (F_, D))]
    for name, shp in shapes:
        jp[name], tp[name] = _stack(kind, rng, shp)
    r = rng.standard_normal((D, E)).astype(np.float32) * 0.5
    jp["router_w"], tp["router_w"] = jnp.asarray(r), _t(r)
    return jp, tp


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("kind", ["f32", "int8", "bitplane"])
def test_moe_forward_matches_reference(impl, shared, kind):
    rng = np.random.default_rng(4)
    jp, tp = _moe_params(kind, shared, rng)
    x = rng.standard_normal((3, 7, D)).astype(np.float32)
    _impl(impl)
    with matmul_backend(_jax_backend(kind)):
        jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), 2)
    for be in ("dense", "kernel", "ref"):
        tout, taux = tmoe.moe_forward(tp, _t(x), 2, be)
        np.testing.assert_allclose(np_of(tout), np.asarray(jout), **FWD_TOL,
                                   err_msg=f"{impl} {kind} {be}")
        np.testing.assert_allclose(float(taux), float(jaux), rtol=0,
                                   atol=1e-6)
        assert tout.dtype == torch.float32 and taux.dtype == torch.float32


def test_moe_forward_bf16_matches_reference():
    """bf16 activations with a bf16 router weight (as ``prepare_params``
    leaves it): both packages take the router logits in f32, combine in
    bf16 in ascending expert id."""
    rng = np.random.default_rng(5)
    jp, tp = _moe_params("f32", True, rng)
    jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), 2)
    tout, taux = tmoe.moe_forward(tp, _t(x).to(torch.bfloat16), 2)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(tout.float()),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_ties_choose_reference_experts(k):
    """A zero router gives every token equal probabilities, and a router
    with two equal columns ties those experts: the port picks the experts
    ``jax.lax.top_k`` picks, lower id first, and routes the same token
    counts to each."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((11, D)).astype(np.float32)
    r = rng.standard_normal((D, E)).astype(np.float32)
    r[:, 3] = r[:, 1]
    for router in (np.zeros((D, E), np.float32), r):
        probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
        jv, ji = jax.lax.top_k(probs, k)
        _, tv, ti = tmoe._route(_t(x), _t(router), k)
        np.testing.assert_array_equal(np_of(ti), np.asarray(ji))
        np.testing.assert_allclose(np_of(tv), np.asarray(
            jv / jnp.sum(jv, -1, keepdims=True)), rtol=1e-6, atol=1e-7)


def test_combine_adds_in_ascending_expert_order():
    """Each token's k rows are added from zero in ascending expert id, in
    the rows' dtype: bit for bit the reference's scatter-add."""
    rng = np.random.default_rng(7)
    t, k = 9, 3
    experts = np.stack([rng.permutation(E)[:k] for _ in range(t)])
    flat = experts.reshape(-1)
    order = np.argsort(flat, kind="stable")
    tok_sorted = np.repeat(np.arange(t), k)[order]
    ys = rng.standard_normal((t * k, D)).astype(np.float32) * 1e3
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = jnp.zeros((t, D), jdt).at[jnp.asarray(tok_sorted)].add(
            jnp.asarray(ys, jdt))
        got = tmoe._combine(_t(ys).to(dt), _t(order), t, k)
        np.testing.assert_array_equal(np_of(got.float()),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n_shared", [0, 1])
def test_init_moe_tree_matches_reference_layout(n_shared):
    """``init_moe`` builds the reference's tree: the same keys, shapes and
    leaf kinds (a plain f32 router, quantized expert stacks)."""
    from repro.models.common import QuantConfig as JQ
    from repro_torch.configs.base import QuantConfig as TQ
    jp = jmoe.init_moe(jax.random.PRNGKey(0), D, F_, E, 2,
                       JQ(mode="fake", n_bits=8), n_shared=n_shared)
    tp = tmoe.init_moe(D, F_, E, 2, TQ(mode="fake", n_bits=8),
                       n_shared=n_shared,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert tp.keys() == jp.keys()
    for k in jp:
        quantized = hasattr(jp[k], "bitwidth")
        assert hasattr(tp[k], "bitwidth") == quantized, k
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
    assert tp["router_w"].dtype == torch.float32
