"""The vlm (qwen2-vl-2b, M-RoPE), ssm (rwkv6-1.6b) and hybrid (zamba2-1.2b)
families in the port, held against the JAX reference module by module and
as whole models, on the CPU in f32.

* ``mrope_angles``, ``_token_shift``, the chunked and the per-token WKV
  scans, ``_causal_conv``, the chunked and the per-token SSD scans,
  ``rwkv6_forward`` and ``mamba2_forward`` with and without a state, and
  ``_walk_hybrid`` with and without a tail: within 1e-5 of the largest
  value of the reference's output (the same inputs, made from a seed with
  numpy; parameters carried across through ``params_from_numpy``);
* the scan branch: the chunked form runs exactly when the width is a
  multiple of the chunk (after ``chunk = min(chunk, L)``) and exceeds 1,
  as the reference picks it;
* whole models with the quantizers off: prefill and teacher-forced
  decode logits within 2e-3 of the reference's (its own ``rtol`` /
  ``atol``), and prefill + decode equals the port's own full forward
  (the reference's tests/test_consistency.py rows); the chunked SSD scan
  equals the per-token recurrence;
* the family gate admits the three families, and so does the training
  gate.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
MOD_TOL = 1e-5                   # relative to the largest reference value
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ("qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b")


def _close(got, want, tol=MOD_TOL):
    want = np.asarray(want)
    err = np.abs(np_of(got) - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _rng(seed):
    return np.random.default_rng((21, seed))


def _both(a):
    """A numpy array as (jax array, torch tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _configs(arch, quant="none", **over):
    jq = JQ(mode=quant, n_bits=8, act_bits=8) if quant != "none" \
        else JQ(mode="none")
    tq = TQ(mode=quant, n_bits=8, act_bits=8) if quant != "none" \
        else TQ(mode="none")
    return (JREG[arch].tiny(dtype="float32", **over).with_quant(jq),
            TREG[arch].tiny(dtype="float32", **over).with_quant(tq))


def _carry(tree):
    return params_from_numpy(tree_to_numpy(tree), device="cpu")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_head", [32, 128])
def test_mrope_angles(d_head):
    """Sections (4, 6, 6) at d_head 32 and (16, 24, 24) at 128; three
    distinct position streams gather per frequency slot."""
    rng = _rng(1)
    pos = rng.integers(0, 300, (2, 5, 3)).astype(np.int32)
    jp, tp = _both(pos)
    want = jrope.mrope_angles(jp, d_head, 1e6)
    _close(trope.mrope_angles(tp, d_head, 1e6), want)
    # equal streams reduce to standard RoPE
    eq = np.repeat(pos[..., :1], 3, axis=-1)
    _close(trope.mrope_angles(torch.from_numpy(eq), d_head, 1e6),
           jrope.rope_angles(jnp.asarray(pos[..., 0]), d_head, 1e6))


def test_token_shift():
    x = _normal(_rng(2), 2, 5, 8)
    prev = _normal(_rng(3), 2, 8)
    for p in (None, prev):
        js, jl = jrwkv._token_shift(jnp.asarray(x),
                                    None if p is None else jnp.asarray(p))
        ts, tl = trwkv._token_shift(torch.from_numpy(x),
                                    None if p is None else
                                    torch.from_numpy(p))
        _close(ts, js)
        _close(tl, jl)


def _wkv_inputs(seed, L=64, b=2, H=2, K=8):
    rng = _rng(seed)
    return (_normal(rng, b, L, H, K), _normal(rng, b, L, H, K),
            _normal(rng, b, L, H, K),
            -np.abs(_normal(rng, b, L, H, K, scale=0.5)),
            _normal(rng, H, K, scale=0.1), _normal(rng, b, H, K, K))


@pytest.mark.parametrize("L,chunk", [(64, 16), (32, 32)])
def test_wkv_chunked(L, chunk):
    args = _wkv_inputs(4, L=L)
    jo, js = jrwkv._wkv_chunked(*(jnp.asarray(a) for a in args), chunk)
    to, ts = trwkv._wkv_chunked(*(torch.from_numpy(a) for a in args), chunk)
    _close(to, jo)
    _close(ts, js)


def test_wkv_steps_match_the_reference_scan():
    """The per-token branch of ``rwkv6_forward`` (a width that is not a
    multiple of the chunk) against the reference's ``lax.scan`` step."""
    r, k, v, logw, u, s0 = _wkv_inputs(5, L=7)

    def step(s, ins):
        r_t, k_t, v_t, lw_t = ins
        o_t = jnp.einsum("bhk,bhkv->bhv", r_t, s) + \
            jnp.einsum("bhk,hk,bhk,bhv->bhv", r_t, jnp.exp(u), k_t, v_t)
        s = s * jnp.exp(lw_t)[..., None] + \
            jnp.einsum("bhk,bhv->bhkv", k_t, v_t)
        return s, o_t
    seq = tuple(jnp.moveaxis(jnp.asarray(t), 1, 0) for t in (r, k, v, logw))
    js, jo = jax.lax.scan(step, jnp.asarray(s0), seq)
    to, ts = trwkv._wkv_steps(*(torch.from_numpy(a)
                                for a in (r, k, v, logw, u, s0)))
    _close(to, jnp.moveaxis(jo, 0, 1))
    _close(ts, js)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = _rng(6)
    x, w, b = _normal(rng, 2, 5, 16), _normal(rng, 4, 16), _normal(rng, 16)
    st = _normal(rng, 2, 3, 16) if with_state else None
    jy, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    ty, tst = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
    _close(ty, jy)
    _close(tst, jst)


def _ssd_inputs(seed, L=64, b=2, H=3, P=8, N=5):
    rng = _rng(seed)
    dt = np.log1p(np.exp(_normal(rng, b, L, H)))
    return (_normal(rng, b, L, H, P), dt.astype(np.float32),
            -np.abs(_normal(rng, b, L, H, scale=0.3)),
            _normal(rng, b, L, N), _normal(rng, b, L, N),
            _normal(rng, b, H, N, P))


def test_ssd_chunked():
    args = _ssd_inputs(7)
    jy, jh = jssm._ssd_chunked(*(jnp.asarray(a) for a in args), 16)
    ty, th = tssm._ssd_chunked(*(torch.from_numpy(a) for a in args), 16)
    _close(ty, jy)
    _close(th, jh)


def test_ssd_steps_match_the_reference_scan():
    xh, dt, da, B, C, h0 = _ssd_inputs(8, L=9)

    def step(hc, ins):
        xh_t, dt_t, da_t, b_t, c_t = ins
        hc = hc * jnp.exp(da_t)[:, :, None, None] + \
            jnp.einsum("bn,bh,bhp->bhnp", b_t, dt_t, xh_t)
        return hc, jnp.einsum("bn,bhnp->bhp", c_t, hc)
    seq = tuple(jnp.moveaxis(jnp.asarray(t), 1, 0)
                for t in (xh, dt, da, B, C))
    jh, jy = jax.lax.scan(step, jnp.asarray(h0), seq)
    ty, th = tssm._ssd_steps(*(torch.from_numpy(a)
                               for a in (xh, dt, da, B, C, h0)))
    _close(ty, jnp.moveaxis(jy, 0, 1))
    _close(th, jh)


def test_ssd_chunked_equals_stepwise():
    """The reference's tests/test_consistency.py row in the port: the
    chunked scan against a numpy per-token recurrence, 1e-4."""
    xh, dt, da, B, C, _ = _ssd_inputs(9)
    h0 = np.zeros((2, 3, 5, 8), np.float32)
    y, hf = tssm._ssd_chunked(*(torch.from_numpy(a)
                                for a in (xh, dt, da, B, C, h0)), 16)
    h = np.zeros_like(h0, dtype=np.float64)
    ys = []
    for t in range(xh.shape[1]):
        h = h * np.exp(da[:, t])[:, :, None, None] + \
            np.einsum("bn,bh,bhp->bhnp", B[:, t], dt[:, t], xh[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", C[:, t], h))
    np.testing.assert_allclose(np_of(y), np.stack(ys, 1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np_of(hf), h, rtol=1e-4, atol=1e-4)


def _layer_params(arch):
    """Layer 0 of the reference's tiny f32 init (quantizers off), as both
    packages' trees, with the zero-initialized vectors given values so
    every term of the layer counts."""
    jc, tc = _configs(arch)
    full = jtr.init_lm(jax.random.PRNGKey(3), jc)
    lp = jax.tree_util.tree_map(lambda a: a[0], full["layers"])
    rng = _rng(10)
    for name in ("bonus_u", "ln_t", "ln_c", "a_log", "dt_bias",
                 "norm_scale", "conv1d_b", "ln"):
        if name in lp:
            lp[name] = jnp.asarray(_normal(rng, *lp[name].shape, scale=0.3))
    return jc, tc, lp, _carry(lp)


@pytest.mark.parametrize("L,with_state", [(32, False), (7, False),
                                          (32, True), (1, True)])
def test_rwkv6_forward(L, with_state):
    """Chunked (32 = chunk) and per-token (7, and decode's 1) widths, from
    zero or from a given state."""
    jc, tc, jp, tp = _layer_params("rwkv6-1.6b")
    rng = _rng(11)
    h = _normal(rng, 2, L, jc.d_model)
    st = None
    if with_state:
        st = {"shift_t": _normal(rng, 2, jc.d_model),
              "shift_c": _normal(rng, 2, jc.d_model),
              "wkv": _normal(rng, 2, jc.n_heads, 32, 32, scale=0.3)}
    jh, jst = jrwkv.rwkv6_forward(
        jp, jnp.asarray(h), n_heads=jc.n_heads, chunk=jc.rwkv_chunk,
        state=None if st is None else {k: jnp.asarray(v)
                                       for k, v in st.items()})
    th, tst = trwkv.rwkv6_forward(
        tp, torch.from_numpy(h), n_heads=tc.n_heads, chunk=tc.rwkv_chunk,
        state=None if st is None else {k: torch.from_numpy(v)
                                       for k, v in st.items()})
    _close(th, jh)
    assert (tst is None) == (jst is None)
    for k in jst or {}:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("L,with_state", [(16, False), (7, False),
                                          (16, True), (1, True)])
def test_mamba2_forward(L, with_state):
    """Chunked (a chunk of 8 dividing 16) and per-token widths, from zero
    or from a given state."""
    jc, tc, jp, tp = _layer_params("zamba2-1.2b")
    jp = {k: v for k, v in jp.items() if k != "ln"}
    tp = {k: v for k, v in tp.items() if k != "ln"}
    rng = _rng(12)
    x = _normal(rng, 2, L, jc.d_model)
    d_inner = jc.ssm_expand * jc.d_model
    nh = d_inner // jc.ssm_headdim
    st = None
    if with_state:
        st = {"conv": _normal(rng, 2, 3, d_inner),
              "ssm": _normal(rng, 2, nh, jc.ssm_state, jc.ssm_headdim,
                             scale=0.3)}
    kw = dict(n_state=jc.ssm_state, headdim=jc.ssm_headdim, chunk=8)
    jo, jst = jssm.mamba2_forward(
        jp, jnp.asarray(x), state=None if st is None else
        {k: jnp.asarray(v) for k, v in st.items()}, **kw)
    to, tst = tssm.mamba2_forward(
        tp, torch.from_numpy(x), state=None if st is None else
        {k: torch.from_numpy(v) for k, v in st.items()}, **kw)
    _close(to, jo)
    for k in jst or {}:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("n_layers", [4, 5])
@pytest.mark.parametrize("with_cache", [False, True])
def test_walk_hybrid(n_layers, with_cache):
    """The whole zamba2 walk: two shared-block calls at 4 layers (period
    2, no tail) and a tail layer at 5; with a cache it is written in place
    and holds the reference's new states and K/V."""
    jc, tc = _configs("zamba2-1.2b", n_layers=n_layers)
    jparams = jtr.init_lm(jax.random.PRNGKey(4), jc)
    tparams = _carry(jparams)
    rng = _rng(13)
    L = 6
    h = _normal(rng, 2, L, jc.d_model)
    emb = _normal(rng, 2, L, jc.d_model)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (2, L))
    jcache = tcache = None
    if with_cache:
        jcache = jtr.init_cache(jc, 2, 8)
        tcache = ttr.init_cache(tc, 2, 8, "cpu")
    jh, _, jnew = jtr._walk_hybrid(jparams, jc, jnp.asarray(h),
                                   jnp.asarray(emb), jnp.asarray(pos),
                                   jcache, jnp.asarray(0, jnp.int32))
    th, tnew = ttr._walk_hybrid(tparams, tc, torch.from_numpy(h),
                                torch.from_numpy(emb),
                                torch.from_numpy(pos.copy()), tcache, 0,
                                "dense", "gather")
    _close(th, jh)
    if with_cache:
        assert tnew is tcache
        for k in ("conv", "ssm"):
            _close(tnew["mamba"][k], jnew["mamba"][k])
        for k in ("k", "v"):
            assert tnew["attn"][k].shape[0] == n_layers // 2
            _close(tnew["attn"][k], jnew["attn"][k])


@pytest.mark.parametrize("L,chunk,chunked", [
    (32, 32, True), (64, 32, True), (33, 32, False), (1, 32, False),
    (7, 128, True), (5, 4, False)])
def test_scan_branch_is_the_references(L, chunk, chunked, monkeypatch):
    """``chunk = min(chunk, L)``, then the chunked scan iff ``L % chunk ==
    0 and L > 1`` — in both modules, for any width the engine passes."""
    calls = []
    for mod, name in ((trwkv, "_wkv_chunked"), (tssm, "_ssd_chunked")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _r=real: calls.append(1) or _r(*a))
    _, tc, _, tp = _layer_params("rwkv6-1.6b")
    trwkv.rwkv6_forward(tp, torch.zeros((1, L, tc.d_model)),
                        n_heads=tc.n_heads, chunk=chunk)
    _, mc, _, mp = _layer_params("zamba2-1.2b")
    tssm.mamba2_forward({k: v for k, v in mp.items() if k != "ln"},
                        torch.zeros((1, L, mc.d_model)),
                        n_state=mc.ssm_state, headdim=mc.ssm_headdim,
                        chunk=chunk)
    assert len(calls) == (2 if chunked else 0)


# ---------------------------------------------------------------------------
# whole models (quantizers off)
# ---------------------------------------------------------------------------

def _model_pair(arch, **over):
    jc, tc = _configs(arch, **over)
    japi, tapi = jbuild(jc), tbuild(tc)
    jp = japi.init(jax.random.PRNGKey(7))
    return jc, japi, jp, tapi, _carry(jp)


def _batch(cfg, b, s, seed):
    rng = _rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = _normal(rng, b, cfg.vision_tokens,
                                         cfg.d_model, scale=0.1)
    return batch


@pytest.mark.parametrize("arch,over", [(a, {}) for a in ARCHS] +
                         [("zamba2-1.2b", dict(n_layers=5))])
def test_prefill_and_decode_match_the_reference(arch, over):
    """Prefill of the first 8 tokens, then each remaining token decoded
    once (recurrent families double-apply a re-fed token): every step's
    logits within 2e-3 of the reference's, and of the port's own full
    forward at that position (the reference's test_consistency row)."""
    jc, japi, jp, tapi, tp = _model_pair(arch, **over)
    s, cut = 12, 8
    batch = _batch(jc, 2, s, 14)
    tv = jc.vision_tokens if jc.family == "vlm" else 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    full, _ = ttr.forward(tp, tapi.cfg, tb["tokens"],
                          vision_embeds=tb.get("vision_embeds"))
    pre = lambda b: dict(b, tokens=b["tokens"][:, :cut])  # noqa: E731
    jl, jst = japi.prefill(jp, pre(jb), extra_slots=8)
    tl, tst = tapi.prefill(tp, pre(tb), extra_slots=8)
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), **LOGIT_TOL)
    for i in range(cut, s):
        jl, jst = japi.decode_step(jp, jb["tokens"][:, i:i + 1], jst,
                                   jnp.asarray(tv + i, jnp.int32))
        tl, tst = tapi.decode_step(tp, tb["tokens"][:, i:i + 1], tst,
                                   tv + i)
        np.testing.assert_allclose(np_of(tl), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(np_of(tl), np_of(full[:, tv + i]),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_family_is_served_and_training_is_refused(arch):
    """The family is served and, since training was ported, trained: the
    training gate refuses only a family the reference does not have."""
    cfg = TREG[arch]
    ttr._check_family(cfg)
    ttr.check_trainable(cfg)
    with pytest.raises(ValueError, match="unknown family"):
        ttr.check_trainable(dataclasses.replace(cfg, family="nonesuch"))
    with pytest.raises(ValueError, match="unknown family"):
        ttr._check_family(dataclasses.replace(cfg, family="nonesuch"))


def test_tiny_configs_are_the_references():
    """``tiny()`` of the three configs is the reference's field for field
    (4 layers and period 2 for the hybrid, 16 vision tokens)."""
    for arch in ARCHS:
        j, t = JREG[arch].tiny(), TREG[arch].tiny()
        for f in dataclasses.fields(j):
            if f.name != "quant":
                assert getattr(t, f.name) == getattr(j, f.name), \
                    (arch, f.name)
    assert TREG["zamba2-1.2b"].tiny().n_layers == 4
    assert TREG["zamba2-1.2b"].tiny().hybrid_attn_every == 2
    assert TREG["qwen2-vl-2b"].tiny().vision_tokens == 16
