"""The port's encoder-decoder model (``repro_torch.models.encdec``) against
the JAX reference (``repro.models.encdec``).

Fixture: ``seamless-m4t-large-v2`` at ``tiny(dtype="float32")`` with 9x8
blocks and 8-bit activations in both packages (the family has no PACT
leaves, so nothing rounds activations), the reference's
``init(PRNGKey(0))`` QAT tree and its int8 deploy carried across through
numpy; tokens from ``numpy.random.default_rng`` (prompt seed 1) and frames
``0.1 * normal`` from numpy (``torch_port_helpers.frames``).  Float
results are held within 1e-5 of the largest |value| (``REL``):

* the tree ``init_encdec`` builds has the reference's keys, shapes and
  dtypes, and the carried QAT tree crosses bit for bit;
* ``attn_forward``'s cross-attention (K/V from ``x_kv``, no rope, no
  mask) on its own;
* ``_conformer_conv``, ``encode`` and ``encdec_forward`` (prefill logits
  and the f32 cache it writes; then a decode step over that cache) on the
  QAT tree through ``dense`` and on the int8 deploy through the plain
  versions behind ``kernel`` and ``ref``;
* the family gate: enc-dec admitted, ssm / hybrid / vlm / M-RoPE still
  refused, training refused by name.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import encdec as jed  # noqa: E402
from repro.models.attention import attn_forward as j_attn  # noqa: E402
from repro.models.common import matmul_backend  # noqa: E402
from repro.models.common import prepare_params as j_prepare  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.fakequant import FakeQuantTensor  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.attention import attn_forward as t_attn  # noqa: E402
from repro_torch.models.common import prepare_params as t_prepare  # noqa: E402
from torch_port_helpers import (np_of, prompt, tiny_fixture,  # noqa: E402
                                tree_to_numpy)

torch.set_num_threads(2)
ARCH = "seamless-m4t-large-v2"
REL = 1e-5


@pytest.fixture(scope="module")
def fx():
    fx = tiny_fixture(ARCH)
    fx["tqat"] = params_from_numpy(tree_to_numpy(fx["qat"]), device="cpu")
    fx["tok"] = prompt(fx["vocab"], 8, 0, b=2)
    fx["fr"] = fx["frames"][:2, :6]             # S_enc 6 beside 8 tokens
    return fx


def _close(got, want, rel=REL, what=""):
    got, want = np_of(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _trees(fx, which):
    """(reference, port) trees and backends: the QAT tree through
    ``dense``, or the int8 deploy through the reference's ``ref`` and the
    port's ``kernel`` (its wrappers' plain versions on the CPU)."""
    if which == "qat":
        return fx["qat"], fx["tqat"], "dense", "dense"
    return fx["jdep"], fx["tdep"], "ref", "kernel"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_init_tree_matches_reference_layout(fx):
    """``ModelAPI.init`` (``init_encdec``) gives the reference's tree: the
    same keys, the same leaf kinds, shapes and dtypes (FakeQuant weights
    for every projection, f32 norms, the f32 depthwise kernel (L, 15, d)
    and the embedding); the reference's tree carried across through numpy
    equals its arrays bit for bit."""
    want = dict(_leaves(tree_to_numpy(fx["qat"])))
    got = dict(_leaves(fx["tapi"].init(seed=0, device="cpu")))
    flat = {}
    for path, leaf in got.items():
        if isinstance(leaf, FakeQuantTensor):
            for f in ("w", "scale", "bitwidth"):
                flat[path + (f,)] = getattr(leaf, f)
            flat[path + ("shape",)] = tuple(leaf.shape)
        else:
            flat[path] = leaf
    want = {k: v for k, v in want.items()
            if k[-1] not in ("wb_rows", "wb_cols", "n_bits")}
    assert flat.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, tuple):
            assert flat[k] == v, k
        else:
            assert tuple(flat[k].shape) == v.shape and \
                np_of(flat[k]).dtype == v.dtype, k
    cfg = fx["tapi"].cfg
    assert want[("enc_layers", "conv_dw")].shape == (cfg.enc_layers, 15,
                                                     cfg.d_model)
    carried = dict(_leaves(fx["tqat"]))
    for path, leaf in _leaves(fx["qat"]):
        a = carried[path]
        if isinstance(a, FakeQuantTensor):
            np.testing.assert_array_equal(np_of(a.w), np.asarray(leaf.w))
        else:
            np.testing.assert_array_equal(np_of(a), np.asarray(leaf))


@pytest.mark.parametrize("s_q,s_kv", [(1, 6), (5, 9)])
def test_cross_attention_matches_reference(fx, s_q, s_kv):
    """Cross-attention on its own: K and V projected from ``x_kv``, no
    rope on either side, every key position visible (no causal, window or
    fill mask), on decoder layer 0's cross weights."""
    cfg = fx["tapi"].cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s_q, cfg.d_model)).astype(np.float32)
    xkv = rng.standard_normal((2, s_kv, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 3 + s_q), (2, s_q)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(s_kv), (2, s_kv)).astype(np.int32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
              rope_theta=cfg.rope_theta)
    jp = j_prepare(fx["qat"], jnp.float32)["dec_layers"]["cross_attn"]
    jl0 = jax.tree_util.tree_map(lambda a: a[0], jp)
    tp = t_prepare(fx["tqat"], torch.float32)["dec_layers"]["cross_attn"]
    tl0 = ttr._unstack(tp, cfg.n_layers)[0]
    want, _ = j_attn(jl0, jnp.asarray(x), jnp.asarray(pos),
                     x_kv=jnp.asarray(xkv), kv_positions=jnp.asarray(kpos),
                     **kw)
    got, cache = t_attn(tl0, torch.from_numpy(x), torch.from_numpy(pos),
                        x_kv=torch.from_numpy(xkv),
                        kv_positions=torch.from_numpy(kpos), **kw)
    assert cache is None
    _close(got, want, what="cross attention")


@pytest.mark.parametrize("which", ["qat", "int8"])
def test_conformer_conv_matches_reference(fx, which):
    """Pointwise GLU, the 15-tap depthwise conv (zero-padded 7 a side)
    and the pointwise projection, on encoder layer 1."""
    jt, tt, jbe, tbe = _trees(fx, which)
    cfg = fx["tapi"].cfg
    x = np.random.default_rng(5).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    jl = {k: jax.tree_util.tree_map(lambda a: a[1], v)
          for k, v in j_prepare(jt, jnp.float32)["enc_layers"].items()
          if k.startswith("conv")}
    tl = {k: v for k, v in ttr._unstack(
        t_prepare(tt, torch.float32)["enc_layers"], cfg.enc_layers)[1]
        .items() if k.startswith("conv")}
    with matmul_backend(jbe):
        want = jed._conformer_conv(jl, jnp.asarray(x))
    got = ted._conformer_conv(tl, torch.from_numpy(x), tbe)
    _close(got, want, what=f"conformer conv {which}")


@pytest.mark.parametrize("which", ["qat", "int8"])
def test_encode_matches_reference(fx, which):
    jt, tt, jbe, tbe = _trees(fx, which)
    cfg = fx["tapi"].cfg
    with matmul_backend(jbe):
        want = jed.encode(j_prepare(jt, jnp.float32), fx["japi"].cfg,
                          jnp.asarray(fx["fr"]))
    got = ted.encode(t_prepare(tt, torch.float32), cfg,
                     torch.from_numpy(fx["fr"]), tbe)
    _close(got, want, what=f"encode {which}")


@pytest.mark.parametrize("which,backend", [("qat", "dense"),
                                           ("int8", "kernel"),
                                           ("int8", "ref")])
def test_encdec_forward_matches_reference(fx, which, backend):
    """Prefill logits, the encoder output and the f32 KV cache written at
    index 0, then one decode step's logits over that cache at a per-slot
    index vector."""
    jt, tt, jbe, _ = _trees(fx, which)
    jcfg, tcfg = fx["japi"].cfg, fx["tapi"].cfg
    tok, fr = fx["tok"], fx["fr"]
    b, s = tok.shape
    jcache = jed.encdec_init_cache(jcfg, b, s + 4)
    tcache = ted.encdec_init_cache(tcfg, b, s + 4, "cpu")
    with matmul_backend(jbe):
        jl, jcache, jenc = jed.encdec_forward(
            jt, jcfg, jnp.asarray(fr), jnp.asarray(tok), jcache,
            jnp.asarray(0, jnp.int32))
    tl, tcache, tenc = ted.encdec_forward(
        tt, tcfg, torch.from_numpy(fr), torch.from_numpy(tok), tcache, 0,
        backend=backend)
    _close(tl, jl, what="prefill logits")
    _close(tenc, jenc, what="enc_out")
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], what=f"cache {name}")
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    idx = np.full((b,), s, np.int32)
    with matmul_backend(jbe):
        jd, _ = jed.encdec_decode_step(jt, jcfg, jnp.asarray(nxt), jcache,
                                       jnp.asarray(idx), jenc)
    td, _ = ted.encdec_decode_step(tt, tcfg, torch.from_numpy(nxt), tcache,
                                   torch.from_numpy(idx), tenc,
                                   backend=backend)
    _close(td, jd, what="decode step")


def test_family_gate():
    """The enc-dec family is admitted, as are the ssm, hybrid and vlm
    families and M-RoPE; a family the reference does not have is refused;
    training the enc-dec family is admitted (``encdec_loss``), as the
    reference trains it."""
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY[ARCH]
    assert cfg.is_encdec and cfg.family == "audio"
    ttr._check_family(cfg)
    base = REGISTRY["phi3-mini-3.8b"]
    for ok in (dict(family="ssm"), dict(family="hybrid"),
               dict(family="vlm"), dict(mrope=True)):
        ttr._check_family(dataclasses.replace(base, **ok))
    with pytest.raises(ValueError, match="unknown family"):
        ttr._check_family(dataclasses.replace(base, family="nonesuch"))
    ttr.check_trainable(cfg)
