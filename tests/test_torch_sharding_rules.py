"""The port's sharding rules (``repro_torch.dist.sharding``), held against
the JAX reference's (``repro.dist.sharding``) devicelessly.

Both rule layers read only ``mesh.shape``, so shape-only meshes stand in
for (1,1), (2,1), (1,2), (2,2), the 2x16x16 pod mesh and the 16x16
production mesh.  On every family's tiny tree (the QAT tree, packed int8
and int4 and bit-plane deploys: ``torch_port_helpers.deployed_pairs``,
the port's deploys being the reference's bit for bit) and on its decode
state (float and int8 KV, contiguous and paged), ``param_pspecs``,
``batch_pspecs`` and ``cache_pspecs`` must equal the reference's spec for
spec (as tuples), and the ``SpecDrop`` / ``SpecPad`` events they record
must come in the same order with the same fields.  ``fit_spec``,
``padded_shape``, ``pad_leaf`` and ``unpad_leaf`` are held on the
reference's own cases (tests/test_sharding_rules.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.dist.sharding as jsh  # noqa: E402
import repro_torch.dist.sharding as tsh  # noqa: E402
from torch_port_helpers import deployed_pairs  # noqa: E402

torch.set_num_threads(2)

MESHES = {"1x1": {"data": 1, "model": 1}, "2x1": {"data": 2, "model": 1},
          "1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "pods": {"pod": 2, "data": 16, "model": 16},
          "prod": {"data": 16, "model": 16}}
ARCHS = ("phi3-mini-3.8b", "granite-moe-3b-a800m", "seamless-m4t-large-v2",
         "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b")
TREES = ((0, ""), (8, "packed"), (4, "packed"), (8, "bitplane"))


class _Shape:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.fixture(scope="module")
def trees():
    return deployed_pairs()


def _jflat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _tflat(specs):
    return [(p, tuple(s)) for p, s in tsh.spec_leaves(specs)]


def _events(events):
    return [(type(e).__name__,) + dataclasses.astuple(e) for e in events]


def _both(fn_j, fn_t, mesh):
    """Each package's specs and recorded events under ``mesh``."""
    m = _Shape(mesh)
    with jsh.use_mesh(m), jsh.collect_spec_events() as je:
        js = fn_j()
    with tsh.use_mesh(m), tsh.collect_spec_events() as te:
        ts = fn_t()
    return _jflat(js), _tflat(ts), _events(je), _events(te)


def _states(japi, tapi, jp, tp, n_slots=4, max_len=24):
    """(reference, port) decode states of a prompt batch: float KV
    contiguous and int8 KV paged (page 4), the port's on ``meta``."""
    from repro.analysis import example_batch as jbatch
    from repro_torch.analysis import example_batch as tbatch
    from repro.models.api import build as jbuild
    from repro_torch.models.api import build as tbuild
    out = []
    for bits, page in ((16, 0), (8, 4)):
        jc = dataclasses.replace(japi.cfg, kv_cache_bits=bits)
        tc = dataclasses.replace(tapi.cfg, kv_cache_bits=bits)
        jb = jbatch(jc, 1, 8)
        js = jax.eval_shape(
            lambda p, b: jbuild(jc).init_decode_state(
                p, b, n_slots, max_len, page_size=page), jp, jb)
        ts = tbuild(tc).init_decode_state(
            None, tbatch(tc, 1, 8, "meta"), n_slots, max_len,
            page_size=page)
        out.append((js, ts, jb, tbatch(tc, 1, 8, "meta")))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_events_equal_reference(trees, arch):
    """param / batch / cache specs and their events, every tree of the
    family, every mesh."""
    for bits, layout in TREES:
        japi, tapi, (jp, tp) = trees(arch, bits, layout)
        states = _states(japi, tapi, jp, tp) if bits in (0, 8) and \
            layout != "bitplane" else []
        for name, mesh in MESHES.items():
            for pad in (None, False):
                js, ts, je, te = _both(
                    lambda: jsh.param_pspecs(jp, pad=pad),
                    lambda: tsh.param_pspecs(tp, pad=pad), mesh)
                assert ts == js, (arch, bits, layout, name, pad)
                assert te == je, (arch, bits, layout, name, pad)
            for jst, tst, jb, tb in states:
                js, ts, je, te = _both(lambda: jsh.batch_pspecs(jb),
                                       lambda: tsh.batch_pspecs(tb), mesh)
                assert ts == js and te == je, (arch, name, "batch")
                for pad in (None, False):
                    js, ts, je, te = _both(
                        lambda: jsh.cache_pspecs(jst, 4, pad=pad),
                        lambda: tsh.cache_pspecs(tst, 4, pad=pad), mesh)
                    assert ts == js, (arch, name, "cache", pad)
                    assert te == je, (arch, name, "cache", pad)


def test_no_mesh_is_replicated(trees):
    _, _, (jp, tp) = trees("phi3-mini-3.8b", 8, "packed")
    assert _tflat(tsh.param_pspecs(tp)) == _jflat(jsh.param_pspecs(jp))
    assert all(s == () for _, s in _tflat(tsh.param_pspecs(tp)))


def test_leaf_rules_fsdp_and_router():
    """The reference's rule cases (tests/test_sharding_rules.py): FSDP on
    big weights, none on small ones, the router replicated."""
    m = _Shape({"data": 1, "model": 1})
    cases = [("['layers']['attn']['wo'].w", (2048, 1024), torch.float32),
             ("['layers']['attn']['wo'].w", (64, 64), torch.float32),
             ("['moe']['router_w']", (4096, 512), torch.float32),
             ("['embed']", (32064, 3072), torch.bfloat16),
             ("['layers']['mlp']['w_up'].w_int", (2, 3072, 8192),
              torch.int8),
             ("['layers']['attn']['wq'].scale", (2, 384, 24), torch.float32)]
    for path, shape, dt in cases:
        leaf = torch.empty(shape, dtype=dt, device="meta")
        jleaf = jax.ShapeDtypeStruct(shape, {
            torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.int8: jnp.int8}[dt])
        for mesh in (m, _Shape({"data": 2, "model": 4})):
            with jsh.use_mesh(mesh):
                want = tuple(jsh._leaf_spec(path, jleaf))
            with tsh.use_mesh(mesh):
                assert tuple(tsh._leaf_spec(path, leaf)) == want, path


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 1},
                                  {"data": 2, "model": 2},
                                  {"pod": 1, "data": 1, "model": 1},
                                  {"pod": 2, "data": 2, "model": 4}])
def test_fit_spec_cases_equal_reference(mesh):
    """``fit_spec`` with and without padding, ``spec`` and the events, on
    the reference's cases."""
    m = _Shape(mesh)
    cases = [(("data", "model"), (7, 8)), (("data", "model"), (8, 7)),
             ((("pod", "data"), "model"), (7, 8)),
             ((("pod", "data"), None), (8, 8)), (("model", "model"), (8, 8)),
             ((None, "data"), (3, 5)), (("data",), (4, 4, 4))]
    for entries, shape in cases:
        for pad in (None, True, False):
            with jsh.collect_spec_events() as je:
                want = tuple(jsh.fit_spec(P(*entries), shape, m, label="x",
                                          pad=pad))
            with tsh.collect_spec_events() as te:
                got = tuple(tsh.fit_spec(tsh.PSpec(*entries), shape, m,
                                         label="x", pad=pad))
            assert got == want, (entries, shape, pad)
            assert _events(te) == _events(je), (entries, shape, pad)
            assert tsh.padded_shape(got, shape, m) == \
                jsh.padded_shape(P(*want), shape, m)
    with jsh.use_mesh(m):
        want = tuple(jsh.spec("batch", None, "ff", "vocab", "bogus"))
    with tsh.use_mesh(m):
        assert tuple(tsh.spec("batch", None, "ff", "vocab", "bogus")) == want


def test_pad_and_unpad_leaf_round_trip():
    """Padded sharding's boundary helpers on numpy and torch leaves."""
    m = _Shape({"data": 2, "model": 2})
    ps = tsh.fit_spec(tsh.PSpec("data", "model"), (7, 8), m)
    assert ps == ("data", "model")
    assert tsh.padded_shape(ps, (7, 8), m) == (8, 8)
    x = np.arange(7 * 8, dtype=np.float32).reshape(7, 8)
    np.testing.assert_array_equal(tsh.pad_leaf(x, ps, m),
                                  jsh.pad_leaf(x, P(*ps), m))
    xt = torch.from_numpy(x)
    xp = tsh.pad_leaf(xt, ps, m)
    assert tuple(xp.shape) == (8, 8) and not xp[7].any()
    np.testing.assert_array_equal(tsh.unpad_leaf(xp, (7, 8)).numpy(), x)
    assert tsh.pad_leaf(xt, tsh.PSpec(None, "model"), m) is xt
    assert tsh.unpad_leaf(xt, (7, 8)) is xt


def test_mesh_context_nests():
    a, b = _Shape({"data": 2}), _Shape({"model": 2})
    assert tsh.get_mesh() is None
    with tsh.use_mesh(a):
        with tsh.use_mesh(b):
            assert tsh.get_mesh() is b
            assert tsh.batch_axes() == ()
        assert tsh.get_mesh() is a and tsh.batch_axes() == ("data",)
        with tsh.use_mesh(None):
            assert tsh.spec("batch") == ()
    assert tsh.get_mesh() is None
