"""Sharded checkpoints and int8 gradient compression in the port, held
against the JAX reference with no process group.

* A tiny phi3 ``TrainState`` after one reference AdamW step (its params
  and moments carried across through numpy), saved by both packages
  under shape-only ``(1, 2)`` and ``(2, 2)`` meshes, with FSDP on every
  leaf so that both axes shard: the same META (manifest, mesh axes,
  shard axes, hosts; the quantization metadata's spec one ``None`` a dim
  where the reference writes ``[]``, which its own CK1 rejects) and the
  same chunk arrays in every shard file, bit for bit; each package
  restores the other's save (the port under no
  mesh and under another shape-only mesh: elastic restore); a spec tree
  given as ``specs=`` shards as the reference's; CK1-CK3 findings equal
  on a clean save, a deleted shard (CK2) and commit debris (CK3).
* ``compress_decompress`` over 3 error-feedback rounds, bit for bit, and
  ``compressed_sum`` (what ``compressed_all_reduce`` gives every rank)
  against the reference's ``compressed_psum`` run under
  ``jax.vmap(..., axis_name=)``.

The live-mesh side (two gloo ranks saving one file each) is in
tests/test_torch_sharded_train.py.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.ckpt.checkpoint as jck  # noqa: E402
import repro.dist.sharding as jsh  # noqa: E402
import repro_torch.dist.sharding as tsh  # noqa: E402
from repro.analysis import validate_checkpoint as j_validate  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import cosine_schedule as j_cos  # noqa: E402
from repro.optim.grad_compress import \
    compress_decompress as j_compress  # noqa: E402
from repro.optim.grad_compress import compressed_psum  # noqa: E402
from repro.optim.grad_compress import \
    init_error_state as j_init_err  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.step import build_train_step as j_step  # noqa: E402
from repro_torch.analysis import ShapeOnlyMesh  # noqa: E402
from repro_torch.analysis.contracts import \
    validate_checkpoint as t_validate  # noqa: E402
from repro_torch.ckpt import restore_tree, save_tree  # noqa: E402
from repro_torch.ckpt.checkpoint import iter_leaves  # noqa: E402
from repro_torch.dist.sharding import PSpec  # noqa: E402
from repro_torch.optim import (compress_decompress,  # noqa: E402
                               compressed_sum, init_error_state)
from repro_torch.train import TrainState  # noqa: E402
from torch_port_helpers import np_of  # noqa: E402
from torch_train_helpers import bridged, family_case  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"
MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2}}


class _Mesh:
    """The reference tests' stand-in (``_Mesh12``): saving reads only
    ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.fixture(scope="module")
def states():
    """(reference TrainState, the port's) after one reference step."""
    japi, _, jp = family_case(ARCH)
    opt = j_adamw(weight_decay=0.0)
    jstate = JTrainState.create(jp, opt, 1e-3)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, japi.cfg.vocab, (2, 17)).astype(np.int32)
    jstate, _ = j_step(lambda p, b: japi.loss(p, b), opt, j_cos(2e-3, 8))(
        jstate, {"tokens": jnp.asarray(tok[:, :-1]),
                 "labels": jnp.asarray(tok[:, 1:])})
    tstate = TrainState(step=int(jstate.step),
                        params=bridged(jstate.params),
                        opt_state=bridged(jstate.opt_state),
                        alpha=torch.tensor(float(jstate.alpha)))
    return jstate, tstate


@pytest.fixture
def fsdp_all(monkeypatch):
    """FSDP on every leaf in both packages (the tiny leaves are under the
    1 MB threshold), so that ``data`` shards too."""
    monkeypatch.setitem(jsh.FSDP, "min_bytes", 0)
    monkeypatch.setitem(tsh.FSDP, "min_bytes", 0)


def _meta(path):
    with open(os.path.join(path, "META")) as f:
        return json.load(f)


def _one_entry_a_dim(meta):
    """META with every leaf's spec padded to its rank: the port's
    spelling of the reference's ``[]`` for replicated metadata."""
    for ent in meta["manifest"].values():
        ent["spec"] = ent["spec"] + [None] * (len(ent["shape"])
                                              - len(ent["spec"]))
    return meta


def _shards(path):
    return sorted(n for n in os.listdir(path) if n.startswith("shard_"))


def _saves(tmp_path, states, shape):
    jstate, tstate = states
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save_tree(jstate, jp, extra_meta={"step": 1}, mesh=_Mesh(shape))
    save_tree(tstate, tp, extra_meta={"step": 1},
              mesh=ShapeOnlyMesh(shape))
    return jp, tp


@pytest.mark.parametrize("shape", list(MESHES))
def test_sharded_save_is_the_references(tmp_path, states, fsdp_all, shape):
    jp, tp = _saves(tmp_path, states, MESHES[shape])
    jm, tm = _meta(jp), _meta(tp)
    short = [k for k, ent in jm["manifest"].items()
             if len(ent["spec"]) != len(ent["shape"])]
    assert short and all(k.endswith((".scale", ".bitwidth"))
                         for k in short)
    assert tm == _one_entry_a_dim(jm)
    assert list(tm["manifest"]) == list(jm["manifest"])
    want_axes = sorted(a for a, n in MESHES[shape].items())
    assert tm["shard_axes"] == want_axes
    assert tm["n_shards"] == MESHES[shape]["data"] * MESHES[shape]["model"]
    assert _shards(tp) == _shards(jp)
    for name in _shards(jp):
        with np.load(os.path.join(jp, name)) as a, \
                np.load(os.path.join(tp, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype and \
                    a[k].shape == b[k].shape, (name, k)
                assert a[k].tobytes() == b[k].tobytes(), (name, k)


@pytest.mark.parametrize("shape", list(MESHES))
def test_sharded_saves_restore_across_packages(tmp_path, states, fsdp_all,
                                               shape):
    """The port restores the reference's sharded save (no mesh, and under
    another shape-only mesh), the reference the port's, every leaf bit
    for bit."""
    jstate, tstate = states
    jp, tp = _saves(tmp_path, states, MESHES[shape])
    want = {k: np.array(np_of(v), copy=True)
            for k, v in iter_leaves(tstate)}
    template = TrainState(
        step=0,
        params=bridged(jax.tree_util.tree_map(jnp.zeros_like,
                                              jstate.params)),
        opt_state=bridged(jax.tree_util.tree_map(jnp.zeros_like,
                                                 jstate.opt_state)),
        alpha=torch.tensor(0.0))
    other = ShapeOnlyMesh({"data": 2, "model": 1})
    for mesh in (None, other):
        got = restore_tree(template, jp, mesh=mesh)
        assert got.step == tstate.step
        for k, v in iter_leaves(got):
            np.testing.assert_array_equal(np_of(v), want[k], err_msg=k)
    back = jck.restore_tree(jax.tree_util.tree_map(jnp.zeros_like, jstate),
                            tp)
    for p, x in jax.tree_util.tree_flatten_with_path(back)[0]:
        k = jax.tree_util.keystr(p)
        np.testing.assert_array_equal(np.asarray(x), want[k], err_msg=k)


def test_spec_tree_shards_as_the_references(tmp_path):
    """``specs=`` (a spec tree) overrides the rules, in both packages."""
    tree = {"wo": np.arange(64, dtype=np.float32).reshape(8, 8),
            "b": np.arange(6, dtype=np.float32).reshape(2, 3)}
    shape = {"data": 2, "model": 2}
    jck.save_tree(tree, str(tmp_path / "j"), mesh=_Mesh(shape),
                  specs={"wo": P("model", "data"), "b": P(None, "model")})
    save_tree({k: torch.from_numpy(v) for k, v in tree.items()},
              str(tmp_path / "t"), mesh=ShapeOnlyMesh(shape),
              specs={"wo": PSpec("model", "data"),
                     "b": PSpec(None, "model")})
    jm, tm = _meta(tmp_path / "j"), _meta(tmp_path / "t")
    assert tm == jm and tm["manifest"]["['b']"]["spec"] == [None, None]
    for name in _shards(tmp_path / "j"):
        with np.load(tmp_path / "j" / name) as a, \
                np.load(tmp_path / "t" / name) as b:
            assert {k: a[k].tobytes() for k in a.files} == \
                {k: b[k].tobytes() for k in b.files}, name


def _findings(fs):
    return sorted((f.rule, f.severity, f.path) for f in fs)


@pytest.mark.parametrize("fault", ["clean", "missing_shard", "debris"])
def test_sharded_checkpoint_contracts(tmp_path, states, fsdp_all, fault):
    """CK1-CK3 on the port's own (2, 2) save: the reference's findings,
    clean, CK2 for a deleted shard and CK3 for commit debris (the
    reference's own save of this tree fails its CK1: the spec of each
    replicated metadata leaf has no entries)."""
    _, tstate = states
    p = str(tmp_path / "ck")
    save_tree(tstate, p, mesh=ShapeOnlyMesh(MESHES["2x2"]))
    if fault == "missing_shard":
        os.remove(os.path.join(p, "shard_00002-of-00004.npz"))
    elif fault == "debris":
        os.makedirs(p + ".tmp.deadbeef")
    want = _findings(j_validate(p))
    assert _findings(t_validate(p)) == want
    assert {r for r, s, _ in want if s != "info"} == {
        "clean": set(), "missing_shard": {"CK2"}, "debris": {"CK3"}}[fault]


def test_compress_decompress_matches_reference():
    """Three error-feedback rounds, bit for bit (ties round half to even
    in both)."""
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((5, 7)).astype(np.float32),
         "b": np.array([1e-3, 0.5, -0.25, 0.5 / 127 * 2.5],
                       dtype=np.float32)}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    jerr, terr = j_init_err(jg), init_error_state(tg)
    for _ in range(3):
        jdeq, jerr = j_compress(jg, jerr)
        tdeq, terr = compress_decompress(tg, terr)
        for k in g:
            assert np.asarray(jdeq[k]).tobytes() == \
                tdeq[k].numpy().tobytes(), k
            assert np.asarray(jerr[k]).tobytes() == \
                terr[k].numpy().tobytes(), k


def test_compressed_sum_matches_compressed_psum():
    """The collective's formula against ``compressed_psum`` over a
    vmapped 3-member axis (one CPU device): equal bit for bit."""
    rng = np.random.default_rng(4)
    xs = (rng.standard_normal((3, 6, 5)) *
          np.array([1.0, 3.0, 0.2])[:, None, None]).astype(np.float32)
    want = jax.vmap(lambda x: compressed_psum(x, "d"), axis_name="d")(
        jnp.asarray(xs))
    got = compressed_sum([torch.from_numpy(x.copy()) for x in xs])
    for w in np.asarray(want):
        assert w.tobytes() == got.numpy().tobytes()
