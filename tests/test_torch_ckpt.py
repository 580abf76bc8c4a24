"""The port's checkpoints (``repro_torch.ckpt``), held against the JAX
reference's (``repro.ckpt``).

* The format-2 machinery, mirrored from tests/test_ckpt_sharded.py and
  tests/test_train_and_ckpt.py::TestCheckpoint: injective key
  sanitization, the crash-safe commit, async errors surfaced, GC at
  keep 0 and 1, mismatch errors and partial restore, a reference save
  sharded over a 2-way stand-in mesh reassembled in the port, CK1-CK3
  findings equal to the reference's on a clean save and on planted
  faults, the v1 ``arrays.npz`` layout, and ``resolve_ckpt_dir``.
* Interchange: a reference save restores in the port and a port save in
  the reference, every array equal bit for bit with its dtype kept
  (f32, int32, int8, uint8, bf16), and the META manifests of the same
  tree equal key for key.  A ``TrainState`` saved by either package
  restores in the other and one more step's loss matches the
  reference's within the train tests' 1e-5.
* Restarts: ``run_with_restarts`` with a fault at step 3 of 4 (saves
  every 2) ends with the uninterrupted run's history and params, bit for
  bit; a save in flight while the next step updates the tensors in
  place holds the state of its own step.
* The train launcher's ``--ckpt-dir`` saves and resumes.
"""
import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.ckpt.checkpoint as jck  # noqa: E402
import repro_torch.ckpt.checkpoint as tck  # noqa: E402
from repro.analysis import validate_checkpoint as j_validate  # noqa: E402
from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.models.api import build as jbuild  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import cosine_schedule as j_cos  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.step import build_train_step as j_step  # noqa: E402
from repro_torch.analysis.contracts import \
    validate_checkpoint as t_validate  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.ckpt import (CheckpointManager,  # noqa: E402
                              CheckpointMismatchError, CheckpointReader,
                              restore_tree, save_tree)
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.configs.base import QuantConfig as TQ  # noqa: E402
from repro_torch.core.state import tensor_leaves  # noqa: E402
from repro_torch.data import make_lm_pipeline  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import cosine_schedule as t_cos  # noqa: E402
from repro_torch.optim import sgd as t_sgd  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig, TrainState,  # noqa: E402
                               build_train_step, run_with_restarts)
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"
LOSS_TOL = 1e-5                  # tests/test_torch_train.py's one-step rule


class _Mesh12:
    """The reference tests' stand-in: chunking reads only ``mesh.shape``."""
    shape = {"data": 1, "model": 2}


@pytest.fixture(scope="module")
def fx():
    jcfg = JREG[ARCH].tiny(dtype="float32").with_quant(
        JQ(mode="fake", n_bits=8, act_bits=8))
    tcfg = TREG[ARCH].tiny(dtype="float32").with_quant(
        TQ(mode="fake", n_bits=8, act_bits=8))
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    return dict(japi=japi, tapi=tapi, jp=jp)


def _bridged(tree):
    return params_from_numpy(tree_to_numpy(tree), device="cpu")


def _tleaves(tree):
    """Copies: a CPU tensor's numpy view would follow in-place updates."""
    return {k: np.array(np_of(v), copy=True)
            for k, v in tck.iter_leaves(tree)}


def _jleaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(vocab, seed=1, b=2, s=16):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _meta(path):
    with open(os.path.join(path, "META")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# format-2 machinery (tests/test_ckpt_sharded.py)
# ---------------------------------------------------------------------------

def test_sanitize_is_the_reference_encoding(tmp_path):
    keys = ["['a b']", "['a_b']", "['a/b']", "a_62", "ab",
            "['layers']['attn']['wq'].w", ".opt_state['m']['embed']"]
    for k in keys:
        assert tck._sanitize(k) == jck._sanitize(k), k
    assert len({tck._sanitize(k) for k in keys}) == len(keys)
    tree = {"a b": torch.arange(3.0), "a_b": torch.arange(3.0) * 10,
            "a/b": torch.arange(3.0) * 100}
    save_tree(tree, str(tmp_path / "ck"))
    out = restore_tree({k: torch.zeros(3) for k in tree}, str(tmp_path / "ck"))
    for k in tree:
        assert torch.equal(out[k], tree[k])


def test_crash_before_commit_preserves_previous(tmp_path, monkeypatch):
    p = str(tmp_path / "ck")
    save_tree({"w": torch.ones(4, 4)}, p)

    def boom(tmp):
        raise OSError("injected crash before commit")
    monkeypatch.setattr(tck, "_fsync_tree", boom)
    with pytest.raises(OSError, match="injected"):
        save_tree({"w": torch.ones(4, 4) * 2}, p)
    monkeypatch.undo()
    out = restore_tree({"w": torch.zeros(4, 4)}, p)
    assert torch.equal(out["w"], torch.ones(4, 4))
    debris = [n for n in os.listdir(tmp_path) if n != "ck"]
    assert debris and all(".tmp." in n for n in debris)


def test_overwrite_commits_and_leaves_no_debris(tmp_path):
    p = str(tmp_path / "ck")
    save_tree({"w": torch.ones(3)}, p)
    save_tree({"w": torch.ones(3) * 7}, p)
    assert torch.equal(restore_tree({"w": torch.zeros(3)}, p)["w"],
                       torch.full((3,), 7.0))
    assert os.listdir(tmp_path) == ["ck"]


def test_manager_crash_then_recovery_sweeps_debris(tmp_path, monkeypatch):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=3, use_async=False)
    mgr.save(1, {"w": torch.arange(4.0)})

    def boom(tmp):
        raise OSError("disk full")
    monkeypatch.setattr(tck, "_fsync_tree", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(2, {"w": torch.arange(4.0)})
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    mgr.save(3, {"w": torch.arange(4.0)})
    assert sorted(os.listdir(d)) == ["step_1", "step_3"]


@pytest.mark.parametrize("surfaced_by", ["wait", "save"])
def test_async_failure_is_reraised(tmp_path, monkeypatch, surfaced_by):
    def boom(*a, **k):
        raise OSError("quota exceeded")
    mgr = CheckpointManager(str(tmp_path), keep=3, use_async=True)
    monkeypatch.setattr(tck, "save_tree", boom)
    mgr.save(1, {"w": torch.ones(2)})
    if surfaced_by == "wait":
        with pytest.raises(RuntimeError, match="quota exceeded"):
            mgr.wait()
        monkeypatch.undo()
        mgr.wait()                       # consumed: usable again
        mgr.save(2, {"w": torch.ones(2)})
        mgr.wait()
        assert mgr.latest_step() == 2
    else:
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="quota exceeded"):
            mgr.save(2, {"w": torch.ones(2)})


@pytest.mark.parametrize("keep,want", [(0, []), (1, ["step_3"]),
                                       (2, ["step_2", "step_3"])])
def test_gc_keeps_the_latest(tmp_path, keep, want):
    mgr = CheckpointManager(str(tmp_path), keep=keep, use_async=False)
    for step in (1, 2, 3):
        mgr.save(step, {"a": torch.ones(2)})
    assert sorted(os.listdir(tmp_path)) == want
    assert mgr.latest_step() == (3 if want else None)


def test_mismatch_lists_keys_and_partial_restore(tmp_path):
    p = str(tmp_path / "ck")
    save_tree({"a": torch.ones(2), "b": torch.ones(2) * 2}, p)
    with pytest.raises(CheckpointMismatchError) as ei:
        restore_tree({"b": torch.zeros(2), "c": torch.zeros(2)}, p)
    assert ei.value.missing == ["['c']"] and ei.value.extra == ["['a']"]
    assert "partial=True" in str(ei.value)
    out = restore_tree({"b": torch.zeros(2), "c": torch.full((2,), 9.0)}, p,
                       partial=True)
    assert torch.equal(out["b"], torch.full((2,), 2.0))
    assert torch.equal(out["c"], torch.full((2,), 9.0)) and "a" not in out


def _sharded_save(d):
    tree = {"wo": np.arange(64, dtype=np.float32).reshape(8, 8),
            "b": np.arange(3, dtype=np.float32)}
    p = os.path.join(d, "ck")
    jck.save_tree(tree, p, extra_meta={"step": 5}, mesh=_Mesh12(),
                  specs={"wo": P("model", None), "b": P()})
    return p, tree


def test_reference_sharded_save_reassembles(tmp_path):
    p, tree = _sharded_save(str(tmp_path))
    assert _meta(p)["n_shards"] == 2
    reader = CheckpointReader(p)
    np.testing.assert_array_equal(reader.read("['wo']"), tree["wo"])
    np.testing.assert_array_equal(reader.read("['b']"), tree["b"])
    assert reader.extra == {"step": 5}
    reader.close()
    out = restore_tree({"wo": torch.zeros(8, 8), "b": torch.zeros(3)}, p)
    np.testing.assert_array_equal(out["wo"].numpy(), tree["wo"])


def _findings(fs):
    return sorted((f.rule, f.severity, f.path) for f in fs)


@pytest.mark.parametrize("fault", ["clean", "missing_shard", "debris",
                                   "orphan", "no_meta"])
def test_checkpoint_contracts_match_reference(tmp_path, fault):
    """CK0-CK3 on a sharded reference save, clean and with each planted
    fault: the port's findings are the reference's."""
    p, _ = _sharded_save(str(tmp_path))
    if fault == "missing_shard":
        os.remove(os.path.join(p, "shard_00001-of-00002.npz"))
    elif fault == "debris":
        os.makedirs(p + ".tmp.deadbeef")
    elif fault == "orphan":
        name = os.path.join(p, "shard_00000-of-00002.npz")
        z = dict(np.load(name))
        z["stray"] = np.ones(2, np.float32)
        np.savez(name, **z)
    elif fault == "no_meta":
        os.remove(os.path.join(p, "META"))
    want = _findings(j_validate(p))
    assert _findings(t_validate(p)) == want
    rules = {r for r, s, _ in want if s != "info"}
    assert rules == {"clean": set(), "missing_shard": {"CK2"},
                     "debris": {"CK3"}, "orphan": {"CK3"},
                     "no_meta": {"CK1"}}[fault]


def test_legacy_v1_checkpoint_still_readable(tmp_path):
    p = str(tmp_path / "ck")
    os.makedirs(p)
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.savez(os.path.join(p, "arrays.npz"), **{"_'w'_": arr})
    with open(os.path.join(p, "META"), "w") as f:
        json.dump({"manifest": {"['w']": "_'w'_"}, "extra": {"step": 1}}, f)
    out = restore_tree({"w": torch.zeros(2, 3)}, p)
    np.testing.assert_array_equal(out["w"].numpy(), arr)
    assert not [f for f in t_validate(p) if f.severity == "error"]


def test_resolve_ckpt_dir(tmp_path):
    from repro_torch.launch.serve import resolve_ckpt_dir
    d = str(tmp_path / "run")
    mgr = CheckpointManager(d, keep=2, use_async=False)
    mgr.save(3, {"w": torch.ones(2)})
    mgr.save(7, {"w": torch.ones(2)})
    step7 = os.path.join(d, "step_7")
    assert resolve_ckpt_dir(d) == step7
    assert resolve_ckpt_dir(d, step=3) == os.path.join(d, "step_3")
    assert resolve_ckpt_dir(step7) == step7
    with pytest.raises(SystemExit):
        resolve_ckpt_dir(d, step=9)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(SystemExit):
        resolve_ckpt_dir(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------

def _mixed_arrays():
    rng = np.random.default_rng(0)
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
            "i8": rng.integers(-128, 127, (2, 6)).astype(np.int8),
            "u8": rng.integers(0, 255, (7,)).astype(np.uint8),
            "bf16": rng.standard_normal((2, 3)).astype(np.float32)
            .astype(ml_dtypes.bfloat16),
            "scalar": np.asarray(3, np.int32)}


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """Raw bytes and dtype name of an array or tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16"
        return x.numpy().tobytes(), str(x.dtype).removeprefix("torch.")
    if x.dtype.kind == "V":
        return x.tobytes(), "bfloat16"
    return x.tobytes(), str(x.dtype)


def test_array_interchange_both_ways_bit_for_bit(tmp_path):
    arrays = _mixed_arrays()
    jtree = {k: jnp.asarray(v) for k, v in arrays.items()}
    ttree = {k: _to_torch(v) for k, v in arrays.items()}
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save_tree(jtree, jp)
    save_tree(ttree, tp)
    assert _meta(jp)["manifest"] == _meta(tp)["manifest"]
    # reference save -> port restore (dtypes from the template)
    out = restore_tree({k: torch.zeros_like(v) for k, v in ttree.items()},
                       jp)
    for k, v in ttree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        assert _bits(out[k]) == _bits(v), k
    # port save -> reference reader (the reference's restore cannot cast
    # its own V2 storage to bfloat16: read and view it) and restore
    reader = jck.CheckpointReader(tp)
    for k, v in arrays.items():
        got = reader.read(f"[{k!r}]")
        if k == "bf16":
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
    reader.close()
    plain = {k: v for k, v in jtree.items() if k != "bf16"}
    save_tree({k: ttree[k] for k in plain}, tp)
    back = jck.restore_tree(jax.tree_util.tree_map(jnp.zeros_like, plain),
                            tp)
    for k, v in plain.items():
        assert _bits(np.asarray(back[k])) == _bits(np.asarray(v)), k


def _j_state(fx):
    jp = jax.tree_util.tree_map(jnp.copy, fx["jp"])  # the step donates
    opt = j_adamw(weight_decay=0.0)
    return JTrainState.create(jp, opt, 1e-3), opt


def _t_state(jstate):
    return TrainState(step=int(jstate.step),
                      params=_bridged(jstate.params),
                      opt_state=_bridged(jstate.opt_state),
                      alpha=torch.tensor(float(jstate.alpha)))


def test_trainstate_manifests_equal(tmp_path, fx):
    jstate, opt = _j_state(fx)
    jstate, _ = j_step(lambda p, b: fx["japi"].loss(p, b), opt,
                       j_cos(2e-3, 8))(jstate, {
                           k: jnp.asarray(v) for k, v in
                           _batch(fx["japi"].cfg.vocab).items()})
    jck.save_tree(jstate, str(tmp_path / "j"))
    save_tree(_t_state(jstate), str(tmp_path / "t"))
    jm, tm = _meta(tmp_path / "j")["manifest"], \
        _meta(tmp_path / "t")["manifest"]
    assert list(tm) == list(jm) and tm == jm
    assert tm[".step"]["dtype"] == "int32" and tm[".step"]["shape"] == []


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_trainstate_interchange_continues(tmp_path, fx, direction):
    """A TrainState after one step, saved by one package and restored by
    the other, takes a second step whose loss matches the reference's
    second step from its own state."""
    japi, tapi = fx["japi"], fx["tapi"]
    jstate, opt = _j_state(fx)
    jtrain = j_step(lambda p, b: japi.loss(p, b), opt, j_cos(2e-3, 8))
    b1, b2 = (_batch(japi.cfg.vocab, seed=s) for s in (1, 2))
    jstate, _ = jtrain(jstate, {k: jnp.asarray(v) for k, v in b1.items()})
    saved = jax.tree_util.tree_map(jnp.copy, jstate)
    _, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in b2.items()})
    jstate = saved
    p = str(tmp_path / "ck")
    ttrain = build_train_step(tapi.loss, t_adamw(weight_decay=0.0),
                              t_cos(2e-3, 8))
    template = TrainState.create(tapi.init(seed=1, device="cpu"),
                                 t_adamw(weight_decay=0.0), 0.0)
    if direction == "reference_to_port":
        jck.save_tree(jstate, p)
        tstate = restore_tree(template, p)
        assert tstate.step == 1 and isinstance(tstate.step, int)
        want = _jleaves(jstate)
        got = _tleaves(tstate)
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        tstate, tm = ttrain(tstate, {k: torch.as_tensor(v)
                                     for k, v in b2.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=LOSS_TOL)
        assert tstate.step == 2
    else:
        save_tree(_t_state(jstate), p)
        jtemplate = jax.tree_util.tree_map(jnp.zeros_like, jstate)
        back = jck.restore_tree(jtemplate, p)
        want = _jleaves(jstate)
        for k, v in _jleaves(back).items():
            assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        _, jm2 = jtrain(back, {k: jnp.asarray(v) for k, v in b2.items()})
        assert float(jm2["loss"]) == float(jm["loss"])


def test_reference_quantized_tree_roundtrip(tmp_path, fx):
    """tests/test_train_and_ckpt.py::TestCheckpoint's quantized tree: a
    bit-plane-mode reference init through a port save and restore."""
    cfg = JREG[ARCH].tiny(dtype="float32").with_quant(
        JQ(mode="bitplane", n_bits=8, act_bits=8))
    params = _bridged(jbuild(cfg).init(jax.random.PRNGKey(0)))
    p = str(tmp_path / "ck")
    save_tree(params, p)
    template = tbuild(TREG[ARCH].tiny(dtype="float32").with_quant(
        TQ(mode="bitplane", n_bits=8, act_bits=8))).abstract_params()
    out = restore_tree(template, p, device="cpu")
    got, want = dict(tensor_leaves(out)), dict(tensor_leaves(params))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_restore_latest_with_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, use_async=True)
    mgr.save(7, {"w": torch.ones(3, 3)}, dict(step=7))
    mgr.wait()
    (step, extra), out = mgr.restore_latest({"w": torch.zeros(3, 3)})
    assert step == 7 and extra["step"] == 7
    assert torch.equal(out["w"], torch.ones(3, 3))


# ---------------------------------------------------------------------------
# restarts
# ---------------------------------------------------------------------------

def _trainer(fx, d, opt="sgd"):
    tapi = fx["tapi"]
    return Trainer(tapi.loss,
                   t_sgd(momentum=0.9, weight_decay=0.0) if opt == "sgd"
                   else t_adamw(weight_decay=0.0),
                   t_cos(1e-2, 4), _bridged(fx["jp"]),
                   TrainerConfig(total_steps=4, ckpt_every=2 if d else 0,
                                 ckpt_dir=d, log_every=1,
                                 requant_interval=2))


def test_run_with_restarts_resumes_to_the_uninterrupted_run(tmp_path, fx):
    cfg = fx["tapi"].cfg

    def data(start):
        return make_lm_pipeline(cfg, 16, 2, seed=3, start_step=start)
    straight = _trainer(fx, None)
    straight.run(data(0), steps=4)
    d = str(tmp_path / "run")
    attempts = []

    def make():
        attempts.append(1)
        return _trainer(fx, d)
    tr = run_with_restarts(make, data, total_steps=4, fault_at=3)
    assert len(attempts) == 2 and tr.state.step == 4
    assert sorted(os.listdir(d)) == ["step_2", "step_4"]
    # the restarted trainer logged steps 3 and 4 only
    assert [h["step"] for h in tr.history] == [3, 4]
    for a, b in zip(tr.history, straight.history[2:]):
        assert {k: v for k, v in a.items() if k != "wall_s"} == \
            {k: v for k, v in b.items() if k != "wall_s"}
    got, want = _tleaves(tr.state), _tleaves(straight.state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_async_save_holds_its_own_step(tmp_path, fx, monkeypatch):
    """The writer thread is held until the next step has updated params
    and AdamW moments in place; the save still holds the state it was
    given."""
    tr = _trainer(fx, str(tmp_path), opt="adamw")
    data = make_lm_pipeline(fx["tapi"].cfg, 16, 2, seed=3)
    tr.run(data, steps=1)                  # step 1, saved at the end
    snap = _tleaves(tr.state)
    gate, real = threading.Event(), tck.save_tree

    def held(*a, **k):
        gate.wait(timeout=60)
        return real(*a, **k)
    monkeypatch.setattr(tck, "save_tree", held)
    tr.ckpt.save(1, tr.state, dict(step=1))    # in flight, held
    tr.state, _ = tr.train_step(tr.state, {
        k: v for k, v in next(data)[1].items()})
    moved = _tleaves(tr.state)
    assert not np.array_equal(moved[".opt_state['m']['embed']"],
                              snap[".opt_state['m']['embed']"])
    gate.set()
    tr.ckpt.wait()
    reader = CheckpointReader(str(tmp_path / "step_1"))
    for k, v in snap.items():
        np.testing.assert_array_equal(reader.read(k), v, err_msg=k)
    reader.close()


def test_train_launcher_ckpt_dir_saves_and_resumes(tmp_path):
    from repro_torch.launch import train as tl
    d = str(tmp_path / "run")
    argv = ["--arch", ARCH, "--device", "cpu", "--seq", "16", "--batch",
            "2", "--requant-every", "2", "--layers", "1", "--ckpt-dir", d]
    first = tl.main(argv + ["--steps", "4"])
    assert sorted(os.listdir(d)) == ["step_2", "step_3", "step_4"]
    assert not [f for f in t_validate(os.path.join(d, "step_4"))
                if f.severity != "info"]
    # a later run with more steps resumes at 4 and trains only 5..8
    again = tl.main(argv + ["--steps", "8"])
    assert [h["step"] for h in again.history][0] > 4
    assert again.state.step == 8
    assert first.state.step == 4
