"""BWQ-A training under a process mesh, on two gloo ranks on the CPU,
held against the JAX reference's single-device ``Trainer``.

One group of two ranks (this file run as a script, one process a rank)
pays the start-up once, while the test process computes the reference's
results.  The model is tiny phi3 in f32 with 9x8 blocks, fake-quant
with the activation quantizers (PACT) off, the reference's
``init(PRNGKey(0))`` carried across through numpy.  Batches of 4 rows (3
at the second step: the data axis does not divide it, so both data ranks
take the whole batch, as the reference's ``batch_pspecs`` fit drops the
axis) carry a ``mask`` whose rows keep 90%, 30%, 60% and all of their
labels: the data ranks' label counts differ.  AdamW without weight
decay on a cosine schedule over 6 steps, maintenance and an alpha round
every 2.

* On (2, 1) the ranks train steps 1-4 with checkpoints every 2 steps
  (FSDP on every leaf, so each data rank writes its own shard file) and
  a fault before data step 3: ``run_with_restarts`` resumes from step 2.
  On (1, 2) a fresh trainer restores step 4 (elastic restore) and trains
  to 6 (one shard file a model rank).  Every step's loss and ``ce`` are
  within ``LOSS_TOL`` of the reference's, and the step-6 params within
  ``LEAF_TOL`` of a leaf's largest magnitude (:func:`leaf_faults`: a
  master weight may sit one quantization level off, where a
  maintenance snapped a weight that the other run's rounding had put
  across a level boundary); the two ranks' histories and whole states
  are equal bit for bit.  Both saves are clean under both
  packages' CK1-CK3, and the reference restores the step-6 save.
* The same first step with every rank's share set equal (a planted
  fault: the gradient all-reduce without the share weights) reads above
  the loss limit.
* The serve launcher under (1, 2) cold-starts the step-6 checkpoint and
  gives the reference's greedy tokens from it.
* granite-moe (tiny, activation quantizers off): one step's gradients on
  (1, 2) equal the single-device gradients bit for bit and the
  reference's within ``LEAF_TOL`` (the model's own expert-parallel
  collectives would carry no gradient); on (2, 1), where the
  load-balancing term's means are summed over ``data``, the loss is the
  single-device loss within ``LOSS_TOL`` and the gradients the
  reference's within ``LEAF_TOL``; the launcher builds its trainer and
  the CIFAR trainer (BatchNorm) trains there.
* The launcher trains with ``--mesh-shape 2,1``, its process group
  initialized from ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT``, within ``LOSS_TOL`` of the single-process launcher;
  only rank 0 prints.
* ``compressed_all_reduce`` over ``data`` on (2, 1) is ``compressed_sum``
  of the ranks' inputs, bit for bit, and moves int8.

A rank's exception fails the test, with its output's tail.
"""
import contextlib
import io
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

ARCH = "phi3-mini-3.8b"
MOE = "granite-moe-3b-a800m"
STEPS, FAULT, LR, DELTA = 6, 3, 2e-3, 1e-3
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4          # tests/torch_train_helpers.py
LEVELS = 255                             # 8-bit fake quantization
FLIP_SHARE = 1e-3                        # of a weight's elements
KEEP = np.array([0.9, 0.3, 0.6, 1.0])    # each row's share of labels kept
SEQ = 16
LAUNCH_ARGV = ["--arch", ARCH, "--device", "cpu", "--steps", "2",
               "--requant-every", "1", "--layers", "1", "--seq", "8",
               "--batch", "2"]
SERVE_ARGV = ["--arch", ARCH, "--device", "cpu", "--backend", "kernel",
              "--attn-backend", "fused", "--kv-bits", "8", "--act-bits",
              "32", "--prompt-len", "8", "--batch", "4", "--max-new", "6"]


def batch_at(step: int, vocab: int):
    rng = np.random.default_rng((7, step))
    b = 3 if step == 1 else 4
    tok = rng.integers(0, vocab, (b, SEQ + 1)).astype(np.int32)
    mask = (rng.random((b, SEQ)) < KEEP[:b, None]).astype(np.float32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:], "mask": mask}


def leaf_faults(got, want, scales):
    """(path, error) of every param leaf of ``got`` (path -> array) off
    ``want``'s: an element more than ``LEAF_TOL`` of the leaf's largest
    magnitude off, unless it is a master weight's (``.w``) and at most one
    quantization level off (its ``.scale`` over ``LEVELS``), in at most
    ``FLIP_SHARE`` of the leaf's elements.  Maintenance snaps every
    master weight to its grid, so a rounding apart moves a weight near a
    level boundary by a whole level."""
    bad = []
    for k, w in want.items():
        if not k.startswith(".params"):
            continue
        w = np.asarray(w, np.float64)
        mag = max(float(np.abs(w).max()), 1e-30)
        d = np.abs(got[k].astype(np.float64) - w)
        off = d > LEAF_TOL * mag
        if not off.any():
            continue
        if k.endswith(".w"):
            level = float(np.max(scales[k[:-2] + ".scale"])) / LEVELS
            if off.mean() <= FLIP_SHARE and d.max() <= 1.01 * level:
                continue
        bad.append((k, float(d.max()) / mag, float(off.mean())))
    return bad


def pipeline(vocab: int, start: int = 0):
    step = start
    while True:
        yield step, batch_at(step, vocab)
        step += 1


# --------------------------------------------------------------------------
# the ranks (this file run as a script)
# --------------------------------------------------------------------------

def _leaves(tree):
    from repro_torch.ckpt.checkpoint import iter_leaves
    return {k: np.array(v.detach().numpy() if hasattr(v, "detach") else v,
                        copy=True) for k, v in iter_leaves(tree)}


def _total(tapi, alpha):
    import torch
    from repro_torch.train.step import quant_reg_loss

    def fn(p, b):
        reg = quant_reg_loss(p, torch.tensor(alpha, dtype=torch.float32))
        loss, m = tapi.loss(p, b)
        return loss + reg, (m, reg)
    return fn


def _launcher(work, rank):
    """``launch.train.main`` with ``--mesh-shape 2,1``, its process group
    from the environment; returns its history and printout."""
    from repro_torch.launch import train as tl
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tr = tl.main(LAUNCH_ARGV + ["--mesh-shape", "2,1", "--ckpt-dir",
                                    os.path.join(work, "launch")])
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in tr.history], "stdout": buf.getvalue()}


def _train(work, inp, meshes):
    """Steps 1-4 on (2, 1) through a crash, 5-6 on (1, 2) after an
    elastic restore."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.api import build
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig, run_with_restarts
    api = build(inp["cfg"])
    ck = os.path.join(work, "ck")
    trainers = []

    def make():
        tr = Trainer(api.loss, adamw(weight_decay=0.0),
                     cosine_schedule(LR, STEPS),
                     params_from_numpy(inp["params"], device="cpu"),
                     TrainerConfig(total_steps=STEPS, ckpt_every=2,
                                   ckpt_dir=ck, log_every=1,
                                   requant_interval=2, alpha_round_steps=2,
                                   delta_alpha=DELTA))
        trainers.append(tr)
        return tr

    def data(start):
        return pipeline(api.cfg.vocab, start)
    fsdp = dict(sharding.FSDP)
    sharding.FSDP["min_bytes"] = 0         # every leaf's data chunk a file
    try:
        with use_mesh(meshes[2, 1]):
            run_with_restarts(make, data, total_steps=4, fault_at=FAULT)
        with use_mesh(meshes[1, 2]):
            last = make()
            resumed = last.try_restore()
            last.run(data(resumed), steps=STEPS)
    finally:
        sharding.FSDP.update(fsdp)
    return {"histories": [[{k: v for k, v in h.items() if k != "wall_s"}
                           for h in t.history] for t in trainers],
            "resumed": resumed, "leaves": _leaves(last.state),
            "steps": sorted(os.listdir(ck))}


def _planted(inp, meshes):
    """The first step with the ranks' shares forced equal."""
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.api import build
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import TrainState, build_train_step
    from repro_torch.train import step as st
    api = build(inp["cfg"])
    state = TrainState.create(params_from_numpy(inp["params"], device="cpu"),
                              adamw(weight_decay=0.0), 0.0)
    train = build_train_step(api.loss, adamw(weight_decay=0.0),
                             cosine_schedule(LR, STEPS))
    batch = {k: torch.as_tensor(v) for k, v in
             batch_at(0, api.cfg.vocab).items()}
    orig = st.rank_share
    st.rank_share = lambda b, mesh: (orig(b, mesh)[0], 0.5)
    try:
        with use_mesh(meshes[2, 1]):
            _, m = train(state, batch)
    finally:
        st.rank_share = orig
    return float(m["loss"])


def _moe(inp, meshes):
    """granite: one step's gradients with no mesh, on (1, 2) and on
    (2, 1) (the load-balancing term's means summed over ``data``); the
    launcher's trainer and the CIFAR trainer (BatchNorm) on (2, 1)."""
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.state import tensor_leaves
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch import cifar
    from repro_torch.launch import train as tl
    from repro_torch.models.api import build
    from repro_torch.train.step import (data_parallel,
                                        microbatched_value_and_grad)
    api = build(inp["moe_cfg"])
    params = params_from_numpy(inp["moe_params"], device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in inp["moe_batch"].items()}
    vg = data_parallel(microbatched_value_and_grad(
        _total(api, inp["alpha"])))
    out = {}
    for key, mesh in (("single", None), ("1x2", meshes[1, 2]),
                      ("2x1", meshes[2, 1])):
        with use_mesh(mesh):
            (loss, _), g = vg(params, batch)
        out[key] = {"loss": float(loss),
                    "grads": {p: t.numpy().copy()
                              for p, t in tensor_leaves(g)}}
    cifar_args = cifar.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--steps", "1", "--batch", "4"])
    with use_mesh(meshes[2, 1]):
        trainer = tl.make_trainer(tl.build_parser().parse_args(
            ["--arch", MOE, "--device", "cpu"]))
        _, _, cnn = cifar.train_quantized_cnn("bwq", cifar_args, "cpu")
    out["launcher_arch"] = trainer.state.params is not None and MOE
    out["cnn_loss"] = float(cnn.history[-1]["loss"])
    return out


def _compressed(meshes, rank):
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.optim import compressed_all_reduce
    x = torch.from_numpy((np.random.default_rng((9, rank)).standard_normal(
        (5, 7)) * (1 + 2 * rank)).astype(np.float32))
    sent, orig = [], dist.all_gather_into_tensor

    def spy(out, t, *a, **k):
        sent.append(str(t.dtype))
        return orig(out, t, *a, **k)
    dist.all_gather_into_tensor = spy
    try:
        with use_mesh(meshes[2, 1]):
            y = compressed_all_reduce(x.clone(), "data")
    finally:
        dist.all_gather_into_tensor = orig
    return {"x": x.numpy(), "y": y.numpy(), "sent": sent}


def _serve(work, meshes):
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.serve import main as serve_main
    with contextlib.redirect_stdout(io.StringIO()), use_mesh(meshes[1, 2]):
        out = serve_main(SERVE_ARGV + ["--ckpt", os.path.join(work, "ck")])
    return {"tokens": out["tokens"].tolist(),
            "peak": out["stats"]["peak_host_bytes"],
            "dense": out["stats"]["dense_tree_bytes"]}


def _rank_main(work: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(2)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"launcher": _launcher(work, rank)}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    meshes = {s: make_mesh(s, ("data", "model"), "cpu")
              for s in ((2, 1), (1, 2))}
    out["train"] = _train(work, inp, meshes)
    out["planted"] = _planted(inp, meshes)
    out["moe"] = _moe(inp, meshes)
    out["compressed"] = _compressed(meshes, rank)
    out["serve"] = _serve(work, meshes)
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the test process
# --------------------------------------------------------------------------

def _free_ports(n: int):
    """``n`` distinct free ports (the sockets held open together)."""
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]


@pytest.fixture(scope="module")
def run():
    pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as j_adamw
    from repro.optim import cosine_schedule as j_cos
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig
    from repro_torch.launch import train as tl
    from torch_port_helpers import tree_to_numpy
    from torch_train_helpers import (ALPHA, family_batch, family_case,
                                     jleaves, ref_step)

    japi, tapi, jp = family_case(ARCH, act_bits=32)
    gj, gt, gjp = family_case(MOE, act_bits=32)
    moe_batch = family_batch(gj.cfg, b=4, s=8)
    work = tempfile.mkdtemp(prefix="sharded_train_")
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"cfg": tapi.cfg, "params": tree_to_numpy(jp),
                     "moe_cfg": gt.cfg, "moe_params": tree_to_numpy(gjp),
                     "moe_batch": moe_batch, "alpha": ALPHA}, f)
    launch_port, port = _free_ports(2)
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(launch_port),
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(here, "..", "src"), here] + sys.path))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, work, str(r), str(port)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.time()

    # the reference's single-device results, while the ranks run
    ref = {}
    jtr = JTrainer(lambda p, b: japi.loss(p, b), j_adamw(weight_decay=0.0),
                   j_cos(LR, STEPS), jp,
                   JTrainerConfig(total_steps=STEPS, ckpt_every=0,
                                  log_every=1, requant_interval=2,
                                  alpha_round_steps=2, delta_alpha=DELTA))
    jtr.run(((s, {k: jnp.asarray(v) for k, v in b.items()})
             for s, b in pipeline(japi.cfg.vocab)), steps=STEPS)
    ref["history"] = jtr.history
    ref["leaves"] = jleaves(jtr.state)
    ref["state"] = jtr.state
    (_, ref["moe_grads"]), _, _ = ref_step(gj, gjp, moe_batch)
    ref["moe_grads"] = jleaves(ref["moe_grads"])
    single = tl.main(LAUNCH_ARGV)
    ref["launcher"] = [{k: v for k, v in h.items() if k != "wall_s"}
                       for h in single.history]

    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(10.0, 300 - (
                time.time() - t0)))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank did not finish in 300 s")
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    outs = []
    for r in range(2):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    ref["tokens"] = _reference_tokens(japi, work)
    return dict(ref=ref, outs=outs, work=work, logs=logs, japi=japi,
                jax=jax, jnp=jnp)


def _reference_tokens(japi, work):
    """The reference's cold start of the port's step-6 save: int8 packed,
    activation quantizers off, int8 KV, greedy over the launcher's
    prompts."""
    import dataclasses

    import jax.numpy as jnp
    from repro.models.api import build as jbuild
    from repro.serve import ServeEngine as JEngine
    from repro.serve.deploy import to_serving_params as j_deploy
    cfg = dataclasses.replace(japi.cfg, quant=dataclasses.replace(
        japi.cfg.quant, act_bits=32))
    api = jbuild(cfg)
    dep = j_deploy(os.path.join(work, "ck", f"step_{STEPS}"), 8,
                   template=api.abstract_params())
    rng = np.random.default_rng(0)
    tok = np.concatenate([rng.integers(0, cfg.vocab, (1, 8)).astype(
        np.int32) for _ in range(4)])
    eng = JEngine(api, dep, backend="ref", attn_backend="ref",
                  kv_quant_bits=8)
    return np.asarray(eng.generate({"tokens": jnp.asarray(tok)},
                                   max_new=6)).tolist()


def _by_step(histories):
    return {h["step"]: h for hist in histories for h in hist}


def test_mesh_training_losses_equal_reference(run):
    """Steps 1-4 on (2, 1) through the crash, 5-6 on (1, 2) after the
    elastic restore: loss and ce within ``LOSS_TOL`` of the reference's
    single-device steps; the restarted attempt repeats step 3 exactly."""
    got = _by_step(run["outs"][0]["train"]["histories"])
    want = {h["step"]: h for h in run["ref"]["history"]}
    assert sorted(got) == list(range(1, STEPS + 1)) == sorted(want)
    errs = {(k, s): abs(got[s][k] - want[s][k]) / max(abs(want[s][k]),
                                                      1e-30)
            for s in got for k in ("loss", "ce", "reg", "avg_bitwidth")}
    assert max(errs.values()) <= LOSS_TOL, errs
    first, again = run["outs"][0]["train"]["histories"][:2]
    assert [h["step"] for h in first] == [1, 2, 3]
    assert [h["step"] for h in again] == [3, 4]
    assert first[2] == again[0]


def test_mesh_training_leaves_equal_reference(run):
    got, want = run["outs"][0]["train"]["leaves"], run["ref"]["leaves"]
    assert got.keys() == want.keys()
    assert not leaf_faults(got, want, want)


def test_replicas_identical_and_checkpoints(run):
    """Both ranks' histories and leaves bit for bit; the restart resumed
    from step 2; the (2, 1) save holds one file a data rank, the (1, 2)
    save one a model rank; both clean under both packages' CK1-CK3."""
    from repro.analysis import validate_checkpoint as j_validate
    from repro_torch.analysis.contracts import \
        validate_checkpoint as t_validate
    a, b = (o["train"] for o in run["outs"])
    assert a["histories"] == b["histories"]
    assert a["leaves"].keys() == b["leaves"].keys()
    for k in a["leaves"]:
        assert a["leaves"][k].tobytes() == b["leaves"][k].tobytes(), k
    assert a["resumed"] == 4 and a["steps"] == ["step_2", "step_4",
                                                "step_6"]
    ck = os.path.join(run["work"], "ck")
    for step, axis in ((4, "data"), (6, "model")):
        path = os.path.join(ck, f"step_{step}")
        shards = sorted(n for n in os.listdir(path) if n.startswith("shard"))
        assert shards == [f"shard_0000{i}-of-00002.npz" for i in (0, 1)]
        with open(os.path.join(path, "META")) as f:
            import json
            meta = json.load(f)
        assert meta["mesh_axes"] == {"data": 2 if axis == "data" else 1,
                                     "model": 2 if axis == "model" else 1}
        for validate in (t_validate, j_validate):
            bad = [f for f in validate(path) if f.severity != "info"]
            assert not bad, (step, bad)


def test_reference_restores_the_mesh_checkpoint(run):
    jax, jnp = run["jax"], run["jnp"]
    import repro.ckpt.checkpoint as jck
    back = jck.restore_tree(jax.tree_util.tree_map(jnp.zeros_like,
                                                   run["ref"]["state"]),
                            os.path.join(run["work"], "ck", f"step_{STEPS}"))
    got = run["outs"][0]["train"]["leaves"]
    for p, x in jax.tree_util.tree_flatten_with_path(back)[0]:
        k = jax.tree_util.keystr(p)
        assert np.asarray(x).tobytes() == got[k].tobytes(), k


def test_unweighted_reduction_fails_the_loss_limit(run):
    """The planted fault: equal shares on the uneven batch move the first
    step's loss past the limit."""
    want = run["ref"]["history"][0]["loss"]
    got = run["outs"][0]["planted"]
    assert abs(got - want) > LOSS_TOL * abs(want), (got, want)


def test_serving_the_mesh_checkpoint_gives_reference_tokens(run):
    """The serve launcher's cold start of the (1, 2) step-6 save, placed
    on (1, 2) on each rank: the reference's greedy tokens; the host peak
    below the dense tree's bytes."""
    for o in run["outs"]:
        assert o["serve"]["tokens"] == run["ref"]["tokens"]
        assert 0 < o["serve"]["peak"] < o["serve"]["dense"]


def test_moe_step_on_model_axis_gives_single_device_gradients(run):
    moe = run["outs"][0]["moe"]
    single, mesh = moe["single"]["grads"], moe["1x2"]["grads"]
    assert moe["single"]["loss"] == moe["1x2"]["loss"]
    assert single.keys() == mesh.keys()
    for k in single:
        assert single[k].tobytes() == mesh[k].tobytes(), k
    want = run["ref"]["moe_grads"]
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(mesh[k].astype(np.float64) - w).max()) / scale
        assert err <= LEAF_TOL, (k, err)


def test_batch_statistics_refused_under_data_parallel(run):
    """No longer refused: on (2, 1) granite's load-balancing term takes
    the whole batch's means, so one step's loss is the single-device
    loss within ``LOSS_TOL`` and its gradients the reference's within
    ``LEAF_TOL``; the launcher builds granite's trainer and the CIFAR
    trainer (BatchNorm) trains on (2, 1)."""
    moe = run["outs"][0]["moe"]
    split, single = moe["2x1"], moe["single"]
    assert abs(split["loss"] - single["loss"]) <= \
        LOSS_TOL * abs(single["loss"]), (split["loss"], single["loss"])
    want = run["ref"]["moe_grads"]
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(split["grads"][k].astype(np.float64) - w).max()) \
            / scale
        assert err <= LEAF_TOL, (k, err)
    assert moe["launcher_arch"] == MOE
    assert moe["cnn_loss"] is not None and np.isfinite(moe["cnn_loss"])


def test_launcher_mesh_shape_from_environment(run):
    """``--mesh-shape 2,1`` through the environment: the single-process
    launcher's history; only rank 0 prints."""
    a, b = (o["launcher"] for o in run["outs"])
    assert a["history"] == b["history"]
    want = run["ref"]["launcher"]
    assert [h["step"] for h in a["history"]] == [h["step"] for h in want]
    for g, w in zip(a["history"], want):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_TOL, err_msg=k)
    assert "step" in a["stdout"] and b["stdout"] == ""


def test_compressed_all_reduce_is_its_formula(run):
    import torch
    from repro_torch.optim import compressed_sum
    a, b = (o["compressed"] for o in run["outs"])
    want = compressed_sum([torch.from_numpy(a["x"]), torch.from_numpy(b["x"])])
    for o in (a, b):
        assert o["y"].tobytes() == want.numpy().tobytes()
        assert o["sent"] == ["torch.int8"]


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
