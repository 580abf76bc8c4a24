"""Losses that hold a statistic of the whole batch, trained on a batch
split over the data axis, and the dry run's recorded collectives against
a live mesh's: two gloo ranks on the CPU, held against the JAX
reference's single-device ``Trainer``.

One group of two ranks (this file run as a script, one process a rank)
pays the start-up once, while the test process computes the reference's
results.

* granite-moe (tiny, f32, fake quantization with the activation
  quantizers off, the reference's ``init(PRNGKey(0))``) trains 2 steps on
  (2, 1): its load-balancing term ``e * sum(mean(hit) * mean(probs))``
  takes the whole batch's means (``dist.parallel.batch_sum``).  Batches of
  4 rows carry a ``mask`` keeping 90%, 30%, 60% and all of their labels,
  so the data ranks' shares differ.  AdamW without weight decay on a
  cosine schedule, maintenance and an alpha round after step 2.
* ResNet-20 (bit-plane mode at 9x8 blocks, 8x8 images, activations
  unquantized) trains 2 steps on (2, 1) with SGD (momentum 0.9, weight
  decay 1e-4): its BatchNorm takes the whole batch's moments.
* Both: every step's loss within ``LOSS_TOL`` of the reference's, the
  params under the sharded training tests' rule
  (``test_torch_sharded_train.leaf_faults``:
  within ``LEAF_TOL`` of a leaf's largest magnitude, but for one-level
  flips of master weights in at most 1e-3 of a weight's elements), the
  two ranks' histories equal.  A planted fault each (the per-rank product
  of means; per-rank BatchNorm statistics) reads above the loss limit and
  fails the params rule.
* The split state reaches the autograd engine's own thread (where a
  CUDA backward, and a checkpointed layer's recomputed forward, run).
* The collectives the dry run records on a ``RecordingMesh``
  (``launch.dryrun.lower_cell(..., include_text=True)``) equal, op for op,
  those the live ranks issue (``dist.parallel.collective_log``): a tiny
  phi3 decode step on (1, 2) and a tiny granite-moe train step on (2, 1).

A rank's exception fails the test, with its output's tail.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

import test_torch_sharded_train as sharded

MOE = "granite-moe-3b-a800m"
ARCH = "phi3-mini-3.8b"
STEPS, LR, DELTA = 2, 2e-3, 1e-3
LOSS_TOL = 1e-5
KEEP = np.array([0.9, 0.3, 0.6, 1.0])    # each row's share of labels kept
SEQ = 8
CNN_DEPTH, CNN_IMAGE, CNN_BATCH = 20, 8, 4
DECODE_B, DECODE_S = 4, 8                # the recorded phi3 decode cell
TRAIN_B, TRAIN_S, TRAIN_MB = 4, 8, 2     # the recorded granite train cell


def batch_at(step: int, vocab: int):
    rng = np.random.default_rng((11, step))
    tok = rng.integers(0, vocab, (4, SEQ + 1)).astype(np.int32)
    mask = (rng.random((4, SEQ)) < KEEP[:, None]).astype(np.float32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:], "mask": mask}


def cnn_batch(step: int):
    from repro_torch.data import SyntheticCIFAR
    return SyntheticCIFAR(image=CNN_IMAGE, batch=CNN_BATCH, noise=0.5,
                          seed=0).batch_at(step)


def _qc(pkg):
    if pkg == "jax":
        from repro.models.common import QuantConfig
    else:
        from repro_torch.configs.base import QuantConfig
    return QuantConfig(mode="bitplane", n_bits=8, act_bits=32)


# --------------------------------------------------------------------------
# the ranks (this file run as a script)
# --------------------------------------------------------------------------

def _moe_train(inp, mesh, planted=False):
    """2 steps of granite on ``mesh``; ``planted``: each rank's aux from
    its own rows' means."""
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models import moe
    from repro_torch.models.api import build
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig
    api = build(inp["moe_cfg"])
    tr = Trainer(api.loss, adamw(weight_decay=0.0), cosine_schedule(LR, STEPS),
                 params_from_numpy(inp["moe_params"], device="cpu"),
                 TrainerConfig(total_steps=STEPS, log_every=1,
                               requant_interval=2, alpha_round_steps=2,
                               delta_alpha=DELTA))
    orig = moe.batch_sum
    if planted:
        moe.batch_sum = lambda t: t
    try:
        with use_mesh(mesh):
            tr.run(((s, {k: torch.as_tensor(v) for k, v in
                         batch_at(s, api.cfg.vocab).items()})
                    for s in range(STEPS)), steps=STEPS)
    finally:
        moe.batch_sum = orig
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in tr.history],
            "leaves": sharded._leaves(tr.state)}


def _cnn_train(inp, mesh, planted=False):
    """2 steps of ResNet-20 on ``mesh``; ``planted``: each rank's
    BatchNorm on its own rows' moments."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models import cnn
    from repro_torch.optim import cosine_schedule, sgd
    from repro_torch.train import Trainer, TrainerConfig
    qc = _qc("torch")
    tr = Trainer(lambda p, b: cnn.cnn_loss(cnn.resnet_apply, p, b, qc),
                 sgd(momentum=0.9, weight_decay=1e-4),
                 cosine_schedule(0.05, STEPS),
                 params_from_numpy(inp["cnn_params"], device="cpu"),
                 TrainerConfig(total_steps=STEPS, log_every=1,
                               requant_interval=2, alpha_round_steps=2,
                               delta_alpha=DELTA))
    orig = cnn.split_mesh
    if planted:
        cnn.split_mesh = lambda: None
    try:
        with use_mesh(mesh):
            tr.run(((s, cnn_batch(s)) for s in range(STEPS)), steps=STEPS)
    finally:
        cnn.split_mesh = orig
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in tr.history],
            "leaves": sharded._leaves(tr.state)}


def _decode_log(mesh):
    """The collectives of one tiny phi3 decode step on ``mesh`` through
    the placed engine (the dry run's decode cell)."""
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.dist.parallel import collective_log
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import collective_records
    from repro_torch.models.api import build
    from repro_torch.serve.engine import ServeEngine
    api = build(REGISTRY[ARCH].tiny(dtype="float32"))
    with use_mesh(mesh):
        eng = ServeEngine(api, api.init(seed=0, device="cpu"),
                          device="cpu", validate=False)
        tok = torch.from_numpy(np.random.default_rng(3).integers(
            0, api.cfg.vocab, (DECODE_B, DECODE_S)).astype(np.int32))
        _, state = eng.prefill({"tokens": tok}, extra_slots=1)
        with collective_log(mesh) as log:
            eng.decode(tok[:, -1:], state, DECODE_S)
    return collective_records(log)


def _train_log(mesh):
    """The collectives of one tiny granite train step on ``mesh`` (the
    dry run's train cell: AdamW, alpha 1e-3, ``TRAIN_MB`` microbatches,
    the capacity dispatch)."""
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.dist.parallel import collective_log
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import collective_records
    from repro_torch.models import moe
    from repro_torch.models.api import build
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState, build_train_step
    api = build(REGISTRY[MOE].tiny(dtype="float32"))
    opt = adamw()
    state = TrainState.create(api.init(seed=0, device="cpu"), opt, 1e-3)
    step = build_train_step(api.loss, opt, lambda s: 1e-3, num_mb=TRAIN_MB)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, api.cfg.vocab, (TRAIN_B, TRAIN_S + 1)).astype(np.int32))
    impl = moe.GROUPED_IMPL["impl"]
    moe.GROUPED_IMPL["impl"] = "capacity"
    try:
        with use_mesh(mesh), collective_log(mesh) as log:
            step(state, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    finally:
        moe.GROUPED_IMPL["impl"] = impl
    return collective_records(log)


def _rank_main(work: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(2)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    meshes = {s: make_mesh(s, ("data", "model"), "cpu")
              for s in ((2, 1), (1, 2))}
    out = {"moe": _moe_train(inp, meshes[2, 1]),
           "moe_planted": _moe_train(inp, meshes[2, 1], planted=True),
           "cnn": _cnn_train(inp, meshes[2, 1]),
           "cnn_planted": _cnn_train(inp, meshes[2, 1], planted=True),
           "decode_log": _decode_log(meshes[1, 2]),
           "train_log": _train_log(meshes[2, 1])}
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the test process
# --------------------------------------------------------------------------

def _reference_moe(japi, jp):
    import jax.numpy as jnp
    from repro.optim import adamw as j_adamw
    from repro.optim import cosine_schedule as j_cos
    from repro.train import Trainer, TrainerConfig
    from torch_train_helpers import jleaves
    tr = Trainer(lambda p, b: japi.loss(p, b), j_adamw(weight_decay=0.0),
                 j_cos(LR, STEPS), jp,
                 TrainerConfig(total_steps=STEPS, ckpt_every=0, log_every=1,
                               requant_interval=2, alpha_round_steps=2,
                               delta_alpha=DELTA))
    tr.run(((s, {k: jnp.asarray(v) for k, v in
                 batch_at(s, japi.cfg.vocab).items()})
            for s in range(STEPS)), steps=STEPS)
    return {"history": tr.history, "leaves": jleaves(tr.state)}


def _reference_cnn(jp):
    import jax.numpy as jnp
    from repro.models import cnn as jcnn
    from repro.optim import cosine_schedule as j_cos
    from repro.optim import sgd as j_sgd
    from repro.train import Trainer, TrainerConfig
    from torch_train_helpers import jleaves
    qc = _qc("jax")
    tr = Trainer(lambda p, b: jcnn.cnn_loss(jcnn.resnet_apply, p, b, qc),
                 j_sgd(momentum=0.9, weight_decay=1e-4), j_cos(0.05, STEPS),
                 jp, TrainerConfig(total_steps=STEPS, ckpt_every=0,
                                   log_every=1, requant_interval=2,
                                   alpha_round_steps=2, delta_alpha=DELTA))
    tr.run(((s, {k: jnp.asarray(v.numpy()) for k, v in cnn_batch(s).items()})
            for s in range(STEPS)), steps=STEPS)
    return {"history": tr.history, "leaves": jleaves(tr.state)}


def _recorded(cfg, cell, shape, **kw):
    from repro_torch.dist.parallel import RecordingMesh
    from repro_torch.launch.dryrun import lower_cell
    return lower_cell(cfg, cell, RecordingMesh(shape), include_text=True,
                      **kw)["collective_log"]


@pytest.fixture(scope="module")
def run():
    pytest.importorskip("torch")
    import jax
    from repro.models import cnn as jcnn
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeCell
    from torch_port_helpers import tree_to_numpy
    from torch_train_helpers import family_case

    gj, gt, gjp = family_case(MOE, act_bits=32)
    cjp = jcnn.resnet_init(jax.random.PRNGKey(0), _qc("jax"),
                           depth=CNN_DEPTH)
    work = tempfile.mkdtemp(prefix="batch_split_")
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"moe_cfg": gt.cfg, "moe_params": tree_to_numpy(gjp),
                     "cnn_params": tree_to_numpy(cjp)}, f)
    (port,) = sharded._free_ports(1)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here] + sys.path))
    procs = [subprocess.Popen(
        [sys.executable, __file__, work, str(r), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    t0 = time.time()

    # the reference's single-device runs and the recorded logs, while the
    # ranks run
    ref = {"moe": _reference_moe(gj, gjp), "cnn": _reference_cnn(cjp)}
    rec = {
        "decode": _recorded(REGISTRY[ARCH].tiny(dtype="float32"),
                            ShapeCell("decode", DECODE_S + 1, DECODE_B,
                                      "decode"),
                            {"data": 1, "model": 2}),
        "train": _recorded(REGISTRY[MOE].tiny(dtype="float32"),
                           ShapeCell("train", TRAIN_S, TRAIN_B, "train"),
                           {"data": 2, "model": 1}, microbatches=TRAIN_MB)}

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
    return dict(ref=ref, rec=rec, outs=outs)


def _loss_errs(got, want, keys):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    return {(k, g["step"]): abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            for g, w in zip(got, want) for k in keys}


MOE_KEYS = ("loss", "ce", "aux", "reg")
CNN_KEYS = ("loss", "acc", "reg")


def test_moe_losses_equal_reference(run):
    errs = _loss_errs(run["outs"][0]["moe"]["history"],
                      run["ref"]["moe"]["history"], MOE_KEYS)
    assert max(errs.values()) <= LOSS_TOL, errs


def test_moe_params_equal_reference(run):
    got, want = run["outs"][0]["moe"]["leaves"], run["ref"]["moe"]["leaves"]
    assert got.keys() == want.keys()
    assert not sharded.leaf_faults(got, want, want)


def test_cnn_losses_equal_reference(run):
    errs = _loss_errs(run["outs"][0]["cnn"]["history"],
                      run["ref"]["cnn"]["history"], CNN_KEYS)
    assert max(errs.values()) <= LOSS_TOL, errs


def test_cnn_params_equal_reference(run):
    got, want = run["outs"][0]["cnn"]["leaves"], run["ref"]["cnn"]["leaves"]
    assert got.keys() == want.keys()
    assert not sharded.leaf_faults(got, want, want)


@pytest.mark.parametrize("leg,keys", [("moe", MOE_KEYS), ("cnn", CNN_KEYS)])
def test_planted_per_rank_statistics_fail_both_checks(run, leg, keys):
    """Per-rank aux means (``moe``) or per-rank BatchNorm moments
    (``cnn``): the losses read above the limit and the params fail the
    rule."""
    planted = run["outs"][0][f"{leg}_planted"]
    errs = _loss_errs(planted["history"], run["ref"][leg]["history"], keys)
    assert max(errs.values()) > LOSS_TOL, errs
    want = run["ref"][leg]["leaves"]
    assert sharded.leaf_faults(planted["leaves"], want, want)


def test_replicas_identical(run):
    a, b = run["outs"]
    for leg in ("moe", "cnn"):
        assert a[leg]["history"] == b[leg]["history"], leg
        for k in a[leg]["leaves"]:
            assert a[leg]["leaves"][k].tobytes() == \
                b[leg]["leaves"][k].tobytes(), (leg, k)


def test_recorded_decode_collectives_equal_live(run):
    """phi3 decode on (1, 2): the column / row products' all-reduces and
    the logits' column gathers, op for op, on both ranks."""
    want = run["rec"]["decode"]
    assert want and {e["op"] for e in want} >= {"all-reduce", "all-gather"}
    for o in run["outs"]:
        assert o["decode_log"] == want


def test_recorded_train_collectives_equal_live(run):
    """granite's train step on (2, 1): the load-balancing term's batch
    sums (forward and backward, a layer a microbatch), the gradient and
    the metrics buckets, op for op, on both ranks."""
    want = run["rec"]["train"]
    assert len(want) > 2 * TRAIN_MB
    for o in run["outs"]:
        assert o["train_log"] == want


def test_split_state_reaches_the_backward_thread():
    """A CUDA backward, and the forward a checkpointed layer recomputes in
    it, run on the autograd engine's own thread: the split state (and the
    collective logs) are the process's, not a thread's."""
    import threading
    import torch
    from repro_torch.dist.parallel import (RecordingMesh, batch_split,
                                           batch_sum, split_mesh)
    mesh = RecordingMesh({"data": 2, "model": 1})
    seen = []
    with batch_split(mesh, 0.5):
        th = threading.Thread(target=lambda: seen.append(
            (split_mesh(), tuple(batch_sum(torch.ones(3)).shape))))
        th.start()
        th.join(timeout=60)
    assert not th.is_alive() and seen == [(mesh, (3,))]
    assert [(c.op, c.axis) for c in mesh.log] == [("all-reduce",
                                                   ("data",))]
    assert split_mesh() is None


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
