"""The dry run's per-device argument and output bytes against the
reference's compiled memory analysis, on a (2, 4) mesh.

The reference (``repro.launch.dryrun.lower_cell(..., calibrate=False)``)
runs in a subprocess (this file run as a script) that forces 8 host
devices before JAX starts; the port's ``lower_cell`` runs on a
``RecordingMesh`` of the same shape.  Configs: tiny phi3 (dense),
granite-moe (MoE; 4 KV heads, so that its heads divide the model axis)
and seamless (enc-dec), each f32, with a train (one microbatch), a
prefill and a decode cell of 8 sequences of 16.

* **Argument bytes** are the shard sums of the step's inputs, equal to
  XLA's to the byte, but where JAX's ``jit`` drops an argument the step
  never reads (``keep_unused=False``): seamless's decode step reads no
  encoder weight, so the reference's figure lacks ``enc_layers`` and
  ``enc_norm``, whose shard bytes the port counts.
* **Output bytes** are the port's hand count of the step's results (the
  train state and the f32 loss; the logits on every rank, as the port's
  engine returns them, and the state's shards).  XLA's figure differs by
  its own bookkeeping, pinned here: its output tuple's pointer table (8
  bytes a result leaf), and the logits, whose sharding the compiler picks
  (``out_shardings=None``): over every device, ``(data, model)``.

A train step of more than three microbatches is counted from runs of two
and of three, extended linearly: the extension equals running them all.
"""
import json
import os
import subprocess
import sys

import pytest

CELLS = ("train", "prefill", "decode")
ARCHS = {"phi3-mini-3.8b": {}, "granite-moe-3b-a800m": {"n_kv_heads": 4},
         "seamless-m4t-large-v2": {}}
SEQ, BATCH = 16, 8
MESH = (2, 4)


def _reference(out_path: str) -> None:
    """The reference's records, as JSON, from a process whose JAX sees 8
    host devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import repro.launch.dryrun as d      # sets 512 devices at import
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import REGISTRY
    from repro.configs.base import ShapeCell
    mesh = Mesh(np.array(jax.devices()).reshape(*MESH), ("data", "model"))
    out = {}
    for arch, over in ARCHS.items():
        cfg = REGISTRY[arch].tiny(dtype="float32", **over)
        for kind in CELLS:
            rec = d.lower_cell(cfg, ShapeCell(kind, SEQ, BATCH, kind), mesh,
                               calibrate=False,
                               microbatches=1 if kind == "train" else 0)
            out[f"{arch}:{kind}"] = {k: rec["per_device"][k] for k in
                                     ("argument_bytes", "output_bytes")}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    pytest.importorskip("torch")
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist.parallel import RecordingMesh
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build
    path = str(tmp_path_factory.mktemp("dryrun_memory") / "ref.json")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here] + sys.path))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, __file__, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    mesh = RecordingMesh(dict(zip(("data", "model"), MESH)))
    port = {}
    for arch, over in ARCHS.items():
        cfg = REGISTRY[arch].tiny(dtype="float32", **over)
        api = build(cfg)
        for kind in CELLS:
            cell = ShapeCell(kind, SEQ, BATCH, kind)
            if kind == "train":
                _, arg, out, _ = dryrun._train_step(api, cell, mesh, 1)
            else:
                _, arg, out, _ = dryrun._serve_step(api, cell, mesh, 0)
            port[f"{arch}:{kind}"] = {"argument_bytes": arg,
                                      "output_bytes": out,
                                      "leaves": _result_leaves(api, cell)}
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log[-3000:]
    with open(path) as f:
        ref = json.load(f)
    return {"ref": ref, "port": port, "mesh": mesh}


def _result_leaves(api, cell) -> int:
    """The step's result leaves: the train state (params, optimizer
    state, step, alpha) and the loss; or the logits and the decode
    state."""
    from repro_torch.core.state import tensor_leaves
    from repro_torch.optim.optimizers import adamw
    if cell.kind == "train":
        params = api.abstract_params()
        tree = {"params": params, "opt_state": adamw().init(params)}
        return len(list(tensor_leaves(tree))) + 3
    return 1 + len(list(tensor_leaves(api.decode_state_spec(cell))))


def _unused_encoder_bytes(mesh) -> int:
    """The shard bytes of seamless's encoder (``enc_layers``,
    ``enc_norm``), which its decode step never reads."""
    from repro_torch.configs import REGISTRY
    from repro_torch.dist.sharding import padded_shape, param_pspecs, \
        spec_leaves, use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build
    p = build(REGISTRY["seamless-m4t-large-v2"].tiny(
        dtype="float32")).abstract_params()
    with use_mesh(mesh):
        specs = dict(spec_leaves(param_pspecs(p, pad=True)))
    from repro_torch.core.state import tensor_leaves
    return sum(dryrun._nbytes(dryrun._shard_shape(
        specs[k], padded_shape(specs[k], t.shape, mesh), mesh), t.dtype)
        for k, t in tensor_leaves(p)
        if k.startswith(("['enc_layers']", "['enc_norm']")))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_equal_compiled(records, arch):
    for kind in CELLS:
        key = f"{arch}:{kind}"
        want = records["ref"][key]["argument_bytes"]
        got = records["port"][key]["argument_bytes"]
        if arch.startswith("seamless") and kind == "decode":
            want += _unused_encoder_bytes(records["mesh"])
        assert got == want, (key, got, want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_output_bytes_equal_compiled_but_for_its_bookkeeping(records, arch):
    d, m = MESH
    for kind in CELLS:
        key = f"{arch}:{kind}"
        port = records["port"][key]
        from repro_torch.configs import REGISTRY
        want = port["output_bytes"] + 8 * port["leaves"]
        if kind != "train":
            logits = BATCH * REGISTRY[arch].tiny().vocab * 4
            want += logits // (d * m) - logits
        assert records["ref"][key]["output_bytes"] == want, (key, port)


def test_microbatch_extension_equals_the_whole_run():
    """A train step of 5 microbatches on (2, 1): the counts extended from
    runs of 2 and 3 equal those of running all 5 (FLOPs, bytes, the live
    peak, the census and the collective log)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist.cost_analysis import shape_census
    from repro_torch.dist.parallel import RecordingMesh
    from repro_torch.launch import dryrun
    from repro_torch.models import moe
    from repro_torch.models.api import build
    cfg = REGISTRY["granite-moe-3b-a800m"].tiny(dtype="float32")
    cell = ShapeCell("train", SEQ, 10, "train")
    mesh = RecordingMesh({"data": 2, "model": 1})
    got = dryrun.trace_cell(cfg, cell, mesh, 5)
    impl = moe.GROUPED_IMPL["impl"]
    moe.GROUPED_IMPL["impl"] = "capacity"
    try:
        run, *_ = dryrun._train_step(build(cfg), cell, mesh, 5)
        mesh.log.clear()
        whole = dryrun._metered(run, True)
    finally:
        moe.GROUPED_IMPL["impl"] = impl
    assert got["flops"] == whole.flops.get_total_flops()
    assert got["bytes"] == whole.bytes
    assert got["temp"] == whole.peak
    assert got["census"] == shape_census(whole.results)
    assert got["log"] == mesh.log and len(mesh.log) > 5


if __name__ == "__main__":
    _reference(sys.argv[1])
