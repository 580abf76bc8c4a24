"""Serving under a process mesh, on two gloo ranks on the CPU, held
against the JAX reference's single-device results.

One group of two ranks (this file run as a script, one process a rank)
pays the start-up once and runs every leg on the meshes (2,1) and (1,2),
while the test process computes the reference's results on one device.
The weights are the reference's ``init(PRNGKey(0))`` trees carried across
through numpy (the deploys made once by the port, which are the
reference's bit for bit, and handed to the reference as its own), at
``tiny(dtype="float32")`` with 9x8 blocks:

* phi3 fake-quant QAT with 8-bit activations under ``dense`` (mirroring
  tests/test_serving.py's sharded test): ``generate``, the fixed-width
  scheduler (4 slots), the paged and chunked scheduler at int8 and int4
  KV (3 slots), and a paged scheduler that parks requests (overcommit);
* packed int8, packed int4 and bit-plane deploys under ``ref`` on local
  shards (the plain versions of the kernels, fused attention, activation
  quantizers off, int8 KV): 9x8 shards start inside a weight block, and
  the bit-plane ``wo`` pads its plane rows (17 bytes over 2 ranks); once
  more with FSDP on every leaf (``FSDP["min_bytes"] = 0``), and once
  under ``dense`` (each rank dequantizing its windows alone);
* a prime vocab of 251 under padded placement (mirroring
  tests/test_ckpt_sharded.py);
* granite-moe: its int8 deploy served (expert parallel, 4 experts), an
  int4 deploy with 3 experts served (in-expert tensor parallel on the
  placed windows: the down projection's 9x8 row shards start mid-block
  and mid nibble pair), and the training loss of the QAT tree through the
  sharded MoE layer, expert parallel (4 experts) and in
  expert tensor parallel (3 experts on 2 ranks), within 1e-5 of the
  reference's single-device loss (mirroring
  tests/test_backend_parity.py's EP test).

A rank's exception fails the test.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

SHAPES = ((2, 1), (1, 2))
PROMPTS = np.random.default_rng((1, 0)).integers(0, 512, (4, 8)).astype(
    np.int32)
P251 = np.random.default_rng((1, 1)).integers(0, 251, (4, 8)).astype(
    np.int32)
MOE_TOK = np.random.default_rng((1, 2)).integers(0, 512, (4, 16)).astype(
    np.int64)

# leg -> (tree, engine kwargs, drive)
DENSE = dict(backend="dense", attn_backend="gather")
REF8 = dict(backend="ref", kv_quant_bits=8)
LEGS = {
    "dense_generate": ("qat8", dict(DENSE, kv_quant_bits=8), "generate"),
    "dense_sched": ("qat8", dict(DENSE, kv_quant_bits=8),
                    dict(n_slots=4)),
    "dense_paged_kv8": ("qat8", dict(DENSE, kv_quant_bits=8),
                        dict(n_slots=3, page_size=4, prefill_chunk=4)),
    "dense_paged_kv4": ("qat8", dict(DENSE, kv_quant_bits=4),
                        dict(n_slots=3, page_size=4, prefill_chunk=4)),
    "dense_park": ("qat8", dict(DENSE, kv_quant_bits=8),
                   dict(n_slots=4, page_size=4, n_pages=9, overcommit=2.0,
                        prefill_chunk=4)),
    "packed8": ("packed8", REF8, "generate"),
    "packed4": ("packed4", REF8, "generate"),
    "bitplane": ("bitplane8", REF8, "generate"),
    "packed8_fsdp": ("packed8", REF8, "generate"),
    "packed8_dense": ("packed8", dict(backend="dense", kv_quant_bits=8),
                      "generate"),
    "vocab251": ("v251", {}, "generate"),
    "granite_packed8": ("granite8", REF8, "generate"),
    "granite3_packed4": ("granite3_4", REF8, "generate"),
}
LOSS_LEGS = ("granite_ep", "granite_tp")


# --------------------------------------------------------------------------
# the ranks (this file run as a script)
# --------------------------------------------------------------------------

def _requests(tok):
    from repro_torch.serve import Request, SamplingParams
    return [Request(uid=i, inputs={"tokens": tok[i:i + 1]},
                    sampling=SamplingParams(max_new_tokens=6), arrival=i)
            for i in range(4)]


def _drive(eng, drive, tok):
    if drive == "generate":
        return eng.generate({"tokens": tok}, 6).cpu().numpy().tolist()
    res = eng.serve(_requests(tok), **drive)
    return [res[i].tokens for i in range(4)]


def _rank_main(work: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import params_from_numpy
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine
    torch.set_num_threads(2)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    trees = {}
    for name, (cfg, tree, deploy) in inp["trees"].items():
        p = params_from_numpy(tree, device="cpu")
        if deploy:
            p = to_serving_params(p, deploy[0], layout=deploy[1],
                                  device="cpu")
        trees[name] = (build(cfg), p)
    out = {"tokens": {}, "loss": {}, "single": {}}
    for leg, (tree, kw, drive) in LEGS.items():
        api, p = trees[tree]
        tok = P251 if tree == "v251" else PROMPTS
        out["single"][leg] = _drive(
            ServeEngine(api, p, device="cpu", **kw), drive, tok)
        for shape in SHAPES:
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            fsdp = dict(sharding.FSDP)
            if leg.endswith("_fsdp"):
                sharding.FSDP["min_bytes"] = 0
            try:
                with use_mesh(mesh):
                    eng = ServeEngine(api, p, device="cpu", **kw)
            finally:
                sharding.FSDP.update(fsdp)
            out["tokens"][leg, shape] = _drive(eng, drive, tok)
    batch = {"tokens": torch.as_tensor(MOE_TOK),
             "labels": torch.zeros(MOE_TOK.shape, dtype=torch.int64)}
    for leg in LOSS_LEGS:
        api, p = trees[leg]
        for shape in SHAPES:
            with use_mesh(make_mesh(shape, ("data", "model"), "cpu")), \
                    torch.no_grad():
                out["loss"][leg, shape] = float(api.loss(p, batch)[0])
    out["refused"] = _refusals(build, make_mesh, use_mesh, ServeEngine)
    out["lint"] = _placed_lint(trees["packed8"], make_mesh, use_mesh,
                               ServeEngine)
    if rank == 0:
        with open(os.path.join(work, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def _placed_lint(tree, make_mesh, use_mesh, ServeEngine):
    """``lint_engine`` of an engine placed on each mesh (every rank runs
    it): its contract, graph and footprint findings against the unplaced
    engine's, and its sharding findings' (rule, path)."""
    from repro_torch.analysis import lint_engine
    api, p = tree
    kw = dict(kv_quant_bits=8, backend="kernel", attn_backend="fused",
              page_size=4, prefill_chunk=4, device="cpu")
    lint = dict(prompt_len=8, n_slots=2, max_new=8)

    def split(rep):
        rest = sorted((f.severity, f.pass_name, f.rule, f.path)
                      for f in rep.findings if f.pass_name != "sharding")
        return rest, [(f.rule, f.path) for f in rep.findings
                      if f.pass_name == "sharding"]
    base, _ = split(lint_engine(ServeEngine(api, p, **kw), **lint))
    out = {}
    for shape in SHAPES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        with use_mesh(mesh):
            eng = ServeEngine(api, p, **kw)
        rep = lint_engine(eng, **lint)
        rest, shard = split(rep)
        out[shape] = dict(ok=rep.ok, rest_equal=rest == base,
                          sharding=shard)
    return out


def _refusals(build, make_mesh, use_mesh, ServeEngine):
    """What an engine raises under the meshes it still refuses (exception
    type and message): a (1, 2) mesh over heads or KV heads that the model
    axis does not divide, a mesh with an axis other than ``data`` and
    ``model``, and a shape-only mesh."""
    from repro_torch.analysis import ShapeOnlyMesh
    from repro_torch.configs import REGISTRY
    out = {}
    tiny = REGISTRY["phi3-mini-3.8b"].tiny(dtype="float32")
    cases = {"kv-heads": (make_mesh((1, 2), ("data", "model"), "cpu"),
                          dataclasses.replace(tiny, n_kv_heads=1)),
             "heads": (make_mesh((1, 2), ("data", "model"), "cpu"),
                       dataclasses.replace(tiny, n_heads=3, n_kv_heads=3)),
             "axes": (make_mesh((1, 2), ("pod", "model"), "cpu"), tiny),
             "shape-only": (ShapeOnlyMesh({"data": 1, "model": 2}), tiny)}
    for key, (mesh, cfg) in cases.items():
        api = build(cfg)
        params = api.init(seed=0, device="cpu")
        try:
            with use_mesh(mesh):
                ServeEngine(api, params, device="cpu")
            out[key] = None
        except Exception as e:              # noqa: BLE001 - recorded
            out[key] = (type(e).__name__, str(e))
    return out


# --------------------------------------------------------------------------
# the test process
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _configs():
    """(reference, port) configs of each tree: 8-bit fake QAT; activation
    quantizers off for the deploys; vocab 251; granite with 4 and 3
    experts."""
    from repro.configs import REGISTRY as JREG
    from repro.models.common import QuantConfig as JQ
    from repro_torch.configs import REGISTRY as TREG
    from repro_torch.configs.base import QuantConfig as TQ
    out = {}
    for name, arch, act, over in (
            ("qat8", "phi3-mini-3.8b", 8, {}),
            ("qat32", "phi3-mini-3.8b", 32, {}),
            ("v251", "phi3-mini-3.8b", 8, dict(vocab=251)),
            ("granite_ep", "granite-moe-3b-a800m", 8, {}),
            ("granite_tp", "granite-moe-3b-a800m", 8, dict(n_experts=3)),
            ("granite32", "granite-moe-3b-a800m", 32, {}),
            ("granite3_32", "granite-moe-3b-a800m", 32,
             dict(n_experts=3))):
        qc = dict(mode="fake", n_bits=8, act_bits=act)
        out[name] = tuple(dataclasses.replace(
            reg[arch].tiny(dtype="float32").with_quant(q(**qc)), **over)
            for reg, q in ((JREG, JQ), (TREG, TQ)))
    return out


@pytest.fixture(scope="module")
def run():
    pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp
    from repro.models.api import build as jbuild
    from repro.serve import Request as JRequest
    from repro.serve import SamplingParams as JSP
    from repro.serve import ServeEngine as JEngine
    from repro_torch.bridge import params_from_numpy
    from repro_torch.serve.deploy import to_serving_params
    from torch_port_helpers import jax_deployed, tree_to_numpy

    cfgs = _configs()
    qat = {name: jbuild(jc).init(jax.random.PRNGKey(0))
           for name, (jc, _) in cfgs.items()}
    np_tree = {name: tree_to_numpy(t) for name, t in qat.items()}
    deploys = {"packed8": ("qat32", (8, "packed")),
               "packed4": ("qat32", (4, "packed")),
               "bitplane8": ("qat32", (8, "bitplane")),
               "granite8": ("granite32", (8, "packed")),
               "granite3_4": ("granite3_32", (4, "packed"))}
    trees = {n: (cfgs[n][1], np_tree[n], None)
             for n in ("qat8", "v251", "granite_ep", "granite_tp")}
    for n, (src, dep) in deploys.items():
        trees[n] = (cfgs[src][1], np_tree[src], dep)
    work = tempfile.mkdtemp(prefix="sharded_serving_")
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"trees": trees}, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + sys.path))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, __file__, work, str(r), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    # the reference's single-device results, while the ranks run
    ref = {"tokens": {}, "loss": {}}
    jtrees = {n: qat[n] for n in ("qat8", "v251", "granite_ep",
                                  "granite_tp")}
    for n, (src, (bits, layout)) in deploys.items():
        tp = to_serving_params(params_from_numpy(np_tree[src],
                                                 device="cpu"),
                               bits, layout=layout, device="cpu")
        jtrees[n] = jax_deployed(tp)
    japis = {n: jbuild(cfgs[src][0]) for n, src in (
        ("qat8", "qat8"), ("v251", "v251"), ("packed8", "qat32"),
        ("packed4", "qat32"), ("bitplane8", "qat32"),
        ("granite8", "granite32"), ("granite3_4", "granite3_32"))}
    for leg, (tree, kw, drive) in LEGS.items():
        kw = dict(kw)
        if kw.get("backend") == "ref":
            kw["attn_backend"] = "ref"
        eng = JEngine(japis[tree], jtrees[tree], **kw)
        tok = P251 if tree == "v251" else PROMPTS
        if drive == "generate":
            ref["tokens"][leg] = np.asarray(eng.generate(
                {"tokens": jnp.asarray(tok)}, max_new=6)).tolist()
        else:
            res = eng.serve([JRequest(
                uid=i, inputs={"tokens": jnp.asarray(tok[i:i + 1])},
                sampling=JSP(max_new_tokens=6), arrival=i)
                for i in range(4)], **drive)
            ref["tokens"][leg] = [res[i].tokens for i in range(4)]
    batch = {"tokens": jnp.asarray(MOE_TOK, jnp.int32),
             "labels": jnp.zeros(MOE_TOK.shape, jnp.int32)}
    for leg in LOSS_LEGS:
        ref["loss"][leg] = float(jbuild(cfgs[leg][0]).loss(qat[leg],
                                                           batch)[0])

    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(10.0, 240 - (
                time.time() - t0)))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank did not finish in 240 s")
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    with open(os.path.join(work, "out.pkl"), "rb") as f:
        out = pickle.load(f)
    return ref, out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("leg", list(LEGS))
def test_sharded_tokens_equal_reference(run, leg, shape):
    """Greedy tokens under the mesh are the reference's single-device
    tokens (and the port's own single-device ones)."""
    ref, out = run
    assert out["single"][leg] == ref["tokens"][leg], leg
    assert out["tokens"][leg, shape] == ref["tokens"][leg], (leg, shape)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("leg", LOSS_LEGS)
def test_sharded_moe_loss_equals_reference(run, leg, shape):
    """The sharded MoE layer's loss (expert parallel with E = 4, in-expert
    tensor parallel with E = 3 on 2 model ranks) within 1e-5 of the
    reference's single-device loss."""
    ref, out = run
    np.testing.assert_allclose(out["loss"][leg, shape], ref["loss"][leg],
                               rtol=1e-5, atol=1e-5)


def test_unported_paths_refuse_a_mesh(run):
    """What the port still does not place raises: heads or KV heads that
    the model axis does not divide, and a mesh axis other than ``data``
    and ``model``, ``NotImplementedError`` naming ROADMAP item 6 (every
    family and speculative decoding serve under a mesh:
    tests/test_torch_sharded_families.py); a shape-only mesh cannot be
    placed on (``TypeError``)."""
    _, out = run
    assert set(out["refused"]) == {"kv-heads", "heads", "axes",
                                   "shape-only"}
    for key, got in out["refused"].items():
        if key == "shape-only":
            assert got is not None and got[0] == "TypeError", got
        else:
            assert got is not None and got[0] == "NotImplementedError" \
                and "item 6" in got[1], (key, got)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_engine_lints(run, shape):
    """``lint_engine`` on an engine placed on the mesh passes with the
    unplaced engine's contract, graph and footprint findings (its shards
    checked as the whole leaves they form, its entry points run under the
    mesh), and its sharding pass lints the padded global shapes, as the
    reference lints its placed arrays."""
    _, out = run
    rec = out["lint"][shape]
    assert rec["ok"] and rec["rest_equal"], rec
    assert rec["sharding"], rec
    # the params' padded global shapes divide the mesh: no param pads
    # (the decode state, placed unpadded, may)
    assert not any(r[0] == "axis-padded" and r[1].startswith("['layers']")
                   for r in rec["sharding"]), rec


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
