"""Serving the vlm, enc-dec, ssm (RWKV-6) and hybrid families, and
self-speculative decoding, under a process mesh: two gloo ranks on the
CPU, held against the JAX reference's single-device results.

As tests/test_torch_sharded_serving.py: one group of two ranks (this file
run as a script, one process a rank) runs every leg on the meshes (2, 1)
and (1, 2) while the test process computes the reference's tokens on one
device.  The weights are the port's ``init(seed=0)`` trees at
``tiny(dtype="float32")`` with 9x8 blocks and the activation quantizers
off (each rank draws the same tree), each deploy made by the port (the
reference's bit for bit) and handed to the reference as its own.  The
port serves through the kernel wrappers (their plain versions on these
host tensors), the reference through its ``ref`` matmuls.  Legs:

* qwen2-vl: packed int8 under ``ref`` with its vision prefix;
* seamless: packed int8, ``generate``, and the scheduler (fixed width, and
  paged, chunked and overcommitted so that requests park with their
  ``enc_out`` rows);
* rwkv6: packed int8, ``generate``, and the scheduler's insert path (its
  recurrent rows split over ``data`` on (2, 1));
* zamba2: packed int8, ``generate``, and a paged scheduler that parks
  (recurrent rows with the pages);
* bit-plane deploys of phi3, granite-moe and qwen2-vl through
  ``speculative_generate`` (each draft and verify step through
  ``bitplane_matmul``'s wrapper on the rank's shards), and phi3's
  speculative scheduler ticks.

Every leg's greedy tokens equal the reference's one-shot greedy tokens of
its prompts (a speculative leg's, the reference's non-speculative ones; no
leg parts at a near-tie on these inputs, so no logit tolerance is
needed).  A scheduler leg under the mesh keeps the unplaced engine's
ledger (parks, resumes and drafts included).  A placed seamless, zamba2
(paged) and rwkv6 (contiguous) engine lint with the unplaced engine's
contract, graph and footprint findings.  A rank's exception fails the
test.  One test a family (each over both meshes and both ranks) keeps the
file's tests fewer than the suite's longest file's, which xdist's
``--dist loadfile`` then starts first.
"""
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
QWEN, SEAMLESS, RWKV, ZAMBA = ("qwen2-vl-2b", "seamless-m4t-large-v2",
                               "rwkv6-1.6b", "zamba2-1.2b")
PHI3, GRANITE = "phi3-mini-3.8b", "granite-moe-3b-a800m"
NEW = 6
SPEC = dict(speculate_planes=4, draft_gamma=3)

# leg -> (arch, (bits, layout), port engine kwargs, reference kwargs,
#         drive: "generate" or scheduler kwargs); the reference runs the
#         "generate" legs alone (a scheduler leg's tokens are the greedy
#         tokens of the "generate" leg of its arch and deploy)
KV8 = dict(backend="kernel", attn_backend="fused", kv_quant_bits=8)
J8 = dict(backend="ref", attn_backend="gather", kv_quant_bits=8)
PARK = dict(n_slots=4, page_size=4, n_pages=9, overcommit=2.0)
LEGS = {
    "qwen2vl_packed8": (QWEN, (8, "packed"),
                        dict(backend="ref", kv_quant_bits=8), J8,
                        "generate"),
    "seamless_packed8": (SEAMLESS, (8, "packed"), KV8, J8, "generate"),
    "seamless_sched": (SEAMLESS, (8, "packed"), KV8, J8, dict(n_slots=4)),
    "seamless_park": (SEAMLESS, (8, "packed"), KV8, J8,
                      dict(PARK, prefill_chunk=4)),
    "rwkv6_packed8": (RWKV, (8, "packed"), dict(backend="kernel"),
                      dict(backend="ref"), "generate"),
    "rwkv6_sched": (RWKV, (8, "packed"), dict(backend="kernel"),
                    dict(backend="ref"), dict(n_slots=4, prefill_chunk=4)),
    "zamba2_packed8": (ZAMBA, (8, "packed"), KV8, J8, "generate"),
    "zamba2_park": (ZAMBA, (8, "packed"), KV8, J8, PARK),
    "phi3_spec": (PHI3, (8, "bitplane"), dict(KV8, **SPEC), J8,
                  "generate"),
    "phi3_spec_sched": (PHI3, (8, "bitplane"), dict(KV8, **SPEC), J8,
                        dict(n_slots=3, page_size=4, prefill_chunk=4)),
    "granite_spec": (GRANITE, (8, "bitplane"), dict(KV8, **SPEC), J8,
                     "generate"),
    "qwen2vl_spec": (QWEN, (8, "bitplane"), dict(KV8, **SPEC), J8,
                     "generate"),
}
# the tests: one a family, each over its legs, both meshes and both ranks
GROUPS = {"qwen2vl": ("qwen2vl_packed8",),
          "seamless": ("seamless_packed8", "seamless_sched",
                       "seamless_park"),
          "rwkv6": ("rwkv6_packed8", "rwkv6_sched"),
          "zamba2": ("zamba2_packed8", "zamba2_park"),
          "speculative": ("phi3_spec", "phi3_spec_sched", "granite_spec",
                          "qwen2vl_spec")}
# arch -> the linted engine's paging: seamless and zamba2 paged and
# chunked, rwkv6 contiguous (on (2, 1) its state holds a rank's rows)
LINTS = {SEAMLESS: dict(page_size=4, prefill_chunk=4),
         ZAMBA: dict(page_size=4, prefill_chunk=4), RWKV: {}}


def _generate_leg(leg):
    """The ``generate`` leg whose greedy tokens a leg is held to."""
    arch, dep = LEGS[leg][:2]
    return next(name for name, (a, d, _, _, drive) in LEGS.items()
                if (a, d) == (arch, dep) and drive == "generate")


def _config(arch):
    """The port's tiny f32 config of ``arch``, 8-bit fake quantization
    with the activation quantizers off."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import QuantConfig
    return REGISTRY[arch].tiny(dtype="float32").with_quant(
        QuantConfig(mode="fake", n_bits=8, act_bits=32))


def _inputs(cfg, rows=4, seed=0):
    """(rows, 8) prompt tokens, and a vlm's vision prefix or an enc-dec
    prompt's 8 frames (``0.1 * normal``), seeded from numpy."""
    rng = np.random.default_rng((1, 20 + seed))
    x = {"tokens": rng.integers(0, cfg.vocab, (rows, 8)).astype(np.int32)}
    if cfg.family == "vlm":
        x["vision_embeds"] = (0.1 * rng.standard_normal(
            (rows, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        x["frames"] = (0.1 * rng.standard_normal(
            (rows, 8, cfg.d_model))).astype(np.float32)
    return x


def _rows(x, i):
    return {k: v[i:i + 1] for k, v in x.items()}


# --------------------------------------------------------------------------
# the ranks (this file run as a script)
# --------------------------------------------------------------------------

def _rank_main(work: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build
    from repro_torch.serve import Request, SamplingParams
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine
    # one thread a rank: the suite's other workers share the cores
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    meshes = {s: make_mesh(s, ("data", "model"), "cpu") for s in SHAPES}
    qat, trees = {}, {}

    def tree(arch, dep):
        if arch not in qat:
            api = build(_config(arch))
            qat[arch] = (api, api.init(seed=0, device="cpu"))
        if (arch, dep) not in trees:
            trees[arch, dep] = to_serving_params(
                qat[arch][1], dep[0], layout=dep[1], device="cpu")
        return qat[arch][0], trees[arch, dep]

    out = {"tokens": {}, "stats": {}}
    for leg, (arch, dep, kw, _, drive) in LEGS.items():
        api, p = tree(arch, dep)
        x = _inputs(api.cfg)
        for shape in (None,) + SHAPES:
            if shape is None:
                # the unplaced engine's scheduler ledger, on rank 0
                if drive == "generate" or rank:
                    continue
                eng = ServeEngine(api, p, device="cpu", **kw)
            else:
                with use_mesh(meshes[shape]):
                    eng = ServeEngine(api, p, device="cpu", **kw)
            if drive == "generate":
                got = eng.generate({k: torch.as_tensor(v)
                                    for k, v in x.items()}, NEW)
                out["tokens"][leg, shape] = got.numpy().tolist()
                out["stats"][leg, shape] = [r["gamma"]
                                            for r in eng.round_log]
                continue
            reqs = [Request(uid=i, inputs=_rows(x, i),
                            sampling=SamplingParams(max_new_tokens=NEW),
                            arrival=i) for i in range(4)]
            sched = eng.make_scheduler(reqs, **drive)
            res = sched.run(reqs)
            out["tokens"][leg, shape] = [res[i].tokens for i in range(4)]
            out["stats"][leg, shape] = dict(sched.sched_stats,
                                            **sched.spec_stats)
    out["lint"] = {arch: _placed_lint(tree(arch, (8, "packed")), paging,
                                      meshes, use_mesh, ServeEngine)
                   for arch, paging in LINTS.items()}
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _placed_lint(tree, paging, meshes, use_mesh, ServeEngine):
    """``lint_engine`` of an engine placed on each mesh (every rank runs
    it): its contract, graph and footprint findings against the unplaced
    engine's, and its sharding findings' (rule, path)."""
    from repro_torch.analysis import lint_engine
    api, p = tree
    kw = dict(KV8, **paging, device="cpu")
    if api.cfg.family == "ssm":
        kw.pop("kv_quant_bits")
    lint = dict(prompt_len=8, n_slots=2, max_new=8)

    def split(rep):
        rest = sorted((f.severity, f.pass_name, f.rule, f.path)
                      for f in rep.findings if f.pass_name != "sharding")
        return rest, [(f.rule, f.path) for f in rep.findings
                      if f.pass_name == "sharding"]
    base, _ = split(lint_engine(ServeEngine(api, p, **kw), **lint))
    out = {}
    for shape, mesh in meshes.items():
        with use_mesh(mesh):
            eng = ServeEngine(api, p, **kw)
        rep = lint_engine(eng, **lint)
        rest, shard = split(rep)
        out[shape] = dict(ok=rep.ok, rest_equal=rest == base,
                          sharding=shard)
    return out


# --------------------------------------------------------------------------
# the test process
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run():
    pytest.importorskip("torch")
    import jax.numpy as jnp
    from repro.configs import REGISTRY as JREG
    from repro.models.api import build as jbuild
    from repro.models.common import QuantConfig as JQ
    from repro.serve import ServeEngine as JEngine
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from torch_port_helpers import jax_deployed

    work = tempfile.mkdtemp(prefix="sharded_families_")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + sys.path))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, __file__, work, str(r), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    # the reference's single-device greedy tokens, while the ranks run
    ref, qat = {}, {}
    for leg, (arch, dep, _, jkw, drive) in LEGS.items():
        if drive != "generate":
            continue
        if arch not in qat:
            qat[arch] = build(_config(arch)).init(seed=0, device="cpu")
        tp = to_serving_params(qat[arch], dep[0], layout=dep[1],
                               device="cpu")
        jcfg = JREG[arch].tiny(dtype="float32").with_quant(
            JQ(mode="fake", n_bits=8, act_bits=32))
        eng = JEngine(jbuild(jcfg), jax_deployed(tp), **jkw)
        x = _inputs(_config(arch))
        ref[leg] = np.asarray(eng.generate(
            {k: jnp.asarray(v) for k, v in x.items()}, max_new=NEW)).tolist()

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
    return ref, outs


@pytest.mark.parametrize("group", list(GROUPS))
def test_sharded_family_tokens_equal_reference(run, group):
    """Greedy tokens of each of the family's legs, under each mesh and on
    both ranks, are the reference's single-device greedy tokens of the
    same prompts (the speculative legs': its non-speculative ones); a
    scheduler leg keeps the unplaced engine's ledger (parks and resumes,
    drafts and acceptances included)."""
    ref, outs = run
    for leg in GROUPS[group]:
        want = ref[_generate_leg(leg)]
        for shape in SHAPES:
            for rank, out in enumerate(outs):
                assert out["tokens"][leg, shape] == want, (leg, shape, rank)
            stats = outs[0]["stats"][leg, shape]
            if LEGS[leg][4] != "generate":
                assert stats == outs[0]["stats"][leg, None], (leg, shape)
            if "park" in leg:
                assert stats["preemptions"] > 0 and stats["resumes"] > 0, \
                    (leg, shape, stats)
            if "spec" in leg:
                drafted = stats["drafted"] if isinstance(stats, dict) \
                    else sum(stats)
                assert drafted > 0, (leg, shape, stats)


@pytest.mark.parametrize("arch", list(LINTS))
def test_placed_family_engine_lints(run, arch):
    """``lint_engine`` on a seamless, a zamba2 and an rwkv6 engine placed
    on each mesh passes, on both ranks, with the unplaced engine's
    contract, graph and footprint findings, plus its sharding pass on the
    padded global shapes."""
    _, outs = run
    for shape in SHAPES:
        for out in outs:
            rec = out["lint"][arch][shape]
            assert rec["ok"] and rec["rest_equal"], (shape, rec)
            assert rec["sharding"], (shape, rec)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
