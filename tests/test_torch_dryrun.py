"""The port's dry run (``repro_torch.launch.dryrun``,
``repro_torch.dist.cost_analysis``) against the reference's
(``repro.launch.dryrun``, ``repro.dist.hlo_analysis``), deviceless.

* ``_model_flops_estimate`` equals the reference's for every registered
  arch and every ``cells_for`` cell; ``cells_for`` / ``LONG_CONTEXT_OK``
  are the reference's.
* phi3-mini at full width on the 16x16 mesh: the argument bytes of the
  train, prefill and decode cells equal the reference's committed
  artifacts (``experiments/dryrun/singlepod__phi3-mini-3.8b__*.json``)
  to the byte; the multi-pod train cell's too.
* The FLOPs the meter counts on a tiny phi3 prefill equal a hand count
  from the config: every projection, the attention products and the LM
  head.
* ``roofline_terms`` / ``dominant_term`` give the reference's values with
  the reference's constants; the defaults are the H100's.
* A ``deploy_bits=8`` decode cell runs the kernel wrappers on ``meta``
  (their plain versions' shapes), and launches nothing.
* Cells the port refuses (heads that do not divide ``model``; the
  ``pod`` axis in serving) write ``.ERROR`` files naming the refusal.
* The recording mesh's collective helpers give their results' shapes and
  log the reference's op names and byte rule; ``collective_stats`` and
  ``shape_census`` total them.
"""
import dataclasses
import importlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.dist import cost_analysis  # noqa: E402
from repro_torch.dist import parallel as par  # noqa: E402
from repro_torch.dist.sharding import use_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.api import build  # noqa: E402

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(HERE, "..", "experiments", "dryrun")


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored after
    it (it sets 512 forced host devices at import)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_model_flops_estimate_and_cells_equal_reference():
    ref = _reference_dryrun()
    from repro.configs import REGISTRY as JREG
    from repro.configs.base import cells_for as j_cells_for
    assert sorted(REGISTRY) == sorted(JREG)
    n = 0
    for name in sorted(REGISTRY):
        cells = list(dryrun.cells_for(REGISTRY[name]))
        assert [c.name for c in cells] == \
            [c.name for c in j_cells_for(JREG[name])], name
        for cell, jcell in zip(cells, j_cells_for(JREG[name])):
            assert dryrun._model_flops_estimate(REGISTRY[name], cell) == \
                ref._model_flops_estimate(JREG[name], jcell), (name, cell)
            n += 1
    assert n == 2 * 4 + 8 * 3
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    assert tbase.LONG_CONTEXT_OK == jbase.LONG_CONTEXT_OK
    assert [dataclasses.astuple(c) for c in tbase.LM_SHAPES] == \
        [dataclasses.astuple(c) for c in jbase.LM_SHAPES]


@pytest.mark.parametrize("multi_pod,cell", [
    (False, "train_4k"), (False, "prefill_32k"), (False, "decode_32k"),
    (True, "train_4k")])
def test_phi3_full_width_argument_bytes_equal_artifacts(multi_pod, cell):
    """The shard-shape sum of each step's inputs, at full width on the
    production mesh, is the reference's compiled ``argument_size``."""
    tag = "multipod" if multi_pod else "singlepod"
    with open(os.path.join(ARTIFACTS,
                           f"{tag}__phi3-mini-3.8b__{cell}.json")) as f:
        want = json.load(f)
    cfg = REGISTRY["phi3-mini-3.8b"]
    c = next(x for x in dryrun.cells_for(cfg) if x.name == cell)
    mesh = dryrun.production_mesh(multi_pod)
    api = build(cfg)
    if c.kind == "train":
        _, arg, _, _ = dryrun._train_step(api, c, mesh, want["microbatches"])
    else:
        _, arg, _, _ = dryrun._serve_step(api, c, mesh, 0)
    assert arg == want["per_device"]["argument_bytes"]


def test_counted_flops_equal_hand_count():
    """Tiny phi3 prefill (B=2, S=16) on one rank: 2 x every projection's
    multiply-adds, QK^T and PV over the whole S x S square (the dense
    core computes every score before the causal mask), the tied LM head
    over every position."""
    cfg = REGISTRY["phi3-mini-3.8b"].tiny(dtype="float32")
    b, s = 2, 16
    rec = dryrun.lower_cell(cfg, ShapeCell("prefill", s, b, "prefill"),
                            par.RecordingMesh({"data": 1, "model": 1}))
    d, h, kv, dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    t = b * s
    proj = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * ff
    attn = 2 * (b * h * s * s * dh)
    want = cfg.n_layers * (2 * t * proj + 2 * attn) + 2 * t * d * cfg.vocab
    assert rec["per_device"]["flops"] == want
    assert rec["per_device"]["collective_bytes"] == 0


def test_roofline_terms_equal_reference_with_its_constants():
    from repro.dist import hlo_analysis as h
    args = (3.7e14, 2.2e12, 8.1e10)
    mine = cost_analysis.roofline_terms(
        *args, peak_flops=h.PEAK_FLOPS, hbm_bw=h.HBM_BW, link_bw=h.ICI_BW)
    assert mine == h.roofline_terms(*args)
    assert cost_analysis.dominant_term(mine) == h.dominant_term(mine)
    terms = cost_analysis.roofline_terms(*args)
    assert terms == {"compute_s": args[0] / 989.4e12,
                     "memory_s": args[1] / 3.35e12,
                     "collective_s": args[2] / 450e9}
    assert cost_analysis.dominant_term(terms) == "memory_s"


def test_quantized_decode_cell_runs_the_wrappers_on_meta(monkeypatch):
    """deploy_bits=8 decode on (1, 2): every projection through
    ``packed_matmul`` and the decode attention through
    ``paged_attention``, their plain versions on ``meta``; no launch."""
    import sys
    calls = {}
    for mod, ref in (("packed_matmul", "packed_matmul_ref"),
                     ("paged_attention", "paged_attention_ref")):
        m = sys.modules[f"repro_torch.kernels.{mod}"]
        orig = getattr(m, ref)

        def spy(*a, _orig=orig, _mod=mod, **k):
            assert a[0].is_meta
            calls[_mod] = calls.get(_mod, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(m, ref, spy)
    from repro_torch.kernels import packed_matmul, paged_attention
    before = (packed_matmul.launches, paged_attention.launches)
    cfg = REGISTRY["phi3-mini-3.8b"].tiny(dtype="float32")
    rec = dryrun.lower_cell(cfg, ShapeCell("decode", 16, 4, "decode"),
                            par.RecordingMesh({"data": 1, "model": 2}),
                            deploy_bits=8)
    # 7 projections a layer (the head is tied to the plain embedding);
    # one attention read a layer
    assert calls == {"packed_matmul": 7 * cfg.n_layers,
                     "paged_attention": cfg.n_layers}
    assert (packed_matmul.launches, paged_attention.launches) == before
    assert rec["per_device"]["flops"] > 0
    # the row-parallel wo and down products a layer, and the vocab-split
    # embedding's lookup
    assert rec["collectives"]["counts"]["all-reduce"] == 2 * cfg.n_layers + 1


def test_refused_cells_write_error_files(tmp_path):
    """granite-moe's 24 heads / 8 KV heads on 16 model ranks, and phi3's
    serving cells on the multi-pod mesh: ``.ERROR`` files naming the
    refusal (the train cells are not run here)."""
    dryrun.run_cells(["granite-moe-3b-a800m"], ["decode_32k"], False,
                     str(tmp_path))
    dryrun.run_cells(["phi3-mini-3.8b"], ["prefill_32k"], True,
                     str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == ["multipod__phi3-mini-3.8b__prefill_32k.ERROR",
                     "singlepod__granite-moe-3b-a800m__decode_32k.ERROR"]
    err = (tmp_path / names[1]).read_text()
    assert "do not divide the model axis (16)" in err
    assert "('pod', 'data', 'model') is not ported" in \
        (tmp_path / names[0]).read_text()


def test_recording_mesh_helpers_and_stats():
    mesh = par.RecordingMesh({"data": 2, "model": 4}, {"model": 1})
    x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    with use_mesh(mesh):
        assert par.active_mesh() is mesh and mesh.coord("model") == 1
        r = par.all_reduce(x, "model")
        g = par.all_gather(x, "model")
        a = par.all_to_all(torch.empty((8, 2), device="meta"), "model")
        c = par.broadcast(x, "data", 1)
        par.all_reduce(x, None)
    assert r is x and c is x
    assert len(g) == 4 and all(t.shape == (3, 5) and t.is_meta for t in g)
    assert len(a) == 4 and all(t.shape == (2, 2) for t in a)
    got = [(e.op, e.shape, e.dtype, e.bytes, e.axis) for e in mesh.log]
    assert got == [("all-reduce", (3, 5), "bfloat16", 30, ("model",)),
                   ("all-gather", (4, 3, 5), "bfloat16", 120, ("model",)),
                   ("all-to-all", (8, 2), "float32", 64, ("model",)),
                   ("collective-broadcast", (3, 5), "bfloat16", 30,
                    ("data",)),
                   ("all-reduce", (3, 5), "bfloat16", 30,
                    ("data", "model"))]
    stats = cost_analysis.collective_stats(mesh.log)
    assert stats.counts == {"all-reduce": 2, "all-gather": 1,
                            "all-to-all": 1, "collective-broadcast": 1}
    assert stats.total_bytes == 274
    assert cost_analysis.shape_census(mesh.log, min_bytes=31) == \
        {"bfloat16": 120, "float32": 64}
    assert cost_analysis.shape_census([("int8", 7), ("float32", 4)]) == \
        {"int8": 7, "float32": 4}
