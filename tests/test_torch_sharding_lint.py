"""The port's sharding lint (``repro_torch.analysis.sharding_lint``,
``lint_engine(mesh=)``, the lint launcher's ``--mesh`` /
``--production-mesh``), held against the JAX reference finding for
finding, devicelessly: shape-only meshes of (2,1), (1,2), (2,2), the
16x16 production mesh and the 2x16x16 pod mesh over every family's tiny
tree (``torch_port_helpers.deployed_pairs``), and over engines built from
the same trees.
"""
import json
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint_engine as j_lint  # noqa: E402
from repro.analysis import lint_sharding as j_lint_sharding  # noqa: E402
from repro.analysis.sharding_lint import ShapeOnlyMesh as JMesh  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.analysis import (ShapeOnlyMesh, lint_engine,  # noqa: E402
                                  lint_sharding, production_mesh_shape)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from torch_port_helpers import deployed_pairs  # noqa: E402

torch.set_num_threads(2)

MESHES = ({"data": 2, "model": 1}, {"data": 1, "model": 2},
          {"data": 2, "model": 2}, production_mesh_shape(),
          production_mesh_shape(multi_pod=True))
ARCHS = ("phi3-mini-3.8b", "granite-moe-3b-a800m", "seamless-m4t-large-v2",
         "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b")
LINT = dict(prompt_len=8, n_slots=2, max_new=8)


@pytest.fixture(scope="module")
def trees():
    return deployed_pairs()


def _list(findings):
    return [(f.severity, f.pass_name, f.rule, f.path, f.message)
            for f in findings if f.pass_name == "sharding"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lint_sharding_equals_reference(trees, arch):
    """Every tree of the family, every mesh: the same findings in the
    same order, messages included."""
    for bits, layout in ((0, ""), (8, "packed"), (4, "packed"),
                         (8, "bitplane")):
        _, _, (jp, tp) = trees(arch, bits, layout)
        for shape in MESHES:
            want = _list(j_lint_sharding(jp, JMesh(shape)))
            got = _list(lint_sharding(tp, ShapeOnlyMesh(shape)))
            assert got == want, (arch, bits, layout, shape)
            assert got and {f[2] for f in got} <= {
                "axis-padded", "axis-indivisible", "axis-absent",
                "axis-used", "mesh-axis-unused", "clean"}


def test_clean_and_unused_axis_rules(trees):
    """A 1x1 mesh is clean; a mesh axis no parameter uses is a warning."""
    _, _, (jp, tp) = trees("phi3-mini-3.8b", 8, "packed")
    for shape in ({"data": 1, "model": 1}, {"data": 1, "model": 1,
                                            "expert": 4}):
        want = _list(j_lint_sharding(jp, JMesh(shape)))
        got = _list(lint_sharding(tp, ShapeOnlyMesh(shape)))
        assert got == want
    assert [f[2] for f in got] == ["mesh-axis-unused"]
    assert [f[2] for f in _list(lint_sharding(
        tp, ShapeOnlyMesh({"data": 1, "model": 1})))] == ["clean"]


@pytest.mark.parametrize("arch,backend,layout,kw", [
    ("phi3-mini-3.8b", "kernel", "packed",
     dict(kv_quant_bits=8, page_size=4, prefill_chunk=4)),
    ("phi3-mini-3.8b", "bitplane", "bitplane", dict(kv_quant_bits=4)),
    ("granite-moe-3b-a800m", "kernel", "packed", dict(kv_quant_bits=8)),
])
def test_lint_engine_mesh_equals_reference(trees, arch, backend, layout,
                                           kw):
    """``lint_engine(mesh=)``: the sharding findings of the params, the
    example prompt and the decode state equal the reference's, finding
    for finding; the other passes as in tests/test_torch_lint_engine.py."""
    japi, tapi, (jp, tp) = trees(arch, 8, layout)
    jb = {"kernel": "pallas"}.get(backend, backend)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine(japi, jp, backend=jb, **kw)
        teng = ServeEngine(tapi, tp, backend=backend, device="cpu", **kw)
    for shape in ({"data": 2, "model": 2}, production_mesh_shape()):
        jr = j_lint(jeng, mesh=JMesh(shape), **LINT)
        tr = lint_engine(teng, mesh=ShapeOnlyMesh(shape), **LINT)
        assert _list(tr.findings) == _list(jr.findings), shape
        assert sorted((f.severity, f.pass_name, f.rule, f.path)
                      for f in tr.findings) == \
            sorted((f.severity, f.pass_name, f.rule, f.path)
                   for f in jr.findings)
        assert tr.ok == jr.ok


@pytest.mark.parametrize("flags", [["--mesh", "data=2,model=2"],
                                   ["--production-mesh"],
                                   ["--production-mesh", "--multi-pod"]])
def test_lint_launcher_mesh_equals_reference(flags, capsys):
    """``python -m repro_torch.launch.lint --mesh`` /
    ``--production-mesh``: exit 0 and the reference launcher's sharding
    findings (its engine drawn from another seed of the same shapes)."""
    import repro.launch.lint as jlaunch
    import repro_torch.launch.lint as tlaunch
    argv = ["--arch", "phi3-mini-3.8b", "--backend", "ref", "--kv-bits", "8",
            "--page-size", "4", "--json"] + flags
    assert jlaunch.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    argv = argv[:2] + ["--device", "cpu"] + argv[2:]
    assert tlaunch.main(argv) == 0
    got = json.loads(capsys.readouterr().out)

    def sharding(rep):
        return [f for f in rep["findings"] if f["pass_name"] == "sharding"]
    assert sharding(got) == sharding(want)
    assert sharding(got)
