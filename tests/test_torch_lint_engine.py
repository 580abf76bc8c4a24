"""The port's ``lint_engine``, held against the JAX reference finding
for finding.

Tiny float32 engines from the same seed in both packages: the
reference's ``init(PRNGKey(0))`` QAT tree carried across through numpy,
deployed once by the port (bit for bit the reference's deploy) and
handed to the reference engine as its own dataclasses
(``torch_port_helpers.deployed_pairs``).  ``lint_engine(prompt_len=8,
n_slots=2, max_new=8)`` must give the reference's (severity, pass, rule,
path) set over the reference's own matrix (tests/test_analysis.py):
phi3, granite-moe and seamless x {``kernel`` / packed, ``bitplane`` /
bitplane} x {int8, int4}; and on a corrupted bit-plane mask (BP2, FAIL)
and a packed tree under ``bitplane`` (the fallback is an error here, a
warning in the graph pass).  A mesh lints.  The other families and
the launchers are in tests/test_torch_lint.py.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint_engine as j_lint  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.deploy import BitplaneServingWeight as JBP  # noqa: E402
import repro_torch.launch.lint as tlaunch  # noqa: E402
from repro_torch.analysis import lint_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from torch_port_helpers import deployed_pairs, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
LINT = dict(prompt_len=8, n_slots=2, max_new=8)
MATRIX = ("phi3-mini-3.8b", "granite-moe-3b-a800m", "seamless-m4t-large-v2")


@pytest.fixture(scope="module")
def trees():
    return deployed_pairs()


def _set(findings):
    return sorted((f.severity, f.pass_name, f.rule, f.path)
                  for f in findings)


def _pair(trees, arch, backend, layout, bits, jparams=None, tparams=None,
          **kw):
    japi, tapi, (jp, tp) = trees(arch, bits, layout)
    jb = {"kernel": "pallas"}.get(backend, backend)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine(japi, jp if jparams is None else jparams, backend=jb,
                       validate=jparams is None, **kw)
        teng = ServeEngine(tapi, tp if tparams is None else tparams,
                           backend=backend, device="cpu",
                           validate=tparams is None, **kw)
        return j_lint(jeng, **LINT), lint_engine(teng, **LINT)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("backend,layout", [("kernel", "packed"),
                                            ("bitplane", "bitplane")])
@pytest.mark.parametrize("arch", MATRIX)
def test_lint_matrix_equals_reference(trees, arch, backend, layout, bits):
    jr, tr = _pair(trees, arch, backend, layout, bits)
    assert tr.ok, tr.format()
    assert _set(tr.findings) == _set(jr.findings)
    assert tr.context["backend"] == backend
    if arch == "granite-moe-3b-a800m":      # the ragged product's stack
        assert {f.rule for f in tr.warnings} == {"sanctioned-moe-dequant"}
    else:
        assert any(f.pass_name == "graph" and f.rule == "clean"
                   for f in tr.findings)
    assert any(f.rule == "donation-ok" for f in tr.findings)


def test_corrupt_mask_is_failure(trees):
    """Acceptance: a corrupted bit-plane mask is a lint FAILURE (BP2)."""
    _, _, (jp, tp) = trees("phi3-mini-3.8b", 8, "bitplane")
    jbad = dict(jp, layers=dict(jp["layers"], attn=dict(
        jp["layers"]["attn"], wq=dataclasses.replace(
            jp["layers"]["attn"]["wq"],
            mask=jp["layers"]["attn"]["wq"].mask * 2.0))))
    assert isinstance(jbad["layers"]["attn"]["wq"], JBP)
    tbad = params_from_numpy(tree_to_numpy(jbad), device="cpu")
    jr, tr = _pair(trees, "phi3-mini-3.8b", "bitplane", "bitplane", 8,
                   jparams=jbad, tparams=tbad)
    assert not tr.ok and "FAIL" in tr.summary()
    assert any(f.rule == "BP2" and f.severity == "error"
               for f in tr.findings)
    assert _set(tr.findings) == _set(jr.findings)


def test_fallback_is_error_in_lint_engine(trees):
    _, _, (jp, tp) = trees("phi3-mini-3.8b", 8, "packed")
    jr, tr = _pair(trees, "phi3-mini-3.8b", "bitplane", "packed", 8,
                   jparams=jp, tparams=tp)
    assert not tr.ok
    assert {f.rule for f in tr.errors} == {"bitplane-dense-fallback"}
    assert _set(tr.findings) == _set(jr.findings)


def test_mesh_raises(trees):
    """A mesh lints (the sharding pass, held finding for finding in
    tests/test_torch_sharding_lint.py); only an object without a mesh's
    axis sizes raises."""
    from repro_torch.analysis import ShapeOnlyMesh
    _, tapi, (_, tp) = trees("phi3-mini-3.8b", 8, "packed")
    eng = ServeEngine(tapi, tp, backend="kernel", device="cpu")
    with pytest.raises(AttributeError):
        lint_engine(eng, mesh=object(), **LINT)
    rep = lint_engine(eng, mesh=ShapeOnlyMesh({"data": 2, "model": 2}),
                      **LINT)
    assert rep.ok and any(f.pass_name == "sharding" for f in rep.findings)
    assert tlaunch.main(["--arch", "phi3-mini-3.8b", "--device", "cpu",
                         "--production-mesh"]) == 0
