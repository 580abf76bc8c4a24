"""The port's serving-graph lint (``repro_torch.analysis.graph_lint``,
``LintReport``, the kernel boundary, the launchers), held against the JAX
reference.

Fixture: ``phi3-mini-3.8b`` at ``tiny(dtype="float32")`` (9x8 blocks),
the reference's ``init(PRNGKey(0))`` QAT tree carried across through
numpy and deployed packed once by the port, the reference getting the
same tree (``torch_port_helpers.deployed_pairs``).  Each graph case runs
the same planted fault or clean call in both packages — the reference
traces its jaxpr, the port executes once under its op recorder — and
the (severity, pass, rule, path) sets must be equal:

* the whole-tree dequant injected into prefill: errors
  (``dequant-materialization``, ``payload-convert``) under ``kernel``,
  sanctioned under ``dense`` (tests/test_analysis.py);
* a packed tree under ``bitplane``: a graph-pass warning
  (``bitplane-dense-fallback``), never an error;
* fused decode over int8 and int4 paged pools is ``kv-clean``; decode
  forced to ``gather`` under ``fused`` gives ``kv-full-width-gather`` and
  ``kv-dequant-materialization`` errors; the gather backend is
  sanctioned (tests/test_paged_attention.py);
* ``lint_engine`` on qwen2-vl, rwkv6 and zamba2 under ``kernel`` / int8
  with fused int8 KV, 4-token pages and 8-token chunks.

Port-only: a materialized transposed payload view is
``payload-transpose``; a decode that clones its state is
``missing-donation``; each wrapper call is one recorder op and hides its
plain version's ops, while the ``ref`` backend's plain versions stay
visible; ``LintReport`` formats, summarizes and serializes as the
reference's.  The launchers: ``launch.lint.main`` exits 0 on a clean
tiny engine, with the reference launcher's findings, and 1 on a packed
tree under ``bitplane``; the serve launcher's ``--lint`` lints, then
serves, and aborts on the same fault.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.lint as jlaunch  # noqa: E402
from repro.analysis import LintReport as JReport  # noqa: E402
from repro.analysis import lint_engine as j_lint_engine  # noqa: E402
from repro.analysis import fallback_leaf_paths as j_fallback  # noqa: E402
from repro.analysis import lint_traced_fn as j_lint  # noqa: E402
from repro.models.attention import paged_attn_backend  # noqa: E402
from repro.models.common import qdense as j_qdense  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.deploy import BitplaneServingWeight as JBP  # noqa: E402
from repro.serve.deploy import ServingWeight as JSW  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
import repro_torch.launch.lint as tlaunch  # noqa: E402
from repro_torch.analysis import (Finding, LintReport,  # noqa: E402
                                  check_decode_donation, fallback_leaf_paths,
                                  lint_engine, lint_traced_fn)
from repro_torch.core.state import tree_map  # noqa: E402
from repro_torch.kernels.boundary import RECORDERS  # noqa: E402
from repro_torch.kernels.ref import packed_matmul_ref  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models.common import qdense  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from torch_port_helpers import deployed_pairs  # noqa: E402

torch.set_num_threads(2)
ARCH = "phi3-mini-3.8b"
LINT = dict(prompt_len=8, n_slots=2, max_new=8)
FAMILIES = ("qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b")
FUSED = dict(kv_quant_bits=8, attn_backend="fused", page_size=4,
             prefill_chunk=8)
_J_DEPLOYED = (JSW, JBP)
_DEPLOYED = (ServingWeight, BitplaneServingWeight)


@pytest.fixture(scope="module")
def trees():
    return deployed_pairs()


@pytest.fixture(scope="module")
def fx(trees):
    japi, tapi, (jpacked, tpacked) = trees(ARCH, 8, "packed")
    _, _, (qat, tqat) = trees(ARCH, 0, "")
    return dict(japi=japi, tapi=tapi, qat=qat, jpacked=jpacked,
                tqat=tqat, tpacked=tpacked)


def _set(findings):
    return sorted((f.severity, f.pass_name, f.rule, f.path)
                  for f in findings)


def _errors(findings, rule=None):
    return [f for f in findings if f.severity == "error"
            and (rule is None or f.rule == rule)]


def _jbatch():
    return {"tokens": jax.ShapeDtypeStruct((1, 8), jnp.int32)}


def _tbatch():
    return {"tokens": torch.zeros((1, 8), dtype=torch.int32)}


def _injected(fx, backend):
    """The whole-tree dequant injected into prefill, both packages."""
    japi, tapi = fx["japi"], fx["tapi"]

    def jbad(p, b):
        dense = jax.tree_util.tree_map(
            lambda x: j_qdense(x, jnp.float32), p,
            is_leaf=lambda x: isinstance(x, _J_DEPLOYED))
        return japi.prefill(dense, b, extra_slots=64)

    def tbad(p, b):
        dense = tree_map(lambda x: qdense(x, torch.float32)
                         if isinstance(x, _DEPLOYED) else x, p)
        return tapi.prefill(dense, b, extra_slots=64, backend=backend)

    jf = j_lint(jbad, (fx["jpacked"], _jbatch()), fn_name="prefill",
                backend={"kernel": "pallas"}.get(backend, backend))
    tf = lint_traced_fn(tbad, (fx["tpacked"], _tbatch()), fn_name="prefill",
                        backend=backend)
    return jf, tf


def test_injected_dequant_is_lint_failure(fx):
    """Acceptance: dense-compose under backend='kernel' must FAIL, with
    the reference's findings."""
    jf, tf = _injected(fx, "kernel")
    assert _errors(tf, "dequant-materialization")
    assert _errors(tf, "payload-convert")
    assert _set(tf) == _set(jf)


def test_same_dequant_is_sanctioned_under_dense(fx):
    jf, tf = _injected(fx, "dense")
    assert not _errors(tf)
    assert any(f.rule == "sanctioned-dequant" for f in tf)
    assert _set(tf) == _set(jf)


def test_materialized_transpose_is_payload_transpose(fx):
    """A transposed view of a payload is free; copying it is the layout
    break (the torch form of the reference's ``payload-transpose``)."""
    tapi = fx["tapi"]

    def bad(p, b):
        p["layers"]["attn"]["wq"].w_int.transpose(-1, -2).contiguous()
        return tapi.prefill(p, b, extra_slots=64, backend="kernel")

    def fine(p, b):
        p["layers"]["attn"]["wq"].w_int.transpose(-1, -2)
        return tapi.prefill(p, b, extra_slots=64, backend="kernel")

    tf = lint_traced_fn(bad, (fx["tpacked"], _tbatch()), fn_name="prefill",
                        backend="kernel")
    assert [(f.rule, f.path) for f in _errors(tf)] == [
        ("payload-transpose", "prefill:['layers']['attn']['wq']")]
    tf = lint_traced_fn(fine, (fx["tpacked"], _tbatch()), fn_name="prefill",
                        backend="kernel")
    assert not _errors(tf) and any(f.rule == "clean" for f in tf)


def test_fallback_lint_is_warning_not_error(fx):
    japi, tapi = fx["japi"], fx["tapi"]
    jf = j_lint(lambda p, b: japi.prefill(p, b, extra_slots=64),
                (fx["jpacked"], _jbatch()), fn_name="prefill",
                backend="bitplane")
    tf = lint_traced_fn(
        lambda p, b: tapi.prefill(p, b, extra_slots=64, backend="bitplane"),
        (fx["tpacked"], _tbatch()), fn_name="prefill", backend="bitplane")
    assert not _errors(tf)
    assert any(f.rule == "bitplane-dense-fallback"
               and f.severity == "warning" for f in tf)
    assert _set(tf) == _set(jf)


def test_fallback_leaf_paths_and_engine_warning(fx):
    got = fallback_leaf_paths(fx["tpacked"], "bitplane")
    assert got and got == j_fallback(fx["jpacked"], "bitplane")
    assert fallback_leaf_paths(fx["tpacked"], "kernel") == []
    with pytest.warns(UserWarning, match="fall back") as rec:
        ServeEngine(fx["tapi"], fx["tpacked"], backend="bitplane",
                    device="cpu")
    assert any(got[0] in str(w.message) for w in rec)


# ---------------------------------------------------------------------------
# KV read side (tests/test_paged_attention.py's census cases)
# ---------------------------------------------------------------------------

def _census_engines(fx, kv_bits):
    kw = dict(kv_quant_bits=kv_bits, attn_backend="fused", page_size=4)
    return (JEngine(fx["japi"], fx["qat"], **kw),
            ServeEngine(fx["tapi"], fx["tqat"], device="cpu", **kw))


def _decode_args(jeng, teng, n_slots=2, max_len=24, page_size=4):
    state = jax.eval_shape(
        lambda p, b: jeng.api.init_decode_state(p, b, n_slots, max_len,
                                                page_size=page_size),
        jeng.params, _jbatch())
    jargs = (jeng.params, jax.ShapeDtypeStruct((n_slots, 1), jnp.int32),
             state, jax.ShapeDtypeStruct((n_slots,), jnp.int32))
    tstate = teng.init_decode_state(_tbatch(), n_slots, max_len,
                                    page_size=page_size)
    targs = (teng.params, torch.zeros((n_slots, 1), dtype=torch.int32),
             tstate, torch.zeros((n_slots,), dtype=torch.int32))
    return jargs, targs


def _kv_case(fx, kv_bits, run_attn, declared):
    jeng, teng = _census_engines(fx, kv_bits)
    jargs, targs = _decode_args(jeng, teng)

    def jfn(p, t, s, i):
        with paged_attn_backend(run_attn):
            return jeng.api.decode_step(p, t, s, i)

    jf = j_lint(jfn, jargs, fn_name="decode", backend="dense",
                attn_backend=declared)
    tf = lint_traced_fn(
        lambda p, t, s, i: teng.api.decode_step(
            p, t, s, i, backend="dense", attn_backend=run_attn),
        targs, fn_name="decode", backend="dense", attn_backend=declared)
    assert _set(tf) == _set(jf)
    return tf


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_fused_decode_is_kv_clean(fx, kv_bits):
    tf = _kv_case(fx, kv_bits, "fused", "fused")
    assert not _errors(tf), [f.format() for f in tf]
    assert any(f.rule == "kv-clean" for f in tf)


def test_gather_fallback_under_fused_is_error(fx):
    tf = _kv_case(fx, 8, "gather", "fused")
    errs = {f.rule for f in _errors(tf)}
    assert {"kv-full-width-gather", "kv-dequant-materialization"} <= errs


def test_gather_backend_is_sanctioned(fx):
    tf = _kv_case(fx, 8, "gather", "gather")
    assert not _errors(tf)
    assert any(f.rule.startswith("sanctioned-kv") for f in tf)


# ---------------------------------------------------------------------------
# donation (the cache written in place)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [0, 4])
def test_cloned_state_is_missing_donation(fx, page):
    eng = ServeEngine(fx["tapi"], fx["tpacked"], backend="kernel",
                      attn_backend="fused", kv_quant_bits=8,
                      page_size=page, device="cpu")
    state = eng.init_decode_state(_tbatch(), 2, 24, page_size=page)
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    index = torch.zeros((2,), dtype=torch.int32)
    ok = check_decode_donation(eng, tokens, state, index)
    assert [(f.severity, f.rule) for f in ok] == [("info", "donation-ok")]

    def cloning_decode(t, s, i):
        s = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                     else x, s)
        return ServeEngine.decode(eng, t, s, i)

    eng.decode = cloning_decode
    bad = check_decode_donation(eng, tokens, state, index)
    assert _errors(bad, "missing-donation")


# ---------------------------------------------------------------------------
# the kernel boundary
# ---------------------------------------------------------------------------

def test_wrapper_is_one_recorded_op(fx):
    """Under the recorder a wrapper call is one op named after its kernel
    (its plain version's dequant unseen); the plain version called
    directly is seen, as the ``ref`` backend calls it."""
    sw = dataclasses.replace(
        fx["tpacked"]["layers"]["attn"]["wq"],
        w_int=fx["tpacked"]["layers"]["attn"]["wq"].w_int[0],
        scale=fx["tpacked"]["layers"]["attn"]["wq"].scale[0],
        shape=fx["tpacked"]["layers"]["attn"]["wq"].shape[1:])
    x = torch.ones((2, sw.shape[0]))
    kw = dict(bits=sw.bits, wbr=sw.spec.wb_rows, wbc=sw.spec.wb_cols)
    calls = []
    args = ({"w": sw}, x)
    tf = lint_traced_fn(
        lambda p, x: tk.packed_matmul(x, p["w"].w_int, p["w"].scale, **kw),
        args, fn_name="kernel", backend="kernel", calls=calls)
    assert [f.rule for f in tf] == ["clean"]
    assert calls == [{"fn": "kernel", "kernel_ops": {"packed_matmul": 1},
                      "launches": {k: 0 for k in tk.launch_counts()}}]
    for backend, rule in (("ref", "sanctioned-dequant"),
                          ("kernel", "dequant-materialization")):
        tf = lint_traced_fn(
            lambda p, x: packed_matmul_ref(x, p["w"].w_int, p["w"].scale,
                                           *kw.values()),
            args, fn_name="plain", backend=backend)
        assert rule in {f.rule for f in tf}
    assert RECORDERS == []


# ---------------------------------------------------------------------------
# lint_engine on the other families, and the launchers
# ---------------------------------------------------------------------------

def _pair(trees, arch, backend, layout, bits, **kw):
    japi, tapi, (jp, tp) = trees(arch, bits, layout)
    jeng = JEngine(japi, jp, backend={"kernel": "pallas"}.get(backend,
                                                             backend), **kw)
    teng = ServeEngine(tapi, tp, backend=backend, device="cpu", **kw)
    return j_lint_engine(jeng, **LINT), lint_engine(teng, **LINT)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lint_families_fused_equals_reference(trees, arch):
    jr, tr = _pair(trees, arch, "kernel", "packed", 8, **FUSED)
    assert tr.ok, tr.format()
    assert _set(tr.findings) == _set(jr.findings)
    want = {"rwkv6-1.6b": {"clean", "donation-ok", "census"},
            "zamba2-1.2b": {"clean", "donation-ok", "census", "kv-clean",
                            "PX-smoke"}}.get(arch)
    rules = {f.rule for f in tr.findings}
    if want:
        assert rules == want
    else:
        assert {"kv-clean", "sanctioned-kv-gather",
                "sanctioned-kv-dequant"} <= rules
    # every recorded call's kernel ops on the CPU (no launches there)
    assert [c["fn"] for c in tr.calls] == (
        ["prefill", "decode", "donation"] if arch != "qwen2-vl-2b"
        else ["prefill", "decode", "chunk", "donation"])
    assert all(c["kernel_ops"].get("packed_matmul") for c in tr.calls)


def test_lint_launcher(trees, capsys):
    argv = ["--arch", "phi3-mini-3.8b", "--backend", "kernel", "--kv-bits",
            "8", "--attn-backend", "fused", "--page-size", "4",
            "--prefill-chunk", "8", "--prompt-len", "8", "--n-slots", "2",
            "--max-new", "8", "--json"]
    assert tlaunch.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["ok"] is True
    assert jlaunch.main(["--backend" if a == "--backend" else
                         ("pallas" if a == "kernel" else a)
                         for a in argv]) == 0
    want = json.loads(capsys.readouterr().out)
    assert sorted((f["severity"], f["pass_name"], f["rule"], f["path"])
                  for f in got["findings"]) == \
        sorted((f["severity"], f["pass_name"], f["rule"], f["path"])
               for f in want["findings"])
    # a planted fault: the packed tree under backend='bitplane'
    _, _, (_, tp) = trees("phi3-mini-3.8b", 8, "packed")
    with pytest.warns(UserWarning, match="fall back"):
        rc = tlaunch.main(["--arch", "phi3-mini-3.8b", "--backend",
                           "bitplane", "--device", "cpu", "--max-info", "0"],
                          params=tp)
    assert rc == 1
    assert capsys.readouterr().out.strip().endswith("-> FAIL")


def test_serve_launcher_lint(trees, capsys):
    argv = ["--arch", "phi3-mini-3.8b", "--device", "cpu", "--requests",
            "--backend", "kernel", "--attn-backend", "fused", "--kv-bits",
            "8", "--page-size", "4", "--prefill-chunk", "3", "--batch", "3",
            "--prompt-lens", "6,2,9", "--max-new", "4", "--lint"]
    out = serve_main(argv)
    assert out["lint"].ok and len(out["results"]) == 3
    assert all(len(r.tokens) == 4 for r in out["results"])
    assert "-> PASS" in capsys.readouterr().out
    _, _, (_, tp) = trees("phi3-mini-3.8b", 8, "packed")
    with pytest.warns(UserWarning, match="fall back"), \
            pytest.raises(SystemExit, match="lint failed"):
        serve_main(["--arch", "phi3-mini-3.8b", "--device", "cpu",
                    "--backend", "bitplane", "--lint"], params=tp)
    assert "-> FAIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# LintReport
# ---------------------------------------------------------------------------

def test_report_text_equals_reference():
    rows = [("info", "graph", "clean", "prefill", "m1"),
            ("error", "contracts", "BP2", "['layers']['w']", "m2"),
            ("warning", "graph", "sanctioned-moe-dequant", "decode:x", "m3"),
            ("info", "footprint", "census", "scheduler", "m4")]
    ctx = {"arch": "a", "backend": "kernel", "page_size": 4}
    jr, tr = JReport(context=dict(ctx)), LintReport(context=dict(ctx))
    for r in rows:
        jr.add(*r)
        tr.add(*r)
    for max_info in (None, 0, 1):
        assert tr.format(max_info) == jr.format(max_info)
    assert tr.summary() == jr.summary() and not tr.ok
    assert tr.to_json() == jr.to_json()
    assert json.loads(tr.to_json())["ok"] is False
    assert [f.rule for f in tr.errors] == ["BP2"]
    assert [f.rule for f in tr.warnings] == ["sanctioned-moe-dequant"]
    other = LintReport(context={"extra": 1})
    other.extend([Finding("info", "graph", "kv-clean", "decode", "m5")])
    other.calls.append({"fn": "decode"})
    tr.merge(other)
    assert len(tr.by_severity("info")) == 3 and tr.context["extra"] == 1
    assert tr.calls == [{"fn": "decode"}]
    with pytest.raises(ValueError):
        Finding("fatal", "graph", "x", "y", "z")
    clean = LintReport()
    clean.add("info", "graph", "clean", "decode", "m")
    assert clean.ok and clean.summary().endswith("PASS")
    assert np.array_equal([f.rule for f in clean.findings], ["clean"])
