"""PyTorch port vs the JAX reference: wire formats, configs, sampling and
the device rule.

Every check here is bit-exact (``array_equal``): int4 nibble packing,
block padding and expansion, fake-quant init, the packed deployment
(int8 / int4 payloads and per-WB scales at 8x128 and at the paper's 9x8
geometry, whose block padding gives an odd K) and its dense compose.
Inputs are made with numpy from a seed and fed to both frameworks.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.core import blocking as jblk  # noqa: E402
from repro.core.fakequant import fq_from_float as j_fq  # noqa: E402
from repro.core.quantize import pack_int4 as j_pack  # noqa: E402
from repro.core.quantize import unpack_int4 as j_unpack  # noqa: E402
from repro.serve.deploy import serving_compose as j_compose  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as TREG  # noqa: E402
from repro_torch.core import blocking as tblk  # noqa: E402
from repro_torch.core.fakequant import fq_from_float as t_fq  # noqa: E402
from repro_torch.core.quantize import pack_int4 as t_pack  # noqa: E402
from repro_torch.core.quantize import unpack_int4 as t_unpack  # noqa: E402
from repro_torch.kernels.tiling import fit_block, pad_dim, round_up  # noqa: E402
from repro_torch.serve.deploy import serving_compose as t_compose  # noqa: E402
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from torch_port_helpers import np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)

GEOMS = [(8, 128), (9, 8)]


@pytest.mark.parametrize("arch", sorted(TREG))
def test_configs_match_reference_field_by_field(arch):
    j, t = JREG[arch], TREG[arch]
    for f in dataclasses.fields(t):
        if f.name != "quant":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.quant) == dataclasses.asdict(j.quant)
    jt, tt = j.tiny(dtype="float32"), t.tiny(dtype="float32")
    for f in dataclasses.fields(tt):
        if f.name != "quant":
            assert getattr(tt, f.name) == getattr(jt, f.name), f.name
    assert tt.head_dim == jt.head_dim


@pytest.mark.parametrize("axis", [-1, -2, 0])
def test_int4_pack_unpack_bit_exact(axis):
    q = np.random.default_rng(1).integers(-8, 8, (6, 4, 10)).astype(np.int32)
    jp = np.array(j_pack(jnp.asarray(q), axis=axis))
    tp = np_of(t_pack(torch.from_numpy(q), axis=axis))
    assert tp.dtype == np.uint8
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(np_of(t_unpack(torch.from_numpy(tp),
                                                 axis=axis)), q)
    np.testing.assert_array_equal(
        np_of(t_unpack(torch.from_numpy(jp), axis=axis)),
        np.asarray(j_unpack(jnp.asarray(jp), axis=axis)))


@pytest.mark.parametrize("wbr,wbc", GEOMS)
def test_blocking_bit_exact(wbr, wbc):
    w = np.random.default_rng(2).standard_normal((3, 21, 130)).astype(
        np.float32)
    jspec, tspec = jblk.BlockingSpec(wbr, wbc), tblk.BlockingSpec(wbr, wbc)
    assert tspec.grid(21, 130) == jspec.grid(21, 130)
    assert tspec.padded(21, 130) == jspec.padded(21, 130)
    jp = np.array(jblk.pad_to_blocks(jnp.asarray(w), jspec))
    tp = np_of(tblk.pad_to_blocks(torch.from_numpy(w), tspec))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(np_of(tblk.block_view(torch.from_numpy(jp),
                                                        tspec)),
                                  np.asarray(jblk.block_view(jnp.asarray(jp),
                                                             jspec)))
    gr, gc = jspec.grid(21, 130)
    m = np.random.default_rng(3).standard_normal((3, gr, gc)).astype(
        np.float32)
    np.testing.assert_array_equal(
        np_of(tblk.expand_block_map(torch.from_numpy(m), tspec)),
        np.asarray(jblk.expand_block_map(jnp.asarray(m), jspec)))


@pytest.mark.parametrize("wbr,wbc", GEOMS)
def test_fq_from_float_bit_exact(wbr, wbc):
    w = np.random.default_rng(4).standard_normal((2, 27, 40)).astype(
        np.float32)
    j = j_fq(jnp.asarray(w), 8, jblk.BlockingSpec(wbr, wbc))
    t = t_fq(torch.from_numpy(w), 8, tblk.BlockingSpec(wbr, wbc))
    for name in ("w", "scale", "bitwidth"):
        np.testing.assert_array_equal(np_of(getattr(t, name)),
                                      np.asarray(getattr(j, name)))
    assert t.shape == j.shape and t.n_bits == j.n_bits
    assert (t.spec.wb_rows, t.spec.wb_cols) == (j.spec.wb_rows,
                                                j.spec.wb_cols)


def _qat_tree(wbr, wbc, seed=5):
    """A QAT tree with a stacked and a plain leaf, mixed per-WB bit-widths
    (so the container rescale of the deployment differs per block)."""
    rng = np.random.default_rng(seed)
    spec = jblk.BlockingSpec(wbr, wbc)
    stacked = j_fq(jnp.asarray(rng.standard_normal((2, 27, 140)).astype(
        np.float32)), 8, spec)
    plain = j_fq(jnp.asarray(rng.standard_normal((30, 50)).astype(
        np.float32)), 8, spec)
    bw = rng.integers(0, 9, stacked.bitwidth.shape).astype(np.float32)
    stacked = dataclasses.replace(stacked, bitwidth=jnp.asarray(bw))
    return {"layers": {"w": stacked}, "head": plain,
            "norm": jnp.zeros((50,), jnp.float32)}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("wbr,wbc", GEOMS)
def test_to_serving_params_bit_exact(bits, wbr, wbc):
    qat = _qat_tree(wbr, wbc)
    jdep = j_deploy(qat, bits)
    tdep = t_deploy(params_from_numpy(tree_to_numpy(qat), device="cpu"),
                    bits, device="cpu")
    for path in (("layers", "w"), ("head",)):
        j, t = jdep, tdep
        for p in path:
            j, t = j[p], t[p]
        assert t.w_int.dtype == (torch.int8 if bits == 8 else torch.uint8)
        np.testing.assert_array_equal(np_of(t.w_int), np.asarray(j.w_int))
        np.testing.assert_array_equal(np_of(t.scale), np.asarray(j.scale))
        assert t.shape == tuple(j.shape) and t.bits == j.bits
        # dense compose of the deployed leaf (what the dense backend runs)
        np.testing.assert_array_equal(
            np_of(t_compose(t, torch.float32)),
            np.asarray(j_compose(j, jnp.float32)))
    np.testing.assert_array_equal(np_of(tdep["norm"]),
                                  np.asarray(jdep["norm"]))


def test_odd_block_padded_k_carries_zero_nibble_row():
    """9x8 with K=27 pads to Kp=27 (3 WB rows): int4 packs 14 byte rows,
    the last high nibble a zero pad row."""
    tdep = t_deploy(params_from_numpy(tree_to_numpy(_qat_tree(9, 8)),
                                      device="cpu"), 4, device="cpu")
    w_int = tdep["layers"]["w"].w_int
    assert w_int.shape == (2, 14, 144)
    assert int((w_int[:, -1] >> 4).abs().sum()) == 0


def test_tiling_helpers():
    assert round_up(13, 8) == 16 and round_up(16, 8) == 16
    assert fit_block(128, 72, 1) == 72 and fit_block(128, 136, 1) == 68
    assert fit_block(128, 130, 1) == 65 and fit_block(128, 200, 1) == 100
    a = torch.ones((2, 3), dtype=torch.int8)
    assert pad_dim(a, 1, 5).shape == (2, 5) and pad_dim(a, 0, 2) is a
    assert int(pad_dim(a, 0, 4)[2:].abs().sum()) == 0


def test_top_k_mask_keeps_exactly_k_ties_by_token_id():
    from repro_torch.serve.sampling import top_k_mask
    logits = torch.tensor([[1.0, 3.0, 3.0, 3.0, 0.5, 3.0]])
    kept = torch.isfinite(top_k_mask(logits, 2))[0].tolist()
    # four logits tie at 3.0: exactly two survive, the lowest token ids
    assert kept == [False, True, True, False, False, False]
    kept3 = torch.isfinite(top_k_mask(logits, 5))[0]
    assert int(kept3.sum()) == 5 and not bool(kept3[4])


def test_sample_token_greedy_and_top_k():
    from repro_torch.serve.sampling import SamplingParams, sample_token
    logits = torch.tensor([[0.0, 5.0, 1.0, 4.9], [2.0, 0.0, 0.0, 1.0]])
    g = torch.Generator().manual_seed(0)
    assert sample_token(logits, SamplingParams(), g).tolist() == [1, 0]
    sp = SamplingParams(temperature=1.0, top_k=2)
    draws = torch.stack([sample_token(logits, sp, g) for _ in range(200)])
    assert set(draws[:, 0].tolist()) <= {1, 3}
    assert set(draws[:, 1].tolist()) <= {0, 3}


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    """Entry points default to the CUDA card and never fall back: on a
    machine without one, a call that does not ask for the CPU raises."""
    from repro_torch.models.api import build
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TREG["phi3-mini-3.8b"].tiny(dtype="float32", n_layers=1)
    api = build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init(0)
    params = api.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_deploy(params, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(api, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"a": np.zeros(2, np.float32)})
    eng = ServeEngine(api, t_deploy(params, 8, device="cpu"), device="cpu")
    # the scheduler runs on its engine's device: an engine bound to the
    # card (here, one whose card is gone) raises instead of serving
    import copy
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve import Request, Scheduler
    reqs = [Request(uid=0, inputs={"tokens": np.zeros((1, 3), np.int32)})]
    card = copy.copy(eng)
    card.device = torch.device("cuda")
    for call in (lambda: card.make_scheduler(reqs),
                 lambda: card.serve(reqs), lambda: Scheduler(card),
                 lambda: serve_main(["--arch", "phi3-mini-3.8b",
                                     "--requests", "--batch", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert len(eng.serve(reqs, n_slots=1)[0].tokens) == 16


def _port_modules():
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    return root, files + [root / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference_package():
    """Every module of the port imports, and none of them (nor
    chip_smoke.py) imports jax or anything of ``repro``."""
    import ast
    import importlib
    root, files = _port_modules()
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
        rel = path.relative_to(root / "src") if "src" in path.parts else None
        if rel is not None:
            mod = ".".join(rel.with_suffix("").parts)
            importlib.import_module(mod.removesuffix(".__init__"))
