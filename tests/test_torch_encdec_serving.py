"""Encoder-decoder serving in the port, held against the JAX reference: the
companions of the reference's seamless rows in tests/test_backend_parity.py
and tests/test_serving.py, and the family through the port's deploy,
engine, scheduler and launcher.

Fixture: ``seamless-m4t-large-v2`` (24 + 24 layers, d_model 1024 at full
width; 2 + 2 layers at d_model 128 here) at ``tiny(dtype="float32")``
with 9x8 blocks and 8-bit activations, the reference's
``init(PRNGKey(0))`` QAT tree, deployed by the reference and carried
across through numpy (``torch_port_helpers.encdec_fixture``).  Tokens
come from ``numpy.random.default_rng`` (prompt seed 1, see
tests/test_torch_slice.py on rounding ties) and frames are ``0.1 *
normal`` from numpy (``torch_port_helpers.frames``); every request of a
batch shares one encoder length (8 frames), as the reference requires.

* the port's deploy of the carried QAT tree equals the reference's bit
  for bit (packed int8 / int4, bit-plane), a stack a layer at a time, the
  depthwise kernel and the embedding left float;
* prefill logits within 2e-4 of the reference across the backends, the
  bit-plane compose bit for bit the packed one; greedy tokens identical
  across the backend matrix and to the reference's;
* the refusals and the prefix-cache warning are the reference's.
(Requests, the scheduler, park / restore and the launcher are in
``tests/test_torch_encdec_requests.py``.)
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.deploy import to_serving_params as j_deploy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.common import qdense  # noqa: E402
from repro_torch.serve import Request, SamplingParams  # noqa: E402
from repro_torch.serve.deploy import (BitplaneServingWeight,  # noqa: E402
                                      ServingWeight)
from repro_torch.serve.deploy import to_serving_params as t_deploy  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from torch_port_helpers import (encdec_batch, encdec_fixture,  # noqa: E402
                                encdec_qat_engines, engine_pair, frames,
                                jax_inputs, mixed_bitwidths, np_of,
                                tree_to_numpy)

torch.set_num_threads(2)
ARCH = "seamless-m4t-large-v2"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
S_ENC = 8


@pytest.fixture(scope="module")
def fx():
    return encdec_fixture()


def _trees(fx, bits, layout="packed"):
    key = (bits, layout)
    if key not in fx["jtrees"]:
        fx["jtrees"][key] = j_deploy(fx["qat"], bits, layout=layout)
        fx["ttrees"][key] = params_from_numpy(
            tree_to_numpy(fx["jtrees"][key]), device="cpu")
    return fx["jtrees"][key], fx["ttrees"][key]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("bits,layout", [(8, "packed"), (4, "packed"),
                                         (8, "bitplane")])
def test_deploy_of_encdec_stacks_equals_reference(fx, bits, layout):
    """The port's ``to_serving_params`` of the carried QAT tree (mixed
    per-WB widths) equals the reference's deploy leaf for leaf, dtypes
    included; both (L, ...) stacks deploy a layer at a time (the same
    payload as the stack converted whole), and the depthwise kernel, the
    norms and the embedding stay f32 leaves."""
    from repro_torch.serve import deploy
    qat = mixed_bitwidths(fx["qat"], np.random.default_rng(3))
    jdep = tree_to_numpy(j_deploy(qat, bits, layout=layout))
    tqat = params_from_numpy(tree_to_numpy(qat), device="cpu")
    tdep = t_deploy(tqat, bits, layout=layout, device="cpu")
    src = dict(_leaves(tqat))
    want = {k: v for k, v in _leaves(jdep)
            if k[-1] not in ("wb_rows", "wb_cols")}
    got, stacks = {}, 0
    for path, leaf in _leaves(tdep):
        if isinstance(leaf, (ServingWeight, BitplaneServingWeight)):
            whole = deploy._convert_layer(src[path], bits, layout)
            stacks += 1
            for f in dataclasses.fields(leaf):
                v = getattr(leaf, f.name)
                if isinstance(v, torch.Tensor):
                    got[path + (f.name,)] = np_of(v)
                    assert torch.equal(v, getattr(whole, f.name)), path
                elif f.name != "spec":
                    got[path + (f.name,)] = v
        else:
            assert leaf.dtype == torch.float32, path
            got[path] = np_of(leaf)
    assert stacks == 8 + 10      # 4 + 2 + 2 a encoder, 4 + 4 + 2 a decoder
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
        else:
            assert tuple(got[k]) == tuple(v) if isinstance(v, tuple) \
                else got[k] == v, k
    assert tdep["enc_layers"]["conv_dw"].shape[1] == 15


@pytest.mark.parametrize("bits", [8, 4])
def test_family_forward_parity(fx, bits):
    """Prefill logits of every backend within 2e-4 of the reference's
    dense prefill on the same deploy; the bit-plane tree composes every
    leaf to the packed tree's weights bit for bit."""
    jp, tp = _trees(fx, bits)
    _, tb = _trees(fx, bits, "bitplane")
    for (path, a), (_, b) in zip(_leaves(tp), _leaves(tb)):
        if isinstance(a, ServingWeight):
            assert torch.equal(qdense(a, torch.float32),
                               qdense(b, torch.float32)), path
    batch = encdec_batch(fx)
    want, _ = JEngine(fx["japi"], jp, backend="dense").prefill(jax_inputs(batch))
    for be, tree in (("dense", tp), ("kernel", tp), ("ref", tp),
                     ("dense", tb), ("bitplane", tb), ("ref", tb)):
        got, state = TEngine(fx["tapi"], tree, backend=be,
                             device="cpu").prefill(batch)
        np.testing.assert_allclose(np_of(got), np.asarray(want),
                                   **LOGIT_TOL, err_msg=f"int{bits} {be}")
        assert state["enc_out"].shape == (2, S_ENC, fx["tapi"].cfg.d_model)


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_greedy_decode_token_identical_matrix(fx, bits):
    """Greedy tokens (int8 KV) identical across dense / kernel / ref on the
    packed tree and bitplane on the bit-plane tree, and to the
    reference's."""
    jp, tp = _trees(fx, bits)
    _, tb = _trees(fx, bits, "bitplane")
    batch = encdec_batch(fx)
    want = np.asarray(JEngine(fx["japi"], jp, kv_quant_bits=8,
                              backend="dense").generate(jax_inputs(batch),
                                                        max_new=4))
    for be, ab, tree in (("dense", "gather", tp), ("kernel", "fused", tp),
                         ("ref", "ref", tp), ("bitplane", "fused", tb)):
        got = TEngine(fx["tapi"], tree, kv_quant_bits=8, backend=be,
                      attn_backend=ab, device="cpu").generate(batch,
                                                              max_new=4)
        np.testing.assert_array_equal(np_of(got), want,
                                      err_msg=f"int{bits} {be}")


def test_encoder_length_mismatch_is_refused(fx):
    """Cross-attention has no per-row length mask: inserting a prompt
    whose frames are wider than the live batch's raises the reference's
    ``ValueError``, in ``prefill_at`` and at scheduler admission."""
    jeng, teng = encdec_qat_engines(fx, 32)
    batch = encdec_batch(fx, b=2)
    wide = dict(encdec_batch(fx, b=1), frames=frames(fx["frames"].shape[-1],
                                               S_ENC + 2, 9))
    _, jst = jeng.prefill(jax_inputs(batch), extra_slots=4)
    with pytest.raises(ValueError, match="same encoder length"):
        jeng.prefill_at(jax_inputs(wide), jst, 0)
    _, tst = teng.prefill(batch, extra_slots=4)
    with pytest.raises(ValueError, match="same encoder length"):
        teng.prefill_at(wide, tst, 0)
    inputs = [{k: v[:1] for k, v in batch.items()}, wide]
    jreqs = [JRequest(uid=i, inputs=jax_inputs(x), sampling=JSP(max_new_tokens=3),
                      arrival=0) for i, x in enumerate(inputs)]
    treqs = [Request(uid=i, inputs=x,
                     sampling=SamplingParams(max_new_tokens=3), arrival=0)
             for i, x in enumerate(inputs)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        sched = eng.make_scheduler(reqs, n_slots=2, page_size=4)
        with pytest.raises(ValueError, match="same encoder length"):
            sched.run(reqs)


def test_prefix_cache_is_disabled_with_a_warning(fx):
    """``prefix_cache=True`` warns as the reference does and shares no
    page: two requests with the same tokens and frames make no lookup."""
    teng = engine_pair(fx, 8)[1]
    same = encdec_batch(fx, b=1, p=9)
    reqs = [Request(uid=i, inputs=same,
                    sampling=SamplingParams(max_new_tokens=3), arrival=i)
            for i in range(2)]
    with pytest.warns(UserWarning, match="prefix_cache needs a purely"):
        sched = teng.make_scheduler(reqs, n_slots=2, page_size=4,
                                    prefix_cache=True)
    results = sched.run(reqs)
    assert sched.prefix_cache is None
    assert sched.sched_stats["prefix_lookups"] == 0
    assert sched.sched_stats["prefix_hits"] == 0
    assert results[0].tokens == results[1].tokens


def test_family_refusals(fx):
    """Speculative decoding (``ValueError``), the verify step and the
    train launcher (``NotImplementedError``) refuse the family, naming
    it; the training loss (``encdec_loss``) takes its frames batch."""
    from repro_torch.launch.train import main as train_main
    _, tb = _trees(fx, 8, "bitplane")
    with pytest.raises(ValueError, match="'audio'"):
        TEngine(fx["tapi"], tb, backend="bitplane", speculate_planes=4,
                device="cpu")
    teng = encdec_qat_engines(fx, 32)[1]
    _, state = teng.prefill(encdec_batch(fx), extra_slots=4)
    tok = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        teng.api.verify_step(teng.params, tok, state, 8)
    loss, m = fx["tapi"].loss(fx["tqat"], {
        "tokens": tok, "labels": tok, "frames": torch.zeros((2, 3, 128))})
    assert torch.isfinite(loss) and float(m["aux"]) == 0.0
    with pytest.raises(NotImplementedError, match="'audio'.*frames"):
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "1"])
