"""Serving the vlm (qwen2-vl-2b), ssm (rwkv6-1.6b) and hybrid (zamba2-1.2b)
families through the port, held against the JAX reference: the
companions of the reference's rows for these families in
tests/test_serving.py and tests/test_autotune.py.

Fixture: each architecture at ``tiny(dtype="float32")`` with 9x8 blocks
and 8-bit activations in both packages, the reference's
``init(PRNGKey(0))`` QAT tree, deployed by the reference and carried
across through numpy (``torch_port_helpers.family_fx``).  Prompt
tokens come from ``numpy.random.default_rng`` (prompt seed 1, see
tests/test_torch_slice.py on rounding ties); a qwen2-vl prompt's vision
prefix is ``0.1 * normal`` from numpy.  The families' other tests are in
``tests/test_torch_families_{serving,generate,scheduler,decode,launch}.py``.

Training these families through the serving launcher is refused as the
reference refuses it; the serve launcher serves each family on the
CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from torch_port_helpers import family_fx, np_of, tree_to_numpy  # noqa: E402

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"
ARCHS = (QWEN, RWKV, ZAMBA)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_is_refused(arch):
    """Training was ported: the loss takes a QAT tree of the family (aux
    0, no experts) and the train launcher builds its trainer
    (tests/test_torch_train_families.py runs it)."""
    from repro_torch.launch import train as tl
    fx = family_fx(arch)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    tqat = params_from_numpy(tree_to_numpy(fx["qat"]), device="cpu")
    loss, m = fx["tapi"].loss(tqat, {"tokens": tok, "labels": tok})
    assert torch.isfinite(loss) and float(m["aux"]) == 0.0
    trainer = tl.make_trainer(tl.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--steps", "1"]))
    assert trainer.state.step == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_family_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id>`` on the CPU with
    the quantizers off: each request's tokens equal one-shot ``generate``
    on its inputs (paged and chunked where the family allows; a qwen2-vl
    request carries its (1, 16, 128) vision prefix from the seeded
    generator), then the one-shot path through the bit-plane kernel."""
    from repro_torch.launch.serve import main
    args = ["--arch", arch, "--device", "cpu", "--requests", "--backend",
            "kernel", "--attn-backend", "fused", "--act-bits", "32",
            "--batch", "4", "--n-slots", "3", "--prompt-lens", "6,2,9",
            "--max-news", "5,3"]
    if arch != RWKV:
        args += ["--kv-bits", "8", "--page-size", "4", "--prefill-chunk",
                 "3"]
    out = main(args)
    eng = out["engine"]
    for req, res in zip(out["requests"], out["results"]):
        if arch == QWEN:
            ve = req.inputs["vision_embeds"]
            assert ve.shape == (1, 16, 128) and ve.dtype == np.float32
        want = eng.generate(req.inputs, max_new=req.sampling.max_new_tokens)
        assert res.tokens == np_of(want)[0].tolist(), req.uid
    main(["--arch", arch, "--device", "cpu", "--backend", "bitplane",
          "--attn-backend", "fused", "--max-new", "3", "--batch", "2"])
    assert "deployed: bitplane int8" in capsys.readouterr().out
