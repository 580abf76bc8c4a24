"""Training of the vlm (qwen2-vl-2b), ssm (rwkv6-1.6b) and hybrid
(zamba2-1.2b) families in the port, held against the JAX reference, and
the abstract input specs of every family.

``lm_batch_for`` gives each family the shapes and dtypes of
``train_batch_spec`` (a vlm batch leaves ``positions`` to the model).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro_torch.configs import REGISTRY, ShapeCell  # noqa: E402
from repro_torch.data import lm_batch_for  # noqa: E402
from repro_torch.models.api import build as tbuild  # noqa: E402

torch.set_num_threads(2)
QWEN, RWKV, ZAMBA = "qwen2-vl-2b", "rwkv6-1.6b", "zamba2-1.2b"


@pytest.mark.parametrize("arch", [QWEN, "seamless-m4t-large-v2", RWKV])
def test_lm_batch_for_follows_the_spec(arch):
    """Batches of the cell's shapes (a vlm batch without ``positions``,
    which the model makes), f32 where the spec says bf16, pure functions
    of (seed, step), 0.1 x standard normal inputs; the tokens are the
    bigram stream's."""
    from repro.data import lm_batch_for as j_batch
    cfg = REGISTRY[arch].tiny(dtype="float32")
    cell = ShapeCell("train", 40, 3, "train")
    spec = tbuild(cfg).train_batch_spec(cell)
    b, again = lm_batch_for(cfg, cell, 2, 5), lm_batch_for(cfg, cell, 2, 5)
    assert b.keys() == spec.keys() - {"positions"}
    for k, t in b.items():
        assert t.shape == spec[k].shape, k
        want = torch.float32 if spec[k].is_floating_point() else torch.int32
        assert t.dtype == want and torch.equal(t, again[k]), k
    ref = j_batch(JREG[arch].tiny(dtype="float32"), cell, 2, 5)
    for k in ("tokens", "labels"):
        assert ref[k].shape == tuple(b[k].shape)
    extra = b.get("vision_embeds", b.get("frames"))
    if extra is not None:
        assert abs(float(extra.std()) - 0.1) < 0.01
        assert not torch.equal(extra, lm_batch_for(cfg, cell, 3, 5)[
            "vision_embeds" if "vision_embeds" in b else "frames"])
