"""Paper-faithful CNN models (ResNet-CIFAR / VGG-BN) with BWQ-A conv layers
(port of ``repro.models.cnn``).

Conv weights are stored in their CSP-flattened 2-D form (C_in*kh*kw,
C_out), the layout the paper blocks into WBs (Fig. 2b), as quantized
leaves, and reshaped back to 4-D when a QAT or plain weight is
materialized.  Activations are NHWC, as the reference's.

A deployed conv (``ServingWeight`` / ``BitplaneServingWeight``) takes the
im2col path: SAME patches in the (C_in, kh, kw) order of the 2-D weight go
through :func:`repro_torch.models.common.qmatmul`, so ``backend="kernel"``
runs ``packed_matmul`` (or ``bitplane_matmul`` for a bit-plane leaf) and
``backend="bitplane"`` runs ``bitplane_matmul``.  QAT and plain weights
run ``F.conv2d``.  SAME padding is JAX's: ``pad_total = max((out - 1) *
stride + k - in, 0)``, ``pad_total // 2`` before and the rest after, so a
stride-2 conv of an even input pads 0 before and 1 after (symmetric
``padding=1`` would shift every window by a pixel).  BatchNorm normalizes
with the batch's own statistics (population variance) in training and
inference alike, so a row's logits depend on the whole batch.

``*_init`` draw from a ``torch.Generator`` (seed ``seed``) on ``device``
(the CUDA card unless the caller names another); the reference draws from
``jax.random``, so parity runs on trees carried across by
``repro_torch.bridge``.  ``backend`` is passed explicitly, as everywhere
in the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import QuantConfig
from ..core.bitrep import from_float
from ..core.device import resolve_device
from ..core.fakequant import fq_from_float
from ..core.pact import pact_quant
from ..dist.parallel import batch_sum, split_mesh
from ..serve.deploy import BitplaneServingWeight, ServingWeight
from .common import qdense, qmatmul


@dataclasses.dataclass(frozen=True)
class ConvMeta:
    """Static conv geometry (a leaf every tree walk passes unchanged)."""
    c_in: int
    c_out: int
    k: int


def conv_init(c_in: int, c_out: int, k: int, qc: QuantConfig, *,
              generator: torch.Generator, device) -> Dict:
    fan_in = c_in * k * k
    w2d = torch.randn((fan_in, c_out), generator=generator, device=device,
                      dtype=torch.float32) * math.sqrt(2.0 / fan_in)
    meta = ConvMeta(c_in=c_in, c_out=c_out, k=k)
    if qc.mode == "bitplane":
        return {"qt": from_float(w2d, qc.n_bits, qc.spec,
                                 per_block_scale=qc.per_block_scale),
                "meta": meta}
    if qc.mode == "fake":
        return {"qt": fq_from_float(w2d, qc.n_bits, qc.spec), "meta": meta}
    return {"qt": w2d, "meta": meta}


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under JAX's ``"SAME"``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x_nchw: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    top, bottom = same_pads(x_nchw.shape[-2], k, stride)
    left, right = same_pads(x_nchw.shape[-1], k, stride)
    return F.pad(x_nchw, (left, right, top, bottom))


def im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """SAME patches of NHWC ``x``: (B, H_out, W_out, C*k*k), features in
    (C, kh, kw) order, channel slowest (the order of the reference's
    ``conv_general_dilated_patches`` and of ``F.unfold``).  The windows
    are a strided view of the padded input, gathered by one copy."""
    b, h, w, c = x.shape
    top, bottom = same_pads(h, k, stride)
    left, right = same_pads(w, k, stride)
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    win = xp.unfold(1, k, stride).unfold(2, k, stride)  # (B, Ho, Wo, C, k, k)
    return win.reshape(b, win.shape[1], win.shape[2], c * k * k)


def conv_apply(p: Dict, x: torch.Tensor, stride: int = 1, act_beta=None,
               qc: QuantConfig | None = None,
               backend: str = "dense") -> torch.Tensor:
    """x: (B, H, W, C_in) NHWC -> (B, H_out, W_out, C_out).

    PACT (the paper's unsigned post-ReLU quantizer) first when
    ``act_beta`` is given and ``qc`` quantizes activations; then im2col
    through ``qmatmul`` for a deployed weight, ``F.conv2d`` for the
    rest."""
    meta = p["meta"]
    wq = p["qt"]
    if act_beta is not None and qc is not None and qc.act_bits < 32:
        x = pact_quant(x, act_beta, qc.act_bits)
    if isinstance(wq, (ServingWeight, BitplaneServingWeight)):
        return qmatmul(im2col(x, meta.k, stride), wq, backend)
    w = qdense(wq).reshape(meta.c_in, meta.k, meta.k, meta.c_out)
    y = F.conv2d(_pad_same(x.permute(0, 3, 1, 2), meta.k, stride),
                 w.permute(3, 0, 1, 2), stride=stride)       # OIHW
    return y.permute(0, 2, 3, 1)


def _bn_init(c: int, device) -> Dict:
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _bn_apply(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch-norm over the batch's own statistics (population variance, as
    ``jnp.var``), folded to a per-channel affine.  With the batch split
    over the data axes (a training step's ``batch_split``) the moments
    are the whole batch's: each rank's channel sums of ``x`` and of
    ``x**2`` and its row count are summed over the data axes
    (:func:`~repro_torch.dist.parallel.batch_sum`, which carries their
    gradients back)."""
    if split_mesh() is not None:
        c = x.shape[-1]
        count = torch.full((1,), float(x.numel() // c), dtype=x.dtype,
                           device=x.device)
        sums = batch_sum(torch.cat([x.sum((0, 1, 2)),
                                    torch.square(x).sum((0, 1, 2)), count]))
        n = sums[2 * c]
        mu = sums[:c] / n
        var = sums[c:2 * c] / n - torch.square(mu)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    mu = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(0, 1, 2), keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * p["scale"] + p["bias"]


def _generator(seed: int, device) -> Tuple[torch.Generator, torch.device]:
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(seed), dev


def _beta(params: Dict, qc: QuantConfig, dev) -> None:
    if qc.enabled and qc.act_bits < 32:
        params["beta"] = torch.tensor(qc.pact_init, dtype=torch.float32,
                                      device=dev)


# ---------------------------------------------------------------------------
# ResNet (CIFAR): depth = 6n+2 (20, 32, ...)
# ---------------------------------------------------------------------------

def resnet_init(qc: QuantConfig, depth: int = 20, num_classes: int = 10, *,
                seed: int = 0, device=None) -> Dict:
    gen, dev = _generator(seed, device)

    def conv(c_in, c_out, k):
        return conv_init(c_in, c_out, k, qc, generator=gen, device=dev)

    n = (depth - 2) // 6
    params: Dict[str, Any] = {"stem": conv(3, 16, 3),
                              "stem_bn": _bn_init(16, dev),
                              "blocks": [], "betas": []}
    c_in = 16
    for stage, c in enumerate((16, 32, 64)):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            blk = {"conv1": conv(c_in, c, 3), "bn1": _bn_init(c, dev),
                   "conv2": conv(c, c, 3), "bn2": _bn_init(c, dev)}
            if stride != 1 or c_in != c:
                blk["proj"] = conv(c_in, c, 1)
            params["blocks"].append(blk)
            c_in = c
    params["head_w"] = torch.randn((64, num_classes), generator=gen,
                                   device=dev) * 0.01
    params["head_b"] = torch.zeros((num_classes,), device=dev)
    _beta(params, qc, dev)
    return params


def resnet_apply(params: Dict, x: torch.Tensor, qc: QuantConfig,
                 backend: str = "dense") -> torch.Tensor:
    beta = params.get("beta")
    h = conv_apply(params["stem"], x, backend=backend)
    h = F.relu(_bn_apply(params["stem_bn"], h))
    for blk in params["blocks"]:
        # stage-entry blocks (the ones with a projection) downsample 2x
        stride = 2 if "proj" in blk else 1
        y = conv_apply(blk["conv1"], h, stride, beta, qc, backend)
        y = F.relu(_bn_apply(blk["bn1"], y))
        y = conv_apply(blk["conv2"], y, 1, beta, qc, backend)
        y = _bn_apply(blk["bn2"], y)
        sc = conv_apply(blk["proj"], h, stride, backend=backend) \
            if "proj" in blk else h
        h = F.relu(y + sc)
    h = torch.mean(h, dim=(1, 2))
    return h @ params["head_w"] + params["head_b"]


# ---------------------------------------------------------------------------
# VGG-BN (CIFAR)
# ---------------------------------------------------------------------------

_VGG_PLANS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def vgg_init(qc: QuantConfig, depth: int = 16, num_classes: int = 10, *,
             seed: int = 0, device=None) -> Dict:
    gen, dev = _generator(seed, device)
    layers: List[Any] = []
    c_in = 3
    for item in _VGG_PLANS[depth]:
        if item == "M":
            layers.append("M")
        else:
            layers.append({"conv": conv_init(c_in, item, 3, qc, generator=gen,
                                             device=dev),
                           "bn": _bn_init(item, dev)})
            c_in = item
    params = {"layers": layers,
              "head_w": torch.randn((512, num_classes), generator=gen,
                                    device=dev) * 0.01,
              "head_b": torch.zeros((num_classes,), device=dev)}
    _beta(params, qc, dev)
    return params


def vgg_apply(params: Dict, x: torch.Tensor, qc: QuantConfig,
              backend: str = "dense") -> torch.Tensor:
    """Five 2x2 max pools: the input must be at least 32 pixels a side."""
    beta = params.get("beta")
    h = x
    first = True
    for layer in params["layers"]:
        if layer == "M":
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        else:
            h = conv_apply(layer["conv"], h, 1, None if first else beta, qc,
                           backend)
            h = F.relu(_bn_apply(layer["bn"], h))
            first = False
    h = torch.mean(h, dim=(1, 2))
    return h @ params["head_w"] + params["head_b"]


MODELS = {"resnet": (resnet_init, resnet_apply),
          "vgg": (vgg_init, vgg_apply)}


def conv_matmuls(params: Dict) -> int:
    """Convs (hence weight matmuls of a deployed tree) in one forward."""
    if "layers" in params:
        return sum(1 for layer in params["layers"] if layer != "M")
    return 1 + sum(2 + ("proj" in blk) for blk in params["blocks"])


def cnn_loss(apply_fn, params, batch, qc: QuantConfig,
             backend: str = "dense"):
    logits = apply_fn(params, batch["images"], qc, backend)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return torch.mean(lse - ll), dict(acc=acc)
