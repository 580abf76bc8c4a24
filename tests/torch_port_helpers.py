"""Shared helpers for the tests that hold the PyTorch port against the JAX
reference: flatten a JAX param tree into the numpy form that
``repro_torch.bridge.params_from_numpy`` takes, and convert results back."""
import numpy as np
import torch

from repro.core.fakequant import FakeQuantTensor
from repro.serve.deploy import BitplaneServingWeight, ServingWeight


def tree_to_numpy(tree):
    """JAX param tree -> nested dict of numpy arrays; quantized leaves
    become dicts of their arrays plus their static fields."""
    if isinstance(tree, FakeQuantTensor):
        return {"w": np.asarray(tree.w), "scale": np.asarray(tree.scale),
                "bitwidth": np.asarray(tree.bitwidth),
                "shape": tuple(tree.shape), "wb_rows": tree.spec.wb_rows,
                "wb_cols": tree.spec.wb_cols, "n_bits": tree.n_bits}
    if isinstance(tree, ServingWeight):
        return {"w_int": np.asarray(tree.w_int),
                "scale": np.asarray(tree.scale), "shape": tuple(tree.shape),
                "wb_rows": tree.spec.wb_rows, "wb_cols": tree.spec.wb_cols,
                "bits": tree.bits}
    if isinstance(tree, BitplaneServingWeight):
        return {"planes": np.asarray(tree.planes),
                "sign": np.asarray(tree.sign), "mask": np.asarray(tree.mask),
                "scale": np.asarray(tree.scale), "shape": tuple(tree.shape),
                "wb_rows": tree.spec.wb_rows, "wb_cols": tree.spec.wb_cols,
                "bits": tree.bits}
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def np_of(x):
    """A torch tensor or JAX array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor_regime_emulation(x, w, *, split_weight=True):
    """The arithmetic of the weight-matmul kernels' tensor-core regime, in
    plain torch on the CPU: the dequantized f32 weight ``w`` (K, N) as a
    pair of bf16 tiles, hi = bf16(w) and lo = bf16(w - hi); bf16 ``x`` times
    both, or f32 ``x`` split the same way and x_hi*hi + x_hi*lo + x_lo*hi;
    every product exact in f32 and summed in f32.  ``split_weight=False``
    keeps only hi (one bf16 weight), the design the tolerance rules out."""
    bf16, f32 = torch.bfloat16, torch.float32
    w = w.to(f32)
    hi = w.to(bf16)
    lo = (w - hi.to(f32)).to(bf16) if split_weight else torch.zeros_like(hi)
    if x.dtype == bf16:
        xs = [(x, (hi, lo))]
    else:
        x = x.to(f32)
        xh = x.to(bf16)
        xl = (x - xh.to(f32)).to(bf16)
        xs = [(xh, (hi, lo)), (xl, (hi,))]
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=f32)
    for xa, ws in xs:
        for wb in ws:
            y = y + xa.to(f32) @ wb.to(f32)
    return y
