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
