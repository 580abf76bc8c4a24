"""Weight carry-across: a param tree given as numpy arrays -> the port's
tree of tensors.

The input is nested dicts and lists whose leaves are numpy arrays; a
quantized weight arrives as a dict of its arrays plus its static fields:

* FakeQuantTensor: ``w``, ``scale``, ``bitwidth``, ``shape``, ``wb_rows``,
  ``wb_cols``, ``n_bits``;
* QuantizedTensor: ``planes``, ``sign``, ``scale``, ``mask``, ``shape``,
  ``wb_rows``, ``wb_cols`` (and no ``bits``);
* ServingWeight: ``w_int``, ``scale``, ``shape``, ``wb_rows``, ``wb_cols``,
  ``bits``;
* BitplaneServingWeight: ``planes``, ``sign``, ``mask``, ``scale``,
  ``shape``, ``wb_rows``, ``wb_cols``, ``bits`` (and its ``tag``, if
  given).

Any other leaf that is not a numpy array (a CNN conv's ``ConvMeta``, the
``"M"`` between VGG's conv layers) passes through unchanged.  Both a QAT
tree (to deploy or train in the port) and a deployed tree are accepted,
and so is any other tree of the same form, such as an optimizer state
(whose ``m`` and ``v`` mirror the params).  Dtypes are
kept (int8, uint8, int32, float32), so wire formats cross bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.bitrep import QuantizedTensor
from .core.blocking import BlockingSpec
from .core.device import resolve_device
from .core.fakequant import FakeQuantTensor
from .serve.deploy import BitplaneServingWeight, ServingWeight


def params_from_numpy(tree: Any, device=None) -> Any:
    """Convert a numpy param tree (see module doc) to tensors on
    ``device`` (the CUDA card unless the caller names another)."""
    dev = resolve_device(device)

    def t(a):
        # a writable C-contiguous copy; keeps 0-d arrays 0-d
        return torch.from_numpy(np.array(a, order="C", copy=True)).to(dev)

    def conv(node):
        if isinstance(node, dict):
            spec = BlockingSpec(int(node.get("wb_rows", 0)),
                                int(node.get("wb_cols", 0)))
            if "w_int" in node:
                return ServingWeight(w_int=t(node["w_int"]),
                                     scale=t(node["scale"]),
                                     shape=tuple(node["shape"]), spec=spec,
                                     bits=int(node["bits"]))
            if "planes" in node and "bits" not in node:
                return QuantizedTensor(
                    planes=t(node["planes"]), sign=t(node["sign"]),
                    scale=t(node["scale"]), mask=t(node["mask"]),
                    shape=tuple(node["shape"]), spec=spec)
            if "planes" in node:
                return BitplaneServingWeight(
                    planes=t(node["planes"]), sign=t(node["sign"]),
                    mask=t(node["mask"]), scale=t(node["scale"]),
                    shape=tuple(node["shape"]), spec=spec,
                    bits=int(node["bits"]), tag=node.get("tag", ""))
            if "bitwidth" in node:
                return FakeQuantTensor(w=t(node["w"]), scale=t(node["scale"]),
                                       bitwidth=t(node["bitwidth"]),
                                       shape=tuple(node["shape"]), spec=spec,
                                       n_bits=int(node["n_bits"]))
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if isinstance(node, (np.ndarray, np.generic)):
            return t(node)
        return node

    return conv(tree)
