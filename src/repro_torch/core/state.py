"""Tree utilities for param trees whose leaves include quantized weights
(port of ``repro.core.state``, plus the tree walks that the reference
gets from ``jax.tree_util``).

A param tree is nested dicts and lists; a quantized weight
(``QuantizedTensor``, ``FakeQuantTensor``) is a dataclass node whose
tensor fields are the tree's leaves and whose other fields are static.
Any other leaf that is not a tensor (a CNN conv's static ``ConvMeta``, the
``"M"`` between VGG's conv layers) passes through every walk unchanged.
Paths are spelt as the reference's ``jax.tree_util.keystr`` spells them
(``['layers']['attn']['wq'].w``, ``['blocks'][0]['conv1']['qt']``) and
dict keys are walked in sorted order, as the reference flattens them, so
a path names the same leaf in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from .bitrep import QuantizedTensor, bitwidths, param_count
from .fakequant import FakeQuantTensor
from .group_lasso import layer_bit_count

QUANT_TYPES = (QuantizedTensor, FakeQuantTensor)


def _is_node(x) -> bool:
    """A dataclass instance holding tensors (a quantized weight); one
    without tensor fields (``ConvMeta``) is a static leaf."""
    return dataclasses.is_dataclass(x) and not isinstance(x, type) and any(
        isinstance(getattr(x, f.name), torch.Tensor)
        for f in dataclasses.fields(x))


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a param tree, quantized and serving
    weights and static leaves (``ConvMeta``, ``"M"``) included: ``fn``
    passes what it does not convert."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves :func:`tree_map` visits, in its order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tensor_leaves(tree: Any, path: str = ""
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf, dataclass fields included."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensor_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tensor_leaves(v, f"{path}[{i}]")
    elif _is_node(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor):
                yield f"{path}.{f.name}", v
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def map_tensors(fn: Callable, tree: Any, *rest: Any) -> Any:
    """A tree of the same structure with ``fn(leaf, *matching leaves of
    rest)`` at every tensor leaf (static fields are kept)."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: fn(getattr(tree, f.name),
                       *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def quant_nodes(params: Any, types=QUANT_TYPES,
                path: str = "") -> Dict[str, Any]:
    """Every quantized weight node of ``types`` keyed by its path
    string."""
    if isinstance(params, types):
        return {path: params}
    out: Dict[str, Any] = {}
    if isinstance(params, dict):
        for k in sorted(params):
            out.update(quant_nodes(params[k], types, f"{path}[{k!r}]"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(quant_nodes(v, types, f"{path}[{i}]"))
    return out


def replace_nodes(tree: Any, new: Dict[str, Any], path: str = "") -> Any:
    """``tree`` with the node at each path of ``new`` (paths as
    :func:`quant_nodes` spells them) replaced; the rest is shared."""
    if path in new:
        return new[path]
    if isinstance(tree, dict):
        return {k: replace_nodes(v, new, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replace_nodes(v, new, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return tree


def quantized_leaves(params: Any) -> Dict[str, QuantizedTensor]:
    """All QuantizedTensor leaves keyed by their path string."""
    return quant_nodes(params, QuantizedTensor)


def map_quantized(fn: Callable[[QuantizedTensor], Any], params: Any) -> Any:
    """Apply ``fn`` to every QuantizedTensor leaf, pass the rest
    through."""
    return tree_map(lambda x: fn(x) if isinstance(x, QuantizedTensor)
                    else x, params)


def quant_summary(params: Any) -> Dict[str, float]:
    """Aggregate compression statistics across all QuantizedTensor
    layers."""
    qts = quantized_leaves(params)
    if not qts:
        return dict(layers=0, avg_bitwidth=0.0, compression_x=1.0,
                    total_params=0)
    total_params = sum(param_count(q) for q in qts.values())
    total_bits = sum(float(layer_bit_count(q)) for q in qts.values())
    return dict(layers=len(qts),
                avg_bitwidth=total_bits / max(total_params, 1),
                compression_x=32.0 * total_params / max(total_bits, 1.0),
                total_params=total_params)


def per_layer_bitwidth_maps(params: Any) -> Dict[str, torch.Tensor]:
    """Per-layer (GR, GC) bit-width heatmaps (paper Fig. 7)."""
    return {k: bitwidths(q) for k, q in quantized_leaves(params).items()}
