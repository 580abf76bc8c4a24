"""Pad-and-trim tiling geometry shared by the kernel wrappers (port of the
framework-neutral part of ``repro.kernels.pallas_utils``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def fit_block(pref: int, total: int, multiple: int) -> int:
    """Largest block <= pref that divides total and is a multiple of
    ``multiple`` (``total`` must itself be a multiple of ``multiple``)."""
    best = multiple
    d = multiple
    while d <= min(pref, total):
        if total % d == 0:
            best = d
        d += multiple
    return best


def pad_dim(a: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad ``a`` along ``axis`` up to length ``target`` (no-op if
    already there)."""
    axis = axis % a.ndim
    cur = a.shape[axis]
    if cur == target:
        return a
    pad = [0, 0] * (a.ndim - axis)
    pad[-1] = target - cur
    return F.pad(a, pad)
