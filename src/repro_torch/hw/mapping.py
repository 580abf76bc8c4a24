"""Weight-mapping schemes for mixed-precision WBs onto OUs (paper Fig. 5;
a copy of ``repro.hw.mapping``, numpy only).

Three schemes for placing the bits of a WB's weight vectors on crossbar
columns:

* ``conventional``  — bits of one weight in consecutive columns; weights may
  straddle OU boundaries, requiring cross-OU shift-and-add indexing logic
  (extra S&A control ops) — Fig. 5(a).
* ``same_ou``       — a weight's bits never straddle an OU; spare columns are
  wasted when ``ou_cols % bits != 0`` — Fig. 5(b).
* ``precision_aware`` — bit-plane slicing: OU *k* of a WB holds bit *k* of
  all ``ou_cols`` weights; 100 % utilization, no cross-OU indexing —
  Fig. 5(c), the paper's contribution.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class MappingCost:
    ou_activations: float    # OU turn-ons to read the whole WB once
    utilization: float       # fraction of activated cells holding live bits
    extra_sna_ops: float     # cross-OU accumulation ops beyond the baseline


def wb_mapping_cost(bits: int, ou_cols: int, scheme: str) -> MappingCost:
    """Cost of reading one WB (``ou_cols`` weights wide) at ``bits`` precision."""
    if bits <= 0:
        return MappingCost(0.0, 1.0, 0.0)
    total_cols = ou_cols * bits                     # live cells per OU row
    if scheme == "precision_aware":
        ous = bits                                  # one OU per bit plane
        return MappingCost(ous, 1.0, 0.0)
    if scheme == "same_ou":
        wpo = max(1, ou_cols // bits)               # weights fitting in one OU
        ous = math.ceil(ou_cols / wpo)
        used = total_cols
        return MappingCost(ous, used / (ous * ou_cols), 0.0)
    if scheme == "conventional":
        ous = math.ceil(total_cols / ou_cols)
        # every weight vector that straddles an OU boundary needs an extra
        # cross-OU shift-add with indexing control
        straddles = sum(1 for w in range(ou_cols)
                        if (w * bits) // ou_cols != (w * bits + bits - 1) // ou_cols)
        return MappingCost(ous, total_cols / (ous * ou_cols), float(straddles))
    raise ValueError(f"unknown mapping scheme: {scheme}")


def layer_mapping_cost(bitwidths: np.ndarray, ou_cols: int,
                       scheme: str) -> MappingCost:
    """Aggregate mapping cost over a (GR, GC) bit-width table."""
    bw = np.asarray(bitwidths).reshape(-1)
    ous = util_num = util_den = sna = 0.0
    # bitwidth values are small integers; group to avoid per-block python loop
    vals, counts = np.unique(bw, return_counts=True)
    for v, c in zip(vals, counts):
        mc = wb_mapping_cost(int(v), ou_cols, scheme)
        ous += c * mc.ou_activations
        util_num += c * mc.ou_activations * mc.utilization
        util_den += c * mc.ou_activations
        sna += c * mc.extra_sna_ops
    util = util_num / util_den if util_den else 1.0
    return MappingCost(ous, util, sna)
