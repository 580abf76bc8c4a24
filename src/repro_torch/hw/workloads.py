"""Build hardware workloads from the port's quantized models and from
layer shapes (port of ``repro.hw.workloads``).  A trained
``QuantizedTensor``'s bit-width LUT and planes are read on the host, as
numpy."""
from __future__ import annotations

import math
from typing import Any, List

import numpy as np

from ..core.bitrep import QuantizedTensor, bitwidths
from ..core.state import quantized_leaves
from .simulator import LayerWorkload
from .spec import HardwareSpec, PAPER_SPEC


def workload_from_qt(name: str, qt: QuantizedTensor, positions: int,
                     act_bits: int) -> LayerWorkload:
    """LayerWorkload from a trained QuantizedTensor (uses its learned LUT)."""
    bw = bitwidths(qt).detach().cpu().numpy()
    if bw.ndim > 2:                       # stacked (L, GR, GC): treat layers
        bw = bw.reshape(-1, bw.shape[-1])
    k, n = qt.shape[-2], qt.shape[-1]
    lead = int(np.prod(qt.shape[:-2])) if qt.shape[:-2] else 1
    planes = qt.planes.detach().cpu().numpy()
    zero_frac = float(np.mean(np.all(planes == 0, axis=0)))
    return LayerWorkload(name=name, k=k * 1, n=n * lead,
                         positions=positions, bitwidths=bw,
                         act_bits=act_bits, weight_zero_frac=zero_frac)


def workloads_from_params(params: Any, positions: int = 1,
                          act_bits: int = 8) -> List[LayerWorkload]:
    return [workload_from_qt(name, qt, positions, act_bits)
            for name, qt in quantized_leaves(params).items()]


# -- shape-only workloads (no trained state): used for config-level studies --

def conv_workload(name: str, c_in: int, c_out: int, ksize: int,
                  h_out: int, w_out: int, act_bits: int = 8,
                  weight_bits: int = 8,
                  spec: HardwareSpec = PAPER_SPEC) -> LayerWorkload:
    k = c_in * ksize * ksize
    gr, gc = math.ceil(k / spec.ou_rows), math.ceil(c_out / spec.ou_cols)
    bw = np.full((gr, gc), weight_bits, dtype=np.int64)
    return LayerWorkload(name, k, c_out, h_out * w_out, bw, act_bits)


def fc_workload(name: str, d_in: int, d_out: int, positions: int = 1,
                act_bits: int = 8, weight_bits: int = 8,
                spec: HardwareSpec = PAPER_SPEC) -> LayerWorkload:
    gr = math.ceil(d_in / spec.ou_rows)
    gc = math.ceil(d_out / spec.ou_cols)
    bw = np.full((gr, gc), weight_bits, dtype=np.int64)
    return LayerWorkload(name, d_in, d_out, positions, bw, act_bits)
