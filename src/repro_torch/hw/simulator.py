"""End-to-end BWQ-H performance/energy simulator (MNSIM-style analytical;
a copy of ``repro.hw.simulator``, numpy only).

Workloads are per-layer VMM descriptions; schemes (BWQ-H and the paper's
baselines ISAAC / SRE / SME / BSQ) decide how many OU activations a layer
needs and what peripheral overheads apply.  Reported quantities:

* latency  — OU/ADC-limited compute time plus the buffer/accumulation time
  of the "unoptimized components" (this term produces the paper's VGG19
  speedup-saturation effect, §VI-B);
* energy   — per-component breakdown (array, DAC, ADC, buffer, S&A, ctrl);
* index    — scheme-specific indexing/metadata storage (paper Fig. 11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from .mapping import layer_mapping_cost
from .spec import HardwareSpec, PAPER_SPEC


@dataclasses.dataclass
class LayerWorkload:
    """One VMM layer: y[positions, n] = x[positions, k] @ W[k, n]."""
    name: str
    k: int                       # fan-in (C_in*kh*kw  or  d_in)
    n: int                       # fan-out
    positions: int               # VMM invocations (H_out*W_out, tokens, ...)
    bitwidths: Optional[np.ndarray] = None   # (GR, GC) per-WB bits (BWQ)
    act_bits: int = 8
    weight_zero_frac: float = 0.0  # fraction of zero weight values (for SRE/SME)

    def grid(self, ou_rows: int, ou_cols: int):
        return (math.ceil(self.k / ou_rows), math.ceil(self.n / ou_cols))


@dataclasses.dataclass
class LayerReport:
    name: str
    cycles: float
    latency_s: float
    energy_j: Dict[str, float]
    index_bits: float

    @property
    def total_energy(self) -> float:
        return sum(self.energy_j.values())


@dataclasses.dataclass
class SimReport:
    layers: List[LayerReport]

    @property
    def latency_s(self) -> float:
        return sum(l.latency_s for l in self.layers)

    @property
    def energy_j(self) -> float:
        return sum(l.total_energy for l in self.layers)

    def energy_breakdown(self) -> Dict[str, float]:
        keys = self.layers[0].energy_j.keys() if self.layers else []
        return {k: sum(l.energy_j[k] for l in self.layers) for k in keys}

    @property
    def index_bits(self) -> float:
        return sum(l.index_bits for l in self.layers)


# ---------------------------------------------------------------------------
# scheme definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scheme:
    """How a given accelerator executes a layer under the OU regime."""
    name: str
    weight_bits: Optional[int] = None   # None => use the learned per-WB table
    act_bits: Optional[int] = None      # None => use the workload's act bits
    mapping: str = "precision_aware"
    # fraction of OU activations skipped via sparsity indexing (SRE/SME)
    ou_skip_frac: float = 0.0
    # indexing metadata bits per *kept* OU row / per WB / per layer
    index_bits_per_ou_row: float = 0.0
    index_bits_per_wb: float = 0.0
    index_bits_per_xbar_row: float = 0.0
    uses_controller: bool = False


def bwq_scheme() -> Scheme:
    # 4-bit LUT entry per WB (bit-widths 0..8)
    return Scheme("BWQ-H", mapping="precision_aware",
                  index_bits_per_wb=4, uses_controller=True)


def bsq_scheme(layer_bits: int = 4) -> Scheme:
    # layer-uniform precision; negligible indexing (one entry per layer)
    return Scheme("BSQ", weight_bits=layer_bits, mapping="same_ou")


def isaac_scheme() -> Scheme:
    # 16-bit weights/acts, 1-bit cells (paper's modification), no compression
    return Scheme("ISAAC", weight_bits=16, act_bits=16, mapping="same_ou")


def sre_scheme(effective_compression: float = 3.3) -> Scheme:
    """SRE @ 9x8 OUs: ~3.3x compression from OU-row sparsity (paper §VI-B),
    paid for with per-OU-row indexing (7-bit row index + presence bit)."""
    return Scheme("SRE", weight_bits=16, act_bits=16, mapping="same_ou",
                  ou_skip_frac=1.0 - 1.0 / effective_compression,
                  index_bits_per_ou_row=16)   # 9b row idx + 7b offset ptr


def sme_scheme(effective_compression: float = 16.0 / 4.0) -> Scheme:
    """SME: <=3 consecutive non-zero bits after PTQ (~4 effective bits incl.
    offset metadata); crossbar-row squeeze-out; tiny per-row indexing."""
    return Scheme("SME", weight_bits=4, act_bits=16, mapping="conventional",
                  index_bits_per_xbar_row=1)   # squeeze-out flag per row


# ---------------------------------------------------------------------------
# simulation
# ---------------------------------------------------------------------------

def simulate_layer(wl: LayerWorkload, scheme: Scheme,
                   spec: HardwareSpec = PAPER_SPEC) -> LayerReport:
    gr, gc = wl.grid(spec.ou_rows, spec.ou_cols)
    act_bits = scheme.act_bits if scheme.act_bits is not None else wl.act_bits

    if scheme.weight_bits is None:
        if wl.bitwidths is None:
            raise ValueError(f"{scheme.name} needs a per-WB bit-width table")
        bw_table = np.asarray(wl.bitwidths, dtype=np.int64)
    else:
        bw_table = np.full((gr, gc), scheme.weight_bits, dtype=np.int64)

    mc = layer_mapping_cost(bw_table, spec.ou_cols, scheme.mapping)
    ou_acts = mc.ou_activations * (1.0 - scheme.ou_skip_frac)

    # ---- compute / ADC path ------------------------------------------
    adc_cycles = spec.adc_cycles_at(spec.adc_bits)
    ou_total = wl.positions * act_bits * ou_acts
    cycles = ou_total * adc_cycles
    t_compute = cycles / (spec.n_xbars * spec.freq_hz)

    # ---- unoptimized components (buffer + accumulation) ---------------
    in_bits = wl.positions * wl.k * act_bits
    out_bits = wl.positions * wl.n * 24            # psum accumulator width
    t_buffer = (in_bits + out_bits) / (
        spec.buffer_bits * spec.n_xbars * spec.freq_hz)
    latency = t_compute + t_buffer

    # ---- energy --------------------------------------------------------
    convs = ou_total * spec.ou_cols
    e = dict(
        adc=convs * spec.e_adc_conv_at(spec.adc_bits),
        dac=ou_total * spec.ou_rows * spec.e_dac_bit,
        array=ou_total * spec.e_array_ou,
        sna=(convs + wl.positions * act_bits * mc.extra_sna_ops)
            * spec.e_sna_op,
        buffer=(in_bits + out_bits) * spec.e_buffer_bit,
        ctrl=(cycles * spec.e_ctrl_cycle) if scheme.uses_controller else 0.0,
    )

    # ---- indexing metadata ----------------------------------------------
    kept_ou_rows = gr * spec.ou_rows * (1.0 - scheme.ou_skip_frac) \
        * math.ceil(wl.n * (scheme.weight_bits or 8) / spec.ou_cols)
    index_bits = (
        scheme.index_bits_per_wb * gr * gc
        + scheme.index_bits_per_ou_row * kept_ou_rows
        + scheme.index_bits_per_xbar_row
        * (wl.k * math.ceil(wl.n * (scheme.weight_bits or 8)
                            / spec.xbar_cols)))
    return LayerReport(wl.name, cycles, latency, e, index_bits)


def simulate(workloads: List[LayerWorkload], scheme: Scheme,
             spec: HardwareSpec = PAPER_SPEC) -> SimReport:
    return SimReport([simulate_layer(w, scheme, spec) for w in workloads])


def speedup_and_energy_saving(workloads: List[LayerWorkload],
                              scheme: Scheme, baseline: Scheme,
                              spec: HardwareSpec = PAPER_SPEC):
    a = simulate(workloads, scheme, spec)
    b = simulate(workloads, baseline, spec)
    return b.latency_s / a.latency_s, b.energy_j / a.energy_j
