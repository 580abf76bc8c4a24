"""Memory-controller cycle model (paper Algorithm 2 + Fig. 6b; a copy of
``repro.hw.controller``, numpy only).

The controller walks the WB grid of one crossbar: for every WB with
non-zero precision it activates one OU per live bit plane (one cycle each,
accumulating ADC outputs into the psum with a shift-left), emits an S&A
*skip* signal between WBs so psums of different WBs never mix, and raises
the IR *fetch* signal when a row of WBs completes so the next activation
slice is loaded.

``trace`` reproduces the event sequence of Fig. 6(b) and is what the unit
tests check; ``cycles`` is the count the simulator consumes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class ControllerTrace:
    events: List[Tuple[int, int, int, int]]  # (cycle, vblock, hblock, bit)
    sna_skips: int
    ir_fetches: int

    @property
    def cycles(self) -> int:
        return len(self.events)


def run_controller(bitwidths: np.ndarray) -> ControllerTrace:
    """Execute Algorithm 2 over a (Vblocks, Hblocks) bit-width table.

    Rows of the table are input (wordline) blocks, columns are output
    (bitline) blocks; one event per OU activation.
    """
    bw = np.asarray(bitwidths, dtype=np.int64)
    vblocks, hblocks = bw.shape
    events, skips, fetches = [], 0, 0
    cycle = 0
    for i in range(vblocks):                 # activation slice (IR section)
        for j in range(hblocks):
            p = int(bw[i, j])
            if p == 0:
                continue                     # spare OU group: skipped entirely
            for b in range(p):
                events.append((cycle, i, j, b))
                cycle += 1
            skips += 1                       # psum boundary after each WB
        fetches += 1                         # next IR slice after the WB row
    return ControllerTrace(events=events, sna_skips=skips, ir_fetches=fetches)


def controller_cycles(bitwidths: np.ndarray, act_bits: int = 1) -> int:
    """OU-activation cycles for one full pass, with bit-serial inputs.

    With 1-bit DACs each OU activation is repeated ``act_bits`` times
    (one input bit per pass), so total cycles = act_bits * sum(bitwidths).
    """
    return int(act_bits) * int(np.sum(np.asarray(bitwidths, dtype=np.int64)))


def lut_bits(bitwidths: np.ndarray, max_bits: int = 8) -> int:
    """Size of the controller's per-WB bit-width LUT in bits."""
    entry = int(np.ceil(np.log2(max_bits + 1)))
    return int(np.prod(np.asarray(bitwidths).shape)) * entry
