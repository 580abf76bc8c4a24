"""BWQ-H hardware specification (paper Table I) and derived device models
(a copy of ``repro.hw.spec``, numpy only).

All constants are chip-level at 1.2 GHz; per-operation energies are derived
so that full-utilization power matches Table I.  The ADC model scales
energy exponentially and latency linearly with resolution (SAR ADC), which
is the scaling the paper's §VI-D OU sweep relies on.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    # memristor array
    xbar_rows: int = 128
    xbar_cols: int = 128
    bits_per_cell: int = 1
    ou_rows: int = 9           # concurrently-on wordlines
    ou_cols: int = 8           # concurrently-on bitlines (= ADCs per xbar)
    # peripherals
    dac_bits: int = 1
    adc_bits: int = 4          # ceil(log2(ou_rows + 1)) for 1-bit cells
    freq_hz: float = 1.2e9
    # chip-level composition
    n_tiles: int = 16
    banks_per_tile: int = 8
    # Table I power (W), chip total 25.25 W
    p_array: float = 0.89
    p_dac: float = 0.36
    p_adc: float = 23.22
    p_buffer: float = 0.59
    p_ctrl: float = 0.0928
    p_digital: float = 0.0926
    # buffer
    buffer_bits: int = 64      # bus width per bank

    # ---- derived -----------------------------------------------------
    @property
    def n_xbars(self) -> int:
        return self.n_tiles * self.banks_per_tile

    @property
    def cycle_s(self) -> float:
        return 1.0 / self.freq_hz

    def adc_bits_for(self, ou_rows: int) -> int:
        """ADC resolution needed to resolve an OU partial sum losslessly."""
        return max(1, math.ceil(math.log2(ou_rows * (2 ** self.bits_per_cell - 1) + 1)))

    # per-op energies (J), normalized so Table-I power holds at 100% duty
    # in the PAPER's reference geometry (9x8 OU, 4-bit ADC).  The reference
    # is fixed so OU-size sweeps (with_ou) scale per-op costs physically
    # instead of silently re-normalizing the calibration.
    _REF_OU_ROWS = 9
    _REF_OU_COLS = 8
    _REF_ADC_BITS = 4

    @property
    def e_adc_conv(self) -> float:
        convs_per_s = self.freq_hz * self.n_xbars * self._REF_OU_COLS
        return self.p_adc / convs_per_s

    def e_adc_conv_at(self, adc_bits: int) -> float:
        """ADC energy/conversion ~ 2^b * b: exponential comparator/cap-DAC
        energy times the b-cycle SAR conversion (paper: "ADC energy scales
        up significantly with its precision", Fig. 13)."""
        return self.e_adc_conv * (2.0 ** (adc_bits - self._REF_ADC_BITS)) \
            * (adc_bits / self._REF_ADC_BITS)

    def adc_cycles_at(self, adc_bits: int) -> float:
        """SAR conversion latency grows linearly with resolution."""
        return max(1.0, adc_bits / self._REF_ADC_BITS)

    @property
    def e_dac_bit(self) -> float:
        bits_per_s = self.freq_hz * self.n_xbars * self._REF_OU_ROWS
        return self.p_dac / bits_per_s

    @property
    def e_array_ou(self) -> float:
        ou_per_s = self.freq_hz * self.n_xbars
        return self.p_array / ou_per_s

    @property
    def e_buffer_bit(self) -> float:
        bits_per_s = self.freq_hz * self.n_xbars * self.buffer_bits
        return self.p_buffer / bits_per_s

    @property
    def e_ctrl_cycle(self) -> float:
        return self.p_ctrl / (self.freq_hz * self.n_xbars)

    @property
    def e_sna_op(self) -> float:
        return self.p_digital / (self.freq_hz * self.n_xbars)

    def with_ou(self, ou_rows: int, ou_cols: int) -> "HardwareSpec":
        """Clone with a different OU geometry (paper Fig. 13 sweep)."""
        return dataclasses.replace(
            self, ou_rows=ou_rows, ou_cols=ou_cols,
            adc_bits=self.adc_bits_for(ou_rows))


PAPER_SPEC = HardwareSpec()
