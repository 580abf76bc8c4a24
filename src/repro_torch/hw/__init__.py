"""BWQ-H: OU-based ReRAM accelerator model + baselines (paper §IV-§VI; port
of ``repro.hw``).  Its figures are outputs of an analytical ReRAM model,
not measurements of any device."""
from .spec import HardwareSpec, PAPER_SPEC
from .mapping import MappingCost, layer_mapping_cost, wb_mapping_cost
from .controller import ControllerTrace, controller_cycles, lut_bits, run_controller
from .simulator import (LayerReport, LayerWorkload, Scheme, SimReport,
                        bsq_scheme, bwq_scheme, isaac_scheme,
                        simulate, simulate_layer, sme_scheme,
                        speedup_and_energy_saving, sre_scheme)
from .workloads import (conv_workload, fc_workload, workload_from_qt,
                        workloads_from_params)
