"""The port's BWQ-H hardware model (``repro_torch.hw``), held against the
reference ``repro.hw``.

* The assertions of ``tests/test_hw_sim.py`` (controller, Alg. 2; mapping
  schemes, Fig. 5; scheme orderings, Fig. 9; OU scaling, Fig. 13), run
  against the port's modules.
* ``simulate`` and ``speedup_and_energy_saving`` equal the reference's
  from the same bit-width maps: every scheme over ``conv_workload`` /
  ``fc_workload`` shapes (ResNet-20's and VGG-16's convs at CIFAR size),
  and over the workloads read from a trained bit-plane tree, the
  reference's and its bridged copy.  The figures are outputs of an
  analytical ReRAM model, not device measurements.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import hw as jhw  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.common import QuantConfig as JQ  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.step import build_maintenance_step as j_maint  # noqa: E402
from repro_torch import hw as thw  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.hw import (PAPER_SPEC, bsq_scheme, bwq_scheme,  # noqa: E402
                            controller_cycles, conv_workload, fc_workload,
                            isaac_scheme, layer_mapping_cost, lut_bits,
                            run_controller, simulate, simulate_layer,
                            sme_scheme, speedup_and_energy_saving,
                            sre_scheme, wb_mapping_cost,
                            workloads_from_params)
from torch_port_helpers import tree_to_numpy  # noqa: E402

torch.set_num_threads(2)


class TestController:
    def test_trace_matches_fig6b_structure(self):
        # two WB rows; row0: WBs of precision 2 and 1; row1: spare + 3
        tr = run_controller(np.array([[2, 1], [0, 3]]))
        assert tr.cycles == 6                    # 2+1+3 OU activations
        assert tr.ir_fetches == 2                # one per WB row
        assert tr.sna_skips == 3                 # one per non-spare WB
        # spare OU (row1, col0) never appears in the trace
        assert all(not (i == 1 and j == 0) for _, i, j, _ in tr.events)

    def test_cycles_scale_with_act_bits(self):
        bw = np.array([[4, 4], [4, 4]])
        assert controller_cycles(bw, act_bits=3) == 3 * 16

    def test_lut_size(self):
        assert lut_bits(np.zeros((10, 10)), max_bits=8) == 100 * 4


class TestMapping:
    def test_precision_aware_full_utilization(self):
        for bits in range(1, 9):
            mc = wb_mapping_cost(bits, 8, "precision_aware")
            assert mc.utilization == 1.0
            assert mc.ou_activations == bits
            assert mc.extra_sna_ops == 0

    def test_same_ou_spare_columns(self):
        # paper Fig 5(b): 3-bit weights, 8 cols -> 2 weights/OU, 25% waste
        mc = wb_mapping_cost(3, 8, "same_ou")
        assert mc.utilization == pytest.approx(0.75)

    def test_conventional_straddles_cost_sna(self):
        mc = wb_mapping_cost(3, 8, "conventional")
        assert mc.extra_sna_ops > 0
        assert mc.ou_activations == 3            # ceil(24/8)

    def test_divisible_case_all_equal(self):
        a = wb_mapping_cost(4, 8, "precision_aware")
        b = wb_mapping_cost(4, 8, "same_ou")
        assert a.ou_activations == b.ou_activations == 4

    def test_layer_aggregate(self):
        bw = np.array([[0, 1], [2, 8]])
        mc = layer_mapping_cost(bw, 8, "precision_aware")
        assert mc.ou_activations == 11


class TestSchemes:
    def _workloads(self):
        rng = np.random.default_rng(0)
        wls = []
        for i, (k, n) in enumerate([(576, 64), (1152, 128), (2304, 256)]):
            wl = fc_workload(f"fc{i}", k, n, positions=64, act_bits=3)
            wl.bitwidths = rng.choice([0, 1, 2, 3, 4],
                                      size=wl.bitwidths.shape,
                                      p=[.1, .3, .3, .2, .1])
            wls.append(wl)
        return wls

    def test_paper_ordering_speedup_and_energy(self):
        wls = self._workloads()
        base = isaac_scheme()
        res = {s.name: speedup_and_energy_saving(wls, s, base)
               for s in [bwq_scheme(), bsq_scheme(4), sre_scheme(),
                         sme_scheme()]}
        # paper Fig. 9: BWQ-H > BSQ > SME/SRE > ISAAC(=1)
        assert res["BWQ-H"][0] > res["BSQ"][0] > 1.0
        assert res["BWQ-H"][0] > res["SRE"][0] > 1.0
        assert res["BWQ-H"][1] > res["BSQ"][1] > 1.0

    def test_adc_dominates_energy(self):
        rep = simulate(self._workloads(), bwq_scheme())
        br = rep.energy_breakdown()
        assert br["adc"] > 0.5 * sum(br.values())

    def test_indexing_overhead_ordering(self):
        wls = self._workloads()
        idx = {s.name: simulate(wls, s).index_bits
               for s in [bwq_scheme(), sre_scheme(), sme_scheme(),
                         bsq_scheme(4)]}
        # paper Fig. 11: SRE >> BWQ > SME > BSQ(~0)
        assert idx["SRE"] > idx["BWQ-H"] > idx["SME"]
        assert idx["BSQ"] == 0.0

    def test_ou_size_energy_grows(self):
        """Paper Fig. 13: ADC energy (and total) grows with OU size."""
        energies = []
        for rows, cols in [(9, 8), (32, 32), (128, 128)]:
            spec = PAPER_SPEC.with_ou(rows, cols)
            wl2 = fc_workload("fc", 1152, 128, positions=64, act_bits=3,
                              weight_bits=4, spec=spec)
            energies.append(simulate([wl2], bsq_scheme(4), spec).energy_j)
        assert energies[0] < energies[1] < energies[2]

    def test_adc_precision_follows_ou_rows(self):
        assert PAPER_SPEC.adc_bits_for(9) == 4      # paper: 4-bit ADC @ 9 WLs
        assert PAPER_SPEC.adc_bits_for(128) == 8

    def test_zero_precision_blocks_cost_nothing(self):
        wl = fc_workload("fc", 72, 8, positions=1, act_bits=1)
        wl.bitwidths = np.zeros_like(wl.bitwidths)
        rep = simulate_layer(wl, bwq_scheme())
        assert rep.cycles == 0


# ---------------------------------------------------------------------------
# the port against the reference, from the same bit-width maps
# ---------------------------------------------------------------------------

SCHEMES = ("bwq", "bsq", "isaac", "sre", "sme")


def _schemes(mod):
    return {"bwq": mod.bwq_scheme(), "bsq": mod.bsq_scheme(4),
            "isaac": mod.isaac_scheme(), "sre": mod.sre_scheme(),
            "sme": mod.sme_scheme()}


def _cnn_shapes():
    """(c_in, c_out, k, h_out) of ResNet-20's and VGG-16's convs on
    32x32 CIFAR images."""
    res = [(3, 16, 3, 32)]
    c_in = 16
    for stage, (c, h) in enumerate(((16, 32), (32, 16), (64, 8))):
        for b in range(3):
            res.append((c_in, c, 3, h))
            res.append((c, c, 3, h))
            if stage and not b:
                res.append((c_in, c, 1, h))
            c_in = c
    vgg, c_in, h = [], 3, 32
    for item in jcnn._VGG_PLANS[16]:
        if item == "M":
            h //= 2
        else:
            vgg.append((c_in, item, 3, h))
            c_in = item
    return res + vgg


def _report_fields(rep):
    return [(l.name, l.cycles, l.latency_s, l.energy_j, l.index_bits)
            for l in rep.layers]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_simulate_equals_reference_on_shape_workloads(scheme):
    rng = np.random.default_rng(0)
    pairs = []
    for i, (c_in, c_out, k, h) in enumerate(_cnn_shapes()):
        args = (f"conv{i}", c_in, c_out, k, h, h)
        jw, tw = jhw.conv_workload(*args, act_bits=3), \
            conv_workload(*args, act_bits=3)
        bw = rng.choice(9, size=jw.bitwidths.shape)
        jw.bitwidths, tw.bitwidths = bw, bw.copy()
        pairs.append((jw, tw))
    jf, tf = jhw.fc_workload("fc", 512, 10, positions=1), \
        fc_workload("fc", 512, 10, positions=1)
    pairs.append((jf, tf))
    for jw, tw in pairs:
        assert dataclasses.astuple(dataclasses.replace(jw, bitwidths=None)) \
            == dataclasses.astuple(dataclasses.replace(tw, bitwidths=None))
    jwls, twls = [p[0] for p in pairs], [p[1] for p in pairs]
    js, ts = _schemes(jhw)[scheme], _schemes(
        thw)[scheme]
    assert _report_fields(simulate(twls, ts)) == \
        _report_fields(jhw.simulate(jwls, js))
    assert speedup_and_energy_saving(twls, ts, isaac_scheme()) == \
        jhw.speedup_and_energy_saving(jwls, js, jhw.isaac_scheme())


def test_simulate_equals_reference_on_a_trained_tree():
    """Workloads read from a bit-plane ResNet-8 tree after a maintenance
    (mixed bit-width maps), the reference's and its bridged copy: the
    same layers, maps and zero fractions, and the same figures."""
    jp = jcnn.resnet_init(jax.random.PRNGKey(0),
                          JQ(mode="bitplane", n_bits=8, act_bits=8), depth=8)
    jp = j_maint()(JTrainState(step=0, params=jp, opt_state=None,
                               alpha=jax.numpy.float32(0))).params
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    jw = jhw.workloads_from_params(jp, positions=64, act_bits=3)
    tw = workloads_from_params(tp, positions=64, act_bits=3)
    assert [w.name for w in tw] == [w.name for w in jw]
    assert any((np.asarray(w.bitwidths) < 8).any() for w in tw)
    for a, b in zip(tw, jw):
        assert (a.k, a.n, a.positions, a.act_bits, a.weight_zero_frac) == \
            (b.k, b.n, b.positions, b.act_bits, b.weight_zero_frac)
        np.testing.assert_array_equal(a.bitwidths, b.bitwidths)
    for name in SCHEMES:
        assert _report_fields(simulate(tw, _schemes(
            thw)[name])) == \
            _report_fields(jhw.simulate(jw, _schemes(jhw)[name])), name
    sp, en = speedup_and_energy_saving(tw, bwq_scheme(), isaac_scheme())
    assert (sp, en) == jhw.speedup_and_energy_saving(
        jw, jhw.bwq_scheme(), jhw.isaac_scheme())
    assert sp > 1.0 and en > 1.0
