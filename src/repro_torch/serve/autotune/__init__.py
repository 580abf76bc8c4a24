"""Serve-time precision tooling over the bit-plane layout (port of
``repro.serve.autotune``):

* :mod:`sensitivity` — per-block plane sensitivity scores from
  calibration activations, computed on the deployed bit-plane tree;
* :mod:`allocate` — the greedy search for per-block occupancies under a
  ``weight_stream_bytes`` budget, emitting a re-packed tree that passes
  BP1-BP3 and AT1, gated by a prefill-logit check;
* :mod:`speculative` — the truncated-plane read of the same deployed
  leaves as a free draft model.
"""
from .allocate import (Allocation, autotune_params, greedy_allocate,
                       quality_gate)
from .sensitivity import (calibrate_activations, leaf_plane_sensitivity,
                          sensitivity_tree, tag_bitplane_leaves)
from .speculative import greedy_verify, make_draft_params

__all__ = [
    "Allocation", "autotune_params", "greedy_allocate", "quality_gate",
    "calibrate_activations", "leaf_plane_sensitivity", "sensitivity_tree",
    "tag_bitplane_leaves", "greedy_verify", "make_draft_params",
]
