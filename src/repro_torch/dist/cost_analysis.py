"""Collective statistics, a result census and roofline terms for the dry
run (the port's counterpart of ``repro.dist.hlo_analysis``).

Torch has no HLO text and no compiler's cost analysis.  The dry run
(``launch.dryrun``) runs a cell's step on ``meta`` tensors for one rank
of a :class:`~repro_torch.dist.parallel.RecordingMesh`, whose collective
helpers record each collective (:class:`~repro_torch.dist.parallel.
Collective`) instead of issuing it; its dispatch modes count FLOPs,
bytes and live storage.  Here those records become what the reference
reads from HLO:

* :func:`collective_stats` — counts and result bytes per op, in the
  reference's vocabulary (``all-reduce``, ``all-gather``, ``all-to-all``,
  ``collective-broadcast``) and by its byte rule (a collective's result
  shape, a device);
* :func:`shape_census` — result bytes by dtype, over a collective log or
  a traced op list (``(dtype, bytes)`` records);
* :func:`roofline_terms` / :func:`dominant_term` — the reference's
  formulas, against the H100's constants below by default (pass the
  reference's to get its figures).

``input_output_aliases`` has no counterpart: there is no compiled module
whose donation map it could read.  The donation check it fed is the
serving-graph lint's ``missing-donation`` rule
(``analysis.graph_lint``), which runs the decode step and checks that the
state's leaves come back in their own storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

# Per-card constants: NVIDIA H100 80GB HBM3 (SXM), power limit 700.00 W,
# datasheet figures.
PEAK_FLOPS = 989.4e12    # FLOP/s, bf16 dense tensor cores
HBM_BW = 3.35e12         # bytes/s, HBM3
LINK_BW = 450e9          # bytes/s, NVLink 4, one direction


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def collective_stats(log: Iterable) -> CollectiveStats:
    """Count collectives and total their result bytes per op, from a
    recording mesh's log (or a live rank's ``parallel.collective_log``)."""
    counts: Dict[str, int] = {}
    bytes_by_op: Dict[str, int] = {}
    for c in log:
        counts[c.op] = counts.get(c.op, 0) + 1
        bytes_by_op[c.op] = bytes_by_op.get(c.op, 0) + int(c.bytes)
    return CollectiveStats(counts=counts, bytes_by_op=bytes_by_op)


def shape_census(log_or_trace: Iterable, min_bytes: int = 0
                 ) -> Dict[str, int]:
    """Result bytes by dtype, ``{dtype: total_bytes}``, of every record
    of at least ``min_bytes``: collectives (``.dtype``, ``.bytes``) or a
    traced op list's ``(dtype, bytes)`` pairs.  A packed serving step
    should be int8/uint8-dominated; an f32 total on the order of the
    weight bytes is a dequant leak."""
    census: Dict[str, int] = {}
    for rec in log_or_trace:
        dtype, n = (rec.dtype, rec.bytes) if hasattr(rec, "bytes") else rec
        if n >= min_bytes:
            census[dtype] = census.get(dtype, 0) + int(n)
    return census


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW, link_bw: float = LINK_BW
                   ) -> Dict[str, float]:
    """Per-device totals -> time lower bounds per roofline resource."""
    return {
        "compute_s": flops / peak_flops,
        "memory_s": bytes_accessed / hbm_bw,
        "collective_s": collective_bytes / link_bw,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(terms, key=lambda k: terms[k])
