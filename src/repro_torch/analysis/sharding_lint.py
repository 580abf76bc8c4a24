"""Sharding lint: validate every param / batch / cache spec against a
mesh and report per leaf what the rule layer weakened (port of
``repro.analysis.sharding_lint``).

The rule layer (``dist/sharding.py``) is written for the production mesh
and degrades everywhere else: :func:`~repro_torch.dist.sharding.fit_spec`
drops axes that are absent or already used, and pads (or, with padding
off, drops) axes that do not divide their dim.  This pass replays the spec
derivation under :func:`~repro_torch.dist.sharding.collect_spec_events`
and turns every event into a path-qualified finding:

* ``axis-padded`` (info) — the mesh axis does not divide the dim but
  padded sharding keeps it: the placement boundary zero-pads and the
  consumer masks;
* ``axis-indivisible`` (warning) — the axis does not divide the dim and
  padding was off for that call (batch placement, the decode state): the
  dim serves replicated;
* ``axis-absent`` / ``axis-used`` (info) — expected degradation on a
  smaller mesh than the rules target;
* ``mesh-axis-unused`` (warning) — a >1-sized mesh axis no parameter leaf
  uses: its ranks hold fully replicated weights.

The rule layer consults only ``mesh.shape``, so :class:`ShapeOnlyMesh`
stands in for a process mesh of any size, and production meshes lint on
one host.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .report import Finding


class ShapeOnlyMesh:
    """Deviceless mesh stand-in: just the axis-name -> size mapping,
    enough for every rule-layer entry point (``fit_spec``,
    ``param_pspecs``, ``batch_pspecs``, ``cache_pspecs``); placing a tree
    needs a process mesh (``launch.mesh.make_mesh``)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)

    def __repr__(self):
        return f"ShapeOnlyMesh({self.shape})"


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """Axis sizes of ``launch.mesh.make_production_mesh`` without its 256
    / 512 ranks."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}


_DROP_RULES = {"indivisible": ("warning", "axis-indivisible"),
               "absent": ("info", "axis-absent"),
               "used": ("info", "axis-used")}


def _spec_axes(specs) -> set:
    """Every mesh axis name used anywhere in a tree of specs."""
    from ..dist.sharding import entry_axes, spec_leaves
    axes = set()
    for _, s in spec_leaves(specs):
        for entry in s:
            axes.update(entry_axes(entry))
    return axes


def lint_sharding(params: Any, mesh, batch: Any = None, state: Any = None,
                  n_slots: int = 8) -> List[Finding]:
    """Replay the spec derivation for ``params`` (and an optional
    ``batch`` / decode ``state``) under ``mesh`` and lint the events.
    ``mesh`` may be a process mesh or a :class:`ShapeOnlyMesh`; the
    trees' tensors may lie on any device (``meta`` included): only their
    shapes and dtypes are read."""
    from ..dist.sharding import (SpecPad, batch_pspecs, cache_pspecs,
                                 collect_spec_events, param_pspecs,
                                 use_mesh)
    findings: List[Finding] = []
    with use_mesh(mesh), collect_spec_events() as events:
        specs = param_pspecs(params)
        if batch is not None:
            batch_pspecs(batch)
        if state is not None:
            cache_pspecs(state, n_slots)
    for d in events:
        if isinstance(d, SpecPad):
            findings.append(Finding(severity="info", pass_name="sharding",
                                    rule="axis-padded", path=d.label,
                                    message=d.message()))
            continue
        severity, rule = _DROP_RULES.get(d.reason, ("warning", "axis-drop"))
        findings.append(Finding(severity=severity, pass_name="sharding",
                                rule=rule, path=d.label,
                                message=d.message()))
    used = _spec_axes(specs)
    for axis, size in mesh.shape.items():
        if size > 1 and axis not in used:
            findings.append(Finding(
                severity="warning", pass_name="sharding",
                rule="mesh-axis-unused", path=f"mesh.{axis}",
                message=f"mesh axis {axis!r} (size {size}) is used by no "
                        f"parameter spec: weights replicate {size}x along "
                        f"it"))
    if not findings:
        findings.append(Finding(
            severity="info", pass_name="sharding", rule="clean",
            path="<tree>",
            message=f"all requested specs fit mesh {dict(mesh.shape)} "
                    f"with no drops"))
    return findings
