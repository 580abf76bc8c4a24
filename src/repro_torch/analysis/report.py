"""Lint findings (port of :class:`repro.analysis.report.Finding` and its
severities).

A finding is *path-qualified*: ``path`` names the exact tree leaf or
scheduler record it refers to.  Severities:

* ``error``   — a contract violation;
* ``warning`` — a documented degradation the check tolerates;
* ``info``    — context a pass recorded.
"""
from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str          # 'error' | 'warning' | 'info'
    pass_name: str         # 'contracts'
    rule: str              # stable rule id, e.g. 'PX1'
    path: str              # tree path / scheduler record
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def format(self) -> str:
        return (f"[{self.severity.upper():7s}] {self.pass_name}/{self.rule} "
                f"{self.path}: {self.message}")
