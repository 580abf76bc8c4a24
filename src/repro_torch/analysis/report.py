"""Lint findings and the report they roll up into (port of
``repro.analysis.report``).

Every analysis pass (contract validator, graph lint, compile-footprint
census) emits :class:`Finding` records into one :class:`LintReport`.  A
finding is *path-qualified*: ``path`` names the exact tree leaf (keystr),
recorded entry point, or scheduler record it refers to.  Severities:

* ``error``   — a contract violation; the lint fails;
* ``warning`` — a documented degradation on the hot path (the ragged MoE
  product's dequantized expert stack); the lint passes but the item stays
  on the worklist;
* ``info``    — context a pass recorded (sanctioned materialization under
  ``dense`` / ``ref``, the census).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str          # 'error' | 'warning' | 'info'
    pass_name: str         # 'contracts' | 'graph' | 'footprint'
    rule: str              # stable rule id, e.g. 'dequant-materialization'
    path: str              # tree keystr / entry point / scheduler record
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def format(self) -> str:
        return (f"[{self.severity.upper():7s}] {self.pass_name}/{self.rule} "
                f"{self.path}: {self.message}")


@dataclasses.dataclass
class LintReport:
    """Accumulated findings across passes, plus run context.

    ``calls`` is the port's record of each entry point the graph lint
    executed: its name, the kernel-boundary ops the recorder saw and the
    kernel wrappers' launch counters over the call (not part of the JSON
    text, which is the reference's)."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    context: Dict[str, Any] = dataclasses.field(default_factory=dict)
    calls: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def add(self, severity: str, pass_name: str, rule: str, path: str,
            message: str) -> Finding:
        f = Finding(severity=severity, pass_name=pass_name, rule=rule,
                    path=path, message=message)
        self.findings.append(f)
        return f

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Finding]:
        return self.by_severity("warning")

    @property
    def ok(self) -> bool:
        return not self.errors

    def merge(self, other: "LintReport") -> "LintReport":
        self.findings.extend(other.findings)
        self.context.update(other.context)
        self.calls.extend(other.calls)
        return self

    def format(self, max_info: Optional[int] = None) -> str:
        lines = []
        shown_info = 0
        for f in sorted(self.findings,
                        key=lambda f: SEVERITIES.index(f.severity)):
            if f.severity == "info" and max_info is not None:
                shown_info += 1
                if shown_info > max_info:
                    continue
            lines.append(f.format())
        n_info = len(self.by_severity("info"))
        if max_info is not None and n_info > max_info:
            lines.append(f"[... {n_info - max_info} more info findings]")
        lines.append(self.summary())
        return "\n".join(lines)

    def summary(self) -> str:
        return (f"lint: {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s), "
                f"{len(self.by_severity('info'))} info "
                f"-> {'FAIL' if self.errors else 'PASS'}")

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "context": self.context,
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }, indent=1, default=str)
