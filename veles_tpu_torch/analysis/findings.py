"""Finding: the shared record the port's analysis emits (its own copy of
`veles_tpu/analysis/findings.py`): today the kernel ledger's findings
(analysis/resources.py `kernel_findings`). Import-light: nothing but the
standard library.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List

SEV_ERROR = "error"
SEV_WARN = "warn"


@dataclass
class Finding:
    """One analyzer finding.

    - `rule`: stable kebab-case rule id (docs/ANALYSIS.md catalogue);
    - `severity`: "error" (broken build / wrong numerics) or "warn"
      (suspicious but possibly intentional);
    - `unit`: what the finding is about — a unit repr for graph findings,
      an op/primitive for jaxpr findings, `path:line` for lint;
    - `site`: the precise link/trace site, when one exists.
    """

    rule: str
    severity: str
    unit: str
    message: str
    site: str = ""

    def as_dict(self) -> Dict[str, str]:
        return asdict(self)

    def format(self) -> str:
        tag = "E" if self.severity == SEV_ERROR else "W"
        loc = f" [{self.site}]" if self.site else ""
        return f"{tag} {self.rule}: {self.unit}: {self.message}{loc}"


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == SEV_ERROR]


def summarize(findings: Iterable[Finding]) -> Dict[str, object]:
    """Compact embeddable summary (bench records, supervisor reports)."""
    findings = list(findings)
    n_err = len(errors(findings))
    return {"errors": n_err,
            "warnings": len(findings) - n_err,
            "findings": [f.as_dict() for f in findings]}
