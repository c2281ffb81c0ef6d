"""The finding type and its rendering for the analysis tools — the
counterpart of ``repro.analysis.report`` (a copy: the port imports
nothing of ``repro``).

Every analyzer (``contracts``, ``audit``, ``lint``) returns a flat list
of ``Finding``s; an empty list is a clean pass. The CLI (``python -m
repro_torch.analysis``) renders them one per line and exits non-zero
when any survive.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence


class Finding(NamedTuple):
    """One verified violation: which tool, which rule, where, and what."""
    tool: str       # "contracts" | "audit" | "lint"
    rule: str       # short rule slug, e.g. "int32-accumulator"
    where: str      # spec/stage/file:line the finding anchors to
    message: str    # one-sentence statement of the violation

    def render(self) -> str:
        return f"{self.tool}:{self.rule} {self.where}: {self.message}"


def render_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(f.render() for f in findings)
