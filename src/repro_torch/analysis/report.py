"""Shared result types for the static-analysis passes.

Every pass (:mod:`.lint`, :mod:`.tracecheck`, :mod:`.warm`,
:mod:`.budget`, :mod:`.deadcode`) returns one :class:`PassResult` holding a
list of :class:`Violation`; the CLI (:mod:`repro_torch.analysis.__main__`)
renders them uniformly and exits nonzero when any pass fails.  The types
are the reference's (``repro.analysis.report``), field for field, so the
two packages' results render and serialise alike; they import nothing, so
the AST passes run without torch.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract violation.

    Attributes:
      pass_name: which pass produced it (``lint``/``tracecheck``/...).
      code: stable machine-readable rule id (e.g. ``duplicate-compute-site``,
        ``bare-assert``, ``f64-narrowing``); tests key off these.
      path: file path or logical location (entry-point / kernel / module
        name for the non-AST passes).
      line: 1-based source line, or 0 when there is no meaningful line.
      message: human-readable explanation.
    """

    pass_name: str
    code: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.code}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PassResult:
    """Outcome of one analysis pass over the repo (or a fixture set)."""

    name: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    checked: int = 0            # how many units (files/entry points/...) ran
    skipped: List[str] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, code: str, path: str, line: int, message: str) -> None:
        self.violations.append(
            Violation(self.name, code, path, line, message))

    def merge(self, other: "PassResult") -> None:
        self.violations.extend(other.violations)
        self.checked += other.checked
        self.skipped.extend(other.skipped)
        self.notes.extend(other.notes)

    def render(self, verbose: bool = False) -> str:
        status = "PASS" if self.ok else "FAIL"
        lines = [f"{status} {self.name}: {len(self.violations)} violation(s)"
                 f" over {self.checked} checked unit(s)"]
        for v in self.violations:
            lines.append(f"  {v.render()}")
        if verbose or not self.ok:
            for s in self.skipped:
                lines.append(f"  skipped: {s}")
        if verbose:
            for n in self.notes:
                lines.append(f"  note: {n}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "checked": self.checked,
                "violations": [v.to_dict() for v in self.violations],
                "skipped": list(self.skipped), "notes": list(self.notes)}
