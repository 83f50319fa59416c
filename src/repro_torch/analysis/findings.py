"""Findings model + versioned report + baseline diffing of the port's
auditor (counterpart of ``repro.analysis.findings``, with its schema:
a report written by either package loads in the other).

A pass emits :class:`Finding`s; the audit CLI folds every pass's
findings into one :class:`Report`, serialized as deterministic JSON
(sorted, versioned) and diffed in CI against the tracked baseline at
``results/AUDIT_torch_baseline.json``:

  * a finding present in the fresh report but not the baseline is NEW —
    the build fails (a regression slipped in);
  * a finding present in the baseline but not the fresh report is FIXED
    — the build also fails, with instructions to regenerate the
    baseline (so the pinned worklist never silently rots into claiming
    problems that no longer exist).

Finding identity is ``(pass_name, site)``.  Sites are structural keys
(function-qualified names, route labels, census hashes) rather than
line numbers, so unrelated code motion does not churn the baseline.

This module imports nothing from the rest of ``repro_torch`` (and no
torch): the CLI must be able to parse reports and print diffs even when
the heavyweight pass modules cannot load.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterable, Optional

#: Bumped whenever the report schema changes shape. A baseline written
#: by a newer schema fails ``--check`` loudly instead of mis-diffing.
REPORT_VERSION = 1

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One fact a pass established about the audited programs.

    ``severity`` is descriptive, not a gate: CI gates on the baseline
    *diff*, so an ``info`` census finding changing is exactly as fatal
    as a new ``error`` — the baseline is the contract, severity is how
    a human triages it.
    """

    pass_name: str
    site: str
    severity: str
    detail: str
    data: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}; "
                f"got {self.severity!r}"
            )

    @property
    def key(self) -> tuple[str, str]:
        return (self.pass_name, self.site)

    def to_json(self) -> dict:
        return {
            "pass": self.pass_name,
            "site": self.site,
            "severity": self.severity,
            "detail": self.detail,
            "data": self.data,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(
            pass_name=str(d["pass"]),
            site=str(d["site"]),
            severity=str(d["severity"]),
            detail=str(d.get("detail", "")),
            data=dict(d.get("data", {})),
        )


@dataclasses.dataclass
class Report:
    """All findings of one audit run, plus enough provenance to judge a
    baseline mismatch (which torch, which passes, which knobs)."""

    findings: list[Finding]
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = REPORT_VERSION

    def __post_init__(self):
        keys = [f.key for f in self.findings]
        dupes = {k for k in keys if keys.count(k) > 1}
        if dupes:
            raise ValueError(f"duplicate finding keys: {sorted(dupes)}")
        self.findings = sorted(self.findings, key=lambda f: f.key)

    def by_pass(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.pass_name, []).append(f)
        return out

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "meta": self.meta,
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Report":
        version = int(d.get("version", 0))
        if version > REPORT_VERSION:
            raise ValueError(
                f"report version {version} > supported {REPORT_VERSION}; "
                f"update the checkout before diffing"
            )
        return cls(
            findings=[Finding.from_json(x) for x in d.get("findings", [])],
            meta=dict(d.get("meta", {})),
            version=version,
        )

    def save(self, path: str) -> str:
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "Report":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


@dataclasses.dataclass(frozen=True)
class BaselineDiff:
    """Outcome of diffing a fresh report against the tracked baseline."""

    new: tuple[Finding, ...]
    fixed: tuple[Finding, ...]

    @property
    def clean(self) -> bool:
        return not self.new and not self.fixed

    def render(self, baseline_path: Optional[str] = None) -> str:
        """Human-readable verdict for CI logs."""
        if self.clean:
            return "audit: report matches baseline"
        lines = []
        if self.new:
            lines.append(
                f"audit: {len(self.new)} NEW finding(s) not in the "
                f"baseline — fix the regression (or, if intentional, "
                f"regenerate the baseline):"
            )
            lines += [f"  + [{f.severity}] {f.pass_name}/{f.site}: "
                      f"{f.detail}" for f in self.new]
        if self.fixed:
            lines.append(
                f"audit: {len(self.fixed)} baseline finding(s) no "
                f"longer reported — if genuinely fixed, regenerate the "
                f"baseline so the pinned worklist stays honest:"
            )
            lines += [f"  - [{f.severity}] {f.pass_name}/{f.site}: "
                      f"{f.detail}" for f in self.fixed]
        regen = baseline_path or "results/AUDIT_torch_baseline.json"
        lines.append(
            f"regenerate with: python -m repro_torch.analysis.audit "
            f"--write-baseline {regen}"
        )
        return "\n".join(lines)


def diff_reports(fresh: Report, baseline: Report) -> BaselineDiff:
    """Symmetric key-level diff: new findings AND vanished findings both
    dirty the diff (see module docstring for why both directions gate)."""
    fresh_keys = {f.key for f in fresh.findings}
    base_keys = {f.key for f in baseline.findings}
    return BaselineDiff(
        new=tuple(f for f in fresh.findings if f.key not in base_keys),
        fixed=tuple(f for f in baseline.findings
                    if f.key not in fresh_keys),
    )


def merge_findings(*groups: Iterable[Finding]) -> list[Finding]:
    """Concatenate pass outputs, failing fast on key collisions."""
    out: list[Finding] = []
    seen: dict[tuple[str, str], Finding] = {}
    for group in groups:
        for f in group:
            if f.key in seen:
                raise ValueError(f"duplicate finding key {f.key}")
            seen[f.key] = f
            out.append(f)
    return out


def finding_data(**kwargs: Any) -> dict:
    """JSON-safe ``data`` payload: tuples to lists, numpy scalars to
    Python numbers — keeps pass code honest about serializability."""

    def conv(x):
        if isinstance(x, dict):
            return {str(k): conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if hasattr(x, "item") and not isinstance(x, (str, bytes)):
            return x.item()
        return x

    return {k: conv(v) for k, v in kwargs.items()}
