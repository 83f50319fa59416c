"""The port's audit CLI — run every pass, emit/diff the findings report
(counterpart of ``repro.analysis.audit``).

    PYTHONPATH=src python -m repro_torch.analysis.audit --out audit.json
    PYTHONPATH=src python -m repro_torch.analysis.audit \\
        --check results/AUDIT_torch_baseline.json
    PYTHONPATH=src python -m repro_torch.analysis.audit \\
        --write-baseline results/AUDIT_torch_baseline.json

CI runs ``--check``: the fresh report's finding KEYS are diffed against
the tracked baseline — a new key fails the build (a regression the
author must fix or consciously pin), a vanished key also fails (a fix
must be accompanied by a baseline regen, so the improvement is recorded
and cannot silently regress back).  ``--write-baseline`` is that regen.

Everything runs on the CPU, statically or at a pinned tiny size: the
routes run once each at the reference's budget on the seeded graphs of
``analysis/routes.py`` with the plain backend, the distributed ones on
``LocalShards(p, "cpu")``, and the bounds are evaluated at synthetic
Graph500 scales without materializing a graph.  No GPU is used, and the
report is the same on any host.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from repro_torch.analysis.findings import (
    Finding,
    Report,
    diff_reports,
    finding_data,
    merge_findings,
)

#: the tuned profile the compile-set pass audits: the reference's serving
#: profile, carried across with ``tune.profile.profile_from_reference``
#: (read only)
DEFAULT_PROFILE = "results/tuned/serve_mix.json"

#: shard counts the distributed routes are audited at
P_VALUES = (1, 2, 4, 8)

#: the tracked baseline of the port
BASELINE = "results/AUDIT_torch_baseline.json"


def _profile_path(profile: str) -> Optional[str]:
    """``profile`` as given, else under the repo root, else None."""
    if os.path.exists(profile):
        return profile
    from repro_torch.analysis.deadcode import repo_root

    path = os.path.join(repo_root(), profile)
    return path if os.path.exists(path) else None


def load_any_profile(path: str):
    """A tuned profile written by either package: a reference file (its
    options carry ``interpret``) is carried across, the port's own is
    read as it is."""
    from repro_torch.tune.profile import TunedProfile, profile_from_reference

    with open(path) as fh:
        d = json.load(fh)
    if "interpret" in d.get("options", {}):
        return profile_from_reference(d)
    return TunedProfile.from_json(d)


def run_audit(
    *,
    profile: Optional[str] = DEFAULT_PROFILE,
    p_values: tuple[int, ...] = P_VALUES,
    batch_size: int = 8,
) -> Report:
    """Run all five passes on the CPU and assemble the versioned
    report."""
    import torch

    from repro_torch.analysis.bounds import DEFAULT_SCALES, audit_bounds
    from repro_torch.analysis.collectives import audit_collectives
    from repro_torch.analysis.compile_set import (
        audit_compile_set,
        predicted_jit_compiles,
    )
    from repro_torch.analysis.deadcode import audit_deadcode
    from repro_torch.analysis.hostsync import (
        audit_hot_path_syncs,
        audit_route_syncs,
    )
    from repro_torch.analysis.routes import enumerate_route_specs
    from repro_torch.api import TriangleEngine

    single = enumerate_route_specs(p_values=(1,))
    path = _profile_path(profile) if profile is not None else None
    predicted = None
    if path is not None:
        engine = TriangleEngine(device="cpu",
                                profile=load_any_profile(path))
        predicted = predicted_jit_compiles(engine, batch_size=batch_size)
        compile_findings = audit_compile_set(
            engine, batch_size=batch_size, label=os.path.basename(path))
    else:
        compile_findings = [Finding(
            pass_name="compile_set",
            site="no-profile",
            severity="info",
            detail=(
                f"tuned profile {profile!r} not found — no prewarm set to "
                f"enumerate (point --profile at a tracked profile)"
            ),
            data=finding_data(profile=profile),
        )]

    findings = merge_findings(
        compile_findings,
        audit_bounds(),
        audit_hot_path_syncs(),
        audit_route_syncs(single),
        audit_collectives(
            s for s in enumerate_route_specs(p_values=p_values)
            if s.route == "distributed"
        ),
        audit_deadcode(),
    )
    return Report(
        findings=findings,
        meta={
            "torch": torch.__version__,
            "profile": profile if path is not None else None,
            "p_values": list(p_values),
            "scales": list(DEFAULT_SCALES),
            "route_programs": [s.name for s in single],
            "batch_size": batch_size,
            "predicted_jit_compiles": predicted,
        },
    )


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="the port's static audit: compile set, int32 bounds, "
                    "host syncs, collectives, dead code",
    )
    ap.add_argument("--out", help="write the fresh report JSON here")
    ap.add_argument("--check", metavar="BASELINE",
                    help="diff against a tracked baseline; exit 1 on "
                         "any new or vanished finding")
    ap.add_argument("--write-baseline", metavar="BASELINE",
                    help="write the fresh report as the new baseline")
    ap.add_argument("--profile", default=DEFAULT_PROFILE,
                    help="tuned profile for the compile-set pass "
                         f"(default {DEFAULT_PROFILE})")
    ap.add_argument("--p-max", type=int, default=max(P_VALUES),
                    help="largest distributed shard count to audit")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    report = run_audit(
        profile=args.profile,
        p_values=tuple(p for p in P_VALUES if p <= args.p_max),
    )
    counts = report.counts()
    print(f"audit: {len(report.findings)} findings "
          f"({', '.join(f'{k}={v}' for k, v in sorted(counts.items()))}) "
          f"in {time.perf_counter() - t0:.1f} s")
    for pass_name, group in sorted(report.by_pass().items()):
        print(f"  {pass_name}: {len(group)}")

    if args.out:
        report.save(args.out)
        print(f"report -> {args.out}")
    if args.write_baseline:
        report.save(args.write_baseline)
        print(f"baseline -> {args.write_baseline}")
    if args.check:
        baseline = Report.load(args.check)
        diff = diff_reports(report, baseline)
        if diff.clean:
            print(f"baseline check OK ({args.check})")
            return 0
        print(diff.render(baseline_path=args.check))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
