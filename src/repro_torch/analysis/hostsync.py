"""Host-sync detection on the serving hot path (counterpart of
``repro.analysis.hostsync``).

The server's latency depends on how often the host waits for the card:
the BFS reads its progress flag back once a sweep
(``core/bfs.py:bfs_levels_iters``), the exact plan reads its degree
profile back, K2's chunking reads its cut points back
(``core/intersect.py:cell_chunks``), and a finished flush is read back
once (``TriangleServer._finalize_one``).  A new ``.item()`` or ``.cpu()``
slipped into that path adds a round trip per flush, or per sweep, and
fails no functional test.  Two detectors pin today's set, so a new sync
fails ``--check`` and a sync that a change removes must be unpinned on
purpose:

* **AST scan** of the hot-path callables: every call whose callee is an
  attribute or name in :data:`SYNC_ATTRS` becomes a finding keyed
  ``ast:{qualname}:{attr}:x{count}``.  The port's syncs sit one call
  lower than the reference's (in the BFS, the exact plan and K2's
  chunking), so those functions are scanned too.
* **Runtime census** (in place of the reference's jaxpr callback scan):
  every single-device route spec (``analysis/routes.py``) runs once on
  the CPU under an :class:`~repro_torch.analysis.walker.OpRecorder`,
  and each sync op it ran (``walker.SYNC_OPS``) becomes a finding keyed
  ``census:{route}:{op}:x{count}``, its ``data`` holding the BFS sweep
  count of the pinned graph (the BFS's ``_local_scalar_dense`` count).
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Iterable

from repro_torch.analysis.findings import Finding, finding_data
from repro_torch.analysis.walker import OpRecorder, op_counts, sync_ops

#: attribute / bare-call names that make the host wait for the device
SYNC_ATTRS = ("item", "cpu", "tolist", "numpy", "synchronize")


def hot_path_callables() -> list[tuple[str, Callable]]:
    """The audited serving-hot-path surface, by qualname.  Startup code
    (``prewarm``, profile loading) and failure paths are left out:
    syncing there is free."""
    from repro_torch import api
    from repro_torch.core import bfs, intersect
    from repro_torch.core import sequential as seq
    from repro_torch.launch import serve_tc

    srv = serve_tc.TriangleServer
    eng = api.TriangleEngine
    out: list[tuple[str, Callable]] = []
    for obj, names in (
        (srv, ("submit", "pump", "_pump_deadlines", "_flush",
               "_poll_inflight", "_finalize_one", "drain")),
        (eng, ("plan_for", "pool_meta", "count_batch_raw")),
        (seq, ("_triangle_count_batch", "batch_plan_for",
               "_exact_batch_plan", "_exact_plan")),
        (bfs, ("bfs_levels_iters", "bfs_levels_batch")),
        (intersect, ("run_plan", "cell_chunks")),
    ):
        prefix = getattr(obj, "__name__", type(obj).__name__)
        for name in names:
            out.append((f"{prefix}.{name}", getattr(obj, name)))
    return out


def _sync_calls(qualname: str, fn: Callable) -> dict[str, int]:
    """``{attr: count}`` of host-sync call sites in one function's
    source: a call is counted when its callee is an attribute or name
    in :data:`SYNC_ATTRS` (``x.item()``, ``t.cpu()``,
    ``torch.cuda.synchronize()``)."""
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    counts: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func
        name = None
        if isinstance(callee, ast.Attribute) and callee.attr in SYNC_ATTRS:
            name = callee.attr
        elif isinstance(callee, ast.Name) and callee.id in SYNC_ATTRS:
            name = callee.id
        if name is not None:
            counts[name] = counts.get(name, 0) + 1
    return counts


def audit_hot_path_syncs(
    callables: Iterable[tuple[str, Callable]] | None = None,
) -> list[Finding]:
    """AST findings: one per ``(hot-path function, sync attr)`` pair,
    counting the sites.  The baseline pins the sanctioned pairs; any
    new pair (or a count change at an existing pair) gates CI."""
    findings: list[Finding] = []
    for qualname, fn in (hot_path_callables() if callables is None
                         else callables):
        for attr, count in sorted(_sync_calls(qualname, fn).items()):
            findings.append(Finding(
                pass_name="hostsync",
                site=f"ast:{qualname}:{attr}:x{count}",
                severity="warning",
                detail=(
                    f"{count} `{attr}` host-sync call(s) in hot-path "
                    f"function {qualname} — each a blocking host/device "
                    f"round trip on the card; the baseline pins the "
                    f"sanctioned set"
                ),
                data=finding_data(qualname=qualname, attr=attr,
                                  count=count),
            ))
    return findings


def census_findings(label: str, record, sweeps: int) -> list[Finding]:
    """One warning a sync op of one recorded route run, keyed by its
    count (``census:{label}:{op}:x{count}``)."""
    return [
        Finding(
            pass_name="hostsync",
            site=f"census:{label}:{op}:x{count}",
            severity="warning",
            detail=(
                f"route {label} ran `{op}` {count} time(s) on the pinned "
                f"graph ({sweeps} BFS sweeps) — a host wait each on the "
                f"card"
            ),
            data=finding_data(route=label, op=op, count=count,
                              bfs_sweeps=sweeps),
        )
        for op, count in sorted(op_counts(sync_ops(record)).items())
    ]


def record_route(spec, device="cpu"):
    """``(record, sweeps)`` of one run of ``spec`` on ``device`` under an
    :class:`OpRecorder` (its inputs are packed outside the recording)."""
    run, sweeps = spec.prepare(device)
    with OpRecorder() as rec:
        with rec.scope(spec.name):
            res = run()
    return rec.record, int(sweeps(res))


def audit_route_syncs(specs) -> list[Finding]:
    """The runtime census over single-device route specs, each run once
    on the CPU."""
    findings: list[Finding] = []
    for spec in specs:
        record, sweeps = record_route(spec, "cpu")
        findings.extend(census_findings(spec.name, record, sweeps))
    return findings
