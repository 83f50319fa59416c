"""Collective completeness over every distributed route (counterpart of
``repro.analysis.collectives``).

The reference walks each lowered shard program.  The port's shard group
records every collective it runs (``core/shards.py``: ``CollectiveCall``,
``recording()``, ``bfs_loop()``), so for every distributed route spec
(per-vertex × hedge mode × shard count, on ``LocalShards(p, "cpu")``)
this pass runs the route once and

* **census** — digests the call record into the finding's *site key*
  (``census:{route}:{k}c:{digest}``).  The calls inside the BFS loop
  are folded to one sweep (their count divided by the run's BFS sweeps),
  so the digest depends on the program, not on the graph's depth.
  Adding, removing or re-phasing one collective re-keys the finding,
  which the baseline diff turns into a CI failure;
* **tally cross-check** — the record priced per phase
  (``comm_instrument.measured_phase_bytes``) must equal the analytic
  ``tally_comm`` at the run's sweeps, phase for phase, else
  ``tally-mismatch:{route}`` (an error);
* **unpriced detection** — a recorded call of a kind outside the priced
  set (``walker.COLLECTIVE_PRIMITIVES``), reported as
  ``unpriced:{route}:{kind}``; and an AST scan of the modules the shard
  body runs (:data:`SHARD_BODY_MODULES`) for a ``torch.distributed``
  call made outside ``GroupShards``: an exchange the shard group does
  not record and the wire model does not price, reported as
  ``unpriced:{route}:{call}`` for every route.  Both are errors.

The reference's StableHLO cross-check and walker-divergence check have
no torch counterpart: there is no lowered text, and the record is the
one inventory.
"""
from __future__ import annotations

import ast
import hashlib
from pathlib import Path
from typing import Iterable, Optional, Sequence

from repro_torch.analysis.findings import Finding, finding_data
from repro_torch.analysis.walker import COLLECTIVE_PRIMITIVES
from repro_torch.core.comm_instrument import (
    _price_call,
    measured_phase_bytes,
    tally_comm,
)
from repro_torch.core.shards import CollectiveCall

#: modules of the shard body (relative to ``src/repro_torch``) scanned for
#: unrecorded ``torch.distributed`` calls; ``GroupShards`` itself is the
#: one sanctioned caller
SHARD_BODY_MODULES = ("core/parallel_tc.py", "core/bfs.py",
                      "core/sampling.py", "core/shards.py")

#: the class whose methods may call ``torch.distributed``
SANCTIONED_CLASS = "GroupShards"


def _phases(calls: Sequence[CollectiveCall], n: int, p: int) -> list[str]:
    """Each call's wire phase, by ``comm_instrument``'s attribution."""
    out, seen_a2a = [], False
    for call in calls:
        out.append(_price_call(call, n=n, p=p,
                               before_transpose=not seen_a2a)[0])
        seen_a2a = seen_a2a or call.kind == "all_to_all"
    return out


def fold_bfs(calls: Sequence[CollectiveCall], sweeps: int
             ) -> list[tuple[CollectiveCall, int]]:
    """``(call, trips)`` of the program: the calls outside the BFS loop
    once each, and the loop's calls folded to one sweep (``trips =
    sweeps``), in program order.  Raises if the loop's calls are not a
    whole number of identical sweeps."""
    loop = [c for c in calls if c.in_bfs]
    if sweeps <= 0 or len(loop) % sweeps:
        raise ValueError(f"{len(loop)} BFS-loop calls over {sweeps} sweeps")
    per = len(loop) // sweeps
    sweep = loop[:per]
    if loop != sweep * sweeps:
        raise ValueError("the BFS loop's sweeps run different collectives")
    out, placed = [], False
    for c in calls:
        if not c.in_bfs:
            out.append((c, 1))
        elif not placed:
            out.extend((s, sweeps) for s in sweep)
            placed = True
    return out


def census_digest(folded: Sequence[tuple[CollectiveCall, int]],
                  phases: Sequence[str]) -> str:
    """Stable 10-hex digest of a folded record: kind, phase, shape,
    dtype, bytes, cross pairs and loop membership of every call, order
    preserved (program order is part of the contract — splitter/hedge
    attribution depends on it)."""
    text = ";".join(
        f"{c.kind}|{ph}|{c.shape}|{c.dtype}|{c.nbytes}|{c.cross}|"
        f"{'loop' if c.in_bfs else 'once'}"
        for (c, _), ph in zip(folded, phases)
    )
    return hashlib.sha1(text.encode()).hexdigest()[:10]


def audit_run_collectives(
    label: str,
    calls: Sequence[CollectiveCall],
    *,
    sweeps: int,
    n: int,
    p: int,
    mode: str,
    cap_chunk: int,
    cap_hedge: int,
    per_vertex: bool,
    frontier_dtype: str = "int32",
) -> list[Finding]:
    """The census and the tally cross-check of one run's call record; a
    call of a kind the wire model does not price is reported
    (``unpriced:{label}:{kind}``) and left out of both."""
    findings = [
        Finding(
            pass_name="collectives",
            site=f"unpriced:{label}:{kind}",
            severity="error",
            detail=(
                f"route {label} ran a `{kind}` collective, not in the "
                f"priced set {COLLECTIVE_PRIMITIVES} — the wire model "
                f"cannot account for it"
            ),
            data=finding_data(route=label, kind=kind),
        )
        for kind in sorted({c.kind for c in calls}
                           - set(COLLECTIVE_PRIMITIVES))
    ]
    calls = [c for c in calls if c.kind in COLLECTIVE_PRIMITIVES]
    folded = fold_bfs(calls, sweeps)
    phases = _phases([c for c, _ in folded], n, p)
    by_phase: dict[str, int] = {}
    for ph in phases:
        by_phase[ph] = by_phase.get(ph, 0) + 1
    measured = measured_phase_bytes(calls, n=n, p=p)
    tally = tally_comm(
        n=n, p=p, cap_chunk=cap_chunk, cap_hedge=cap_hedge, mode=mode,
        frontier_dtype=frontier_dtype, sweeps=sweeps, per_vertex=per_vertex,
    ).phase_bytes()
    findings.append(Finding(
        pass_name="collectives",
        site=f"census:{label}:{len(folded)}c:{census_digest(folded, phases)}",
        severity="info",
        detail=(
            f"{label}: {len(folded)} priced collectives a program "
            f"({', '.join(f'{k}={v}' for k, v in sorted(by_phase.items()))};"
            f" the BFS loop's folded to one of {sweeps} sweeps), "
            f"{sum(measured.values())} wire bytes measured == tally"
            f" — any inventory change re-keys this finding and gates CI"
        ),
        data=finding_data(
            count=len(folded), calls=len(calls), by_phase=by_phase,
            bfs_sweeps=sweeps, measured=measured, tally=tally,
            inventory=[
                {"kind": c.kind, "phase": ph, "shape": list(c.shape),
                 "dtype": c.dtype, "nbytes": c.nbytes, "cross": c.cross,
                 "trips": trips}
                for (c, trips), ph in zip(folded, phases)
            ],
        ),
    ))
    if measured != tally:
        findings.append(Finding(
            pass_name="collectives",
            site=f"tally-mismatch:{label}",
            severity="error",
            detail=(
                f"{label}: recorded bytes != analytic tally at sweeps="
                f"{sweeps} — measured {measured}, tally {tally}"
            ),
            data=finding_data(measured=measured, tally=tally),
        ))
    return findings


def unpriced_calls(paths: Iterable[Path]) -> list[str]:
    """``"{module}:{qualname}:{call}"`` for every ``torch.distributed``
    call in the modules at ``paths`` made outside
    :data:`SANCTIONED_CLASS` — ``dist.all_reduce(...)`` through any
    import alias of ``torch.distributed``, a name imported from it, or
    the full ``torch.distributed.X`` path."""
    out = []
    for path in paths:
        path = Path(path)
        tree = ast.parse(path.read_text())
        aliases: set[str] = set()   # names bound to torch.distributed
        members: set[str] = set()   # names imported from it
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch.distributed" and a.asname:
                        aliases.add(a.asname)
            elif (isinstance(node, ast.ImportFrom)
                  and node.module == "torch.distributed"):
                members.update(a.asname or a.name for a in node.names)
            elif (isinstance(node, ast.ImportFrom) and node.module == "torch"
                  and any(a.name == "distributed" for a in node.names)):
                aliases.update(a.asname or a.name for a in node.names
                               if a.name == "distributed")

        def call_name(func) -> Optional[str]:
            if isinstance(func, ast.Name) and func.id in members:
                return func.id
            if isinstance(func, ast.Attribute):
                v = func.value
                if isinstance(v, ast.Name) and v.id in aliases:
                    return f"{v.id}.{func.attr}"
                if (isinstance(v, ast.Attribute) and v.attr == "distributed"
                        and isinstance(v.value, ast.Name)
                        and v.value.id == "torch"):
                    return f"torch.distributed.{func.attr}"
            return None

        def visit(node, scope):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    if (isinstance(child, ast.ClassDef)
                            and child.name == SANCTIONED_CLASS):
                        continue
                    visit(child, scope + (child.name,))
                    continue
                if isinstance(child, ast.Call):
                    name = call_name(child.func)
                    if name is not None:
                        out.append(f"{path.stem}:"
                                   f"{'.'.join(scope) or '<module>'}:{name}")
                visit(child, scope)

        visit(tree, ())
    return out


def shard_body_paths() -> list[Path]:
    """:data:`SHARD_BODY_MODULES` as paths."""
    import repro_torch

    root = Path(repro_torch.__file__).resolve().parent
    return [root / m for m in SHARD_BODY_MODULES]


def audit_unpriced(labels: Iterable[str],
                   paths: Optional[Iterable[Path]] = None) -> list[Finding]:
    """One error a route and unrecorded ``torch.distributed`` call."""
    calls = unpriced_calls(shard_body_paths() if paths is None else paths)
    return [
        Finding(
            pass_name="collectives",
            site=f"unpriced:{label}:{call}",
            severity="error",
            detail=(
                f"`{call}` runs a torch.distributed collective outside "
                f"{SANCTIONED_CLASS}: route {label}'s shard group does not "
                f"record it and the wire model cannot price it"
            ),
            data=finding_data(route=label, call=call),
        )
        for label in labels for call in calls
    ]


def audit_collectives(specs) -> list[Finding]:
    """The full pass over every distributed route spec, each run once on
    ``LocalShards(p, "cpu")``."""
    from repro_torch.core.parallel_tc import _capacities

    findings: list[Finding] = []
    labels = []
    for spec in specs:
        if spec.route != "distributed":
            continue
        res = spec.run("cpu")
        o = spec.options()
        _, cap_chunk, cap_hedge = _capacities(_edge_slots(spec), spec.p,
                                              float(o.slack))
        findings.extend(audit_run_collectives(
            spec.name, res.collectives, sweeps=int(res.comm.bfs_sweeps),
            n=spec.n_budget, p=spec.p, mode=spec.mode or "allgather",
            cap_chunk=cap_chunk, cap_hedge=cap_hedge,
            per_vertex=spec.per_vertex, frontier_dtype=o.frontier_dtype,
        ))
        labels.append(spec.name)
    return findings + audit_unpriced(labels)


def _edge_slots(spec) -> int:
    """The real directed edge count (2m) of the route's graph."""
    from repro_torch.analysis.routes import route_graphs
    from repro_torch.graph.csr import _normalize_edges_host

    edges, _ = route_graphs()[0]
    return int(_normalize_edges_host(edges, spec.n_budget)[0].shape[0])
