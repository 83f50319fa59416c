"""Compile-set enumeration (counterpart of
``repro.analysis.compile_set``).

The serving layer's claim is "a finite, warmable set": every flush of
traffic a tuned profile covers lands on a plan that
``serve(prewarm=True)`` already made and ran.  The port compiles nothing
at run time, so its "compile key" is one plan-cache entry together with
the warm batch that ``TriangleServer.prewarm`` runs for it: per profile
cell with a meta ceiling, the pooled meta's plan (the engine's plan
cache key ``(budget, pooled meta, options_for(cell).plan_view(device))``)
at each lane count of ``launch.serve_tc.lanes_ladder`` — the helper
``prewarm`` iterates, so predictor and warmer cannot drift.  ``root``
and ``per_vertex`` come from the engine's *global* options, as
``count_batch_raw`` reads them.

The plan cache is keyed without the lane count, so a prewarmed engine's
cache holds one entry per distinct plan key (:func:`plan_cache_keys`),
while the server ran one warm batch per compile key.

Findings: a census of the enumerated set (``census:{label}:b{batch}:
jit{keys}:plan{plans}``; any growth re-keys it and gates CI) and a
warning when the audited grid is unbounded (the raw request space then
has no finite set — only profile-covered traffic is warmable).  The
reference's weak-type check has no torch counterpart (torch has no weak
types).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.findings import Finding, finding_data
from repro_torch.core.intersect import IntersectPlan
from repro_torch.graph.csr import BatchDegreeMeta, ShapeBudget


@dataclasses.dataclass(frozen=True)
class CompileKey:
    """One predicted warm batch: a plan-cache entry at a lane count."""

    budget: ShapeBudget
    lanes: int
    plan: IntersectPlan
    root: int
    per_vertex: bool


@dataclasses.dataclass(frozen=True)
class _MetaProbe:
    """What ``batch_plan_for`` reads of a ``GraphBatch``: its budget, its
    meta and its device (no tensor is made)."""

    budget: ShapeBudget
    meta: BatchDegreeMeta
    device: torch.device


def _cells(engine):
    profile = getattr(engine, "profile", None)
    if profile is None:
        return []
    return [c for c in profile.cells if c.meta is not None]


def plan_cache_keys(engine) -> list[tuple]:
    """The plan-cache keys ``(budget, pooled meta, plan view)`` that
    ``serve(prewarm=True)`` plans on ``engine``, one per profile cell
    with a meta: exactly what a prewarmed engine's plan cache holds.
    Pools each ceiling into the engine's mark (``pool_meta``), as
    ``prewarm`` does."""
    keys: dict = {}
    for cell in _cells(engine):
        pooled = engine.pool_meta(cell.budget, cell.meta)
        view = engine.options_for(cell.budget).plan_view(engine.device)
        keys[(cell.budget, pooled, view)] = None
    return list(keys)


def enumerate_compile_keys(engine, *, batch_size: int = 8
                           ) -> list[CompileKey]:
    """Every warm batch a ``serve(prewarm=True)`` server on ``engine``
    runs — and, because serving flushes route through ``pool_meta`` onto
    the same ceilings, every (plan, lane count) post-warm traffic covered
    by the profile can land on.  Pure host arithmetic: plans are laid
    out from metas in a cache of its own (the engine's is untouched);
    nothing runs on a device.

    A profile-less engine returns ``[]`` (nothing is warmable),
    matching ``prewarm``'s no-op."""
    from repro_torch.core.sequential import PlanCache, batch_plan_for
    from repro_torch.launch.serve_tc import lanes_ladder

    root = int(engine.options.root)
    per_vertex = bool(engine.options.per_vertex)
    cache, stats = PlanCache(None), {"hits": 0, "misses": 0}
    keys: dict = {}
    for budget, meta, _ in plan_cache_keys(engine):
        plan = batch_plan_for(
            _MetaProbe(budget, meta, engine.device),
            options=engine.options_for(budget), cache=cache, stats=stats)
        for lanes in lanes_ladder(batch_size):
            k = CompileKey(budget=budget, lanes=int(lanes), plan=plan,
                           root=root, per_vertex=per_vertex)
            keys[k] = k
    return list(keys.values())


def predicted_jit_compiles(engine, *, batch_size: int = 8) -> int:
    """How many warm batches ``serve(prewarm=True)`` runs on ``engine``
    (the reference's count of fused jit entries)."""
    return len(enumerate_compile_keys(engine, batch_size=batch_size))


def audit_compile_set(
    engine,
    *,
    batch_size: int = 8,
    label: str = "default",
) -> list[Finding]:
    """Findings for one engine configuration (see module docstring)."""
    from repro_torch.launch.serve_tc import lanes_ladder

    findings: list[Finding] = []
    grid = engine.budgets
    if grid.max_nodes is None or grid.max_slots is None:
        findings.append(Finding(
            pass_name="compile_set",
            site=f"unbounded-grid:{label}",
            severity="warning",
            detail=(
                "BudgetGrid has no top cell (max_nodes/max_slots None): "
                "the set of plans over raw request sizes is unbounded — "
                "only profile-covered cells are finite and warmable"
            ),
            data=finding_data(
                min_nodes=grid.min_nodes, min_slots=grid.min_slots,
                factor=grid.factor,
            ),
        ))
    keys = enumerate_compile_keys(engine, batch_size=batch_size)
    cells = _cells(engine)
    findings.append(Finding(
        pass_name="compile_set",
        site=(f"census:{label}:b{batch_size}:"
              f"jit{len(keys)}:plan{len({k.plan for k in keys})}"),
        severity="info",
        detail=(
            f"prewarm set for {label!r} at batch_size={batch_size}: "
            f"{len(keys)} warm batches over {len(cells)} profile cells × "
            f"{len(lanes_ladder(batch_size))} lane counts"
        ),
        data=finding_data(
            jit_entries=len(keys),
            plan_cache_entries=len(plan_cache_keys(engine)),
            profile_cells=len(cells),
            lanes=lanes_ladder(batch_size),
            budgets=sorted({(k.budget.n_budget, k.budget.slot_budget)
                            for k in keys}),
        ),
    ))
    return findings
