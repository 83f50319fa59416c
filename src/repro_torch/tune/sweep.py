"""The offline sweep: replay a recorded workload through the real serving
path under candidate configs, prune by successive halving, and freeze
the winner as a :class:`TunedProfile` (counterpart of
``repro.tune.sweep``).

The honesty rules of ``launch.serve_tc.measure_serve`` hold:

* every candidate is served through a real ``engine.serve()`` server —
  the batching, meta pooling, plan cache and K1 launches that serving
  runs, not a microbenchmark of the kernel;
* every candidate gets a warm replay before its timed ones, so library
  loads and plan builds stay out of the measurement;
* every evaluated config's answers must equal the baseline's (the
  default config's) bit for bit, by request id; a config that changes an
  answer, overflows, or answers a request inexactly aborts the sweep
  (:class:`SweepMismatch`).

Rung ``i`` replays a prefix of the trace, ranks the surviving configs by
graphs/s and keeps the top half; the last rung replays the whole trace,
so the winner's numbers are never extrapolated.  Every function that
builds an engine takes ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.graph.csr import DEFAULT_BUDGET_GRID, BudgetGrid
from repro_torch.tune.profile import CellProfile, TunedProfile
from repro_torch.tune.trace import TraceRecord, trace_signature


class SweepMismatch(AssertionError):
    """A swept config changed an answer: the sweep must not persist it."""


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """One point of the search space: a label, the ``TCOptions`` to
    serve with and the ``BudgetGrid`` to bucket with."""

    label: str
    options: "object"  # TCOptions
    grid: BudgetGrid = DEFAULT_BUDGET_GRID


def default_space(*, smoke: bool = False,
                  device: Union[str, torch.device] = "cuda",
                  ) -> List[SweepConfig]:
    """The reference's candidate grid over the ``plan_view()`` space:
    bucket-width ladders (subsets of ``META_WIDTHS``), ``row_mult`` /
    ``query_chunk``, backend, hedge mode and ``BudgetGrid`` geometry.
    ``configs[0]`` is the default config, the baseline every other one
    is checked against.

    The reference's ``backend:jnp`` is ``backend:torch`` (the plain
    probe) on the CPU, where it equals the default's resolved backend as
    ``jnp`` does in the reference; on a CUDA device it is left out, so
    a sweep winner served from a profile never puts the plain probe on
    the serving path while a card is present."""
    from repro_torch.api import TCOptions

    base = TCOptions()
    coarse = BudgetGrid(min_nodes=128, min_slots=1024, factor=4.0)
    coarser = BudgetGrid(min_nodes=128, min_slots=2048, factor=8.0)
    space = [
        SweepConfig("default", base),
        SweepConfig("grid:128x1024xf4", base, coarse),
        SweepConfig("widths:8-64", dataclasses.replace(
            base, bucket_widths=(8, 64))),
        SweepConfig("row_mult:16", dataclasses.replace(base, row_mult=16)),
        SweepConfig(
            "grid:128x1024xf4+widths:8-64",
            dataclasses.replace(base, bucket_widths=(8, 64)),
            coarse,
        ),
    ]
    if smoke:
        return space
    space += [
        SweepConfig("grid:128x2048xf8", base, coarser),
        SweepConfig("widths:64", dataclasses.replace(
            base, bucket_widths=(64,))),
        SweepConfig("widths:8-32-64-256", dataclasses.replace(
            base, bucket_widths=(8, 32, 64, 256))),
        SweepConfig("row_mult:128", dataclasses.replace(base, row_mult=128)),
        SweepConfig("query_chunk:256", dataclasses.replace(
            base, query_chunk=256)),
    ]
    if torch.device(device).type != "cuda":
        space.append(SweepConfig("backend:torch", dataclasses.replace(
            base, backend="torch")))
    space += [
        SweepConfig("hedge:ring", dataclasses.replace(base, mode="ring")),
        SweepConfig(
            "grid:128x2048xf8+widths:8-64",
            dataclasses.replace(base, bucket_widths=(8, 64)),
            coarser,
        ),
        SweepConfig(
            "grid:128x1024xf4+row_mult:16",
            dataclasses.replace(base, row_mult=16),
            coarse,
        ),
    ]
    return space


def _replay(engine, records: Sequence[TraceRecord], batch_size: int):
    server = engine.serve(batch_size=batch_size)
    t0 = time.perf_counter()
    for rec in records:
        edges, n = rec.request()
        server.submit(edges, n, deadline_s=rec.deadline_s)
    server.drain()
    return server, time.perf_counter() - t0


def evaluate_config(config: SweepConfig, records: Sequence[TraceRecord], *,
                    batch_size: int = 8, repeats: int = 1,
                    device: Union[str, torch.device] = "cuda") -> dict:
    """Measure one config on one trace through the real serving path: a
    fresh engine on ``device``, a warm replay, then ``repeats`` timed
    replays, keeping the fastest.  Returns the objective row and the
    per-request triangle counts (by submit order) that the bit-identity
    check reads."""
    from repro_torch.api import TriangleEngine
    from repro_torch.launch.serve_tc import TriangleAnalytics, _pct_ms

    engine = TriangleEngine(config.options, budgets=config.grid,
                            device=device)
    _replay(engine, records, batch_size)  # warm
    server, wall = _replay(engine, records, batch_size)
    for _ in range(max(1, int(repeats)) - 1):
        s2, w2 = _replay(engine, records, batch_size)
        if w2 < wall:
            server, wall = s2, w2
    by_id = {r.request_id: r for r in server.results}
    triangles, overflow = [], False
    for i in range(len(records)):
        r = by_id.get(i)
        if not isinstance(r, TriangleAnalytics) or r.route == "approx":
            raise SweepMismatch(
                f"config {config.label!r}: request {i} was not answered "
                f"exactly ({type(r).__name__ if r else 'missing'}) — "
                "sweep configs must serve the whole trace exactly"
            )
        triangles.append(int(r.triangles))
        overflow = overflow or bool(r.overflow)
    lat = sorted(r.latency_s for r in server.results
                 if isinstance(r, TriangleAnalytics))
    stats = server.summary()
    return {
        "label": config.label,
        "requests": len(records),
        "graphs_per_s": len(records) / wall if wall > 0 else float("inf"),
        "wall_s": wall,
        "p50_ms": _pct_ms(lat, 50),
        "p99_ms": _pct_ms(lat, 99),
        "batches": stats["batches"],
        "plan_hit": stats["plan_hit"],
        "overflow": overflow,
        "triangles": triangles,
    }


def _check_identical(result: dict, baseline: dict, label: str) -> None:
    n = len(result["triangles"])
    ref = baseline["triangles"][:n]
    if result["overflow"]:
        raise SweepMismatch(f"config {label!r} overflowed a bounded plan")
    if result["triangles"] != ref:
        bad = next(i for i, (a, b) in enumerate(zip(result["triangles"], ref))
                   if a != b)
        raise SweepMismatch(
            f"config {label!r} changed request {bad}: "
            f"{result['triangles'][bad]} != {ref[bad]}"
        )


def successive_halving(space: Sequence[SweepConfig],
                       records: Sequence[TraceRecord], *,
                       batch_size: int = 8,
                       rungs: Sequence[float] = (0.25, 0.5, 1.0),
                       keep: float = 0.5, repeats: int = 1, log=None,
                       device: Union[str, torch.device] = "cuda") -> dict:
    """Sweep ``space`` over ``records`` with successive-halving pruning.

    The baseline (``space[0]``) is evaluated once on the whole trace;
    every other evaluation, at every rung, is checked bit for bit
    against it on the replayed prefix.  Returns the baseline row, each
    rung's ranking, the winner's whole-trace row and the baseline's
    answers (``triangles``)."""
    if not records:
        raise ValueError("cannot sweep an empty trace")
    if not space:
        raise ValueError("cannot sweep an empty config space")
    say = log or (lambda *_: None)
    baseline_cfg = space[0]
    baseline = evaluate_config(baseline_cfg, records, batch_size=batch_size,
                               repeats=repeats, device=device)
    say(f"baseline {baseline_cfg.label}: "
        f"{baseline['graphs_per_s']:.1f} graphs/s")
    alive = list(space)
    results = {baseline_cfg.label: baseline}
    history = []
    fracs = list(rungs)
    if not fracs or fracs[-1] < 1.0:
        fracs.append(1.0)  # the winner's numbers come from the whole trace
    for rung, frac in enumerate(fracs):
        n = max(1, min(len(records), math.ceil(len(records) * frac)))
        sub = records[:n]
        rows = []
        for cfg in alive:
            if frac >= 1.0 and cfg.label == baseline_cfg.label:
                row = baseline  # already measured on the whole trace
            else:
                row = evaluate_config(cfg, sub, batch_size=batch_size,
                                      repeats=repeats, device=device)
                _check_identical(row, baseline, cfg.label)
            rows.append((cfg, row))
            results[cfg.label] = row
            say(f"rung {rung} ({n} reqs) {cfg.label}: "
                f"{row['graphs_per_s']:.1f} graphs/s")
        rows.sort(key=lambda cr: -cr[1]["graphs_per_s"])
        history.append({
            "rung": rung,
            "fraction": frac,
            "requests": n,
            "evals": [
                {k: r[k] for k in ("label", "graphs_per_s", "p50_ms",
                                   "p99_ms", "batches", "plan_hit")}
                for _, r in rows
            ],
        })
        if frac >= 1.0:
            alive = [rows[0][0]]
            break
        alive = [cfg for cfg, _ in rows[: max(1, math.ceil(len(rows) * keep))]]
    winner_cfg = alive[0]
    winner = results[winner_cfg.label]
    return {
        "baseline": {k: v for k, v in baseline.items() if k != "triangles"},
        "winner": {k: v for k, v in winner.items() if k != "triangles"},
        # the answers every config was checked against (the prewarm
        # replay's gate reads them too)
        "triangles": list(baseline["triangles"]),
        "winner_config": winner_cfg,
        "history": history,
        "improvement_graphs_per_s": (
            winner["graphs_per_s"] / baseline["graphs_per_s"]),
        "p50_reduction": (
            1.0 - winner["p50_ms"] / baseline["p50_ms"]
            if baseline["p50_ms"] > 0 else 0.0),
    }


def build_profile(config: SweepConfig, records: Sequence[TraceRecord], *,
                  objective: Optional[dict] = None) -> TunedProfile:
    """Freeze a sweep winner into a :class:`TunedProfile`.

    Each cell's meta ceiling is the union of the per-request metas the
    trace routes into it under the winner's grid: an upper bound on
    every flush's meta (the quantizers commute with ``max``), which is
    what ``serve(prewarm=True)`` needs to cover the trace."""
    cells: dict = {}
    for rec in records:
        if rec.meta is None:
            continue
        if not config.grid.fits(rec.n_nodes, rec.n_edges):
            continue  # distributed under this grid: no batch cell
        b = config.grid.budget_for(rec.n_nodes, rec.n_edges)
        cells[b] = rec.meta if b not in cells else cells[b].union(rec.meta)
    return TunedProfile(
        signature=trace_signature(records),
        options=config.options,
        grid=config.grid,
        cells=tuple(CellProfile(budget=b, options=config.options, meta=m)
                    for b, m in sorted(cells.items())),
        objective=objective,
    )


def prewarm_replay(profile: TunedProfile, records: Sequence[TraceRecord], *,
                   batch_size: int = 8,
                   device: Union[str, torch.device] = "cuda") -> dict:
    """The prewarm contract's check: serve the trace on a fresh
    prewarmed engine on ``device`` and report ``plan_hit`` and the
    libraries loaded after the prewarm (``jit_compiles``; 1.0 and 0 on
    traffic the trace covers), and the per-request triangle counts for
    the caller's bit check."""
    from repro_torch.api import TriangleEngine
    from repro_torch.launch.serve_tc import TriangleAnalytics

    engine = TriangleEngine(profile=profile, device=device)
    server = engine.serve(batch_size=batch_size, prewarm=True)
    t0 = time.perf_counter()
    for rec in records:
        edges, n = rec.request()
        server.submit(edges, n, deadline_s=rec.deadline_s)
    server.drain()
    wall = time.perf_counter() - t0
    stats = server.summary()
    by_id = {r.request_id: r for r in server.results}
    return {
        "plan_hit": stats["plan_hit"],
        "jit_compiles": stats["jit_compiles"],
        "graphs_per_s": len(records) / wall if wall > 0 else float("inf"),
        "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"],
        "triangles": [
            int(by_id[i].triangles)
            if isinstance(by_id.get(i), TriangleAnalytics) else None
            for i in range(len(records))
        ],
    }
