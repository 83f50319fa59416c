"""Algorithm 1 — sequential cover-edge triangle counting.

Counterpart of ``repro.core.sequential`` for one graph:

    1. BFS from a root -> levels L(v)
    2. mark horizontal edges  (L(u) == L(w)), compact and degree-sort them
    3. for each horizontal edge, intersect N(u) and N(w)
       c1 += apexes on a different level      (counted once)
       c2 += apexes on the same level         (counted thrice, Lemma 2)
    4. T = c1 + c2 // 3                       (Theorem 1)

The reference runs one graph as a B=1 lane of its batched pipeline,
which is bit-identical to the single-graph path by construction; the
port writes the single-graph path directly.  The plan pass pulls only
the first ``n_h`` entries of the degree profile to the host (one sync
for ``n_h``, one for the profile) and lays out the exact plan there.

``triangle_count_dense`` is the seed's golden reference: every directed
slot probed at the global ``d_max`` width, non-horizontal rows masked.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bfs import bfs_levels_iters
from repro_torch.core.edges import (
    horizontal_mask,
    horizontal_queries,
    k_fraction,
)
from repro_torch.core.intersect import (
    CsrAdjacency,
    IntersectPlan,
    plan_buckets,
    probe_operands,
    resolve_backend,
    run_plan,
)
from repro_torch.graph.csr import Graph, max_degree, undirected_edges
from repro_torch.kernels.intersect.ref import search_steps, split_counts


@dataclasses.dataclass(frozen=True)
class TCResult:
    """Raw count result; tensors live on the graph's device."""

    triangles: torch.Tensor   # int32 scalar
    c1: torch.Tensor
    c2: torch.Tensor
    num_horizontal: torch.Tensor
    k: torch.Tensor           # float32 scalar
    levels: torch.Tensor      # int32[n]
    probe_rows: int           # query rows actually intersected (padded)
    probe_cells: float        # Σ rows × candidate width, rounded to
    #   float32 as the reference stores it (a work metric)
    peak_rows: int            # largest single probed block
    h_overflow: torch.Tensor  # True iff real horizontal queries were
    #   dropped (cap_h) or a width clamp truncated candidate lists (d_max)
    plan: Optional[IntersectPlan] = None  # the exact plan that ran (None
    #   on the dense reference path)


class StageClock:
    """Per-stage wall seconds of one count, each stage closed by a device
    synchronize so the time is the device's, not the enqueue's.  Passed
    in by a caller that wants the split; the count does not sync per
    stage without one."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._t = time.perf_counter()

    def start(self) -> None:
        self._sync()
        self._t = time.perf_counter()

    def lap(self, stage: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self._t = now

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _triangle_count(g: Graph, o, *,
                    clock: Optional[StageClock] = None) -> TCResult:
    """Single-graph count — ``o`` is a ``repro_torch.api.TCOptions``.
    ``o.compact=False`` runs the dense seed reference instead."""
    if not o.compact:
        dm = o.d_max if o.d_max is not None else max(1, max_degree(g))
        return triangle_count_dense(g, d_max=dm, root=int(o.root))
    backend = resolve_backend(o.backend, g.device)
    if clock is not None:
        clock.start()
    level, sweeps = bfs_levels_iters(
        g.src, g.dst, g.n_nodes, int(o.root), row_offsets=g.row_offsets
    )
    if clock is not None:
        clock.lap("bfs")
        clock.counts["bfs_sweeps"] = sweeps
    qu, qw, d_small, d_large, n_h = horizontal_queries(g, level, order="desc")
    k = k_fraction(g.src, g.dst, level, g.n_nodes)
    if clock is not None:
        clock.lap("compact")
    H = int(n_h.item())
    h_used = H if o.cap_h is None else min(int(o.cap_h), H)
    row_mult = int(o.query_chunk) if o.query_chunk else o.row_mult
    plan = plan_buckets(
        d_small[:h_used].cpu().numpy(),
        d_large[:h_used].cpu().numpy(),
        bucket_widths=o.bucket_widths,
        d_cap=o.d_max,
        row_mult=row_mult,
        backend=backend,
        query_chunk=o.query_chunk,
        layout="desc",
    )
    if clock is not None:
        clock.lap("plan")
    eng = run_plan(CsrAdjacency.from_graph(g), qu, qw, plan, level=level)
    if clock is not None:
        clock.lap("probe")
    return TCResult(
        triangles=eng.c1 + eng.c2 // 3,
        c1=eng.c1,
        c2=eng.c2,
        num_horizontal=n_h,
        k=k,
        levels=level,
        probe_rows=plan.probe_rows,
        probe_cells=float(np.float32(plan.probe_cells)),
        peak_rows=plan.peak_rows,
        h_overflow=(n_h > h_used) | eng.overflow,
        plan=plan,
    )


def triangle_count_dense(g: Graph, *, d_max: int, root: int = 0) -> TCResult:
    """Seed reference: probe ALL ``num_slots`` directed edge slots at the
    global ``d_max`` width, non-horizontal rows sentinel-masked.

    Candidates are clamped to ``d_max`` and the membership search runs
    ``ceil(log2(d_max + 1))`` steps over the unclamped larger list, so a
    ``d_max`` below the true max degree also under-searches large
    endpoints — the seed artifact the reference keeps for fidelity."""
    n = g.n_nodes
    level, _ = bfs_levels_iters(g.src, g.dst, n, root,
                                row_offsets=g.row_offsets)
    horiz = horizontal_mask(g.src, g.dst, level, n)
    eu, ew, und = undirected_edges(g)
    use = und & horiz
    qu = torch.where(use, eu, n)
    qw = torch.where(use, ew, n)
    adj = CsrAdjacency.from_graph(g)
    s_s, l_s, s_l, l_l, lev_u = probe_operands(
        adj, qu, qw, (*adj.bounds(qu), *adj.bounds(qw)), 0, g.num_slots,
        level,
    )
    c1r, c2r = split_counts(
        adj.flat, s_s, l_s, s_l, l_l, level, lev_u,
        d_cand=d_max, num_steps=search_steps(d_max),
    )
    c1 = c1r.sum(dtype=torch.int32)
    c2 = c2r.sum(dtype=torch.int32)
    return TCResult(
        triangles=c1 + c2 // 3,
        c1=c1,
        c2=c2,
        num_horizontal=use.sum(dtype=torch.int32),
        k=k_fraction(g.src, g.dst, level, n),
        levels=level,
        probe_rows=g.num_slots,
        probe_cells=float(np.float32(float(g.num_slots) * d_max)),
        peak_rows=g.num_slots,
        h_overflow=torch.zeros((), dtype=torch.bool, device=g.device),
    )
