"""Algorithm 1 — sequential cover-edge triangle counting (and finding).

Counterpart of ``repro.core.sequential`` for one graph:

    1. BFS from a root -> levels L(v)
    2. mark horizontal edges  (L(u) == L(w)), compact and degree-sort them
    3. for each horizontal edge, intersect N(u) and N(w)
       c1 += apexes on a different level      (counted once)
       c2 += apexes on the same level         (counted thrice, Lemma 2)
    4. T = c1 + c2 // 3                       (Theorem 1)

The reference runs one graph as a B=1 lane of its batched pipeline,
which is bit-identical to the single-graph path by construction; the
port writes the single-graph path directly.  The plan pass
(``_exact_plan``, shared by counting and finding) pulls only the first
``n_h`` entries of the degree profile to the host (one sync for
``n_h``, one for the profile) and lays out the exact plan there.

With ``per_vertex`` the count also returns each vertex's triangle
count, and ``_find_triangles`` returns the triangles themselves; both
probe through the hit mask (K2 on the card).

``triangle_count_dense`` / ``find_triangles_dense`` are the seed's
golden reference: every directed slot probed at the global ``d_max``
width, non-horizontal rows masked.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
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
    PlanBucket,
    bucket_slices,
    hit_chunks,
    plan_buckets,
    probe_operands,
    resolve_backend,
    run_plan,
)
from repro_torch.graph.csr import Graph, max_degree, undirected_edges


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
    per_vertex: Optional[torch.Tensor] = None  # int32[n] exactly-once
    #   triangle credit per vertex (sum == 3 * triangles); None unless
    #   requested (always set on the dense reference path)
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


def _exact_plan(g: Graph, o, backend: str, *,
                clock: Optional[StageClock] = None):
    """Shared plan pass of the exact path (counting and finding): BFS,
    horizontal compaction (descending by small-endpoint degree), the
    degree profile to the host in one sync, the exact plan.  Counterpart
    of the reference's ``_exact_batch_plan`` for one graph.

    Returns ``(level, qu, qw, n_h, k, h_used, h_dropped, plan)``: the
    plan covers the first ``h_used = min(cap_h, n_h)`` query rows and
    ``h_dropped`` is True iff ``cap_h`` cut real queries."""
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
    return level, qu, qw, n_h, k, h_used, h_used < H, plan


def _triangle_count(g: Graph, o, *,
                    clock: Optional[StageClock] = None) -> TCResult:
    """Single-graph count — ``o`` is a ``repro_torch.api.TCOptions``.
    ``o.compact=False`` runs the dense seed reference instead.  With
    ``o.per_vertex`` the probe also credits every triangle to its three
    corners (``TCResult.per_vertex``)."""
    if not o.compact:
        dm = o.d_max if o.d_max is not None else max(1, max_degree(g))
        return triangle_count_dense(g, d_max=dm, root=int(o.root))
    backend = resolve_backend(o.backend, g.device)
    level, qu, qw, n_h, k, _, h_dropped, plan = _exact_plan(
        g, o, backend, clock=clock
    )
    eng = run_plan(CsrAdjacency.from_graph(g), qu, qw, plan, level=level,
                   per_vertex=bool(o.per_vertex), clock=clock)
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
        h_overflow=h_dropped | eng.overflow,
        per_vertex=(eng.per_vertex[:-1] if eng.per_vertex is not None
                    else None),
        plan=plan,
    )


def _dense_queries(g: Graph, d_max: int, root: int):
    """The dense reference's probe: levels, every directed slot as a query
    row (non-horizontal rows sentinel-masked), and a one-bucket plan at
    the global ``d_max`` width on the plain probe — candidates clamped to
    ``d_max``, a ``ceil(log2(d_max + 1))``-step search over the
    unclamped larger list."""
    n = g.n_nodes
    level, _ = bfs_levels_iters(g.src, g.dst, n, root,
                                row_offsets=g.row_offsets)
    horiz = horizontal_mask(g.src, g.dst, level, n)
    eu, ew, und = undirected_edges(g)
    use = und & horiz
    qu = torch.where(use, eu, n)
    qw = torch.where(use, ew, n)
    rows = g.num_slots
    plan = IntersectPlan(
        buckets=(PlanBucket(0, rows, rows, int(d_max), int(d_max)),)
        if rows else (),
        backend="torch",
    )
    return level, use, qu, qw, plan


def triangle_count_dense(g: Graph, *, d_max: int, root: int = 0) -> TCResult:
    """Seed reference: probe ALL ``num_slots`` directed edge slots at the
    global ``d_max`` width, non-horizontal rows sentinel-masked.

    Candidates are clamped to ``d_max`` and the membership search runs
    ``ceil(log2(d_max + 1))`` steps over the unclamped larger list, so a
    ``d_max`` below the true max degree also under-searches large
    endpoints — the seed artifact the reference keeps for fidelity.  As
    a reference it always computes the per-vertex credit."""
    n = g.n_nodes
    level, use, qu, qw, plan = _dense_queries(g, d_max, root)
    eng = run_plan(CsrAdjacency.from_graph(g), qu, qw, plan, level=level,
                   per_vertex=True)
    return TCResult(
        triangles=eng.c1 + eng.c2 // 3,
        c1=eng.c1,
        c2=eng.c2,
        num_horizontal=use.sum(dtype=torch.int32),
        k=k_fraction(g.src, g.dst, level, n),
        levels=level,
        probe_rows=g.num_slots,
        probe_cells=float(np.float32(float(g.num_slots) * d_max)),
        peak_rows=g.num_slots,
        h_overflow=torch.zeros((), dtype=torch.bool, device=g.device),
        per_vertex=eng.per_vertex[:n],
    )


# ----------------------------------------------------------------- find


def _emit_mask(qu, qw, row, cand, level):
    """Emission mask over a hit list: a hit whose apex is on another
    level than the edge is that triangle's only sighting and is kept; an
    all-same-level triangle {u, w, v} is seen at each of its three
    horizontal edges, so only the sighting with ``v > max(u, w)`` — the
    smallest pair's edge — is kept."""
    u, w = qu[row], qw[row]
    same = level[cand] == level[u]
    return ~same | (cand > torch.maximum(u, w))


def _find_block(adj: CsrAdjacency, qu, qw, bounds, base, b: PlanBucket, *,
                level, backend, clock=None):
    """Yield the emitted triangles ``int32[t, 3]`` (rows ``(u, w,
    apex)``) of one slice of bucket rows, chunk after chunk, row-major
    over ``(row, candidate)`` — the order of the reference's cumsum
    compaction."""
    ops = probe_operands(adj, qu, qw, bounds, base, b.count, level)
    for row, cand in hit_chunks(adj, ops, d_cand=b.d_cand, d_targ=b.d_targ,
                                backend=backend, clock=clock):
        keep = _emit_mask(qu, qw, row, cand, level)
        row, cand = row[keep], cand[keep]
        yield torch.stack([qu[row], qw[row], cand], dim=1)


def _find_plan(g: Graph, level, qu, qw, plan, *, max_triangles: int,
               clock=None):
    """Run a plan's find: ``(tri int32[max_triangles, 3], count)``.
    Triangles are taken bucket after bucket, chunk after chunk, into the
    buffer until it is full; ``count`` counts them all."""
    out = torch.full((max_triangles, 3), -1, dtype=torch.int32,
                     device=g.device)
    off = total = 0
    adj = CsrAdjacency.from_graph(g)
    for b, base, qu_c, qw_c, bounds in bucket_slices(adj, qu, qw, plan):
        for tri in _find_block(adj, qu_c, qw_c, bounds, base, b,
                               level=level, backend=plan.backend,
                               clock=clock):
            c = tri.shape[0]
            take = min(c, max_triangles - off)
            if take > 0:
                out[off:off + take] = tri[:take]
                off += take
            total += c
            if clock is not None:
                clock.lap("emit")
    return out, torch.tensor(total, dtype=torch.int32, device=g.device)


def _find_triangles(g: Graph, o, *, max_triangles: int,
                    clock: Optional[StageClock] = None):
    """Triangle finding — ``o`` is a ``repro_torch.api.TCOptions``:
    ``(tri int32[max_triangles, 3], count int32)`` on the graph's device.

    Rows past ``count`` (or past the buffer, when ``count`` exceeds it)
    are -1.  Each triangle appears once (``_emit_mask``), in the
    reference's order: bucket after bucket in plan order, row-major
    within a bucket.  A ``cap_h`` that drops real horizontal queries
    truncates the list and warns.  ``o.compact=False`` runs the dense
    reference."""
    if not o.compact:
        dm = o.d_max if o.d_max is not None else max(1, max_degree(g))
        return find_triangles_dense(g, d_max=dm,
                                    max_triangles=max_triangles,
                                    root=int(o.root))
    backend = resolve_backend(o.backend, g.device)
    level, qu, qw, _, _, _, h_dropped, plan = _exact_plan(
        g, o, backend, clock=clock
    )
    if h_dropped:
        warnings.warn(
            f"find_triangles: cap_h={o.cap_h} dropped horizontal queries — "
            "the returned triangle list is incomplete",
            stacklevel=2,
        )
    return _find_plan(g, level, qu, qw, plan, max_triangles=max_triangles,
                      clock=clock)


def find_triangles_dense(g: Graph, *, d_max: int, max_triangles: int,
                         root: int = 0):
    """Seed reference for triangle finding: the dense reference's probe
    (``triangle_count_dense``), triangles emitted in slot order."""
    level, _, qu, qw, plan = _dense_queries(g, d_max, root)
    return _find_plan(g, level, qu, qw, plan, max_triangles=max_triangles)
