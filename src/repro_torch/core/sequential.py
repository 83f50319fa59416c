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

The batch route (``_triangle_count_batch``) runs B budget-padded lanes
of a ``GraphBatch`` through the same steps with a leading lane axis —
one BFS loop and one compaction for all lanes — and probes them with
ONE plan that covers every lane (``run_plan`` over a ``LaneView``: one
K1 or K2 launch per bucket slice for all lanes).  Two planning modes:

* **exact**: the pooled degree profile (a per-row max over the lanes'
  descending profiles, itself descending) comes to the host in one
  sync and ``plan_buckets`` lays out the plan;
* **bounded** (``plan=batch_plan_for(gb)``): a plan from the batch's
  quantized ``BatchDegreeMeta``, made before the BFS and kept in an
  LRU ``PlanCache`` — the serving path (``launch/serve_tc.py``), with
  no host sync besides the BFS's one per sweep.

``triangle_count_dense`` / ``find_triangles_dense`` are the seed's
golden reference: every directed slot probed at the global ``d_max``
width, non-horizontal rows masked.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bfs import bfs_levels_batch, bfs_levels_iters
from repro_torch.core.edges import (
    horizontal_mask,
    horizontal_queries,
    k_fraction,
)
from repro_torch.core.hostio import HOST_IO, note_read_back
from repro_torch.core.intersect import (
    CsrAdjacency,
    IntersectPlan,
    LaneView,
    PlanBucket,
    bucket_slices,
    hit_chunks,
    plan_buckets,
    plan_buckets_bounded,
    probe_operands,
    resolve_backend,
    run_plan,
)
from repro_torch.graph.csr import (
    Graph,
    GraphBatch,
    max_degree,
    undirected_edges,
)
from repro_torch.kernels.intersect.intersect import LAUNCHES


@dataclasses.dataclass(frozen=True)
class TCResult:
    """Raw count result; tensors live on the graph's device.  A batch's
    result has a leading lane axis on every tensor (``levels`` is ``[B,
    n_budget]``, ``per_vertex`` ``[B, n_budget]``); the plan work counts
    stay scalar, since every lane runs the same plan."""

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


def _io_marks() -> tuple[int, int, int]:
    """``(host syncs, read-back bytes, intersect launches)`` so far in
    this process."""
    return (HOST_IO["syncs"], HOST_IO["d2h_bytes"],
            sum(LAUNCHES.values()))


class StageClock:
    """Per-stage wall seconds of one count, each stage closed by a device
    synchronize so the time is the device's, not the enqueue's.  Passed
    in by a caller that wants the split; the count does not sync per
    stage without one.

    ``start()`` opens a stage and ``lap(stage)`` closes it.  Besides its
    seconds, each lap records into ``counts`` the stage's host waits,
    read-back bytes (``core/hostio.py``) and K1/K2/K3 launches
    (``LAUNCHES``), under ``host_syncs.<stage>``,
    ``readback_bytes.<stage>`` and ``probe_launches.<stage>``, and adds
    them to the answer's totals ``host_syncs``, ``readback_bytes`` and
    ``probe_launches``.

    ``timeline`` keeps every lap, every :meth:`span` and the facade's
    ``count`` span as ``(name, begin_ns, end_ns)`` on ``time.time_ns()``,
    the clock of the profiler's raw device records, so a caller can line
    the stages up with a ``torch.profiler`` trace of the same answer."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.timeline: list[tuple[str, int, int]] = []
        self._t = time.perf_counter()
        self._ns = time.time_ns()
        self._io = _io_marks()

    def start(self) -> None:
        self._sync()
        self._t = time.perf_counter()
        self._ns = time.time_ns()
        self._io = _io_marks()

    def lap(self, stage: str) -> None:
        self._sync()
        now = time.perf_counter()
        now_ns = time.time_ns()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self.timeline.append((stage, self._ns, now_ns))
        io = _io_marks()
        for key, a, b in zip(("host_syncs", "readback_bytes",
                              "probe_launches"), self._io, io):
            for k in (key, f"{key}.{stage}"):
                self.counts[k] = self.counts.get(k, 0) + b - a
        self._t, self._ns, self._io = now, now_ns, io

    @contextlib.contextmanager
    def span(self, name: str):
        """A host-only span, with no synchronize: kept on ``timeline``;
        a dotted name (``plan.host``) is a part of the stage before its
        dot and its seconds also go into ``seconds``, where undotted
        keys stay the stages that tile the answer."""
        t, ns = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.timeline.append((name, ns, time.time_ns()))
            if "." in name:
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _nested(clock: Optional[StageClock], name: str):
    """``clock.span(name)``, or nothing without a clock."""
    return contextlib.nullcontext() if clock is None else clock.span(name)


def _exact_plan(g: Graph, o, backend: str, *,
                clock: Optional[StageClock] = None):
    """Shared plan pass of the exact path (counting and finding): BFS,
    horizontal compaction (descending by small-endpoint degree), the
    degree profile to the host in one sync, the exact plan.  Counterpart
    of the reference's ``_exact_batch_plan`` for one graph.

    Returns ``(level, qu, qw, n_h, k, h_used, h_dropped, plan)``: the
    plan covers the first ``h_used = min(cap_h, n_h)`` query rows and
    ``h_dropped`` is True iff ``cap_h`` cut real queries.  A ``clock``
    is started by the caller (``TriangleEngine._graph``), so ``bfs``
    begins where ``csr`` ended."""
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
    note_read_back(n_h)
    H = int(n_h.item())
    h_used = H if o.cap_h is None else min(int(o.cap_h), H)
    row_mult = int(o.query_chunk) if o.query_chunk else o.row_mult
    ds, dl = d_small[:h_used], d_large[:h_used]
    note_read_back(ds, dl)
    ds, dl = ds.cpu().numpy(), dl.cpu().numpy()
    with _nested(clock, "plan.host"):
        plan = plan_buckets(
            ds, dl,
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


# ----------------------------------------------------------------- batch


def _lane_plan(gview: Graph, root: int, clock: Optional[StageClock] = None):
    """Plan pass of a batch's lanes (``GraphBatch.lane_view()``): BFS
    levels, the desc-compacted, degree-sorted horizontal queries and the
    paper's k, each with a lane axis — one BFS loop (one host sync a
    sweep for all lanes) and one compaction."""
    level, sweeps = bfs_levels_batch(gview.src, gview.dst, gview.n_nodes,
                                     root, row_offsets=gview.row_offsets)
    if clock is not None:
        clock.lap("bfs")
        clock.counts["bfs_sweeps"] = sweeps
    qu, qw, d_small, d_large, n_h = horizontal_queries(gview, level,
                                                       order="desc")
    k = k_fraction(gview.src, gview.dst, level, gview.n_nodes)
    if clock is not None:
        clock.lap("compact")
    return level, qu, qw, d_small, d_large, n_h, k


def _plan_batch(gview: Graph, root: int, clock: Optional[StageClock] = None):
    """The plan pass and the pooled profile: the per-row max over the
    lanes' descending profiles is itself descending, so it is one
    profile that bounds every lane row by row."""
    level, qu, qw, ds, dl, n_h, k = _lane_plan(gview, root, clock)
    return level, qu, qw, ds.max(0).values, dl.max(0).values, n_h, k


def _exact_batch_plan(gview: Graph, o, backend: str, *,
                      clock: Optional[StageClock] = None):
    """The exact path's plan pass for a batch: the pooled profile and the
    largest lane's ``n_h`` to the host in ONE sync, then the exact plan
    covering the first ``h_used = min(cap_h, max n_h)`` rows of every
    lane.  Returns ``(level, qu, qw, n_h, k, h_used, h_dropped, plan)``
    with a lane axis on the tensors."""
    level, qu, qw, ds_pool, dl_pool, n_h, k = _plan_batch(
        gview, int(o.root), clock)
    S = ds_pool.shape[0]
    host = torch.cat([ds_pool, dl_pool, n_h.max().reshape(1)])
    note_read_back(host)
    host = host.cpu().numpy()
    H = int(host[-1])
    h_used = H if o.cap_h is None else min(int(o.cap_h), H)
    row_mult = int(o.query_chunk) if o.query_chunk else o.row_mult
    with _nested(clock, "plan.host"):
        plan = plan_buckets(
            host[:h_used], host[S:S + h_used],
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


def _run_batch(gb: GraphBatch, qu, qw, level, plan: IntersectPlan,
               per_vertex: bool = False,
               clock: Optional[StageClock] = None):
    """Probe a batch's ``[B, rows]`` query blocks with one shared plan:
    ``run_plan`` over the batch's ``LaneView`` (one probe per bucket
    slice for all lanes).  Returns the engine's per-lane counts and,
    with ``per_vertex``, the credit as ``[B, n_budget]``."""
    view = LaneView.from_batch(gb)
    eng = run_plan(view.adj, view.ids(qu), view.ids(qw), plan,
                   level=view.levels(level), per_vertex=per_vertex,
                   clock=clock)
    if per_vertex:
        eng = eng._replace(per_vertex=view.lane_credit(eng.per_vertex))
    return eng


def _tc_batch_fused(gb: GraphBatch, plan: IntersectPlan, root: int,
                    per_vertex: bool = False,
                    clock: Optional[StageClock] = None):
    """The serving path: BFS, compaction and the probe with a plan known
    before the BFS (the bounded plan cache).  The count makes no host
    sync besides the BFS's one per sweep; with ``per_vertex`` each K2
    chunk also reads its size back."""
    level, qu, qw, _, _, n_h, k = _lane_plan(gb.lane_view(), root, clock)
    eng = _run_batch(gb, qu, qw, level, plan, per_vertex, clock)
    return level, n_h, k, eng


#: default bound of a plan cache: far above any serving grid (budgets x
#: widths x chunking), low enough that a sweep over many option sets
#: through one engine cannot grow the dict without bound
DEFAULT_PLAN_CACHE_CAPACITY = 256


class PlanCache:
    """Bounded LRU mapping for bounded ``IntersectPlan``s: ``get`` marks
    a key recent, inserting past ``capacity`` evicts the least recently
    used plan (``evictions`` counts them).  Eviction is a performance
    event only: planning is a pure function of the key.
    ``capacity=None`` leaves it unbounded."""

    def __init__(self, capacity: Optional[int] = DEFAULT_PLAN_CACHE_CAPACITY):
        if capacity is not None and int(capacity) <= 0:
            raise ValueError(f"capacity must be positive; got {capacity}")
        self.capacity = int(capacity) if capacity is not None else None
        self.evictions = 0
        self._d: dict = {}  # insertion-ordered; re-insert marks recency

    def get(self, key):
        plan = self._d.get(key)
        if plan is not None:  # touch: move to the recent end
            del self._d[key]
            self._d[key] = plan
        return plan

    def __setitem__(self, key, plan) -> None:
        self._d.pop(key, None)
        self._d[key] = plan
        while self.capacity is not None and len(self._d) > self.capacity:
            self._d.pop(next(iter(self._d)))
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def keys(self) -> list:
        """The cached keys, least recently used first."""
        return list(self._d)

    def clear(self) -> None:
        self._d.clear()
        self.evictions = 0


_BATCH_PLAN_CACHE = PlanCache()
_BATCH_PLAN_STATS = {"hits": 0, "misses": 0}


def batch_plan_for(gb: GraphBatch, *, options=None,
                   cache: Optional[PlanCache] = None,
                   stats: Optional[dict] = None) -> IntersectPlan:
    """The bounded plan of a packed batch, memoized on the host.

    ``plan_buckets_bounded`` lays it out from the batch's
    ``BatchDegreeMeta`` (upper bounds on every lane's query profile,
    known at pack time), so it is exact and needs no BFS.  The key is
    ``(budget, meta, options.plan_view(device))``; quantized metas make
    same-scale traffic share a key.  ``cache``/``stats`` let a
    ``TriangleEngine`` own its cache; the module's default cache serves
    other callers (``batch_plan_cache_stats``)."""
    if options is None:
        from repro_torch.api import TCOptions  # api imports this module

        options = TCOptions()
    if gb.meta is None:
        raise ValueError(
            "GraphBatch carries no degree metadata; pack it with "
            "from_edges_batch(with_meta=True) or plan exact "
            "(count_batch_raw without a plan)"
        )
    key_opts = options.plan_view(gb.device)
    cache = _BATCH_PLAN_CACHE if cache is None else cache
    stats = _BATCH_PLAN_STATS if stats is None else stats
    key = (gb.budget, gb.meta, key_opts)
    plan = cache.get(key)
    if plan is None:
        stats["misses"] += 1
        plan = plan_buckets_bounded(
            gb.meta.h_rows,
            d_pad=gb.meta.d_pad,
            exceed=gb.meta.exceed,
            bucket_widths=key_opts.bucket_widths,
            row_mult=key_opts.row_mult,
            backend=key_opts.backend,
            query_chunk=key_opts.query_chunk,
            sort_queries=False,  # lanes arrive desc-sorted from compaction
        )
        cache[key] = plan
    else:
        stats["hits"] += 1
    return plan


def batch_plan_cache_stats(reset: bool = False) -> dict:
    """``{"hits", "misses", "size", "evictions", "capacity"}`` of the
    module's default plan cache (an engine's own cache reports through
    ``TriangleEngine.plan_cache_stats``)."""
    out = dict(
        _BATCH_PLAN_STATS,
        size=len(_BATCH_PLAN_CACHE),
        evictions=_BATCH_PLAN_CACHE.evictions,
        capacity=_BATCH_PLAN_CACHE.capacity,
    )
    if reset:
        _BATCH_PLAN_STATS.update(hits=0, misses=0)
    return out


def _triangle_count_batch(gb: GraphBatch, o, *,
                          plan: Optional[IntersectPlan] = None,
                          clock: Optional[StageClock] = None) -> TCResult:
    """Count every lane of a ``GraphBatch`` — ``o`` is a
    ``repro_torch.api.TCOptions``.  Without ``plan`` the exact two-stage
    path runs (plan pass, one host sync, probe); with one (see
    ``batch_plan_for``) the fused path runs with the plan's own backend
    and chunking, and ``d_max``/``cap_h`` must be unset.  Each lane's
    result equals the graph's own count bit for bit; ``h_overflow[i]``
    is True iff ``cap_h`` dropped real queries of lane ``i``, lane ``i``
    has more queries than the plan covers, or it overflowed a bucket
    width.  A ``clock`` records the bfs, compact, plan (exact path) and
    probe stages."""
    backend = resolve_backend(o.backend, gb.device)
    per_vertex = bool(o.per_vertex)
    if plan is not None:
        if o.d_max is not None or o.cap_h is not None:
            raise ValueError(
                "d_max/cap_h only apply to exact planning; a precomputed "
                "plan fixes coverage and widths"
            )
        level, n_h, k, eng = _tc_batch_fused(gb, plan, int(o.root),
                                             per_vertex, clock)
        # coverage is the plan's contract: a lane with more horizontal
        # queries than the plan probes must flag, not undercount (a plan
        # from this batch's own meta covers it; a reused one may not)
        h_ovf = (n_h > plan.total_rows) | eng.overflow
    else:
        level, qu, qw, n_h, k, h_used, _, plan = _exact_batch_plan(
            gb.lane_view(), o, backend, clock=clock)
        eng = _run_batch(gb, qu, qw, level, plan, per_vertex, clock)
        h_ovf = (n_h > h_used) | eng.overflow
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
        h_overflow=h_ovf,
        per_vertex=eng.per_vertex,
        plan=plan,
    )


def _squeeze_lane(res: TCResult) -> TCResult:
    """Drop the lane axis of a B=1 result (the plan's scalars pass
    through)."""
    return dataclasses.replace(
        res, triangles=res.triangles[0], c1=res.c1[0], c2=res.c2[0],
        num_horizontal=res.num_horizontal[0], k=res.k[0],
        levels=res.levels[0], h_overflow=res.h_overflow[0],
        per_vertex=(res.per_vertex[0] if res.per_vertex is not None
                    else None),
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
