"""The neighbourhood-intersection engine: plan once, execute many.

Counterpart of ``repro.core.intersect`` for the exact local count, its
per-vertex credit and triangle finding:

* **Adjacency views.**  ``CsrAdjacency`` reads a ``Graph``'s CSR arrays
  and ``PairListAdjacency`` Algorithm 2's lex-sorted ``(owner, value)``
  pairs; each exposes ``bounds(v) -> (starts, lens)`` into one flat
  sorted array.
* **Plans.**  ``plan_buckets`` (exact, from a degree profile) and
  ``plan_buckets_bounded`` (from upper bounds known before the BFS, the
  batch route's cached plans) — host numpy, verbatim from the
  reference, so the plan work counts match — lay out contiguous
  query-row buckets, each with a row count and candidate/target widths.
* **Execution.**  ``run_plan`` probes each bucket — whole, or in
  ``query_chunk`` slices — through one of two backends, after sorting
  the block by descending min-degree when the plan asks
  (``sort_queries``, Algorithm 2's blocks):

  - ``"cuda"``: the Hopper kernel K1 (``kernels/intersect``), which reads
    the candidate and target slices straight from the CSR array, clamped
    to the bucket widths as the reference's dense gather clamps them;
  - ``"torch"``: the reference's ``jnp`` probe in plain PyTorch — a dense
    candidate gather and a bounded binary search of
    ``ceil(log2(d_targ + 1))`` steps over the *unclamped* target slice,
    which under-searches when ``d_targ`` is too small, exactly as the
    reference does.

  The two agree on every exact plan: ``plan_buckets`` sizes ``d_targ``
  to at least every large degree of its bucket.

* **Lanes.**  ``run_plan`` also runs a batch: given ``[B, rows]`` query
  blocks over a :class:`LaneView` (the batch's B CSRs numbered as one),
  each bucket slice is ONE probe over its ``B * rows`` rows, and the
  counts and overflow are reduced per lane — the counterpart of the
  reference's ``vmap`` of ``run_plan``.  BFS, compaction and planning
  stay per lane; only the probe sees one index space.

* **Level-free probes.**  Without ``level`` (the stream route's batch
  deltas, Algorithm 2's hedge rounds) every hit counts once: ``c1`` is the raw hit total and ``c2``
  is 0.  The ``cuda`` backend counts with K3, the Hopper port of
  ``intersect_pallas_count``.

* **Hits.**  Per-vertex credit and finding need the membership mask
  itself, not its counts, so there the ``cuda`` backend switches from K1
  or K3 to K2 (the ragged hit mask), as the reference switches from
  ``intersect_pallas`` to ``intersect_pallas_hits``.  The mask is
  ragged — only each row's real candidates — and is turned into a hit
  list ``(row, candidate id)`` chunk by chunk, each chunk at most
  ``HIT_CELL_BUDGET`` candidate cells, in plan order.

* **Edge membership.**  ``edge_exists`` answers "is ``(u, v)`` an edge"
  by a bounded binary search of ``u``'s row in plain torch ops (the
  reference's is a ``jnp`` search, no Pallas kernel): the wedge
  baseline's closing-edge check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.graph.csr import (
    Graph,
    GraphBatch,
    _ceil_to,
    _next_pow2,
    bounded_binary_search,
    gather_rows,
)
from repro_torch.graph.segment import segment_sum
from repro_torch.kernels.intersect.intersect import (
    intersect_count,
    intersect_hits,
    intersect_levels,
)
from repro_torch.kernels.intersect.ref import (
    CAND_PAD,
    found_counts,
    probe_hits,
    search_steps,
    split_counts,
)

#: Default small-endpoint-degree bucket boundaries: queries whose smaller
#: endpoint has degree <= w probe at candidate width w (plus an implicit
#: top bucket at the max/capped width).
DEFAULT_BUCKET_WIDTHS = (32, 256)

BACKENDS = ("auto", "torch", "cuda")

#: Most candidate cells one hit-mask probe covers (one K2 launch on the
#: card): the mask costs a byte per cell and its hit list ~24 bytes per
#: hit, so this bounds a chunk's memory to a few GB.
HIT_CELL_BUDGET = 1 << 28

# --------------------------------------------------------------- views


@dataclasses.dataclass(frozen=True)
class CsrAdjacency:
    """Adjacency view over a ``Graph``'s CSR arrays (Algorithm 1).

    ``flat`` is the CSR neighbour array (``g.dst``); vertex ``v``'s sorted
    neighbour list is ``flat[row_offsets[v] : row_offsets[v] + deg[v]]``.
    """

    flat: torch.Tensor
    row_offsets: torch.Tensor
    deg: torch.Tensor
    n_nodes: int

    @classmethod
    def from_graph(cls, g: Graph) -> "CsrAdjacency":
        return cls(flat=g.dst, row_offsets=g.row_offsets, deg=g.deg,
                   n_nodes=g.n_nodes)

    def bounds(self, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(starts, lens)`` of each vertex's slice of ``flat``; any
        ``v >= n_nodes`` (sentinel) gets length 0."""
        n = self.n_nodes
        vc = v.clamp(0, n)
        deg_ext = torch.cat([
            self.deg,
            torch.zeros((1,), dtype=torch.int32, device=self.deg.device),
        ])
        return self.row_offsets[vc], torch.where(v < n, deg_ext[vc], 0)


@dataclasses.dataclass(frozen=True)
class PairListAdjacency:
    """Adjacency view over lex-sorted ``(owner, value)`` pairs — the shard
    Algorithm 2 receives from its all-to-all transpose
    (``core/sampling.py:repartition_by_value``).

    ``owners`` is sorted ascending (padding owners sort last: the
    sentinel exceeds every real vertex id) and ``values`` is co-sorted,
    so the sublist of vertex ``v`` is a contiguous, sorted slice found by
    two ``searchsorted`` probes.  ``flat`` is ``values``: the kernels
    read it as they read a CSR array."""

    owners: torch.Tensor
    values: torch.Tensor
    n_nodes: int

    @property
    def flat(self) -> torch.Tensor:
        return self.values

    def bounds(self, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(starts, lens)`` of each vertex's sublist; any ``v >=
        n_nodes`` (sentinel or transpose padding) gets length 0."""
        owners = self.owners.contiguous()
        vv = v.contiguous()
        lo = torch.searchsorted(owners, vv, right=False, out_int32=True)
        hi = torch.searchsorted(owners, vv, right=True, out_int32=True)
        return lo, torch.where(v < self.n_nodes, hi - lo, 0)


# --------------------------------------------------------------- plans


@dataclasses.dataclass(frozen=True)
class PlanBucket:
    """One contiguous query-row range probed at one width pair.

    ``[start, start + rows)`` are the rows sliced from the query block;
    the first ``count`` are real queries, rows past ``count`` are masked.
    ``d_cand`` is the candidate width (smaller endpoint), ``d_targ`` the
    target width / binary-search depth (larger endpoint).
    """

    start: int
    count: int
    rows: int
    d_cand: int
    d_targ: int


@dataclasses.dataclass(frozen=True)
class IntersectPlan:
    """A hashable execution plan for one query-block layout, produced on
    the host once (``plan_buckets`` / ``plan_buckets_bounded``) and
    executed by ``run_plan``.  ``sort_queries`` asks the run to sort the
    block by descending min-degree first (Algorithm 2's blocks, which
    the host could not sort)."""

    buckets: tuple[PlanBucket, ...]
    backend: str = "torch"
    query_chunk: int | None = None
    sort_queries: bool = False

    @property
    def total_rows(self) -> int:
        return max((b.start + b.rows for b in self.buckets), default=0)

    @property
    def probe_rows(self) -> int:
        return sum(b.rows for b in self.buckets)

    @property
    def probe_cells(self) -> float:
        return float(sum(float(b.rows) * b.d_cand for b in self.buckets))

    @property
    def peak_rows(self) -> int:
        return max(
            (min(b.rows, self.query_chunk or b.rows) for b in self.buckets),
            default=0,
        )


def plan_buckets(
    ds_h,
    dl_h,
    *,
    bucket_widths: tuple[int, ...] = DEFAULT_BUCKET_WIDTHS,
    d_cap: int | None = None,
    row_mult: int = 64,
    backend: str = "torch",
    query_chunk: int | None = None,
    layout: str = "asc",
) -> IntersectPlan:
    """Exact host-side plan from a known per-query degree profile.

    ``ds_h``/``dl_h`` are the small/large endpoint degrees of the real
    queries, sorted by ``ds_h`` in the direction named by ``layout``
    (``"asc"`` or ``"desc"``).  Buckets are contiguous ``searchsorted``
    ranges; ``d_cand`` is the bucket's width boundary (clamped to
    ``d_cap`` if given — a lossy candidate-list cap), ``d_targ`` the
    widest larger-endpoint list in the bucket, 128-aligned.  Widths are
    rounded (pow2 top, 128-aligned ``d_targ``, ``row_mult``-padded rows)
    as in the reference, so the plan work counts match it.
    """
    if layout not in ("asc", "desc"):
        raise ValueError(f"layout must be 'asc' or 'desc'; got {layout!r}")
    ds_h = np.asarray(ds_h)
    dl_h = np.asarray(dl_h)
    H = int(ds_h.shape[0])
    buckets = []
    if H:
        d_top = int(ds_h[-1] if layout == "asc" else ds_h[0])
        top = _next_pow2(max(d_top, 1))
        if d_cap is not None:
            top = min(top, int(d_cap))
        widths = sorted(
            w for w in {int(w) for w in bucket_widths} if 0 < w < top
        )
        widths.append(top)
        if layout == "asc":
            bounds = [
                int(np.searchsorted(ds_h, w, side="right"))
                for w in widths[:-1]
            ] + [H]
        else:
            # rows with d_small > w form a prefix of the descending block
            asc = ds_h[::-1]
            bounds = [
                H - int(np.searchsorted(asc, w, side="right"))
                for w in widths[:-1]
            ] + [0]
        start = H if layout == "desc" else 0
        for w, b in zip(widths, bounds):
            lo, hi = (b, start) if layout == "desc" else (start, b)
            start = b
            if hi <= lo:
                continue
            buckets.append(PlanBucket(
                start=lo,
                count=hi - lo,
                rows=_ceil_to(hi - lo, row_mult),
                d_cand=w,
                d_targ=_ceil_to(int(dl_h[lo:hi].max()), 128),
            ))
    return IntersectPlan(
        buckets=tuple(buckets), backend=backend, query_chunk=query_chunk,
    )


def plan_buckets_bounded(
    total_rows: int,
    *,
    d_pad: int,
    exceed: tuple[tuple[int, int], ...] | None = None,
    bucket_widths: tuple[int, ...] = DEFAULT_BUCKET_WIDTHS,
    row_mult: int = 1,
    backend: str = "torch",
    query_chunk: int | None = None,
    sort_queries: bool | None = None,
) -> IntersectPlan:
    """Safe plan when the per-query degree profile is known only as
    upper bounds: the batch route's cached plans, whose bounds come from
    a ``BatchDegreeMeta`` (``core.sequential.batch_plan_for``).

    ``exceed`` holds ``(width, bound)`` pairs: for each candidate width,
    an upper bound on how many queries of any block this plan runs have
    min-endpoint degree above it.  Buckets are laid out widest-first and
    sized from those bounds, so on a block sorted by descending
    min-degree every query lands in a bucket at least as wide as its
    candidate list; a violated bound flags ``overflow`` in the run
    instead of miscounting.  ``exceed=None`` is one ``d_pad``-wide
    bucket.  ``sort_queries=None`` asks the run to sort the block when
    the plan has more than one bucket; the batch route passes ``False``
    (its lanes arrive sorted from the compaction).
    """
    T = _ceil_to(int(total_rows), row_mult) if total_rows > 0 else 0
    if T == 0:
        return IntersectPlan((), backend=backend, query_chunk=query_chunk)
    if sort_queries is None:
        sort_queries = True  # resolved to len(buckets) > 1 below
    top = int(d_pad)
    bound = dict(exceed or ())
    widths = sorted(
        w for w in {int(w) for w in bucket_widths}
        if 0 < w < top and w in bound
    )
    widths.append(top)  # ascending, widest last
    buckets = []
    used = 0
    for i in range(len(widths) - 1, -1, -1):  # allocate widest-first
        w = widths[i]
        if i == 0:
            rows = T - used  # narrowest bucket absorbs the remainder
        else:
            # every query with min-degree > widths[i-1] must rank before
            # this bucket's end — size it so cumulative rows cover the bound
            need = int(bound[widths[i - 1]])
            need_rows = _ceil_to(need, row_mult) if need > 0 else 0
            rows = min(T - used, max(0, need_rows - used))
        if rows <= 0:
            continue
        buckets.append(PlanBucket(
            start=used, count=rows, rows=rows, d_cand=w, d_targ=top,
        ))
        used += rows
    return IntersectPlan(
        buckets=tuple(buckets), backend=backend, query_chunk=query_chunk,
        sort_queries=bool(sort_queries) and len(buckets) > 1,
    )


# ----------------------------------------------------------- execution


class EngineCounts(NamedTuple):
    """``run_plan`` result: the paper's diff-level / same-level apex
    splits ``(c1, c2)`` as int32 scalar tensors, ``overflow`` (bool
    tensor), True iff some real query's candidate (or target) list
    exceeded its bucket width — exact plans set it only under an explicit
    ``d_cap``/``d_max`` clamp — and, with ``per_vertex``, the credit
    int32[n + 1] (slot ``n`` is the throwaway of sentinel rows)."""

    c1: torch.Tensor
    c2: torch.Tensor
    overflow: torch.Tensor
    per_vertex: Optional[torch.Tensor] = None


def _swapped_bounds(su, lu, sw, lw, row_ok):
    """Per-query (small-side, large-side) slice bounds from the two
    endpoints' bounds, probing from the smaller list; masked rows probe
    nothing."""
    swap = lw < lu
    s_s = torch.where(swap, sw, su)
    l_s = torch.where(row_ok, torch.where(swap, lw, lu), 0)
    s_l = torch.where(swap, su, sw)
    l_l = torch.where(row_ok, torch.where(swap, lu, lw), 0)
    return s_s, l_s, s_l, l_l


def probe_operands(adj: CsrAdjacency, qu, qw, bounds, base: int, count: int,
                   level: Optional[torch.Tensor], *, lanes: int = 1):
    """The kernel operands of one slice of bucket rows: ``(s_s, l_s, s_l,
    l_l, lev_u)``.  ``base`` is the slice's offset within its bucket
    (rows at or past ``count`` are masked), ``bounds`` the slice's
    ``(su, lu, sw, lw)`` endpoint bounds; ``lev_u`` is None without
    ``level``.  Over a lane view the slice is ``lanes`` lanes' rows one
    after another, each lane's offset counted from ``base``."""
    n = adj.n_nodes
    pos = base + torch.arange(qu.shape[0] // lanes, dtype=torch.int32,
                              device=qu.device).repeat(lanes)
    row_ok = (pos < count) & (qu < n) & (qw < n)
    s_s, l_s, s_l, l_l = _swapped_bounds(*bounds, row_ok)
    if level is None:
        return s_s, l_s, s_l, l_l, None
    lev_ext = torch.cat([
        level, torch.full((1,), -9, dtype=torch.int32, device=level.device)
    ])
    lev_u = lev_ext[qu.clamp(0, n)]
    return s_s, l_s, s_l, l_l, lev_u


def _probe_rows(adj: CsrAdjacency, s_s, l_s, s_l, l_l, *, d_cand, d_targ,
                backend):
    """One hit-mask probe: the ragged ``(offsets int64[Q + 1], hits
    bool[offsets[-1]])`` of rows ``flat[s_s : s_s + min(l_s, d_cand)]``
    against their targets.  ``"cuda"`` is K2 over the target clamped to
    ``d_targ``; ``"torch"`` the reference's jnp probe, a bounded search
    of ``search_steps(d_targ)`` steps over the *unclamped* target."""
    if backend == "cuda":
        return intersect_hits(adj.flat, s_s, l_s, s_l, l_l,
                              d_cand=d_cand, d_targ=d_targ)
    return probe_hits(adj.flat, s_s, l_s, s_l, l_l, d_cand=d_cand,
                      num_steps=search_steps(d_targ))


def hit_list(flat, s_s, offsets, hits):
    """The ragged mask as a hit list ``(row int64[H], cand int32[H])``,
    row-major (row by row, candidates in order): each hit's row and its
    candidate ``flat[s_s[row] + j]``."""
    pos = hits.nonzero().squeeze(1)
    row = torch.searchsorted(offsets[1:], pos, right=True)
    return row, flat[s_s[row].long() + (pos - offsets[row])]


def cell_chunks(l_s, *, d_cand: int):
    """Row ranges ``[(r0, r1), ...]`` covering ``l_s`` in order, each of
    at most ``HIT_CELL_BUDGET + d_cand`` clamped candidate cells (one
    host sync)."""
    budget = HIT_CELL_BUDGET
    q = l_s.shape[0]
    cum = torch.cumsum(l_s.clamp(0, max(0, d_cand)), 0, dtype=torch.int64)
    total = int(cum[-1].item()) if q else 0
    if total <= budget:
        return [(0, q)] if q else []
    marks = torch.arange(budget, total, budget, dtype=torch.int64,
                         device=l_s.device)
    cuts = [0, *torch.searchsorted(cum, marks, right=True).tolist(), q]
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]


def hit_chunks(adj: CsrAdjacency, ops, *, d_cand, d_targ, backend,
               clock=None):
    """Yield ``(row, cand)`` hit lists (:func:`hit_list`) of one slice of
    bucket rows, ``ops = (s_s, l_s, s_l, l_l, ...)``, chunk after chunk
    under the cell budget, in row-major order; ``row`` indexes the slice.
    A ``clock`` (``core.sequential.StageClock``) records the ``probe``
    and ``hit_list`` stages."""
    s_s, l_s, s_l, l_l = ops[:4]
    for r0, r1 in cell_chunks(l_s, d_cand=d_cand):
        offsets, hits = _probe_rows(
            adj, s_s[r0:r1], l_s[r0:r1], s_l[r0:r1], l_l[r0:r1],
            d_cand=d_cand, d_targ=d_targ, backend=backend,
        )
        if clock is not None:
            clock.lap("probe")
        row, cand = hit_list(adj.flat, s_s[r0:r1], offsets, hits)
        del offsets, hits
        if clock is not None:
            clock.lap("hit_list")
        yield row + r0, cand


def _ends_credit(n, end_rows, qu_c, qw_c):
    """Endpoint half of the exactly-once rule: ``end_rows`` hits per row
    credit both edge endpoints.  Sentinel endpoints (``n``) land in the
    throwaway slot ``n``."""
    return (segment_sum(end_rows, qu_c, n + 1)
            + segment_sum(end_rows, qw_c, n + 1))


def _chunk_credit(n, cand, end_rows, qu_c, qw_c):
    """int32[n + 1] per-vertex triangle credit of one probed chunk.

    Exactly-once rule: every hit credits its apex (the candidate it
    found); ``end_rows`` — per row, the hits whose triangle is seen ONLY
    at this horizontal edge (the diff-level hits under Algorithm 1) —
    additionally credits the edge endpoints ``qu``/``qw``.  Same-level
    hits credit the apex alone, because an all-same-level triangle
    surfaces once per corner across its three horizontal edges.

    Apex credit scatters each hit's candidate id directly (``cand``, the
    hit list's ids, all real vertices).  The reference's slot
    accumulator (``_apex_window_add`` + ``_apex_from_slots``) exists
    because of how XLA scatters; it adds the same integers."""
    apex = torch.zeros(n + 1, dtype=torch.int32, device=cand.device)
    apex.index_add_(0, cand.long(),
                    torch.ones_like(cand, dtype=torch.int32))
    return apex + _ends_credit(n, end_rows, qu_c, qw_c)


def _per_lane(x: torch.Tensor, lanes: Optional[int]) -> torch.Tensor:
    """Per-row ``x`` as ``[lanes, rows]`` over a lane view; one graph's
    rows stay 1-D (a reduction over the last axis then gives a 0-d
    total)."""
    return x if lanes is None else x.view(lanes, -1)


def _count_chunk(adj, qu, qw, bounds, base, count, *, d_cand, d_targ,
                 level, backend, per_vertex=False, clock=None, lanes=None):
    """Summed ``(c1, c2, overflow, credit)`` for one slice of bucket
    rows; ``credit`` is int32[n + 1] with ``per_vertex``, else None.
    With ``lanes`` (a lane view's slice, ``lanes`` lanes' rows one after
    another) c1, c2 and overflow are per lane, ``[lanes]``; else 0-d.

    Without ``per_vertex`` the ``cuda`` backend counts with K1 (K3 when
    ``level`` is None) and the ``torch`` backend with the jnp probe's
    counts.  With it, both go through the hit mask (K2 on the card) and
    c1/c2 are derived from the mask: a hit is same-level (c2) when its
    apex's level equals the edge's, else diff-level (c1).  Without
    ``level`` every hit is c1 and credits its apex and both edge
    endpoints (Algorithm 2's N-hat regime).  A ``clock`` records the
    per-vertex path's ``probe``, ``hit_list`` and ``credit`` stages."""
    s_s, l_s, s_l, l_l, lev_u = probe_operands(
        adj, qu, qw, bounds, base, count, level, lanes=lanes or 1
    )
    # the reference's width-overflow predicate (``_gather_cand_targ``):
    # some row's candidate or target list is longer than its width
    overflow = _per_lane((l_s > d_cand) | (l_l > d_targ), lanes).any(-1)
    if per_vertex:
        n = adj.n_nodes
        rpl = qu.shape[0] // (lanes or 1)
        shape = () if lanes is None else (lanes,)
        c1 = torch.zeros(shape, dtype=torch.int32, device=qu.device)
        c2 = torch.zeros(shape, dtype=torch.int32, device=qu.device)
        credit = torch.zeros(n + 1, dtype=torch.int32, device=qu.device)

        def tally(mask, row):
            """Hits of ``mask``, in total or per lane of their ``row``."""
            if lanes is None:
                return mask.sum(dtype=torch.int32)
            return segment_sum(mask.to(torch.int32), row // rpl, lanes)

        for row, cand in hit_chunks(adj, (s_s, l_s, s_l, l_l),
                                    d_cand=d_cand, d_targ=d_targ,
                                    backend=backend, clock=clock):
            ones = torch.ones_like(cand, dtype=torch.int32)
            if level is None:
                diff = torch.ones_like(cand, dtype=torch.bool)
            else:
                diff = level[cand] != lev_u[row]
            c1 = c1 + tally(diff, row)
            c2 = c2 + tally(~diff, row)
            diff_rows = segment_sum(ones[diff], row[diff], qu.shape[0])
            credit += _chunk_credit(n, cand, diff_rows, qu, qw)
            if clock is not None:
                clock.lap("credit")
        return c1, c2, overflow, credit
    if level is None:
        if backend == "cuda":
            cnt = intersect_count(adj.flat, s_s, l_s, s_l, l_l,
                                  d_cand=d_cand, d_targ=d_targ)
        else:
            cnt = found_counts(adj.flat, s_s, l_s, s_l, l_l, d_cand=d_cand,
                               num_steps=search_steps(d_targ))
        c1 = _per_lane(cnt, lanes).sum(-1, dtype=torch.int32)
        return c1, torch.zeros_like(c1), overflow, None
    if backend == "cuda":
        c1, c2 = intersect_levels(
            adj.flat, s_s, l_s, s_l, l_l, level, lev_u,
            d_cand=d_cand, d_targ=d_targ,
        )
    else:
        # the reference's jnp probe: search depth sized by d_targ over the
        # UNclamped target list (under-searches when d_targ is too small)
        c1, c2 = split_counts(
            adj.flat, s_s, l_s, s_l, l_l, level, lev_u,
            d_cand=d_cand, num_steps=search_steps(d_targ),
        )
    return (_per_lane(c1, lanes).sum(-1, dtype=torch.int32),
            _per_lane(c2, lanes).sum(-1, dtype=torch.int32), overflow, None)


def bucket_slices(adj: CsrAdjacency, qu, qw, plan: IntersectPlan):
    """Yield ``(bucket, base, qu, qw, bounds)`` for every slice
    ``run_plan`` probes, in its order: each bucket whole, or in
    ``query_chunk`` slices (the last slice of a bucket may be shorter;
    the sums do not depend on the slicing).  ``qu``/``qw`` are padded to
    the plan's total rows with the sentinel first and, for a
    ``sort_queries`` plan, sorted by descending min-degree.  Given
    ``[B, rows]`` blocks (a lane view's), each slice is the B lanes'
    rows one after another, flattened, and each lane is sorted on its
    own."""
    n = adj.n_nodes
    need = plan.total_rows
    if qu.shape[-1] < need:
        fill = torch.full((*qu.shape[:-1], need - qu.shape[-1]), n,
                          dtype=qu.dtype, device=qu.device)
        qu = torch.cat([qu, fill], -1)
        qw = torch.cat([qw, fill], -1)
    # endpoint bounds once per block, then sliced per bucket
    su, lu = adj.bounds(qu)
    sw, lw = adj.bounds(qw)
    if plan.sort_queries:
        # descending min-degree, invalid rows last; stable, as the
        # reference's argsort is, so credit and overflow see its order
        valid = (qu < n) & (qw < n)
        key = torch.where(valid, torch.minimum(lu, lw), -1)
        order = torch.sort(-key, dim=-1, stable=True).indices
        qu, qw, su, lu, sw, lw = (x.gather(-1, order)
                                  for x in (qu, qw, su, lu, sw, lw))
    for b in plan.buckets:
        chunk = min(plan.query_chunk or b.rows, b.rows)
        for base in range(0, b.rows, chunk):
            lo, hi = b.start + base, b.start + min(base + chunk, b.rows)
            qu_c, qw_c, *bounds = (x[..., lo:hi].reshape(-1)
                                   for x in (qu, qw, su, lu, sw, lw))
            yield b, base, qu_c, qw_c, tuple(bounds)


def run_plan(adj: CsrAdjacency, qu, qw, plan: IntersectPlan, *,
             level: Optional[torch.Tensor], per_vertex: bool = False,
             clock=None) -> EngineCounts:
    """Execute a bucket plan against an adjacency view (a
    :class:`CsrAdjacency`, a :class:`PairListAdjacency`, or a lane or
    shard view's).

    ``qu``/``qw`` are the query endpoints (entries ``>= adj.n_nodes`` are
    sentinels and never counted).  Coverage is the planner's contract:
    rows beyond ``plan.total_rows`` are not probed (that is how the
    sequential pipeline skips the non-horizontal tail and how ``cap_h``
    truncates).  A ``sort_queries`` plan sorts the block by descending
    min-degree first (:func:`bucket_slices`).  With ``level``, hits are
    split into the paper's ``(c1, c2)`` by apex level; with
    ``level=None`` every hit counts once into ``c1`` and ``c2`` is 0 (the
    stream route's probes and Algorithm 2's hedge rounds, after N-hat's
    dedup).  Sums are int32, as in the reference.

    Given ``[B, rows]`` query blocks in a :class:`LaneView`'s ids (and
    its levels), the plan covers every lane: each bucket slice is one
    probe over the B lanes' rows, and ``c1``, ``c2`` and ``overflow``
    come back per lane, ``[B]``.

    With ``per_vertex=True`` the same probe pass also returns triangle
    credit (:func:`_chunk_credit`), int32[n + 1]: slot ``n`` absorbs
    sentinel-row credit and is dropped by the caller, and
    ``sum(per_vertex[:n]) == 3 * triangles`` exactly (with ``level``;
    without it every hit credits all three corners).  A ``clock``
    (``core.sequential.StageClock``) splits that path's stages.
    """
    dev = qu.device
    n = adj.n_nodes
    lanes = qu.shape[0] if qu.dim() == 2 else None
    shape = () if lanes is None else (lanes,)
    c1 = torch.zeros(shape, dtype=torch.int32, device=dev)
    c2 = torch.zeros(shape, dtype=torch.int32, device=dev)
    ovf = torch.zeros(shape, dtype=torch.bool, device=dev)
    credit = (torch.zeros(n + 1, dtype=torch.int32, device=dev)
              if per_vertex else None)
    if qu.shape[-1] == 0 or not plan.buckets:
        return EngineCounts(c1, c2, ovf, credit)
    for b, base, qu_c, qw_c, bounds in bucket_slices(adj, qu, qw, plan):
        d1, d2, do, dc = _count_chunk(
            adj, qu_c, qw_c, bounds, base, b.count,
            d_cand=b.d_cand, d_targ=b.d_targ, level=level,
            backend=plan.backend, per_vertex=per_vertex, clock=clock,
            lanes=lanes,
        )
        c1, c2, ovf = c1 + d1, c2 + d2, ovf | do
        if per_vertex:
            credit += dc
    return EngineCounts(c1, c2, ovf, credit)


@dataclasses.dataclass(frozen=True)
class LaneView:
    """A batch's B CSRs numbered as one adjacency, built once per batch:
    vertex ``v`` of lane ``i`` is ``i * (n_budget + 1) + v``, its row
    offsets shift by ``i * slot_budget``, and each lane's sentinel
    ``n_budget`` becomes an isolated vertex of degree 0.  ``adj`` has
    ``B * (n_budget + 1)`` vertices; its own sentinel pads the plan's
    rows.

    This is an index view at the probe's boundary: every probe row reads
    only its own lane's slices, and K1's bitmap works over each target's
    own id span, so the shifted ids change none of its results.  BFS,
    compaction and planning stay per lane."""

    adj: CsrAdjacency
    lanes: int
    n_budget: int

    @classmethod
    def from_batch(cls, gb: GraphBatch) -> "LaneView":
        B, nb, S = gb.batch_size, gb.n_budget, gb.slot_budget
        dev = gb.device  # GraphBatch checked that the ids fit in int32
        lane = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
        flat = (gb.dst + lane * (nb + 1)).reshape(-1)
        row = (gb.row_offsets[:, :nb + 1] + lane * S).reshape(-1)
        row = torch.cat([row, torch.full((1,), B * S, dtype=torch.int32,
                                         device=dev)])
        deg = torch.cat([gb.deg, torch.zeros((B, 1), dtype=torch.int32,
                                             device=dev)], 1).reshape(-1)
        return cls(adj=CsrAdjacency(flat=flat, row_offsets=row, deg=deg,
                                    n_nodes=B * (nb + 1)),
                   lanes=B, n_budget=nb)

    def ids(self, v: torch.Tensor) -> torch.Tensor:
        """Lane-local ids ``[B, rows]`` (the lane sentinel included) as
        the view's ids."""
        lane = torch.arange(self.lanes, dtype=v.dtype, device=v.device)
        return v + (lane * (self.n_budget + 1))[:, None]

    def levels(self, level: torch.Tensor) -> torch.Tensor:
        """Per-lane levels ``[B, n_budget]`` as the view's flat levels
        (each lane's sentinel, never a candidate, at ``-9``)."""
        pad = torch.full((self.lanes, 1), -9, dtype=level.dtype,
                         device=level.device)
        return torch.cat([level, pad], 1).reshape(-1)

    def lane_credit(self, credit: torch.Tensor) -> torch.Tensor:
        """The view's credit ``int32[B * (n_budget + 1) + 1]`` as
        ``[B, n_budget]``: the view's sentinel slot and each lane's
        sentinel column dropped (the reference's ``[:, :-1]``)."""
        return credit[:-1].view(self.lanes, self.n_budget + 1)[:, :-1]


# ------------------------------------------------- probe-level wrappers


def resolve_backend(backend: str = "auto",
                    device: str | torch.device = "cpu") -> str:
    """The port's backend rule: ``"auto"`` is ``"cuda"`` (the Hopper
    kernel) on a CUDA device and ``"torch"`` (the plain probe) on the
    CPU.  ``"cuda"`` on the CPU raises; ``"torch"`` on the card runs only
    when asked for by name."""
    if backend not in BACKENDS:
        raise ValueError(
            f"intersect_backend must be 'auto', 'torch' or 'cuda'; "
            f"got {backend!r}"
        )
    dev = torch.device(device)
    if backend == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"backend 'cuda' launches the Hopper kernel and needs a CUDA "
            f"device; got {dev}"
        )
    return backend


def count_common_neighbors(
    g: Graph,
    qu: torch.Tensor,
    qw: torch.Tensor,
    level: torch.Tensor,
    *,
    d_cand: int,
    d_targ: int | None = None,
    backend: str = "torch",
    query_chunk: int | None = None,
):
    """Summed ``(c1, c2)`` (diff-level / same-level apex hits) over one
    fixed-width query block — a single-bucket ``run_plan``, kept as the
    stable block-level API.  ``query_chunk`` probes the rows in slices
    of that size (rows must be a multiple)."""
    backend = resolve_backend(backend, g.device)
    rows = qu.shape[0]
    chunk = rows if query_chunk is None else min(query_chunk, rows)
    if rows % chunk:
        raise ValueError(f"rows={rows} not a multiple of query_chunk={chunk}")
    plan = IntersectPlan(
        buckets=(PlanBucket(0, rows, rows, d_cand, d_targ or d_cand),),
        backend=backend, query_chunk=chunk,
    )
    eng = run_plan(CsrAdjacency.from_graph(g), qu, qw, plan, level=level)
    return eng.c1, eng.c2


def probe_block(g: Graph, qu: torch.Tensor, qw: torch.Tensor, *,
                d_cand: int, d_targ: int | None = None,
                backend: str = "torch"):
    """Backend-dispatched block probe, dense: ``(apexes int32[q, d_cand],
    found bool[q, d_cand])``.  Candidates come from the smaller-degree
    endpoint in CSR order, clamped to ``d_cand``; ``d_targ`` bounds the
    larger side's width and search depth (``None`` = ``d_cand``).
    Apexes are padded with ``n`` (the finding pipeline's convention).
    The dense form is for small blocks; the pipelines use the ragged
    mask."""
    backend = resolve_backend(backend, g.device)
    n = g.n_nodes
    adj = CsrAdjacency.from_graph(g)
    row_ok = (qu < n) & (qw < n)
    s_s, l_s, s_l, l_l = _swapped_bounds(*adj.bounds(qu), *adj.bounds(qw),
                                         row_ok)
    _, hits = _probe_rows(adj, s_s, l_s, s_l, l_l, d_cand=d_cand,
                          d_targ=d_targ or d_cand, backend=backend)
    ls = l_s.clamp(max=d_cand)
    cand = gather_rows(adj.flat, s_s, ls, width=d_cand, pad=CAND_PAD)
    found = torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
    found[torch.arange(d_cand, device=cand.device)[None, :]
          < ls[:, None]] = hits
    return torch.where(cand >= 0, cand, n), found


def probe_common_neighbors(g: Graph, eu: torch.Tensor, ew: torch.Tensor, *,
                           d_max: int, d_search: int | None = None):
    """For query edges ``(eu, ew)`` (sentinel-padded with ``n``), the
    candidate common neighbours and their membership mask,
    ``(apexes int32[q, d_max], found bool[q, d_max])``, by the plain
    probe.  ``d_max`` bounds the candidate width, ``d_search`` the search
    over the larger list (``None`` = ``d_max``, exact only when it is the
    global max degree)."""
    return probe_block(g, eu, ew, d_cand=d_max, d_targ=d_search,
                       backend="torch")


def edge_exists(g: Graph, qu: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """Vectorized membership: is ``(qu, qv)`` an edge?  A bounded binary
    search of each ``qu`` row for ``qv``; false for any id ``>= n``.
    Used by the wedge baseline (the closing-edge check prior algorithms
    communicate for)."""
    n = g.n_nodes
    num_steps = max(1, math.ceil(math.log2(g.num_slots + 1)))
    deg_ext = torch.cat([g.deg, g.deg.new_zeros(1)])
    qu_c = qu.clamp(0, n)
    hit = bounded_binary_search(g.dst, g.row_offsets[qu_c], deg_ext[qu_c],
                                torch.where(qv < n, qv, -1),
                                num_steps=num_steps)
    return hit & (qu < n) & (qv < n)
