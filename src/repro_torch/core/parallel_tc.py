"""Algorithm 2 — communication-efficient parallel cover-edge triangle
counting over a shard group (counterpart of ``repro.core.parallel_tc``).

The per-shard body is written once against ``core/shards.py``'s
collectives; :class:`~repro_torch.core.shards.LocalShards` runs the p
shards stacked on one device (the H100: p logical shards on one card),
:class:`~repro_torch.core.shards.GroupShards` one shard a rank of a
``torch.distributed`` group.  The paper's lines map as in the reference:

  line 2      parallel BFS            -> ``bfs_levels_sharded`` (one
                                         int32 pmax of the has-edge vector,
                                         then one pmax of the frontier a
                                         sweep)
  lines 3-5   modified neighbourhoods -> drop ``(v, w)`` pairs with
                                         horizontal ``v < w`` from each
                                         shard (N-hat has (2 - k)m entries)
  lines 6-28  sample-sort transpose   -> ``repartition_by_value`` (regular
                                         sampling, one all-to-all an array)
  lines 29-43 horizontal-edge rounds  -> one all-gather of the horizontal
                                         edges (``allgather``) or a local
                                         probe and exactly p - 1 ppermute
                                         rounds (``ring``); each block
                                         probed through ``run_plan``,
                                         level-free, over the shards' pair
                                         lists — K3 on the card
  line 44     reduction               -> psum

The modified neighbourhoods break symmetry, so every triangle is counted
exactly once (no /3).

**The shards as one adjacency.**  Every probe reads all local shards'
pair lists as one :class:`~repro_torch.core.intersect.PairListAdjacency`
(:class:`ShardView`, as ``LaneView`` reads a batch's CSRs): id ``v`` of
shard ``l`` is ``l * (n + 2) + v``, so the shards' sorted owner lists
concatenate into one sorted list, and a bucket slice is ONE K3 launch
for all local shards.  Each probe row reads only its own shard's lists,
so the counts, overflow and credit are each shard's own.  The hedge
plan's ``query_chunk`` (the reference's fori-loop slice) is kept for the
plan's work counts; the run probes with a copy of the plan whose
``query_chunk`` is ``HEDGE_SLICE_ROWS`` rows over all local shards,
which bounds memory and gives the same integers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.bfs import UNVISITED, bfs_levels_sharded
from repro_torch.core.comm_instrument import CommTally, tally_comm
from repro_torch.core.edges import (
    exceed_counts,
    horizontal_mask,
    mindeg_exceedance,
    mindeg_slots,
)
from repro_torch.core.intersect import (
    DEFAULT_BUCKET_WIDTHS,
    IntersectPlan,
    PairListAdjacency,
    plan_buckets_bounded,
    resolve_backend,
    run_plan,
)
from repro_torch.core.sampling import repartition_by_value
from repro_torch.core.shards import CollectiveCall, ShardGroup
from repro_torch.graph.csr import Graph, max_degree
from repro_torch.graph.partition import shard_edges

__all__ = [
    "HEDGE_SLICE_ROWS",
    "ParallelTCResult",
    "ShardView",
    "build_tc_shard_fn",
    "plan_hedge_rounds",
]

#: most query rows (over all local shards) one hedge-round probe covers:
#: one K3 launch on the card, its operands ~16 bytes a row
HEDGE_SLICE_ROWS = 1 << 24


@dataclasses.dataclass(frozen=True)
class ParallelTCResult:
    """Algorithm 2's raw result, as the reference's: ``triangles``,
    ``k`` (float32) and ``num_horizontal`` (int32 scalars),
    ``per_device`` (the t_i) and ``recv_counts`` (transposed entries a
    shard), int32[p], both overflow flags, the ``comm`` tally and, with
    per-vertex credit, ``per_vertex`` int32[n] (summed over the shards;
    ``sum == 3 * triangles``).  ``collectives`` is the shard group's
    call record of the run (``core/comm_instrument.comm_report`` prices
    it); ``sweeps`` the BFS sweeps it ran."""

    triangles: torch.Tensor
    per_device: torch.Tensor
    k: torch.Tensor
    num_horizontal: torch.Tensor
    transpose_overflow: torch.Tensor
    hedge_overflow: torch.Tensor
    recv_counts: torch.Tensor
    comm: CommTally
    per_vertex: Optional[torch.Tensor] = None
    collectives: tuple[CollectiveCall, ...] = ()


def _capacities(m2: int, p: int, slack: float) -> tuple[int, int, int]:
    """Capacities for a (n, 2m) graph on p shards: edge slots a shard,
    the transpose chunk a destination, the horizontal-edge buffer.
    Only ``cap_chunk`` depends on ``slack``."""
    cap_edges = max(1, math.ceil(m2 / p * 2))
    cap_chunk = max(4, math.ceil(slack * m2 / (p * p)))
    cap_hedge = cap_edges // 2 + 1
    return cap_edges, cap_chunk, cap_hedge


def _hedge_layout(m2: int, p: int, mode: str,
                  hedge_chunk: Optional[int]) -> tuple[int, int]:
    """``(rows, chunk)`` of one horizontal round's query block, shared by
    ``plan_hedge_rounds`` and ``build_tc_shard_fn``: ``chunk`` is the
    plan's probe slice and bucket-row granularity (at most 1,024 unless
    ``hedge_chunk`` says otherwise)."""
    _, _, cap_hedge = _capacities(m2, p, slack=4.0)
    chunk = int(hedge_chunk) if hedge_chunk else min(cap_hedge, 1024)
    rows = p * cap_hedge if mode == "allgather" else cap_hedge
    return rows, chunk


def _ring_mindeg_exceedance(g: Graph, p: int, widths,
                            shards=None) -> tuple[int, ...]:
    """Ring-mode bucket bounds: one plan serves every shard's block, so
    each width's bound is the max over shards of that shard's
    undirected edges above the width (on the graph's device, read back
    once).  ``shards``: optional pre-sharded ``(src[p, cap], dst[p,
    cap])``."""
    if shards is None:
        shards = shard_edges(g, p, capacity=None)[:2]
    s_sh, d_sh = shards
    return exceed_counts(mindeg_slots(s_sh, d_sh, g.deg), widths,
                         per_row=True)


def plan_hedge_rounds(
    g: Graph,
    p: int,
    *,
    mode: str = "allgather",
    hedge_chunk: Optional[int] = None,
    d_pad: Optional[int] = None,
    bucket_widths: tuple[int, ...] = DEFAULT_BUCKET_WIDTHS,
    intersect_backend: str = "torch",
    shards=None,
) -> IntersectPlan:
    """The intersection plan of Algorithm 2's horizontal rounds: one
    query block a round — the gathered horizontal edges (``allgather``,
    p·cap_hedge rows, once) or one shard's (``ring``, cap_hedge rows, p
    times).  Bucket caps come from degree-histogram exceedance bounds
    (the whole graph's, or the per-shard max in ring mode), valid for
    any BFS; the run sorts each block by descending min-degree
    (``sort_queries``), so every query fits its bucket or flags
    overflow."""
    m2 = int(g.n_edges_dir.item())
    if d_pad is None:
        d_pad = max(1, max_degree(g))
    rows, chunk = _hedge_layout(m2, p, mode, hedge_chunk)
    widths = tuple(sorted(
        w for w in {int(w) for w in bucket_widths} if 0 < w < d_pad
    ))
    if mode == "ring":
        bounds = _ring_mindeg_exceedance(g, p, widths, shards=shards)
    else:
        bounds = mindeg_exceedance(g, widths)
    return plan_buckets_bounded(
        rows, d_pad=d_pad, exceed=tuple(zip(widths, bounds)),
        bucket_widths=widths, row_mult=chunk, backend=intersect_backend,
        query_chunk=chunk,
    )


@dataclasses.dataclass(frozen=True)
class ShardView:
    """The local shards' pair lists as ONE
    :class:`~repro_torch.core.intersect.PairListAdjacency`: id ``v`` of
    shard ``l`` (``v`` up to the transpose padding ``n + 1``) is ``l *
    (n + 2) + v``, so the shards' owner lists, each sorted, concatenate
    into one sorted list, and every shard's ids stay in its own span.
    A query id ``>= n`` of any shard maps to the view's sentinel."""

    adj: PairListAdjacency
    local: int
    n: int

    @classmethod
    def from_pairs(cls, owners: torch.Tensor, values: torch.Tensor,
                   n: int) -> "ShardView":
        local = owners.shape[0]
        if max(owners.numel(), local * (n + 2)) >= 2**31:
            raise ValueError(
                f"{local} shards of {owners.shape[1]} pairs over {n} "
                f"vertices exceed the int32 ids and offsets of one view")
        shift = (torch.arange(local, dtype=torch.int32,
                              device=owners.device) * (n + 2))[:, None]
        return cls(adj=PairListAdjacency(
            owners=(owners + shift).reshape(-1),
            values=(values + shift).reshape(-1),
            n_nodes=local * (n + 2)), local=local, n=n)

    def ids(self, v: torch.Tensor) -> torch.Tensor:
        """Per-shard ids ``[local, rows]`` as the view's ids."""
        shift = (torch.arange(self.local, dtype=v.dtype, device=v.device)
                 * (self.n + 2))[:, None]
        return torch.where(v < self.n, v + shift, self.adj.n_nodes)

    def shard_credit(self, credit: torch.Tensor) -> torch.Tensor:
        """The view's credit ``int32[local * (n + 2) + 1]`` as ``[local,
        n]`` (the sentinel slots dropped)."""
        return credit[:-1].view(self.local, self.n + 2)[:, :self.n]


def _tc_shard(src_i, dst_i, *, shards: ShardGroup, n: int, p: int,
              root: int, cap_chunk: int, cap_hedge: int,
              hplan: IntersectPlan, mode: str = "allgather",
              frontier_dtype: str = "int32", per_vertex: bool = False,
              clock=None):
    """The per-shard body over ``src_i``/``dst_i`` int32[local,
    cap_edges], sentinel-padded; returns the result's fields (replicated
    or per local shard).  ``clock`` (a ``StageClock``) records the
    stages ``bfs``, ``transpose``, ``hedge`` and ``reduce``."""
    inf = n + 1
    # ---- line 2: parallel BFS + horizontal marking -------------------
    level = bfs_levels_sharded(src_i, dst_i, n, root=root, shards=shards,
                               frontier_dtype=frontier_dtype)
    horiz = horizontal_mask(src_i, dst_i, level, n)
    valid = (src_i < n) & (dst_i < n)
    if clock is not None:
        clock.lap("bfs")

    # ---- lines 3-5: modified neighbourhoods N-hat ---------------------
    keep = valid & ~(horiz & (src_i < dst_i))
    # ---- lines 6-28: sample-sort transpose by neighbour value ---------
    rep = repartition_by_value(
        values=torch.where(keep, dst_i, inf),
        carry=torch.where(keep, src_i, inf),
        valid=keep, p=p, cap_chunk=cap_chunk, shards=shards, inf=inf,
    )
    # received pairs (owner = carry, value) sorted by (owner, value)
    view = ShardView.from_pairs(rep.carry, rep.values, n)
    if clock is not None:
        clock.lap("transpose")

    # ---- lines 29-43: horizontal-edge exchange + planned intersections
    is_h = horiz & (src_i < dst_i)
    order = torch.sort((~is_h).to(torch.uint8), dim=1, stable=True).indices
    take = order[:, :cap_hedge]
    is_h_o = is_h.gather(1, take)
    hv = torch.where(is_h_o, src_i.gather(1, take), inf)
    hw = torch.where(is_h_o, dst_i.gather(1, take), inf)
    n_h_local = is_h.sum(1, dtype=torch.int32)
    hedge_overflow = shards.pmax((n_h_local > cap_hedge).to(torch.int32)) > 0

    sliced = dataclasses.replace(
        hplan, query_chunk=max(1, HEDGE_SLICE_ROWS // view.local))

    def probe(qv, qw):
        return run_plan(view.adj, view.ids(qv), view.ids(qw), sliced,
                        level=None, per_vertex=per_vertex)

    local = src_i.shape[0]
    if mode == "allgather":
        # one collective, volume k·m·p — the paper's p rounds
        all_hv = shards.all_gather(hv).reshape(1, -1).expand(local, -1)
        all_hw = shards.all_gather(hw).reshape(1, -1).expand(local, -1)
        eng = probe(all_hv, all_hw)
        t_i, d_ovf, credit = eng.c1, eng.overflow, eng.per_vertex
    elif mode == "ring":
        # the local block, then exactly p - 1 ppermute rounds (a p-th
        # would only bring the buffers home)
        perm = [(i, (i + 1) % p) for i in range(p)]
        eng = probe(hv, hw)
        t_i, d_ovf, credit = eng.c1, eng.overflow, eng.per_vertex
        cv, cw = hv, hw
        for _ in range(p - 1):
            cv = shards.ppermute(cv, perm)
            cw = shards.ppermute(cw, perm)
            eng = probe(cv, cw)
            t_i, d_ovf = t_i + eng.c1, d_ovf | eng.overflow
            if per_vertex:
                credit = credit + eng.per_vertex
    else:
        raise ValueError(mode)
    if clock is not None:
        clock.lap("hedge")

    d_overflow = shards.pmax(d_ovf.to(torch.int32)) > 0
    # ---- line 44: reduction -------------------------------------------
    T = shards.psum(t_i)
    pv = shards.psum(view.shard_credit(credit)) if per_vertex else None
    n_h = shards.psum(n_h_local)
    m = shards.psum((valid & (src_i < dst_i)).sum(1, dtype=torch.int32))
    k = n_h / m.clamp(min=1)
    # sweeps = max level + 1: every sweep but the last assigned a level
    sweeps = int((torch.where(level == UNVISITED, 0, level).max() + 1
                  ).item()) if n else 1
    if clock is not None:
        clock.lap("reduce")
    return dict(
        triangles=T, per_device=shards.gather_result(t_i), k=k,
        num_horizontal=n_h,
        transpose_overflow=rep.overflow | d_overflow,
        hedge_overflow=hedge_overflow,
        recv_counts=shards.gather_result(rep.count), per_vertex=pv,
        sweeps=sweeps,
    )


def build_tc_shard_fn(*, n: int, m2: int, p: int, root: int = 0,
                      slack: float = 4.0, d_pad: int = 256,
                      mode: str = "allgather",
                      hedge_chunk: Optional[int] = None,
                      frontier_dtype: str = "int32",
                      hplan: Optional[IntersectPlan] = None,
                      intersect_backend: str = "torch",
                      per_vertex: bool = False):
    """The shard function and its static capacities for a graph of (n,
    2m) size: ``(fn, cap_edges, cap_chunk, cap_hedge)``, where
    ``fn(src_i, dst_i, shards=..., clock=None)`` runs the body.
    ``hplan=None`` builds the single bucket at ``d_pad``; a plan that
    covers fewer rows than the mode's block raises (it would skip
    horizontal edges without flagging anything)."""
    cap_edges, cap_chunk, cap_hedge = _capacities(m2, p, slack)
    rows, chunk = _hedge_layout(m2, p, mode, hedge_chunk)
    if hplan is None:
        hplan = plan_buckets_bounded(
            rows, d_pad=d_pad, exceed=None, row_mult=chunk,
            backend=intersect_backend, query_chunk=chunk,
        )
    elif hplan.buckets and hplan.total_rows < rows:
        raise ValueError(
            f"hplan covers {hplan.total_rows} rows but mode={mode!r} "
            f"probes {rows}-row blocks (plan_hedge_rounds mode mismatch?)"
        )

    def fn(src_i, dst_i, *, shards, clock=None):
        return _tc_shard(
            src_i, dst_i, shards=shards, n=n, p=p, root=root,
            cap_chunk=cap_chunk, cap_hedge=cap_hedge, hplan=hplan,
            mode=mode, frontier_dtype=frontier_dtype,
            per_vertex=per_vertex, clock=clock,
        )

    return fn, cap_edges, cap_chunk, cap_hedge


def _parallel_triangle_count(g: Graph, shards: ShardGroup, *, options,
                             clock=None) -> ParallelTCResult:
    """Algorithm 2 over ``shards``; ``options`` is a
    ``repro_torch.api.TCOptions`` with ``mode`` resolved to
    ``"allgather"`` or ``"ring"`` (the ``"auto"`` policy lives in the
    engine).  ``g`` lives on the shard group's device.  ``clock`` (a
    ``StageClock``) records ``shard`` (host sharding and the plan) and
    the body's stages."""
    o = options
    if o.mode not in ("allgather", "ring"):
        raise ValueError(
            f"hedge mode must be resolved before the impl; got {o.mode!r}"
        )
    backend = resolve_backend(o.backend, shards.device)
    p = shards.p
    n = g.n_nodes
    m2 = int(g.n_edges_dir.item())
    d_pad = o.d_pad if o.d_pad is not None else max(1, max_degree(g))
    if clock is not None:
        clock.start()
    # shard once: the same host pass feeds the shards AND the ring plan
    cap_edges = _capacities(m2, p, float(o.slack))[0]
    s_sh, d_sh, _, _ = shard_edges(g, p, capacity=cap_edges)
    hplan = plan_hedge_rounds(
        g, p, mode=o.mode, hedge_chunk=o.hedge_chunk, d_pad=d_pad,
        bucket_widths=o.bucket_widths, intersect_backend=backend,
        shards=(s_sh, d_sh),
    )
    fn, _, cap_chunk, cap_hedge = build_tc_shard_fn(
        n=n, m2=m2, p=p, root=int(o.root), slack=float(o.slack),
        d_pad=d_pad, mode=o.mode, hedge_chunk=o.hedge_chunk, hplan=hplan,
        intersect_backend=backend, frontier_dtype=o.frontier_dtype,
        per_vertex=bool(o.per_vertex),
    )
    mine = shards.shard_ids.to(s_sh.device)
    src_i = s_sh[mine].to(shards.device)
    dst_i = d_sh[mine].to(shards.device)
    if clock is not None:
        clock.lap("shard")
    with shards.recording() as record:
        out = fn(src_i, dst_i, shards=shards, clock=clock)
    comm = tally_comm(
        n=n, p=p, cap_chunk=cap_chunk, cap_hedge=cap_hedge, mode=o.mode,
        frontier_dtype=o.frontier_dtype, sweeps=out.pop("sweeps"),
        per_vertex=bool(o.per_vertex),
    )
    return ParallelTCResult(comm=comm, collectives=tuple(record), **out)
