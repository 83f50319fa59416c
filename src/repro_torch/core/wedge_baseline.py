"""The prior-art baseline the paper compares against (§V-B): open-wedge
generation and closing-edge queries, as most distributed triangle
counters before the paper did (counterpart of
``repro.core.wedge_baseline``).

* :func:`wedge_count` — ``Σ_v C(d(v), 2)``, Table I's "Wedges" column;
* :func:`wedge_triangle_count` — the single-device oracle: every
  triangle is closed at each of its three apexes, so ``T = closed // 3``
  (int32, as in the reference).  The reference builds one dense
  ``[num_slots, d_max]`` block; here it is cut into chunks of slots to
  bound memory, with the same integer.

* :func:`parallel_wedge_triangle_count` — the same count over a shard
  group (``core/shards.py``): each shard generates the wedges of its
  owned vertices and routes EVERY wedge query ``(v1, v2)`` to the owner
  of ``v1`` through ``repartition_by_value`` with fixed owner-bound
  splitters: the O(#wedges) communication that Table I's "Previous"
  column charges, measured from the shard group's call record.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.intersect import edge_exists
from repro_torch.core.sampling import repartition_by_value
from repro_torch.core.shards import ShardGroup
from repro_torch.graph.csr import Graph, max_degree
from repro_torch.graph.partition import shard_edges

__all__ = [
    "WEDGE_CELL_BUDGET",
    "WedgeTCResult",
    "parallel_wedge_triangle_count",
    "wedge_count",
    "wedge_triangle_count",
]

#: most wedge cells (``slots x d_max``) one chunk of
#: :func:`wedge_triangle_count` holds: about 40 bytes a cell at the
#: chunk's peak
WEDGE_CELL_BUDGET = 1 << 24


def wedge_count(g: Graph) -> torch.Tensor:
    """#wedges = ``Σ_v C(d(v), 2)`` as a float64 scalar on ``g``'s
    device."""
    d = g.deg.to(torch.float64)
    return torch.sum(d * (d - 1) / 2)


def wedge_triangle_count(g: Graph, *, d_max: int) -> torch.Tensor:
    """Oracle: for every directed edge ``(v, u)`` and neighbor ``x =
    N(v)[j]``, ``j < d_max``, with ``u < x``, check the closing edge
    ``(u, x)``; returns ``closed // 3`` as an int32 scalar on ``g``'s
    device.  ``d_max`` below the max degree truncates each neighbour
    list as the reference does.  As many directed edges are expanded
    at a time as :data:`WEDGE_CELL_BUDGET` cells hold (at least one);
    the integer does not depend on it."""
    n, slots, d_max = g.n_nodes, g.num_slots, max(int(d_max), 0)
    step = max(1, WEDGE_CELL_BUDGET // max(d_max, 1))
    dev = g.device
    pos = torch.arange(d_max, dtype=torch.int64, device=dev)
    deg_ext = torch.cat([g.deg, g.deg.new_zeros(1)])
    closed = torch.zeros((), dtype=torch.int64, device=dev)
    for s0 in range(0, slots, step):
        src = g.src[s0:s0 + step].to(torch.int64)
        u = g.dst[s0:s0 + step].to(torch.int64)[:, None]
        src_c = src.clamp(0, n)
        idx = (g.row_offsets[src_c].to(torch.int64)[:, None]
               + pos[None, :]).clamp(0, slots - 1)
        x = torch.where(pos[None, :] < deg_ext[src_c][:, None],
                        g.dst[idx].to(torch.int64), n)
        is_wedge = (src[:, None] < n) & (u < x) & (x < n)
        closed += edge_exists(
            g, torch.where(is_wedge, u, n).reshape(-1),
            torch.where(is_wedge, x, n).reshape(-1)).sum()
    # the reference sums in int32 (wrapping past 2^31) and floor-divides
    return closed.to(torch.int32) // 3


@dataclasses.dataclass(frozen=True)
class WedgeTCResult:
    """The parallel wedge baseline's result, as the reference's:
    ``triangles`` and ``wedges_routed`` (int32 scalars, the measured
    wedge-query traffic in queries) and ``overflow`` (a routed chunk
    exceeded its capacity).  ``collectives`` is the shard group's call
    record (``core/comm_instrument.py`` prices it)."""

    triangles: torch.Tensor
    wedges_routed: torch.Tensor
    overflow: torch.Tensor
    collectives: tuple = ()


def _wedge_shard(src_i, dst_i, splitters, *, shards, n: int, p: int,
                 d_pad: int, cap_chunk: int) -> dict:
    """Per-shard body over ``src_i``/``dst_i`` int32[local, cap]: the
    wedges of each shard's owned vertices, routed to the owner of their
    first endpoint, closed against that owner's edge list."""
    inf = n + 1
    local, L = src_i.shape
    dev = src_i.device
    valid = (src_i < n) & (dst_i < n)
    # the shard's local CSR: (src_i, dst_i) is (src, dst)-sorted
    starts = torch.searchsorted(
        src_i.contiguous(),
        torch.arange(n + 1, dtype=torch.int32, device=dev).expand(
            local, -1).contiguous(), out_int32=True)
    deg_local = starts[:, 1:] - starts[:, :-1]
    pos = torch.arange(d_pad, dtype=torch.int64, device=dev)
    owner = src_i.clamp(0, n - 1).long()
    dv = deg_local.gather(1, owner)
    st = starts.gather(1, owner)
    idx = (st.long()[:, :, None] + pos).clamp(0, L - 1)
    x = torch.where(pos < dv[:, :, None],
                    dst_i.gather(1, idx.reshape(local, -1)).view(idx.shape),
                    n)
    u = dst_i[:, :, None]
    is_wedge = valid[:, :, None] & (u < x) & (x < n)
    qu = torch.where(is_wedge, u, inf).reshape(local, -1)
    qx = torch.where(is_wedge, x, inf).reshape(local, -1)
    wedges_local = is_wedge.sum((1, 2), dtype=torch.int32)
    del x, idx
    # route query (u, x) to owner(u): fixed owner-bound splitters
    rep = repartition_by_value(
        values=qu, carry=qx, valid=is_wedge.reshape(local, -1), p=p,
        cap_chunk=cap_chunk, shards=shards, inf=inf, splitters=splitters,
    )
    # the closing-edge check against the local (src, dst)-sorted shard:
    # a lower bound of (Ru, Rx) by binary search, in the reference's steps
    Ru, Rx = rep.values, rep.carry
    steps = max(1, math.ceil(math.log2(L + 1)))
    lo = torch.zeros_like(Ru)
    hi = torch.full_like(Ru, L)
    for _ in range(steps):
        cont = lo < hi
        mid = (lo + hi) // 2
        ms = mid.clamp(0, L - 1).long()
        ka, kb = src_i.gather(1, ms), dst_i.gather(1, ms)
        less = ((ka < Ru) | ((ka == Ru) & (kb < Rx))) & cont
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(cont & ~less, mid, hi)
    ls = lo.clamp(0, L - 1).long()
    closed = ((lo < L) & (src_i.gather(1, ls) == Ru)
              & (dst_i.gather(1, ls) == Rx) & (Ru < n))
    t = shards.psum(closed.sum(1, dtype=torch.int32)) // 3
    wedges = shards.psum(wedges_local)
    return dict(triangles=t, wedges_routed=wedges, overflow=rep.overflow)


def parallel_wedge_triangle_count(g: Graph, shards: ShardGroup, *,
                                  slack: float = 32.0,
                                  d_pad: Optional[int] = None
                                  ) -> WedgeTCResult:
    """The prior algorithms' communication pattern over a shard group:
    each shard generates the wedges of its owned vertices and routes
    every wedge query ``(v1, v2)`` to the owner of ``v1`` (fixed
    owner-bound splitters through ``repartition_by_value``), where the
    closing edge is checked.  The fat default ``slack``: wedge traffic
    concentrates on hub owners, so chunks are far more skewed than the
    cover-edge transpose; an overflow is flagged.  The shards' dense
    ``[cap, d_pad]`` wedge block is the reference's."""
    p = shards.p
    n = g.n_nodes
    m2 = int(g.n_edges_dir.item())
    cap_edges = max(1, math.ceil(m2 / p * 2))
    s_sh, d_sh, _, bounds = shard_edges(g, p, capacity=cap_edges)
    if d_pad is None:
        d_pad = max(1, max_degree(g))
    est_wedges = float(wedge_count(g).item())
    cap_chunk = max(8, math.ceil(slack * max(est_wedges, 1) / (p * p)))
    mine = shards.shard_ids.to(s_sh.device)
    dev = shards.device
    src_i, dst_i = s_sh[mine].to(dev), d_sh[mine].to(dev)
    # owner bounds as splitters: value v goes to the i with bounds[i] <= v
    # < bounds[i + 1]
    spl = torch.from_numpy(bounds[1:p].astype(np.int32) - 1).to(dev)
    with shards.recording() as record:
        out = _wedge_shard(src_i, dst_i, spl, shards=shards, n=n, p=p,
                           d_pad=int(d_pad), cap_chunk=cap_chunk)
    return WedgeTCResult(collectives=tuple(record), **out)
