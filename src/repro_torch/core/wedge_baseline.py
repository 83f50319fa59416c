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

``parallel_wedge_triangle_count`` routes every wedge query to the owner
of its first endpoint through ``repartition_by_value`` over a device
mesh: ROADMAP Queue 1 item 10 (distributed Algorithm 2).
"""
from __future__ import annotations

import torch

from repro_torch.core.intersect import edge_exists
from repro_torch.graph.csr import Graph

__all__ = [
    "WEDGE_CELL_BUDGET",
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


def parallel_wedge_triangle_count(*args, **kwargs):
    """The reference's wedge baseline over a device mesh: ROADMAP Queue
    1 item 10."""
    raise NotImplementedError(
        "parallel_wedge_triangle_count routes wedge queries through "
        "repartition_by_value over a mesh, not ported to repro_torch yet: "
        "ROADMAP Queue 1 item 10 (distributed Algorithm 2)")
