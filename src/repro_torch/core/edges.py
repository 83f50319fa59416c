"""Edge classification after BFS (paper §II): tree / strut / horizontal.

Counterpart of ``repro.core.edges``.  Only the horizontal bit is
consumed by the counting algorithm; ``k_fraction`` is the paper's ``k``,
the fraction of undirected edges that are horizontal.
"""
from __future__ import annotations

import torch

from repro_torch.core.bfs import UNVISITED
from repro_torch.graph.csr import Graph, undirected_edges


def _level_ext(level: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([
        level,
        torch.full((1,), pad, dtype=torch.int32, device=level.device),
    ])


def _endpoint_levels(src, dst, level, n_nodes):
    lev_ext = _level_ext(level, UNVISITED)
    return lev_ext[src.clamp(0, n_nodes)], lev_ext[dst.clamp(0, n_nodes)]


def horizontal_mask(
    src: torch.Tensor, dst: torch.Tensor, level: torch.Tensor, n_nodes: int
) -> torch.Tensor:
    """bool per (possibly padded) directed edge: endpoints on equal level."""
    valid = (src < n_nodes) & (dst < n_nodes)
    ls, ld = _endpoint_levels(src, dst, level, n_nodes)
    return valid & (ls == ld) & (ls != UNVISITED)


def horizontal_queries(g: Graph, level: torch.Tensor, *, order: str = "asc"):
    """Compact + degree-sort the horizontal undirected query edges.

    One stable sort keyed by small-endpoint degree moves the real queries
    to the front and lays them out in degree buckets.  ``order`` is
    ``"asc"`` (small degrees first) or ``"desc"`` (large degrees first —
    the layout the exact planner consumes).  The sort must be stable:
    without it the query order, and so the plan's rows, would not match
    the reference bit for bit.

    Returns ``(qu, qw, d_small, d_large, n_h)``: int32[num_slots] tensors
    whose first ``n_h`` rows are the horizontal queries (``qu < qw``)
    sorted by ``d_small`` in ``order``; trailing rows are sentinel (``n``)
    with ``d_small == d_large == 0``; ``n_h`` is an int32 scalar tensor.
    """
    n = g.n_nodes
    dev = g.device
    horiz = horizontal_mask(g.src, g.dst, level, n)
    eu, ew, und = undirected_edges(g)
    use = und & horiz
    deg_ext = torch.cat([g.deg, torch.zeros((1,), dtype=torch.int32,
                                            device=dev)])
    du = deg_ext[eu.clamp(0, n)]
    dw = deg_ext[ew.clamp(0, n)]
    d_min = torch.minimum(du, dw)
    if order == "asc":
        key = torch.where(use, d_min, g.num_slots + 1)  # > any degree
    elif order == "desc":
        # real queries have min-degree >= 1, so -1 ranks padding last
        key = -torch.where(use, d_min, -1)
    else:
        raise ValueError(f"order must be 'asc' or 'desc'; got {order!r}")
    sort = torch.sort(key, stable=True).indices
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    qu = torch.where(use, eu, n)[sort]
    qw = torch.where(use, ew, n)[sort]
    d_small = torch.where(use, d_min, zero)[sort]
    d_large = torch.where(use, torch.maximum(du, dw), zero)[sort]
    n_h = use.sum(dtype=torch.int32)
    return qu, qw, d_small, d_large, n_h


def classify_edges(src, dst, level, n_nodes):
    """Return int8 class per directed edge: 0 pad/invalid/unvisited,
    1 horizontal, 2 adjacent-level (tree or strut).

    An edge between two UNVISITED vertices has ``ls == ld`` but is NOT
    horizontal — the ``ls != UNVISITED`` guard keeps a partial BFS from
    classifying every unreached component's edges as class 1."""
    valid = (src < n_nodes) & (dst < n_nodes)
    ls, ld = _endpoint_levels(src, dst, level, n_nodes)
    horiz = valid & (ls == ld) & (ls != UNVISITED)
    adj = valid & (ls != UNVISITED) & (ld != UNVISITED) & (
        (ls - ld).abs() == 1
    )
    out = torch.where(adj, 2, 0)
    return torch.where(horiz, 1, out).to(torch.int8)


def k_fraction(src, dst, level, n_nodes) -> torch.Tensor:
    """Paper's k: |horizontal undirected edges| / m, float32 — an
    int32/int32 true division, as in the reference."""
    h = horizontal_mask(src, dst, level, n_nodes)
    und = src < dst  # count each undirected edge once
    m = ((src < n_nodes) & (dst < n_nodes) & und).sum(dtype=torch.int32)
    return (h & und).sum(dtype=torch.int32) / m.clamp(min=1)
