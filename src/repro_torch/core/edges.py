"""Edge classification after BFS (paper §II): tree / strut / horizontal.

Counterpart of ``repro.core.edges``.  Only the horizontal bit is
consumed by the counting algorithm; ``k_fraction`` is the paper's ``k``,
the fraction of undirected edges that are horizontal.

Every function here also takes a batch's tensors with a leading lane
axis (``GraphBatch.lane_view()``, levels ``[B, n]``): gathers, sorts and
sums run along the last axis, lane by lane.
"""
from __future__ import annotations

import torch

from repro_torch.core.bfs import UNVISITED, _take
from repro_torch.graph.csr import Graph, undirected_edges


def _ext(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with one more entry, ``pad``, along its last axis."""
    return torch.cat([
        x,
        torch.full((*x.shape[:-1], 1), pad, dtype=x.dtype, device=x.device),
    ], -1)


def _endpoint_levels(src, dst, level, n_nodes):
    lev_ext = _ext(level, UNVISITED)
    return (_take(lev_ext, src.clamp(0, n_nodes)),
            _take(lev_ext, dst.clamp(0, n_nodes)))


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
    deg_ext = _ext(g.deg, 0)
    du = _take(deg_ext, eu.clamp(0, n))
    dw = _take(deg_ext, ew.clamp(0, n))
    d_min = torch.minimum(du, dw)
    if order == "asc":
        key = torch.where(use, d_min, g.num_slots + 1)  # > any degree
    elif order == "desc":
        # real queries have min-degree >= 1, so -1 ranks padding last
        key = -torch.where(use, d_min, -1)
    else:
        raise ValueError(f"order must be 'asc' or 'desc'; got {order!r}")
    sort = torch.sort(key, dim=-1, stable=True).indices
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    qu = _take(torch.where(use, eu, n), sort)
    qw = _take(torch.where(use, ew, n), sort)
    d_small = _take(torch.where(use, d_min, zero), sort)
    d_large = _take(torch.where(use, torch.maximum(du, dw), zero), sort)
    n_h = use.sum(-1, dtype=torch.int32)
    return qu, qw, d_small, d_large, n_h


def mindeg_slots(src: torch.Tensor, dst: torch.Tensor,
                 deg: torch.Tensor) -> torch.Tensor:
    """Each undirected (``src < dst``) slot's smaller endpoint degree, 0
    elsewhere (sentinel pads have ``src == dst`` and drop out), any slot
    layout, on the edge tensors' device.  Every bound the bucket
    planners read counts ``mind > w`` strictly: a query with ``d_small
    == w`` fits a ``w``-wide bucket."""
    hi = deg.shape[0] - 1
    if hi < 0:
        return torch.zeros_like(src)
    return torch.where(src < dst, torch.minimum(deg[src.clamp(0, hi)],
                                                deg[dst.clamp(0, hi)]), 0)


def exceed_counts(mind: torch.Tensor, widths, *, per_row: bool = False
                  ) -> tuple[int, ...]:
    """For each width ``w``, how many slots of ``mind`` exceed it (the
    largest row's count with ``per_row``), read back in one copy."""
    if not len(widths):
        return ()
    counts = torch.stack([
        ((mind > int(w)).sum(-1).amax() if per_row else (mind > int(w)).sum())
        for w in widths])
    return tuple(int(c) for c in counts.tolist())


def mindeg_exceedance(g: Graph, widths) -> tuple[int, ...]:
    """For each width ``w``, the number of undirected edges whose
    smaller endpoint has degree > ``w`` (computed on the graph's device,
    the counts read back once).  The horizontal queries of any BFS are a
    subset of the undirected edges, so these counts bound every bucket's
    occupancy whatever the root — what ``plan_buckets_bounded`` is laid
    out from."""
    return exceed_counts(mindeg_slots(g.src, g.dst, g.deg), widths)


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
    int32/int32 true division, as in the reference (per lane on a lane
    axis)."""
    h = horizontal_mask(src, dst, level, n_nodes)
    und = src < dst  # count each undirected edge once
    m = ((src < n_nodes) & (dst < n_nodes) & und).sum(-1, dtype=torch.int32)
    return (h & und).sum(-1, dtype=torch.int32) / m.clamp(min=1)
