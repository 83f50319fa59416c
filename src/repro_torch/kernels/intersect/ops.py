"""Per-edge ``(c1, c2)`` for CSR horizontal-edge queries.

Counterpart of ``repro.kernels.intersect.ops``.
:func:`gather_query_blocks` is the reference's front end: the dense
``(cand, targ, lev_c, lev_u)`` blocks of query edges ``(qu, qw)``, with
the candidates from the endpoint of smaller degree (the intersection is
symmetric, so the candidate width is bounded by the smaller degree;
both endpoints of a horizontal edge sit on one BFS level, so the swap
never changes the level split).  :func:`horizontal_edge_counts` counts
each edge's apexes by level: on the card through K1, which reads the
same slices straight from the CSR array (its ``intersect_levels``), on
the CPU through the plain dense ``intersect_ref`` on those blocks.
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import Graph, gather_neighbors
from repro_torch.kernels.intersect.intersect import intersect_levels
from repro_torch.kernels.intersect.ref import (
    CAND_PAD,
    TARG_PAD,
    intersect_ref,
)


def _endpoints(g: Graph, qu: torch.Tensor, qw: torch.Tensor):
    """``(small, large)``: each edge's endpoint of smaller degree and the
    other; an edge with a sentinel endpoint (``>= n``) keeps it."""
    n = g.n_nodes
    deg_ext = torch.cat([g.deg, torch.zeros(1, dtype=torch.int32,
                                            device=g.deg.device)])
    qu_c, qw_c = qu.clamp(0, n), qw.clamp(0, n)
    swap = deg_ext[qw_c] < deg_ext[qu_c]
    small = torch.where(qu < n, torch.where(swap, qw_c, qu_c), n)
    large = torch.where(qw < n, torch.where(swap, qu_c, qw_c), n)
    return small, large


def _lev_u(g: Graph, qu: torch.Tensor, level: torch.Tensor):
    n = g.n_nodes
    lev_ext = torch.cat([level, torch.full((1,), -7, dtype=torch.int32,
                                           device=level.device)])
    return lev_ext, torch.where(qu < n, lev_ext[qu.clamp(0, n)], -9)


def gather_query_blocks(g: Graph, qu: torch.Tensor, qw: torch.Tensor,
                        level: torch.Tensor, *, d_cand: int, d_targ: int):
    """Dense ``(cand int32[Q, d_cand], targ int32[Q, d_targ], lev_c,
    lev_u)`` for query edges ``(qu, qw)`` (sentinel-padded with ``n``):
    candidates from the smaller-degree endpoint (pad ``CAND_PAD``),
    targets from the other (pad ``TARG_PAD``), each candidate's level
    (-7 for a pad) and the edge's (-9 for a sentinel edge)."""
    small, large = _endpoints(g, qu, qw)
    cand = gather_neighbors(g, small, width=d_cand, pad=CAND_PAD)
    targ = gather_neighbors(g, large, width=d_targ, pad=TARG_PAD)
    lev_ext, lev_u = _lev_u(g, qu, level)
    lev_c = torch.where(cand >= 0, lev_ext[cand.clamp(0, g.n_nodes)], -7)
    return cand, targ, lev_c, lev_u


def horizontal_edge_counts(g: Graph, qu: torch.Tensor, qw: torch.Tensor,
                           level: torch.Tensor, *, d_max: int,
                           d_targ: int | None = None):
    """Per horizontal edge ``(qu, qw)``: ``(#diff-level apexes,
    #same-level apexes)`` int32[Q], candidates clamped to ``d_max`` and
    targets to ``d_targ`` (default ``d_max``).  K1 on a CUDA graph, the
    plain dense version on a CPU one."""
    d_targ = d_targ or d_max
    if qu.device.type != "cuda":
        return intersect_ref(*gather_query_blocks(g, qu, qw, level,
                                                  d_cand=d_max,
                                                  d_targ=d_targ))
    n = g.n_nodes
    deg_ext = torch.cat([g.deg, torch.zeros(1, dtype=torch.int32,
                                            device=g.deg.device)])
    small, large = _endpoints(g, qu, qw)
    _, lev_u = _lev_u(g, qu, level)
    return intersect_levels(
        g.dst, g.row_offsets[small], deg_ext[small], g.row_offsets[large],
        deg_ext[large], level, lev_u.to(torch.int32), d_cand=d_max,
        d_targ=d_targ)
