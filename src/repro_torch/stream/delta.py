"""Exact per-batch triangle deltas through the intersection engine
(counterpart of ``repro.stream.delta``).

**The delta rule.**  For a *net* batch of inserted undirected edges
``I`` into graph ``A`` (giving ``B = A ∪ I``), let ``Tj`` be the new
triangles with exactly ``j`` edges in ``I``.  Three level-free
``run_plan`` probes of the **same** delta query block measure

  ``S_A = Σ_{(u,w)∈I} |N_A(u) ∩ N_A(w)| = T1``            (before),
  ``S_B = Σ_{(u,w)∈I} |N_B(u) ∩ N_B(w)| = T1 + 2·T2 + 3·T3`` (after),
  ``S_I = Σ_{(u,w)∈I} |N_I(u) ∩ N_I(w)| = 3·T3``          (delta alone),

and ``ΔT = (3·(S_A + S_B) − S_I) / 6``.  Deleting ``D`` from ``A`` is
inserting ``D`` into ``A ∖ D``, so the same identity gives the lost
count; a mixed batch runs its net deletes first, then its net inserts.
Per-vertex credit rides the same probes with the same weights.  Both
divisions are checked and raise on a remainder.

On the card the probes without credit run K3 (``intersect_count``), the
probes with credit K2.  Every snapshot is built on the device from
device keys.  The reference's per-plan jit cache has no counterpart:
``run_plan`` runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.analysis.dtypes import torch_index_dtype
from repro_torch.core.intersect import (
    CsrAdjacency,
    plan_buckets,
    resolve_backend,
    run_plan,
)
from repro_torch.graph.csr import Graph, _next_pow2, from_edges

__all__ = ["DeltaCounts", "batch_delta", "padded_graph", "probe_sum"]


def _next_pow4(x: int) -> int:
    """Pow4 ceiling — the reference's candidate-width quantizer (kept so
    the plans, and so the probes' search depths, are the reference's)."""
    p = 1
    while p < int(x):
        p <<= 2
    return p


def padded_graph(edges: Union[np.ndarray, torch.Tensor], n_nodes: int, *,
                 device: Union[str, torch.device] = "cuda") -> Graph:
    """``from_edges`` with the slot budget rounded up to a power of two
    (min 128), as the reference pads every stream snapshot; an int64
    edge tensor already on ``device`` is packed there without a host
    round trip."""
    m = int(edges.reshape(-1, 2).shape[0])
    slots = max(128, _next_pow2(2 * m))
    return from_edges(edges, n_nodes, num_slots=slots, device=device)


@dataclasses.dataclass(frozen=True)
class DeltaCounts:
    """One phase's exactly-once triangle delta.

    ``triangles`` is signed (< 0 for a delete phase); ``per_vertex`` is
    the matching signed credit array (host int64[n]) when attribution
    was requested, else ``None``.  ``probes`` counts the ``run_plan``
    calls the phase issued (0, 2 or 3 — the all-new probe is skipped for
    batches of fewer than three edges, where ``T3`` cannot exist)."""

    triangles: int
    per_vertex: Optional[np.ndarray]
    probes: int


def probe_sum(
    g: Graph,
    delta: np.ndarray,
    deg: np.ndarray,
    *,
    options,
    per_vertex: bool,
) -> tuple[int, Optional[np.ndarray]]:
    """``Σ_{(u,w)∈delta} |N_g(u) ∩ N_g(w)|`` (and, with ``per_vertex``,
    the level-free credit vector) via ONE exact-planned ``run_plan``.

    ``deg`` is the host degree array of ``g``; its maximum prices the
    plan's single target width, so no list can exceed its width.  The
    layout is the reference's: the block is pow2-padded (min 64) with
    ``(n, n)`` sentinels, one bucket, candidate width the pow4 ceiling
    of the block's largest smaller-endpoint degree (min 16), target
    width the pow2 ceiling of the graph's max degree, and rows a
    multiple of ``query_chunk or 64``."""
    h = int(delta.shape[0])
    if h == 0 or g.n_nodes == 0 or g.num_slots == 0:
        # nothing to probe, or an edgeless adjacency
        return 0, (np.zeros(g.n_nodes, dtype=np.int64) if per_vertex
                   else None)
    qu = delta[:, 0]
    qw = delta[:, 1]
    ds_max = int(np.minimum(deg[qu], deg[qw]).max())
    pad = max(64, _next_pow2(h)) - h
    if pad:
        sent = np.full(pad, g.n_nodes, dtype=np.int64)
        qu = np.concatenate([qu, sent])
        qw = np.concatenate([qw, sent])
    w_cand = _next_pow4(max(16, ds_max))
    w_targ = _next_pow2(max(1, int(deg.max()) if deg.size else 1))
    backend = resolve_backend(options.backend, g.device)
    chunk = int(options.query_chunk) if options.query_chunk else None
    plan = plan_buckets(
        np.full(qu.shape[0], w_cand, dtype=np.int64),
        np.full(qu.shape[0], max(w_cand, w_targ), dtype=np.int64),
        bucket_widths=(),
        # chunked runs need chunk-multiple bucket rows
        row_mult=(chunk if chunk else 64),
        backend=backend,
        query_chunk=chunk,
    )
    vid = torch_index_dtype(g.n_nodes, site="stream.delta query block")
    res = run_plan(
        CsrAdjacency.from_graph(g),
        torch.from_numpy(qu.astype(np.int32)).to(g.device, vid),
        torch.from_numpy(qw.astype(np.int32)).to(g.device, vid),
        plan, level=None, per_vertex=per_vertex,
    )
    total = int(res.c1)  # level-free: c1 is the raw hit total, c2 == 0
    pv = None
    if per_vertex:
        # slot n is the sentinel bucket (padding rows); real credit only
        pv = res.per_vertex[: g.n_nodes].cpu().numpy().astype(np.int64)
    return total, pv


def batch_delta(
    delta: np.ndarray,
    *,
    g_small: Graph,
    g_big: Graph,
    deg_small: np.ndarray,
    deg_big: np.ndarray,
    n_nodes: int,
    options,
    per_vertex: bool,
    sign: int,
) -> DeltaCounts:
    """Exactly-once triangle delta of one phase.

    ``delta`` (host int64[b, 2], unique undirected rows) is the phase's
    net edge set; ``g_small``/``g_big`` are CSR snapshots **without** and
    **with** those edges (insert phase: before/after; delete phase:
    after/before), with their host degree arrays.  ``sign`` is ``+1``
    for inserts, ``-1`` for deletes."""
    b = int(delta.shape[0])
    if b == 0:
        return DeltaCounts(
            0, np.zeros(n_nodes, dtype=np.int64) if per_vertex else None, 0
        )
    s_small, p_small = probe_sum(
        g_small, delta, deg_small, options=options, per_vertex=per_vertex
    )
    s_big, p_big = probe_sum(
        g_big, delta, deg_big, options=options, per_vertex=per_vertex
    )
    probes = 2
    if b >= 3:
        # the all-new term needs >= 3 delta edges to close a triangle
        g_delta = padded_graph(torch.from_numpy(delta), n_nodes,
                               device=g_big.device)
        deg_delta = np.zeros(n_nodes, dtype=np.int64)
        np.add.at(deg_delta, delta[:, 0], 1)
        np.add.at(deg_delta, delta[:, 1], 1)
        s_delta, p_delta = probe_sum(
            g_delta, delta, deg_delta, options=options,
            per_vertex=per_vertex,
        )
        probes = 3
    else:
        s_delta = 0
        p_delta = (np.zeros(n_nodes, dtype=np.int64) if per_vertex
                   else None)
    num = 3 * (s_small + s_big) - s_delta
    if num % 6:
        raise AssertionError(
            f"delta identity violated: 3*({s_small}+{s_big})-{s_delta} "
            f"not divisible by 6 — the probes disagree on the batch split"
        )
    pv = None
    if per_vertex:
        pv_num = 3 * (p_small + p_big) - p_delta
        bad = pv_num % 6
        if bad.any():
            raise AssertionError(
                "per-vertex delta identity violated at vertices "
                f"{np.nonzero(bad)[0][:8].tolist()}"
            )
        pv = sign * (pv_num // 6)
    return DeltaCounts(sign * (num // 6), pv, probes)
