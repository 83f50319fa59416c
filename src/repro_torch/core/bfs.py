"""Frontier (level-synchronous) BFS — step 1 of the cover-edge algorithm.

Counterpart of ``repro.core.bfs.bfs_levels`` on its CSR cumsum path.
Only level equality along an edge is consumed downstream, so components
other than the root's may start at any fresh level value; the levels
must still match the reference bit for bit, because c1 and c2 depend on
them.  So the reference's three rules are kept exactly:

  * edge-less vertices are seeded in bulk at level 0, then ``root`` is
    set to 0;
  * each sweep reads the frontier with one exclusive cumsum over the
    CSR-sorted slices (the frontier is 0/1, so "any neighbour on the
    frontier" is a range difference — no scatter);
  * when the frontier dies while vertices remain unvisited, the smallest
    unvisited vertex is reseeded at ``cur + 1``, one per sweep.

The reference runs this as a ``while_loop`` on the device.  Here it is a
written-out loop whose condition costs one host sync per sweep; a graph
with many non-trivial components pays one sweep per component on top of
its diameters.

The same loop runs a batch's lanes at once (:func:`bfs_levels_batch`):
every tensor gains a leading lane axis, each gather and cumsum runs
along the last one, and one host sync per sweep serves all lanes.
:func:`bfs_levels_sharded` runs it over Algorithm 2's edge shards, one
``pmax`` of the frontier a sweep.
"""
from __future__ import annotations

import torch

UNVISITED = 2**30


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` on one graph; on a lane axis, each lane's row of
    ``table`` indexed by its row of ``idx``."""
    if table.dim() == 1:
        return table[idx]
    return table.gather(-1, idx.long())


def bfs_levels_iters(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    root: int = 0,
    *,
    row_offsets: torch.Tensor,
) -> tuple[torch.Tensor, int]:
    """``(level int32[..., n_nodes], sweeps)``: :func:`bfs_levels` plus
    the number of sweeps it ran (the BFS stage's host-sync count).
    ``dst`` and ``row_offsets`` may carry a leading lane axis
    (:func:`bfs_levels_batch`)."""
    del src  # the CSR path reads the frontier through dst + row_offsets
    dev = dst.device
    n = int(n_nodes)
    lead = dst.shape[:-1]
    dst_c = dst.clamp(0, n)
    has_edge = row_offsets[..., 1:n + 1] - row_offsets[..., :n]
    level = torch.where(
        has_edge > 0,
        torch.tensor(UNVISITED, dtype=torch.int32, device=dev),
        torch.tensor(0, dtype=torch.int32, device=dev),
    )
    level[..., root] = 0
    unv_pad = torch.full((*lead, 1), UNVISITED, dtype=torch.int32,
                         device=dev)
    zero1 = torch.zeros((*lead, 1), dtype=torch.int32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    cur = 0
    progressed = True
    while progressed and cur < n + 1:
        lev_ext = torch.cat([level, unv_pad], -1)
        # symmetric graph: v is reached iff any neighbour in v's own
        # sorted CSR slice sits on the frontier
        active = (_take(lev_ext, dst_c) == cur).to(torch.int32)
        csum = torch.cat([zero1, torch.cumsum(active, -1, dtype=torch.int32)],
                         -1)
        reached = (_take(csum, row_offsets[..., 1:n + 1])
                   - _take(csum, row_offsets[..., :n]))
        newly = (level == UNVISITED) & (reached > 0)
        any_new = newly.any(-1)
        level = torch.where(newly, cur + 1, level)
        still = level == UNVISITED
        need_seed = ~any_new & still.any(-1)
        # first maximum of the 0/1 mask = smallest unvisited vertex
        seed = torch.argmax(still.to(torch.int32), dim=-1)
        level = torch.where(need_seed[..., None] & (ids == seed[..., None]),
                            cur + 1, level)
        progressed = bool((any_new | need_seed).any().item())
        cur += 1
    return level, cur


def bfs_levels_batch(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    root: int = 0,
    *,
    row_offsets: torch.Tensor,
) -> tuple[torch.Tensor, int]:
    """Per-lane levels ``int32[B, n_nodes]`` and the sweep count, for a
    batch's ``int32[B, num_slots]`` edge tensors and ``int32[B, n_nodes +
    2]`` CSR offsets (``GraphBatch.lane_view()``).

    One sweep counter ``cur`` serves every lane, and the loop runs until
    no lane progressed: the sweep count is the largest lane's.  That is
    exact.  A lane whose loop has ended (nothing newly reached, nothing
    left to seed) has every vertex visited, so in any later sweep it
    reaches nothing new and seeds nothing: its levels stay as they are,
    which is what the reference's ``vmap`` of its ``while_loop`` does
    when it freezes the finished lanes.  The lanes that still run see the
    same ``cur`` as they would alone."""
    if dst.dim() != 2:
        raise ValueError(f"dst must be [B, num_slots]; got {tuple(dst.shape)}")
    return bfs_levels_iters(src, dst, n_nodes, root,
                            row_offsets=row_offsets)


def bfs_levels(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    root: int = 0,
    *,
    row_offsets: torch.Tensor,
) -> torch.Tensor:
    """Level of every vertex, int32[n_nodes].  ``src``/``dst`` may be
    sentinel-padded (entries == n_nodes are ignored); ``row_offsets`` are
    the CSR offsets of the whole symmetrized edge list."""
    return bfs_levels_iters(
        src, dst, n_nodes, root, row_offsets=row_offsets
    )[0]


def bfs_levels_sharded(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    root: int = 0,
    *,
    shards,
    frontier_dtype: str = "int32",
) -> torch.Tensor:
    """Level of every vertex, int32[n_nodes] (replicated), from the
    shards' edge lists ``int32[local, cap]`` (``graph/partition.py:
    shard_edges``: each shard a run of CSR rows, sorted by ``(src,
    dst)``, sentinel-padded with ``n_nodes``) over a shard group
    (``core/shards.py``) — counterpart of ``repro.core.bfs.bfs_levels``
    with ``axis_name``.

    The reference's rules, levels bit for bit: edge-less vertices seeded
    at level 0 (one int32 ``pmax`` of the has-edge vector), then ``root``;
    each sweep is one ``pmax`` of the reachability vector in
    ``frontier_dtype`` (``"uint8"`` changes the exchange's wire width
    and its tally, not the levels); the smallest unvisited vertex is
    reseeded when the frontier dies.  A shard reads its own part of the
    frontier with the CSR cumsum of ``bfs_levels_iters`` over its local
    row offsets (v reached when a neighbour in v's slice of this shard
    is on the frontier); the graph is symmetric, so the ``pmax`` over
    shards is the reference's scatter over in-edges.  The local shards'
    slots are scanned as ONE flat cumsum, each shard's slices read at
    its own offset (a scan along a short leading axis of long rows is
    PyTorch's slow innermost-dimension scan).  One host sync a sweep, as
    on the local route."""
    dev = dst.device
    n = int(n_nodes)
    local, cap = dst.shape
    dst_c = dst.clamp(0, n)
    ids = torch.arange(n + 1, dtype=torch.int32, device=dev)
    off = torch.searchsorted(src.clamp(0, n).contiguous(),
                             ids.expand(local, -1).contiguous(),
                             out_int32=True)
    has_edge = shards.pmax((off[:, 1:] > off[:, :-1]).to(torch.int32))
    # each shard's row slices in the flat slot numbering
    base = torch.arange(local, dtype=torch.int64, device=dev)[:, None] * cap
    lo, hi = off[:, :-1] + base, off[:, 1:] + base
    scan = torch.int32 if local * cap < 2**31 else torch.int64
    level = torch.where(
        has_edge > 0,
        torch.tensor(UNVISITED, dtype=torch.int32, device=dev),
        torch.tensor(0, dtype=torch.int32, device=dev),
    )
    level[root] = 0
    wire = getattr(torch, frontier_dtype)
    unv_pad = torch.full((1,), UNVISITED, dtype=torch.int32, device=dev)
    zero1 = torch.zeros((1,), dtype=scan, device=dev)
    cur = 0
    progressed = True
    with shards.bfs_loop():
        while progressed and cur < n + 1:
            lev_ext = torch.cat([level, unv_pad])
            active = (lev_ext[dst_c] == cur).reshape(-1)
            csum = torch.cat([zero1, torch.cumsum(active, 0, dtype=scan)])
            mine = (csum[hi] - csum[lo]) > 0
            reached = shards.pmax(mine.to(wire))
            newly = (level == UNVISITED) & (reached > 0)
            any_new = newly.any()
            level = torch.where(newly, cur + 1, level)
            still = level == UNVISITED
            need_seed = ~any_new & still.any()
            seed = torch.argmax(still.to(torch.int32))
            level = torch.where(need_seed & (ids[:n] == seed), cur + 1,
                                level)
            progressed = bool((any_new | need_seed).item())
            cur += 1
    return level
