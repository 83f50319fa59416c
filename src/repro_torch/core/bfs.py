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
