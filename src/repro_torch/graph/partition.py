"""Degree-balanced 1-D vertex partitioning (paper §V: ~2m/p edge
endpoints per processor), the port's copy of ``repro.graph.partition``:
the same bounds (host numpy, from the row offsets) and the same
sentinel-padded shards (on the graph's device).

``vertex_partition`` computes contiguous vertex ranges whose CSR slices
are as equal as possible — the paper's non-uniform vertex partition.
``shard_edges`` materializes per-shard, equal-capacity edge arrays
(sentinel padded) for the distributed route's shard group
(``core/shards.py``).  Each shard is a run of whole CSR rows, so its
edges stay sorted by ``(src, dst)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.csr import Graph


def vertex_partition(row_offsets: np.ndarray, p: int) -> np.ndarray:
    """Return ``bounds`` int64[p+1]: processor i owns vertices
    ``[bounds[i], bounds[i+1])`` with ~2m/p edge endpoints each."""
    row_offsets = np.asarray(row_offsets)
    n = row_offsets.shape[0] - 2  # Graph keeps an extra sentinel row
    total = int(row_offsets[n])
    targets = (np.arange(1, p) * total) // p
    cuts = np.searchsorted(row_offsets[: n + 1], targets, side="left")
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    return np.maximum.accumulate(bounds)


def shard_edges(g: Graph, p: int, *, capacity: int | None = None):
    """Split the CSR edge list into ``p`` equal-capacity shards by owner
    (= src) vertex.  Returns ``(src[p, cap], dst[p, cap], counts[p],
    bounds[p+1])``: the reference's arrays, the shards as int32 tensors
    on the graph's device (built there: only the row offsets come to the
    host), ``counts`` and ``bounds`` int64 numpy; padded entries are the
    sentinel ``n``."""
    row = g.row_offsets.cpu().numpy()
    bounds = vertex_partition(row, p)
    starts = row[bounds[:-1]]
    ends = row[bounds[1:]]
    counts = (ends - starts).astype(np.int64)
    cap = int(capacity) if capacity is not None else int(counts.max()) if p else 0
    cap = max(cap, 1)
    if counts.max(initial=0) > cap:
        raise ValueError(f"capacity {cap} < max shard size {counts.max()}")
    s_sh = torch.full((p, cap), g.n_nodes, dtype=torch.int32,
                      device=g.device)
    d_sh = torch.full_like(s_sh, g.n_nodes)
    for i in range(p):
        a, b = int(starts[i]), int(ends[i])
        s_sh[i, : b - a] = g.src[a:b]
        d_sh[i, : b - a] = g.dst[a:b]
    return s_sh, d_sh, counts, bounds
