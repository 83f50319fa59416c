"""The plain reference: triangle counts, each vertex's count and the BFS
levels of a graph, from its raw edge list, in plain PyTorch.

It imports nothing of the program and uses nothing the program made: it
starts again from the same host edge list the program was handed.  The
count is the textbook one, with no BFS and no cover edges: orient each
edge from its endpoint of lower ``(degree, id)`` rank to the higher one;
every triangle ``r1 < r2 < r3`` is then the one wedge ``r1 -> r2, r1 ->
r3`` at its lowest corner whose closing edge ``r2 -> r3`` exists, looked
up by binary search in the sorted edge keys.  The wedges are enumerated
in chunks, so that it fits beside nothing else on the card.

``bfs_levels`` follows the program's documented BFS rule (edge-less
vertices at level 0, the root at 0, one frontier sweep at a time, the
smallest unvisited vertex reseeded when the frontier dies), so its
horizontal edges are the ones the program intersects; the benchmark
reads them for the intersection work (``work.py``), not for ``correct``.
"""
from __future__ import annotations

import numpy as np
import torch

#: wedges looked up per chunk (~5 int64 arrays of this length live)
WEDGE_CHUNK = 1 << 26


def simple_graph(edges, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` int64: the graph's undirected edges as a set, ``lo <
    hi``, sorted; self-loops dropped, repeats and reversed repeats
    merged."""
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64)).to(device)
    e = e.reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    lo = torch.minimum(e[:, 0], e[:, 1])
    hi = torch.maximum(e[:, 0], e[:, 1])
    del e
    key = torch.unique(lo * n + hi, sorted=True)
    return key // n, key % n


def degrees(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Each vertex's degree in the simple graph ``(lo, hi)``."""
    return (torch.bincount(lo, minlength=n)
            + torch.bincount(hi, minlength=n))


def triangles(edges, n: int, *, device, per_vertex: bool = False,
              chunk: int = WEDGE_CHUNK):
    """``(T, per_vertex)``: the number of triangles of the graph and,
    with ``per_vertex``, each vertex's number of triangles as an int64
    tensor on ``device`` (else ``None``)."""
    lo, hi = simple_graph(edges, n, device)
    deg = degrees(lo, hi, n)
    ids = torch.arange(n, dtype=torch.int64, device=device)
    order = torch.argsort(deg * n + ids)           # rank -> vertex
    rank = torch.empty_like(order)
    rank[order] = ids                              # vertex -> rank
    del deg, ids
    ra, rb = rank[lo], rank[hi]
    del lo, hi, rank
    key = torch.sort(torch.minimum(ra, rb) * n + torch.maximum(ra, rb)).values
    del ra, rb
    a, b = key // n, key % n                       # a -> b, a < b, sorted
    m = key.shape[0]
    out_deg = torch.bincount(a, minlength=n)
    row_end = torch.cumsum(out_deg, 0)             # end of a's out-list
    del out_deg
    pos = torch.arange(m, dtype=torch.int64, device=device)
    partners = row_end[a] - pos - 1                # later slots of a's list
    del row_end
    cum = torch.cumsum(partners, 0)
    wedges = int(cum[-1].item()) if m else 0
    total = 0
    pv = torch.zeros(n, dtype=torch.int64, device=device) if per_vertex \
        else None
    if wedges:
        cuts = [0, m]
        if wedges > chunk:
            marks = torch.arange(chunk, wedges, chunk, dtype=torch.int64,
                                 device=device)
            cuts[1:1] = torch.searchsorted(cum, marks, right=True).tolist()
        for p0, p1 in zip(cuts, cuts[1:]):
            if p1 <= p0:
                continue
            cnt = partners[p0:p1]
            w = int(cnt.sum().item())
            if w == 0:
                continue
            p = torch.repeat_interleave(pos[p0:p1], cnt)
            first = torch.cumsum(cnt, 0) - cnt         # each slot's first
            j = torch.arange(w, dtype=torch.int64, device=device) \
                - torch.repeat_interleave(first, cnt)
            q = p + 1 + j
            del first, j
            want = b[p] * n + b[q]
            at = torch.searchsorted(key, want).clamp_(max=m - 1)
            hit = key[at] == want
            del want, at
            total += int(hit.sum().item())
            if per_vertex:
                p, q = p[hit], q[hit]
                for corner in (a[p], b[p], b[q]):
                    pv += torch.bincount(order[corner], minlength=n)
            del p, q, hit
    return total, pv


UNVISITED = -1


def bfs_levels(lo: torch.Tensor, hi: torch.Tensor, n: int,
               root: int = 0) -> tuple[torch.Tensor, int]:
    """``(level int64[n], sweeps)`` by the program's BFS rule (module
    docstring): one frontier sweep at a time; when a sweep reaches
    nothing new while vertices with edges are unvisited, the smallest of
    them starts the next level."""
    dev = lo.device
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    has_edge = torch.bincount(src, minlength=n) > 0
    level = torch.where(has_edge, UNVISITED, 0).to(torch.int64)
    level[root] = 0
    cur = 0
    while cur < n + 1:
        reached = torch.zeros(n, dtype=torch.bool, device=dev)
        reached[src[level[dst] == cur]] = True
        newly = reached & (level == UNVISITED)
        level[newly] = cur + 1
        progressed = bool(newly.any().item())
        if not progressed:
            left = (level == UNVISITED).nonzero()
            if left.numel():
                level[left[0, 0]] = cur + 1
                progressed = True
        cur += 1
        if not progressed:
            break
    return level, cur
