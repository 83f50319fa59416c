"""The path-independent intersection work, held to a count by hand (plain
Python loops over the edges) on karate and a small R-MAT graph, and the
peaks that turn it into a least time."""
import _setup  # noqa: F401
from collections import deque

import numpy as np
import pytest
import torch

from portbench import graphs, reference, work

CPU = torch.device("cpu")


def by_hand(edges, n):
    """Horizontal edges, operations and bytes with sets and loops: BFS
    from 0 with each further component started at its smallest vertex,
    then the module's rules one edge at a time."""
    adj = [set() for _ in range(n)]
    for u, v in edges:
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    level = [None] * n
    base = 0
    for s in [0] + list(range(n)):
        if level[s] is not None or (s != 0 and not adj[s]):
            continue
        level[s] = base
        todo = deque([s])
        while todo:
            x = todo.popleft()
            for y in adj[x]:
                if level[y] is None:
                    level[y] = level[x] + 1
                    todo.append(y)
        base = max(v for v in level if v is not None) + 1
    horizontal = [(u, w) for u in range(n) for w in adj[u]
                  if u < w and level[u] == level[w]]
    ops = sum(min(len(adj[u]), len(adj[w])) for u, w in horizontal)
    ends = {x for e in horizontal for x in e}
    named = set(ends) | {y for x in ends for y in adj[x]}
    nbytes = (4 * sum(len(adj[x]) for x in ends) + 8 * len(horizontal)
              + 4 * len(named))
    return {"horizontal": len(horizontal), "ops": ops, "bytes": nbytes}


def _graphs():
    from repro_torch.graph import generators as gen

    e, n = graphs.make_pool(
        {"generator": "rmat", "scale": 8, "edge_factor": 8, "a": 0.57,
         "b": 0.19, "c": 0.19, "pool_seeds": [5]}, 3, CPU)[0][0]
    return [("karate", *gen.karate()), ("rmat8", e, n)]


@pytest.mark.parametrize("name,edges,n", _graphs(),
                         ids=[g[0] for g in _graphs()])
def test_work_equals_a_count_by_hand(name, edges, n):
    lo, hi = reference.simple_graph(edges, n, CPU)
    level, _ = reference.bfs_levels(lo, hi, n)
    got = work.intersection_work(lo, hi, n, level)
    assert got == by_hand(np.asarray(edges), n)
    assert got["horizontal"] > 0


def test_karate_work_by_hand():
    # karate from vertex 0 (degree 16): levels 1, 2 and 3 hold 16, 9 and
    # 8 vertices; 28 of the 78 edges are horizontal, and the totals pin
    # the arithmetic down
    from repro_torch.graph import generators as gen

    e, n = gen.karate()
    lo, hi = reference.simple_graph(e, n, CPU)
    level, sweeps = reference.bfs_levels(lo, hi, n)
    assert [int((level == k).sum()) for k in (1, 2, 3)] == [16, 9, 8]
    assert sweeps == 4
    got = work.intersection_work(lo, hi, n, level)
    assert got == by_hand(e, n) == {"horizontal": 28, "ops": 116,
                                    "bytes": 840}


def test_least_seconds_takes_the_larger_bound():
    t, by = work.least_seconds({"ops": int(work.INT32_OPS_PER_S),
                                "bytes": 1})
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = work.least_seconds({"ops": 1, "bytes": 2 * 3.35e12})
    assert by == "bytes" and t == pytest.approx(2.0)


def test_published_peaks():
    assert work.HBM_BYTES_PER_S == 3.35e12
    assert work.INT32_OPS_PER_S == pytest.approx(1.672704e13)


def test_card_readout_is_text_without_a_card():
    assert isinstance(work.card(), str)
