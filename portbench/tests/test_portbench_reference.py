"""The plain reference against a brute-force count and the port's CPU
count, for triangles and every vertex's count; its BFS levels against
the program's."""
import _setup  # noqa: F401
import numpy as np
import pytest
import torch

from portbench import graphs, reference

CPU = torch.device("cpu")


def brute(edges, n):
    """Triangles and per-vertex counts from the dense cube of the
    adjacency matrix."""
    a = np.zeros((n, n), dtype=np.int64)
    for u, v in edges:
        if u != v:
            a[u, v] = a[v, u] = 1
    a3 = a @ a @ a
    return int(np.trace(a3)) // 6, np.diag(a3) // 2


def karate():
    from repro_torch.graph import generators as gen

    return gen.karate()


def small_graphs():
    rng = np.random.default_rng(4)
    out = [("karate", *karate())]
    for s in range(3):
        n = int(rng.integers(5, 60))
        m = int(rng.integers(0, 4 * n))
        e = rng.integers(0, n, (m, 2))   # with loops and repeats
        out.append((f"random{s}", e, n))
    out.append(("complete9", np.array([(i, j) for i in range(9)
                                       for j in range(9)]), 9))
    return out


@pytest.mark.parametrize("name,edges,n", small_graphs(),
                         ids=[g[0] for g in small_graphs()])
@pytest.mark.parametrize("chunk", [1, 7, reference.WEDGE_CHUNK])
def test_reference_equals_brute_force(name, edges, n, chunk):
    t, pv = reference.triangles(edges, n, device=CPU, per_vertex=True,
                                chunk=chunk)
    bt, bpv = brute(edges, n)
    assert t == bt
    assert np.array_equal(pv.numpy(), bpv)
    if name == "karate":
        assert t == 45


def _pool(cfg, seed=7):
    return graphs.make_pool(dict(cfg, pool_seeds=[3]), seed, CPU)[0][0]


CASES = [
    ("rmat10", {"generator": "rmat", "scale": 10, "edge_factor": 16,
                "a": 0.57, "b": 0.19, "c": 0.19}),
    ("rmat12", {"generator": "rmat", "scale": 12, "edge_factor": 16,
                "a": 0.57, "b": 0.19, "c": 0.19}),
    ("urand11", {"generator": "urand", "scale": 11, "degree": 16}),
]


@pytest.mark.parametrize("name,cfg", CASES, ids=[c[0] for c in CASES])
def test_reference_equals_the_ports_cpu_count(name, cfg):
    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.sequential import StageClock

    edges, n = _pool(cfg)
    clock = StageClock(CPU)
    rep = TriangleEngine(device="cpu").count(
        (edges, n), route="local", options=TCOptions(per_vertex=True),
        clock=clock)
    t, pv = reference.triangles(edges, n, device=CPU, per_vertex=True,
                                chunk=1 << 14)
    assert t == rep.triangles
    assert np.array_equal(pv.numpy(), rep.per_vertex)
    lo, hi = reference.simple_graph(edges, n, CPU)
    level, sweeps = reference.bfs_levels(lo, hi, n)
    assert np.array_equal(level.numpy(), rep.levels)
    assert sweeps == clock.counts["bfs_sweeps"]
    assert int((level[lo] == level[hi]).sum()) == rep.num_horizontal


def test_simple_graph_drops_loops_and_merges_repeats():
    e = np.array([[0, 1], [1, 0], [2, 2], [1, 2], [1, 2], [3, 0]])
    lo, hi = reference.simple_graph(e, 4, CPU)
    assert lo.tolist() == [0, 0, 1] and hi.tolist() == [1, 3, 2]


def test_bfs_reseeds_each_component_at_its_smallest_vertex():
    # components {0, 1, 2} (a path from the root), {3, 4}, {5} alone,
    # {6, 7, 8} (a path whose smallest vertex is its middle)
    e = np.array([[0, 1], [1, 2], [4, 3], [7, 6], [6, 8]])
    lo, hi = reference.simple_graph(e, 9, CPU)
    level, sweeps = reference.bfs_levels(lo, hi, 9)
    assert level.tolist() == [0, 1, 2, 3, 4, 0, 5, 6, 6]
    assert sweeps == 7
