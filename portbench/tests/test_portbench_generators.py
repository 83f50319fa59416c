"""The benchmark's generators: seeded, Graph500's initiator for R-MAT,
uniform endpoints for urand, and a pool whose seed relabels isomorphic
graphs."""
import _setup  # noqa: F401
import numpy as np
import pytest
import torch

from portbench import graphs, reference
from portbench.graphs import load_module

RMAT = {"generator": "rmat", "scale": 10, "edge_factor": 16,
        "a": 0.57, "b": 0.19, "c": 0.19, "d": 0.05}
URAND = {"generator": "urand", "scale": 10, "degree": 16}


def _make(cfg, seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return load_module("generators", cfg["generator"]).make(cfg, g)


@pytest.mark.parametrize("cfg", [RMAT, URAND], ids=["rmat", "urand"])
def test_generator_is_seeded_and_sized(cfg):
    e1, n = _make(cfg, 5)
    e2, _ = _make(cfg, 5)
    e3, _ = _make(cfg, 6)
    assert n == 1 << 10
    assert e1.shape == (16 * n, 2) and e1.dtype == torch.int64
    assert torch.equal(e1, e2)
    assert not torch.equal(e1, e3)
    assert int(e1.min()) >= 0 and int(e1.max()) < n


def test_rmat_quadrants_follow_graph500_initiator():
    # scale 1: each edge is one quadrant; the label permutation of two
    # vertices either keeps or swaps them, so a and d may trade places
    cfg = dict(RMAT, scale=1, edge_factor=100_000)
    e, n = _make(cfg, 11)
    m = e.shape[0]
    q = {(i, j): float(((e[:, 0] == i) & (e[:, 1] == j)).sum()) / m
         for i in (0, 1) for j in (0, 1)}
    big, small = max(q[0, 0], q[1, 1]), min(q[0, 0], q[1, 1])
    assert abs(big - 0.57) < 0.01 and abs(small - 0.05) < 0.01
    assert abs(q[0, 1] - 0.19) < 0.01 and abs(q[1, 0] - 0.19) < 0.01


def test_rmat_rejects_a_bad_initiator():
    with pytest.raises(ValueError):
        _make(dict(RMAT, a=0.9, b=0.3, c=0.3), 0)


def test_urand_endpoints_are_uniform():
    cfg = dict(URAND, scale=6, degree=4096)
    e, n = _make(cfg, 3)
    counts = torch.bincount(e.reshape(-1), minlength=n).double()
    mean = counts.mean()
    # each count is ~Binomial(2m, 1/n): its sd is ~sqrt(mean)
    assert float((counts - mean).abs().max()) < 6 * float(mean.sqrt())


def test_run_seed_takes_seeds_past_32_bits():
    a = graphs.run_seed(2**31 + 12345, 0)
    b = graphs.run_seed(2**31 + 12346, 0)
    c = graphs.run_seed(2**31 + 12345, 1)
    assert len({a, b, c}) == 3 and all(0 <= x < 2**63 for x in (a, b, c))
    assert graphs.run_seed(2**33, 0) == graphs.run_seed(2**33, 0)


@pytest.mark.parametrize("cfg", [RMAT, URAND], ids=["rmat", "urand"])
def test_pool_relabels_the_same_graphs(cfg):
    cfg = dict(cfg, pool_seeds=[1, 2])
    dev = torch.device("cpu")
    p1, w1 = graphs.make_pool(cfg, 2**31 + 7, dev)
    p1b, w1b = graphs.make_pool(cfg, 2**31 + 7, dev)
    p2, _ = graphs.make_pool(cfg, 99, dev)
    assert len(p1) == 2
    assert np.array_equal(w1[0], w1b[0])
    for (a, n), (b, _), (c, _) in zip(p1, p1b, p2):
        assert a.dtype == np.int64 and a.shape == (16 * n, 2)
        assert np.array_equal(a, b)            # the seed fixes the inputs
        assert not np.array_equal(a, c)        # another seed, other labels
        da = np.bincount(a.reshape(-1), minlength=n)
        dc = np.bincount(c.reshape(-1), minlength=n)
        assert np.array_equal(np.sort(da), np.sort(dc))   # isomorphic
        assert da[0] == dc[0]                  # the root keeps its place
        assert graphs.giant_root(torch.from_numpy(a), n) == 0
        assert (reference.triangles(a, n, device=dev)[0]
                == reference.triangles(c, n, device=dev)[0])
    # two pool slots are two different graphs; the warm-up graph is the
    # first one under labels of its own
    assert not np.array_equal(p1[0][0], p1[1][0])
    wd = np.bincount(w1[0].reshape(-1), minlength=w1[1])
    d0 = np.bincount(p1[0][0].reshape(-1), minlength=p1[0][1])
    assert not np.array_equal(w1[0], p1[0][0])
    assert np.array_equal(np.sort(wd), np.sort(d0)) and wd[0] == d0[0]


def test_giant_root_is_the_largest_components_smallest_vertex():
    e = torch.tensor([[1, 2], [2, 3], [5, 6], [6, 7], [7, 4]])
    assert graphs.giant_root(e, 8) == 4        # 0 alone, {1,2,3}, {4..7}
    # R-MAT base seed 1 at scale 12 leaves vertex 0 without edges; the
    # pool still starts the BFS in the giant component
    cfg = dict(RMAT, scale=12, pool_seeds=[1])
    base, n = _make(cfg, 1)
    assert int((base == 0).sum()) == 0
    root = graphs.giant_root(base, n)
    assert root > 0 and int((base == root).sum()) > 0
    (edges, _), = graphs.make_pool(cfg, 5, torch.device("cpu"))[0]
    assert graphs.giant_root(torch.from_numpy(edges), n) == 0
    deg = np.bincount(edges.reshape(-1), minlength=n)
    assert deg[0] == int((base == root).sum())
