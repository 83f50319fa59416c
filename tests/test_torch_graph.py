"""The port's graph substrate, BFS and edge classes held bit for bit
against the JAX package: generators, ``from_edges`` (set semantics and
index width), ``graph_from_numpy``, the CSR helpers, ``bfs_levels`` and
``horizontal_queries``.  Data crosses between the packages only as
numpy arrays made from a seed.  Also: the port imports neither JAX nor
``repro``, and its entry points refuse to run on a host without a card
unless asked for the CPU."""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs as jbfs
from repro.core import edges as jedges
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro_torch.analysis import dtypes as tdtypes
from repro_torch.core import bfs as tbfs
from repro_torch.core import edges as tedges
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CPU path is small; one thread avoids oversubscribing the host
    # when the suite runs in several worker processes
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _pair(edges, n, **kw):
    return (jcsr.from_edges(edges, n, **kw),
            tcsr.from_edges(edges, n, device=CPU, **kw))


def _assert_graph_equal(jg, tg):
    assert tg.n_nodes == jg.n_nodes
    for name in ("src", "dst", "row_offsets", "deg", "n_edges_dir"):
        a, b = _np(getattr(jg, name)), _np(getattr(tg, name))
        assert b.dtype == np.int32 == a.dtype, name
        assert a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# ------------------------------------------------------------ generators

GENERATOR_CASES = {
    "rmat8": ("rmat", (8, 8), {"seed": 1}),
    "rmat10": ("rmat", (10, 16), {"seed": 0}),
    "erdos_renyi": ("erdos_renyi", (200, 0.05), {"seed": 3}),
    "complete": ("complete", (9,), {}),
    "path": ("path", (12,), {}),
    "star": ("star", (10,), {}),
    "ring_of_cliques": ("ring_of_cliques", (5, 6), {}),
    "karate": ("karate", (), {}),
    "dolphins_like": ("dolphins_like", (), {}),
    "random_geometric": ("random_geometric", (80, 0.25), {"seed": 2}),
}


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_generators_match_reference(case):
    fn, args, kw = GENERATOR_CASES[case]
    je, jn = getattr(jgen, fn)(*args, **kw)
    te, tn = getattr(tgen, fn)(*args, **kw)
    assert tn == jn
    assert te.dtype == je.dtype
    np.testing.assert_array_equal(te, je)


# ------------------------------------------------------------ from_edges

def _edge_cases():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 40, size=(120, 2))
    return {
        "karate": tgen.karate(),
        "duplicates_and_reversed": (
            np.concatenate([base, base[:, ::-1], base[:30]]), 40),
        "self_loops": (np.array([[0, 0], [1, 2], [2, 2], [2, 1], [3, 3]]), 5),
        "empty_edges": (np.zeros((0, 2), np.int64), 7),
        "zero_nodes": (np.zeros((0, 2), np.int64), 0),
        "isolated_vertices": (np.array([[0, 5], [5, 9], [0, 9]]), 16),
        "rmat8": tgen.rmat(8, 8, seed=1),
    }


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_from_edges_matches_reference(case):
    edges, n = _edge_cases()[case]
    _assert_graph_equal(*_pair(edges, n))


@pytest.mark.parametrize("extra", [0, 1, 37])
def test_from_edges_num_slots_padding_matches(extra):
    edges, n = tgen.karate()
    m2 = 2 * 78
    _assert_graph_equal(*_pair(edges, n, num_slots=m2 + extra))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("case", ["karate", "self_loops", "empty_edges",
                                  "rmat8"])
def test_from_edges_takes_a_tensor(case, dtype, monkeypatch):
    """An edge tensor already on the device packs there, with no numpy
    round trip, into the same arrays; ``num_slots`` pads as before."""
    edges, n = _edge_cases()[case]
    e = torch.from_numpy(np.asarray(edges, dtype=np.int64)).to(dtype)
    jg = jcsr.from_edges(edges, n, num_slots=2 * len(edges) + 5)

    def no_host_copy(*_a, **_k):
        raise AssertionError("from_edges took the numpy path")

    monkeypatch.setattr(tcsr.np, "asarray", no_host_copy)
    tg = tcsr.from_edges(e, n, num_slots=2 * len(edges) + 5, device=CPU)
    monkeypatch.undo()
    _assert_graph_equal(jg, tg)
    assert bool((tg.src[int(tg.n_edges_dir):] == n).all())


def test_from_edges_rejects_short_slot_budget():
    edges, n = tgen.karate()
    with pytest.raises(ValueError, match="num_slots"):
        jcsr.from_edges(edges, n, num_slots=10)
    with pytest.raises(ValueError, match="num_slots"):
        tcsr.from_edges(edges, n, num_slots=10, device=CPU)


def test_index_width_policy():
    assert tdtypes.index_dtype(tdtypes.INT32_MAX) == np.int32
    assert tdtypes.index_dtype(tdtypes.INT32_MAX + 1) == np.int64
    assert tdtypes.torch_index_dtype(2**31 - 1, site="t") == torch.int32
    with pytest.raises(tdtypes.IndexWidthError, match="need int64"):
        tdtypes.torch_index_dtype(2**31, site="t")
    with pytest.raises(ValueError):
        tdtypes.index_dtype(-1)
    # past int32 vertex ids: both packages refuse before allocating
    none = np.zeros((0, 2), np.int64)
    from repro.analysis.dtypes import IndexWidthError as JErr

    with pytest.raises(JErr):
        jcsr.from_edges(none, 2**31)
    with pytest.raises(tdtypes.IndexWidthError):
        tcsr.from_edges(none, 2**31, device=CPU)


@pytest.mark.parametrize("case", ["karate", "rmat8", "isolated_vertices"])
def test_graph_from_numpy_round_trips_a_reference_graph(case):
    edges, n = _edge_cases()[case]
    jg = jcsr.from_edges(edges, n, num_slots=None)
    tg = tcsr.graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in
          ("src", "dst", "row_offsets", "deg", "n_edges_dir")),
        jg.n_nodes, device=CPU,
    )
    _assert_graph_equal(jg, tg)


# ---------------------------------------------------------- CSR helpers

def test_undirected_edges_and_max_degree_match():
    edges, n = tgen.rmat(8, 8, seed=1)
    jg, tg = _pair(edges, n, num_slots=2 * 4000)
    for a, b in zip(jcsr.undirected_edges(jg), tcsr.undirected_edges(tg)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert tcsr.max_degree(tg) == jcsr.max_degree(jg)
    assert tcsr._next_pow2(300) == jcsr._next_pow2(300) == 512
    assert tcsr._ceil_to(130, 64) == jcsr._ceil_to(130, 64) == 192


@pytest.mark.parametrize("width,pad", [(1, -1), (8, -2), (40, -1)])
def test_gather_rows_matches(width, pad):
    rng = np.random.default_rng(width)
    flat = np.sort(rng.integers(0, 500, size=300)).astype(np.int32)
    starts = rng.integers(0, 300, size=50).astype(np.int32)
    lens = rng.integers(0, 30, size=50).astype(np.int32)
    a = jcsr.gather_rows(jnp.asarray(flat), jnp.asarray(starts),
                         jnp.asarray(lens), width=width, pad=pad)
    b = tcsr.gather_rows(torch.from_numpy(flat), torch.from_numpy(starts),
                         torch.from_numpy(lens), width=width, pad=pad)
    np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize("num_steps", [1, 3, 9])
def test_bounded_binary_search_matches_including_under_search(num_steps):
    rng = np.random.default_rng(num_steps)
    rows = [np.unique(rng.integers(0, 400, size=rng.integers(0, 200)))
            for _ in range(40)]
    flat = np.concatenate(rows).astype(np.int32)
    starts = np.cumsum([0] + [len(r) for r in rows[:-1]]).astype(np.int32)
    lens = np.array([len(r) for r in rows], np.int32)
    queries = rng.integers(-1, 400, size=(40, 16)).astype(np.int32)
    s2 = np.broadcast_to(starts[:, None], queries.shape).copy()
    l2 = np.broadcast_to(lens[:, None], queries.shape).copy()
    a = jcsr.bounded_binary_search(
        jnp.asarray(flat), jnp.asarray(s2), jnp.asarray(l2),
        jnp.asarray(queries), num_steps=num_steps)
    b = tcsr.bounded_binary_search(
        torch.from_numpy(flat), torch.from_numpy(s2), torch.from_numpy(l2),
        torch.from_numpy(queries), num_steps=num_steps)
    np.testing.assert_array_equal(_np(b), np.asarray(a))


# ------------------------------------------------------------------- BFS

def _two_components_with_isolated():
    a = tgen.ring_of_cliques(3, 4)[0]
    b = tgen.path(6)[0] + 20
    return np.concatenate([a, b]), 30


BFS_CASES = {
    "ring_of_cliques": tgen.ring_of_cliques(5, 6),
    "star": tgen.star(12),
    "path": tgen.path(15),
    "isolated_and_components": _two_components_with_isolated(),
    "karate": tgen.karate(),
    "rmat10": tgen.rmat(10, 16, seed=0),
}


def _levels_pair(edges, n, root=0):
    jg, tg = _pair(edges, n)
    jl = jbfs.bfs_levels(jg.src, jg.dst, n, root=root,
                         row_offsets=jg.row_offsets)
    tl = tbfs.bfs_levels(tg.src, tg.dst, n, root=root,
                         row_offsets=tg.row_offsets)
    return jg, tg, jl, tl


@pytest.mark.parametrize("case", sorted(BFS_CASES))
def test_bfs_levels_match_reference(case):
    _, _, jl, tl = _levels_pair(*BFS_CASES[case])
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))


@pytest.mark.parametrize("root", [3, 21, 29])
def test_bfs_levels_match_reference_from_other_roots(root):
    _, _, jl, tl = _levels_pair(*_two_components_with_isolated(), root=root)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))


def test_bfs_sweep_count_is_reported():
    edges, n = tgen.path(15)
    tg = tcsr.from_edges(edges, n, device=CPU)
    level, sweeps = tbfs.bfs_levels_iters(tg.src, tg.dst, n,
                                          row_offsets=tg.row_offsets)
    # 14 levels reached one per sweep, one sweep that finds nothing
    assert int(level.max()) == 14 and sweeps == 15


# ----------------------------------------------------- edge classification

@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("case", ["ring_of_cliques", "star", "rmat10",
                                  "isolated_and_components"])
def test_horizontal_queries_match_reference(case, order):
    jg, tg, jl, tl = _levels_pair(*BFS_CASES[case])
    ja = jedges.horizontal_queries(jg, jl, order=order)
    ta = tedges.horizontal_queries(tg, tl, order=order)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_horizontal_queries_rejects_bad_order():
    edges, n = tgen.karate()
    tg = tcsr.from_edges(edges, n, device=CPU)
    lev = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="order must be"):
        tedges.horizontal_queries(tg, lev, order="up")


@pytest.mark.parametrize("case", ["karate", "star", "rmat10"])
def test_masks_classes_and_k_match_reference(case):
    jg, tg, jl, tl = _levels_pair(*BFS_CASES[case])
    n = jg.n_nodes
    np.testing.assert_array_equal(
        _np(tedges.horizontal_mask(tg.src, tg.dst, tl, n)),
        np.asarray(jedges.horizontal_mask(jg.src, jg.dst, jl, n)))
    np.testing.assert_array_equal(
        _np(tedges.classify_edges(tg.src, tg.dst, tl, n)),
        np.asarray(jedges.classify_edges(jg.src, jg.dst, jl, n)))
    jk = np.asarray(jedges.k_fraction(jg.src, jg.dst, jl, n))
    tk = _np(tedges.k_fraction(tg.src, tg.dst, tl, n))
    assert tk.dtype == np.float32 == jk.dtype
    assert tk.tobytes() == jk.tobytes()


def test_classify_edges_unvisited_guard():
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([1, 0, 3], dtype=torch.int32)
    lev = torch.tensor([0, 0, tbfs.UNVISITED, tbfs.UNVISITED],
                       dtype=torch.int32)
    out = tedges.classify_edges(src, dst, lev, 4)
    ref = jedges.classify_edges(jnp.asarray(_np(src)), jnp.asarray(_np(dst)),
                                jnp.asarray(_np(lev)), 4)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    assert _np(out).tolist() == [1, 1, 0]


# --------------------------------------------------- package boundaries

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro[\s.])",
    re.M,
)


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    text = path.read_text()
    assert not _FORBIDDEN.search(text), (
        f"{path} imports jax or the JAX package")


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from repro_torch.api import TriangleEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges, n = tgen.karate()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TriangleEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcsr.from_edges(edges, n)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcsr.graph_from_numpy(*(np.zeros(1, np.int32),) * 5, 0)
    assert TriangleEngine(device="cpu").count((edges, n)).triangles == 45
