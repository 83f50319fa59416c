"""The batch route of the port held against the JAX package on the CPU:
packing (``from_edges_batch``, ``GraphBatch``, ``BatchDegreeMeta``,
``BudgetGrid``, ``to_batch``), the batched BFS and compaction, the
bounded planner, ``TriangleEngine.count_batch`` on the bounded and the
exact path (triangles, c1, c2, n_h, k as float32 bits, levels, overflow,
per-vertex credit and the plan work counts, bit for bit), the batch
route of ``count``, the refusals, and the plan cache's hits, misses and
evictions on engine-owned caches.  The reference runs its ``jnp``
backend (its ``auto`` on this host), and once its Pallas kernel in
interpret mode."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import bfs as jbfs
from repro.core import edges as jedges
from repro.core import intersect as jint
from repro.graph import csr as jcsr
from repro_torch import api as tapi
from repro_torch.analysis.dtypes import IndexWidthError
from repro_torch.core import bfs as tbfs
from repro_torch.core import edges as tedges
from repro_torch.core import intersect as tint
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


EMPTY = (np.zeros((0, 2), np.int64), 0)
#: the fixtures of tests/test_torch_count.py that share one budget cell
#: with rmat10, and a mixed-size list over one cell of its own
MIXES = {
    "fixtures": [gen.karate(), gen.path(12), gen.star(10), gen.complete(9),
                 gen.ring_of_cliques(5, 6), gen.rmat(10, 16, seed=0)],
    "mixed": [gen.erdos_renyi(90, 0.1, seed=3), gen.rmat(7, 8, seed=2),
              gen.complete(12), EMPTY, gen.rmat(6, 8, seed=5),
              gen.dolphins_like()],
}


def _np(x):
    return np.asarray(x)


def _assert_batch_equal(jb, tb):
    for f in ("src", "dst", "row_offsets", "deg", "n_nodes", "n_edges_dir"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)), err_msg=f)
        assert getattr(tb, f).dtype == torch.int32, f
    assert tb.n_budget == jb.n_budget
    assert tb.meta == _meta(jb.meta)
    assert tb.budget == tcsr.ShapeBudget(jb.budget.n_budget,
                                         jb.budget.slot_budget)


def _meta(m):
    """A reference meta as the port's type (the same three fields)."""
    if m is None:
        return None
    return tcsr.BatchDegreeMeta(m.d_pad, m.h_rows, m.exceed)


# ------------------------------------------------------------- packing


@pytest.mark.parametrize("case", ["karate", "dups_and_loops", "empty",
                                  "no_edges", "rmat9"])
def test_normalize_edges_host_matches_reference(case):
    rng = np.random.default_rng(4)
    e = rng.integers(0, 30, size=(200, 2))
    inputs = {
        "karate": gen.karate(),
        "dups_and_loops": (np.r_[e, e[:, ::-1], [[3, 3], [7, 7]]], 30),
        "empty": EMPTY,
        "no_edges": (np.array([[2, 2]]), 5),
        "rmat9": gen.rmat(9, 8, seed=1),
    }
    edges, n = inputs[case]
    js, jd = jcsr._normalize_edges(edges, n)
    ts, td = tcsr._normalize_edges_host(edges, n)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    assert ts.dtype == np.int64


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("padded", [False, True], ids=["tight", "padded"])
def test_graph_batch_arrays_and_meta_match_reference(mix, padded):
    graphs = MIXES[mix]
    kw = dict(batch_size=len(graphs) + 2) if padded else {}
    jb = jcsr.from_edges_batch(graphs, **kw)
    tb = tcsr.from_edges_batch(graphs, device=CPU, **kw)
    _assert_batch_equal(jb, tb)
    budget = jcsr.ShapeBudget(2 * jb.n_budget, 2 * jb.slot_budget)
    jb = jcsr.from_edges_batch(graphs, budget=budget, with_meta=False)
    tb = tcsr.from_edges_batch(
        graphs, budget=tcsr.ShapeBudget(budget.n_budget, budget.slot_budget),
        with_meta=False, device=CPU)
    _assert_batch_equal(jb, tb)
    assert tb.meta is None


def test_degree_meta_and_union_match_reference():
    metas = []
    for edges, n in [*MIXES["mixed"], *MIXES["fixtures"]]:
        jm, tm = jcsr.degree_meta(edges, n), tcsr.degree_meta(edges, n)
        assert tm == _meta(jm)
        metas.append((jm, tm))
    ju, tu = metas[0]
    for jm, tm in metas[1:]:
        ju, tu = ju.union(jm), tu.union(tm)
        assert tu == _meta(ju)
    # the union of request metas bounds the batch's own meta
    graphs = MIXES["fixtures"]
    packed = tcsr.from_edges_batch(graphs, device=CPU).meta
    assert packed.union(tu) == tu
    bad = dataclasses.replace(tu, exceed=tu.exceed[:-1])
    with pytest.raises(ValueError, match="different width grids"):
        tu.union(bad)


GRIDS = [dict(), dict(min_nodes=32, min_slots=128, factor=1.5),
         dict(min_nodes=100, min_slots=300, factor=3.0, max_nodes=2700,
              max_slots=8100)]


@pytest.mark.parametrize("geometry", range(len(GRIDS)))
def test_budget_grid_cells_match_reference(geometry):
    jg, tg = jcsr.BudgetGrid(**GRIDS[geometry]), tcsr.BudgetGrid(
        **GRIDS[geometry])
    for n in (0, 1, 31, 63, 64, 65, 100, 1000, 2700, 5000):
        for m in (0, 5, 127, 128, 129, 4 * n, 4050, 20000):
            assert tg.fits(n, m) == jg.fits(n, m), (n, m)
            if jg.fits(n, m):
                b = jg.budget_for(n, m)
                assert tg.budget_for(n, m) == tcsr.ShapeBudget(
                    b.n_budget, b.slot_budget)
            else:
                with pytest.raises(ValueError) as je:
                    jg.budget_for(n, m)
                with pytest.raises(ValueError) as te:
                    tg.budget_for(n, m)
                assert str(te.value) == str(je.value)
    assert tg.capped == (tg.max_nodes is not None)


@pytest.mark.parametrize("kw", [dict(min_nodes=0), dict(min_slots=-1),
                                dict(factor=1.0), dict(max_nodes=8),
                                dict(max_slots=100)])
def test_budget_grid_validation_matches_reference(kw):
    with pytest.raises(ValueError) as je:
        jcsr.BudgetGrid(**kw)
    with pytest.raises(ValueError) as te:
        tcsr.BudgetGrid(**kw)
    assert str(te.value) == str(je.value)


def test_to_batch_matches_reference_and_index_width():
    edges, n = gen.karate()
    jb = jcsr.to_batch(jcsr.from_edges(edges, n))
    tb = tcsr.to_batch(tcsr.from_edges(edges, n, device=CPU))
    _assert_batch_equal(jb, tb)
    assert tb.meta is None and tb.batch_size == 1
    # the lane view numbers B * (n_budget + 1) ids in int32
    z = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(IndexWidthError, match="lane-view vertex ids"):
        tcsr.GraphBatch(z, z, z, z, z[:, 0], z[:, 0], n_budget=2**30)
    with pytest.raises(ValueError, match="n_budget=16"):
        tcsr.from_edges_batch([(edges, n)], budget=tcsr.ShapeBudget(16, 256),
                              device=CPU)
    with pytest.raises(ValueError, match="slot_budget=8"):
        tcsr.from_edges_batch([(edges, n)], budget=tcsr.ShapeBudget(64, 8),
                              device=CPU)
    with pytest.raises(ValueError, match="batch_size=1"):
        tcsr.from_edges_batch([(edges, n)] * 2, batch_size=1, device=CPU)


# ------------------------------------------------------------ planning


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_bfs_levels_batch_matches_reference_and_single_bfs(mix):
    graphs = MIXES[mix]
    jb = jcsr.from_edges_batch(graphs)
    tb = tcsr.from_edges_batch(graphs, device=CPU)
    want = _np(jbfs.bfs_levels_batch(jb.src, jb.dst, jb.n_budget, root=0,
                                     row_offsets=jb.row_offsets))
    got, sweeps = tbfs.bfs_levels_batch(tb.src, tb.dst, tb.n_budget, 0,
                                        row_offsets=tb.row_offsets)
    np.testing.assert_array_equal(got.numpy(), want)
    lane_sweeps = []
    for i, (edges, n) in enumerate(graphs):
        if n == 0:  # an empty request: every padding vertex at level 0
            assert not got[i].any()
            continue
        g = tcsr.from_edges(edges, n, device=CPU)
        one, s = tbfs.bfs_levels_iters(g.src, g.dst, n, 0,
                                       row_offsets=g.row_offsets)
        np.testing.assert_array_equal(got[i, :n].numpy(), one.numpy())
        # the padding vertices are isolated: seeded at level 0
        assert not got[i, n:].any()
        lane_sweeps.append(s)
    # the lanes share one sweep counter: the largest lane's sweeps (a
    # padded lane may need its own final sweep that finds nothing)
    assert max(lane_sweeps) <= sweeps <= max(lane_sweeps) + 1


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_lane_axis_compaction_and_k_match_reference(mix):
    graphs = MIXES[mix]
    jb = jcsr.from_edges_batch(graphs)
    tb = tcsr.from_edges_batch(graphs, device=CPU)
    jv, tv = jb.lane_view(), tb.lane_view()
    jlev = jbfs.bfs_levels_batch(jb.src, jb.dst, jb.n_budget,
                                 row_offsets=jb.row_offsets)
    tlev, _ = tbfs.bfs_levels_batch(tb.src, tb.dst, tb.n_budget,
                                    row_offsets=tb.row_offsets)
    want = jax.vmap(lambda g, lv: jedges.horizontal_queries(
        g, lv, order="desc"))(jv, jlev)
    got = tedges.horizontal_queries(tv, tlev, order="desc")
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), _np(w))
    jk = jax.vmap(lambda s, d, lv: jedges.k_fraction(s, d, lv, jb.n_budget))(
        jb.src, jb.dst, jlev)
    tk = tedges.k_fraction(tb.src, tb.dst, tlev, tb.n_budget)
    assert tk.dtype == torch.float32
    assert tk.numpy().tobytes() == _np(jk).astype(np.float32).tobytes()


def test_mindeg_exceedance_matches_reference():
    for edges, n in MIXES["fixtures"]:
        jg, tg = jcsr.from_edges(edges, n), tcsr.from_edges(edges, n,
                                                            device=CPU)
        widths = (1, 8, 32, 256)
        assert tedges.mindeg_exceedance(tg, widths) == \
            jedges.mindeg_exceedance(jg, widths)


BOUNDED_KW = [dict(), dict(bucket_widths=(8, 64, 1024)), dict(row_mult=64),
              dict(row_mult=128, query_chunk=128), dict(sort_queries=None)]


@pytest.mark.parametrize("kw", range(len(BOUNDED_KW)))
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_plan_buckets_bounded_matches_reference(mix, kw):
    meta = tcsr.from_edges_batch(MIXES[mix], device=CPU).meta
    o = dict(BOUNDED_KW[kw])
    o.setdefault("sort_queries", False)
    for rows, exceed in ((meta.h_rows, meta.exceed), (meta.h_rows, None),
                         (0, meta.exceed), (1000, ((32, 2000),))):
        jp = jint.plan_buckets_bounded(rows, d_pad=meta.d_pad,
                                       exceed=exceed, **o)
        tp = tint.plan_buckets_bounded(rows, d_pad=meta.d_pad,
                                       exceed=exceed, **o)
        assert [dataclasses.astuple(b) for b in tp.buckets] == [
            dataclasses.astuple(b) for b in jp.buckets]
        assert (tp.total_rows, tp.probe_rows, tp.probe_cells,
                tp.peak_rows) == (jp.total_rows, jp.probe_rows,
                                  jp.probe_cells, jp.peak_rows)
        assert tp.sort_queries == jp.sort_queries
        assert tp.query_chunk == jp.query_chunk


def test_sort_queries_plan_names_item_10():
    """Item 10 (the distributed route) ported the in-run sort: a plan
    with ``sort_queries=True`` over an unsorted block (ascending order)
    counts what the reference's ``run_plan`` counts, overflow included."""
    edges, n = gen.karate()
    g = tcsr.from_edges(edges, n, device=CPU)
    jg = jcsr.from_edges(edges, n)
    plan = tint.plan_buckets_bounded(78, d_pad=32, exceed=((8, 40),),
                                     bucket_widths=(8,))
    jplan = jint.plan_buckets_bounded(78, d_pad=32, exceed=((8, 40),),
                                      bucket_widths=(8,), backend="jnp")
    assert plan.sort_queries and len(plan.buckets) == 2
    qu, qw, *_ = tedges.horizontal_queries(
        g, tbfs.bfs_levels(g.src, g.dst, n, row_offsets=g.row_offsets))
    got = tint.run_plan(tint.CsrAdjacency.from_graph(g), qu, qw, plan,
                        level=None)
    want = jint.run_plan(jint.CsrAdjacency.from_graph(jg),
                         jax.numpy.asarray(qu.numpy()),
                         jax.numpy.asarray(qw.numpy()), jplan)
    assert (int(got.c1), bool(got.overflow)) == (int(want.c1),
                                                 bool(want.overflow))


# ------------------------------------------------------------ counting


def _engines(per_vertex, jkw=(("backend", "jnp"),), **kw):
    """The reference's engine (``jkw`` its own options) and the port's,
    both with ``per_vertex`` and ``kw``."""
    return (japi.TriangleEngine(japi.TCOptions(**dict(jkw),
                                               per_vertex=per_vertex, **kw)),
            tapi.TriangleEngine(tapi.TCOptions(per_vertex=per_vertex, **kw),
                                device=CPU))


def _assert_lane_reports_equal(jr, tr, per_vertex):
    assert (tr.triangles, tr.c1, tr.c2, tr.num_horizontal) == (
        jr.triangles, jr.c1, jr.c2, jr.num_horizontal)
    assert np.float32(tr.k).tobytes() == np.float32(jr.k).tobytes()
    assert tr.levels.dtype == np.int32
    np.testing.assert_array_equal(tr.levels, _np(jr.levels))
    assert tr.overflow.h == jr.overflow.h
    assert tr.route == jr.route == "batch"
    # the same plan, with the port's backend name
    assert tr.plan_id.split("/")[2:] == jr.plan_id.split("/")[2:]
    if per_vertex:
        np.testing.assert_array_equal(tr.per_vertex, _np(jr.per_vertex))
        np.testing.assert_array_equal(tr.degrees, _np(jr.degrees))
        assert int(tr.per_vertex.sum()) == 3 * tr.triangles
    else:
        assert tr.per_vertex is None and jr.per_vertex is None


def _assert_raw_equal(jres, tres):
    assert tres.probe_rows == int(jres.probe_rows)
    assert np.float32(tres.probe_cells) == _np(jres.probe_cells)
    assert tres.peak_rows == int(jres.peak_rows)
    np.testing.assert_array_equal(tres.h_overflow.numpy(),
                                  _np(jres.h_overflow))
    np.testing.assert_array_equal(tres.triangles.numpy(),
                                  _np(jres.triangles))


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
@pytest.mark.parametrize("path", ["bounded", "exact"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_count_batch_matches_reference(mix, path, per_vertex):
    graphs = MIXES[mix]
    je, te = _engines(per_vertex)
    jb = jcsr.from_edges_batch(graphs)
    tb = tcsr.from_edges_batch(graphs, device=CPU)
    if path == "exact":  # no meta: the exact two-stage path
        jb, tb = (dataclasses.replace(jb, meta=None),
                  dataclasses.replace(tb, meta=None))
    jr, tr = je.count_batch(jb), te.count_batch(tb)
    assert len(tr) == len(jr) == len(graphs)
    for j, t in zip(jr, tr):
        _assert_lane_reports_equal(j, t, per_vertex)
        assert t.plan_id.startswith(
            "bounded/torch/" if path == "bounded" else "exact/torch")
    jp = je.plan_for(jb) if path == "bounded" else None
    tp = te.plan_for(tb) if path == "bounded" else None
    _assert_raw_equal(je.count_batch_raw(jb, plan=jp),
                      te.count_batch_raw(tb, plan=tp))
    # the edge-list form packs onto the engine's grid the same way
    for j, t in zip(jr, te.count_batch(graphs) if path == "bounded"
                    else tr):
        _assert_lane_reports_equal(j, t, per_vertex)


@pytest.mark.parametrize("kw", [dict(query_chunk=128),
                                dict(bucket_widths=(8, 64)),
                                dict(root=3), dict(cap_h=40),
                                dict(d_max=16)])
def test_count_batch_options_match_reference(kw):
    graphs = MIXES["mixed"]
    je, te = _engines(False, **kw)
    jr, tr = je.count_batch(graphs), te.count_batch(graphs)
    for j, t in zip(jr, tr):
        _assert_lane_reports_equal(j, t, False)
    if "cap_h" in kw or "d_max" in kw:
        assert any(t.overflow.h for t in tr)  # lossy knobs flag


def test_count_batch_matches_reference_pallas_interpret():
    graphs = [gen.karate(), gen.complete(9), gen.rmat(7, 8, seed=2)]
    for per_vertex in (False, True):
        je, te = _engines(per_vertex, jkw=dict(backend="pallas",
                                               interpret=True).items())
        jr, tr = je.count_batch(graphs), te.count_batch(graphs)
        assert jr[0].backend == "pallas"
        for j, t in zip(jr, tr):
            assert (t.triangles, t.c1, t.c2, t.num_horizontal) == (
                j.triangles, j.c1, j.c2, j.num_horizontal)
            assert np.float32(t.k).tobytes() == np.float32(j.k).tobytes()
            np.testing.assert_array_equal(t.levels, _np(j.levels))
            if per_vertex:
                np.testing.assert_array_equal(t.per_vertex,
                                              _np(j.per_vertex))


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
@pytest.mark.parametrize("case", ["karate", "ring_of_cliques", "rmat9",
                                  "graph_input"])
def test_batch_route_equals_local_route(case, per_vertex):
    edges, n = {"karate": gen.karate(),
                "ring_of_cliques": gen.ring_of_cliques(5, 6),
                "rmat9": gen.rmat(9, 8, seed=4),
                "graph_input": gen.dolphins_like()}[case]
    eng = tapi.TriangleEngine(tapi.TCOptions(per_vertex=per_vertex),
                              device=CPU)
    x = tcsr.from_edges(edges, n, device=CPU) if case == "graph_input" \
        else (edges, n)
    loc, bat = eng.count(x, route="local"), eng.count(x, route="batch")
    assert (bat.triangles, bat.c1, bat.c2, bat.num_horizontal, bat.k) == (
        loc.triangles, loc.c1, loc.c2, loc.num_horizontal, loc.k)
    assert bat.route == "batch" and bat.plan_id.startswith("bounded/torch/")
    # levels keep the budget's length; the padding vertices are isolated
    np.testing.assert_array_equal(bat.levels[:n], loc.levels)
    assert len(bat.levels) >= n and not bat.levels[n:].any()
    if per_vertex:
        np.testing.assert_array_equal(bat.per_vertex, loc.per_vertex)
        np.testing.assert_array_equal(bat.degrees, loc.degrees)
    jr = japi.TriangleEngine(japi.TCOptions(
        backend="jnp", per_vertex=per_vertex)).count((edges, n),
                                                     route="batch")
    _assert_lane_reports_equal(jr, bat, per_vertex)


def test_foreign_plan_undercoverage_is_flagged():
    """A reused plan that probes fewer rows than a lane's horizontal
    count sets h_overflow, as in the reference, and never undercounts
    silently."""
    eng = tapi.TriangleEngine(device=CPU)
    path = np.stack([np.arange(15), np.arange(1, 16)], 1)
    sparse = tcsr.from_edges_batch([(path, 16)], device=CPU)
    dense = tcsr.from_edges_batch([gen.complete(16)], device=CPU)
    assert sparse.budget == dense.budget
    res = eng.count_batch_raw(dense, plan=eng.plan_for(sparse))
    assert bool(res.h_overflow[0])
    ok = eng.count_batch_raw(dense, plan=eng.plan_for(dense))
    assert not bool(ok.h_overflow[0]) and int(ok.triangles[0]) == 560
    je = japi.TriangleEngine(japi.TCOptions(backend="jnp"))
    jsparse = jcsr.from_edges_batch([(path, 16)])
    jdense = jcsr.from_edges_batch([gen.complete(16)])
    jres = je.count_batch_raw(jdense, plan=je.plan_for(jsparse))
    _assert_raw_equal(jres, res)


def test_plan_with_d_max_or_cap_h_raises():
    eng = tapi.TriangleEngine(device=CPU)
    gb = tcsr.from_edges_batch([gen.karate()], device=CPU)
    plan = eng.plan_for(gb)
    for kw in (dict(cap_h=4), dict(d_max=8)):
        with pytest.raises(ValueError, match="d_max/cap_h only apply"):
            eng.count_batch_raw(gb, options=tapi.TCOptions(**kw), plan=plan)
        with pytest.raises(ValueError, match="route='batch' uses cached"):
            eng.count(gen.karate(), route="batch",
                      options=tapi.TCOptions(**kw))
    with pytest.raises(ValueError, match="no degree metadata"):
        eng.plan_for(tcsr.to_batch(tcsr.from_edges(*gen.karate(),
                                                   device=CPU)))
    with pytest.raises(TypeError, match="count_batch"):
        eng.count(gb)


def test_auto_route_on_a_capped_grid_names_item_10():
    """Past a capped grid's top cell ``auto`` resolves to the distributed
    route (item 10), which answers: the local count's triangles."""
    grid = tcsr.BudgetGrid(max_nodes=64, max_slots=256)
    eng = tapi.TriangleEngine(budgets=grid, device=CPU)
    assert eng.count(gen.karate()).route == "local"  # fits the top cell
    assert eng.route_for(500, 3000) == "distributed"
    assert japi.TriangleEngine(budgets=jcsr.BudgetGrid(
        max_nodes=64, max_slots=256)).route_for(500, 3000) == "distributed"
    big = gen.rmat(9, 8, seed=0)
    rep = eng.count(big)
    assert (rep.route, rep.c1, rep.c2) == ("distributed", None, None)
    assert rep.triangles == eng.count(big, route="local").triangles
    assert rep.plan_id == "hedge/allgather/p1"
    # the grid also comes from the options
    eng2 = tapi.TriangleEngine(tapi.TCOptions(grid=grid), device=CPU)
    assert eng2.budgets is grid
    with pytest.raises(TypeError, match="BudgetGrid"):
        tapi.TCOptions(grid=(64, 256))


# ---------------------------------------------------------- plan cache


def test_plan_cache_follows_reference_on_engine_owned_caches():
    """The same key sequence through an engine-owned cache of capacity 2
    on each side: the same hits, misses, evictions and sizes, step by
    step (caches an engine owns, so no other test's traffic counts)."""
    seq = [[gen.erdos_renyi(50, 0.1, seed=1)],
           [gen.erdos_renyi(48, 0.1, seed=2)],
           [gen.complete(12)], [gen.rmat(7, 8, seed=1)],
           [gen.erdos_renyi(50, 0.1, seed=1)], [gen.complete(12)],
           [gen.rmat(7, 8, seed=1), gen.karate()]]
    je = japi.TriangleEngine(japi.TCOptions(backend="jnp"),
                             plan_cache_capacity=2)
    te = tapi.TriangleEngine(device=CPU, plan_cache_capacity=2)
    keys = ("hits", "misses", "size", "evictions", "capacity")
    for graphs in seq:
        jp = je.plan_for(jcsr.from_edges_batch(graphs))
        tp = te.plan_for(tcsr.from_edges_batch(graphs, device=CPU))
        assert [dataclasses.astuple(b) for b in tp.buckets] == [
            dataclasses.astuple(b) for b in jp.buckets]
        js, ts = je.plan_cache_stats(), te.plan_cache_stats()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["evictions"] > 0 and ts["hits"] > 0
    assert te.plan_cache_stats(reset=True)["hits"] == ts["hits"]
    assert te.plan_cache_stats()["hits"] == 0
    # a hit hands back the cached plan itself; options that lay out the
    # same plan share one key (row_mult folds into query_chunk)
    gb = tcsr.from_edges_batch([gen.karate()], device=CPU)
    eng = tapi.TriangleEngine(tapi.TCOptions(query_chunk=64, row_mult=8),
                              device=CPU)
    assert eng.plan_for(gb) is eng.plan_for(gb)
    assert tapi.TCOptions(query_chunk=64, row_mult=8).plan_view(CPU) == \
        tapi.TCOptions(query_chunk=64).plan_view(CPU)
    with pytest.raises(ValueError, match="capacity must be positive"):
        tapi.TriangleEngine(device=CPU, plan_cache_capacity=0)


def test_pool_meta_ratchets_up():
    eng = tapi.TriangleEngine(device=CPU)
    small = tcsr.from_edges_batch([gen.complete(6)], device=CPU)
    big = tcsr.from_edges_batch([gen.complete(12)], device=CPU)
    assert small.budget == big.budget
    assert eng.pool_meta(small.budget, small.meta) == small.meta
    pooled = eng.pool_meta(big.budget, big.meta)
    assert pooled == small.meta.union(big.meta)
    assert eng.pool_meta(small.budget, small.meta) == pooled
