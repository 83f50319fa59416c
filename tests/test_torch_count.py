"""The port's main path end to end, held bit for bit against the JAX
package: ``repro_torch.api.TriangleEngine(device="cpu").count`` against
``repro.api.TriangleEngine().count`` (its ``jnp`` backend, and its Pallas
kernel in interpret mode) on the fixtures and RMAT scales 10-12, for
triangles, c1, c2, n_h, k, levels, overflow and the plan work counts;
the dense golden reference; the options' validation; and the routes
still to be ported."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import sequential as jseq
from repro.graph import csr as jcsr
from repro_torch import api as tapi
from repro_torch.core import sequential as tseq
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FIXTURES = {
    "karate": (gen.karate(), 45),
    "path": (gen.path(12), 0),
    "star": (gen.star(10), 0),
    "complete": (gen.complete(9), 84),
    "ring_of_cliques": (gen.ring_of_cliques(5, 6), 100),
    "rmat10": (gen.rmat(10, 16, seed=0), 75682),
    "rmat11": (gen.rmat(11, 16, seed=0), 194100),
    "rmat12": (gen.rmat(12, 16, seed=0), 483937),
}


def _reports(edges, n, jopts=None, topts=None):
    jr = japi.TriangleEngine(jopts).count((edges, n), route="local")
    tr = tapi.TriangleEngine(topts, device=CPU).count((edges, n))
    return jr, tr


def _assert_reports_equal(jr, tr):
    assert tr.triangles == jr.triangles
    assert (tr.c1, tr.c2) == (jr.c1, jr.c2)
    assert tr.num_horizontal == jr.num_horizontal
    assert np.float32(tr.k).tobytes() == np.float32(jr.k).tobytes()
    assert tr.levels.dtype == np.int32
    np.testing.assert_array_equal(tr.levels, jr.levels)
    assert dataclasses.astuple(tr.overflow) == dataclasses.astuple(
        jr.overflow)
    assert tr.route == jr.route == "local"


def _assert_work_counts_equal(jres, tres):
    assert tres.probe_rows == int(jres.probe_rows)
    assert np.float32(tres.probe_cells) == np.asarray(jres.probe_cells)
    assert tres.peak_rows == int(jres.peak_rows)
    assert bool(tres.h_overflow) == bool(jres.h_overflow)


@pytest.mark.parametrize("case", list(FIXTURES))
def test_count_matches_reference_jnp(case):
    (edges, n), expect = FIXTURES[case]
    jr, tr = _reports(edges, n, japi.TCOptions(backend="jnp"))
    _assert_reports_equal(jr, tr)
    assert tr.triangles == expect
    assert tr.backend == "torch" and tr.plan_id == "exact/torch"


@pytest.mark.parametrize("case", ["karate", "rmat10"])
def test_count_matches_reference_pallas_interpret(case):
    (edges, n), expect = FIXTURES[case]
    jr, tr = _reports(edges, n,
                      japi.TCOptions(backend="pallas", interpret=True))
    assert jr.backend == "pallas"
    _assert_reports_equal(jr, tr)
    assert tr.triangles == expect


@pytest.mark.parametrize("case", ["karate", "ring_of_cliques", "rmat10",
                                  "rmat12"])
def test_plan_work_counts_match_reference(case):
    (edges, n), _ = FIXTURES[case]
    jres = japi.TriangleEngine().count_raw(jcsr.from_edges(edges, n))
    tres = tapi.TriangleEngine(device=CPU).count_raw((edges, n))
    _assert_work_counts_equal(jres, tres)
    assert int(tres.c1) == int(jres.c1) and int(tres.c2) == int(jres.c2)


def test_scale_counts_and_horizontal_queries():
    # results/BENCH_tc.json: n_h 8139 at scale 10, 26048 at scale 12
    for case, nh in (("rmat10", 8139), ("rmat12", 26048)):
        (edges, n), expect = FIXTURES[case]
        r = tapi.TriangleEngine(device=CPU).count((edges, n))
        assert (r.triangles, r.num_horizontal) == (expect, nh)
        assert not r.overflow


OPTION_CASES = {
    "cap_h": dict(cap_h=500),
    "d_max": dict(d_max=16),
    "query_chunk": dict(query_chunk=256),
    "bucket_widths": dict(bucket_widths=(8, 64, 512)),
    "root": dict(root=17),
    "row_mult": dict(row_mult=8),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_options_match_reference(case):
    kw = OPTION_CASES[case]
    (edges, n), _ = FIXTURES["rmat10"]
    jo = japi.TCOptions(backend="jnp", **kw)
    to = tapi.TCOptions(**kw)
    jr, tr = _reports(edges, n, jo, to)
    _assert_reports_equal(jr, tr)
    jres = japi.TriangleEngine(jo).count_raw(jcsr.from_edges(edges, n))
    tres = tapi.TriangleEngine(to, device=CPU).count_raw((edges, n))
    _assert_work_counts_equal(jres, tres)
    if case in ("cap_h", "d_max"):
        assert tr.overflow.h  # lossy knobs flag, never miscount silently


@pytest.mark.parametrize("d_max", [None, 8, 20])
@pytest.mark.parametrize("case", ["karate", "rmat10"])
def test_dense_reference_matches(case, d_max):
    (edges, n), expect = FIXTURES[case]
    jg = jcsr.from_edges(edges, n)
    tg = tcsr.from_edges(edges, n, device=CPU)
    dm = d_max or jcsr.max_degree(jg)
    ja = jseq.triangle_count_dense(jg, d_max=dm)
    ta = tseq.triangle_count_dense(tg, d_max=dm)
    for f in ("triangles", "c1", "c2", "num_horizontal", "probe_rows",
              "peak_rows"):
        assert int(getattr(ta, f)) == int(getattr(ja, f)), f
    assert np.float32(ta.probe_cells) == np.asarray(ja.probe_cells)
    np.testing.assert_array_equal(ta.levels.numpy(), np.asarray(ja.levels))
    assert ta.k.numpy().tobytes() == np.asarray(ja.k).tobytes()
    if d_max is None:
        assert int(ta.triangles) == expect
    # the same path through the engine's compact=False escape hatch
    jr, tr = _reports(edges, n, japi.TCOptions(compact=False, d_max=d_max),
                      tapi.TCOptions(compact=False, d_max=d_max))
    _assert_reports_equal(jr, tr)


def test_lossy_dense_d_max_under_searches_like_the_reference():
    (edges, n), expect = FIXTURES["rmat10"]
    ta = tseq.triangle_count_dense(tcsr.from_edges(edges, n, device=CPU),
                                   d_max=20)
    assert int(ta.triangles) < expect


def test_graph_input_and_empty_graph():
    (edges, n), _ = FIXTURES["karate"]
    eng = tapi.TriangleEngine(device=CPU)
    assert eng.count(tcsr.from_edges(edges, n, device=CPU)).triangles == 45
    jr = japi.TriangleEngine().count((np.zeros((0, 2), np.int64), 0))
    tr = eng.count((np.zeros((0, 2), np.int64), 0))
    assert (tr.triangles, tr.c1, tr.c2, tr.num_horizontal, tr.plan_id) == (
        jr.triangles, jr.c1, jr.c2, jr.num_horizontal, jr.plan_id)
    assert tr.levels.shape == (0,) and not tr.overflow


def test_stage_clock_records_every_stage():
    (edges, n), expect = FIXTURES["rmat10"]
    clock = tseq.StageClock(CPU)
    r = tapi.TriangleEngine(device=CPU).count((edges, n), clock=clock)
    assert r.triangles == expect
    assert set(clock.seconds) == {"csr", "bfs", "compact", "plan",
                                  "plan.host", "probe", "report"}
    assert clock.counts["bfs_sweeps"] >= 2


@pytest.mark.parametrize("route", ["batch", "distributed", "approx",
                                   "stream", "auto_capped"])
def test_unported_routes_name_their_roadmap_item(route):
    if route in ("stream", "batch"):
        # ported in slices 3 and 9: the route answers instead of refusing,
        # with the local route's count
        assert tapi.TCOptions(route=route).route == route
        eng = tapi.TriangleEngine(device=CPU)
        rep = eng.count(gen.karate(), route=route)
        loc = eng.count(gen.karate(), route="local")
        assert (rep.route, rep.triangles) == (route, 45)
        assert (rep.c1, rep.c2, rep.num_horizontal, rep.k) == (
            loc.c1, loc.c2, loc.num_horizontal, loc.k)
        return
    if route == "approx":
        # ported in slice 10: the route answers the reference's estimate
        # (seed 0, the options' samples), with no level split
        assert tapi.TCOptions(route=route).route == route
        rep = tapi.TriangleEngine(device=CPU).count(gen.karate(), route=route)
        want = japi.TriangleEngine().count(gen.karate(), route=route)
        assert (rep.route, rep.triangles, rep.plan_id) == (
            route, want.triangles, want.plan_id)
        assert (rep.c1, rep.c2, rep.num_horizontal) == (None, None, 0)
        assert np.isnan(rep.k) and rep.approx.samples == 8192
        return
    # ported in slice 11 (item 10): "distributed", and "auto" past a
    # capped grid's top cell, answer on Algorithm 2 with the local count
    # and no level split
    eng = tapi.TriangleEngine(
        budgets=tcsr.BudgetGrid(max_nodes=64, max_slots=256), device=CPU)
    g = gen.rmat(10, 16, seed=0) if route == "auto_capped" else gen.karate()
    rep = eng.count(g, route="auto" if route == "auto_capped" else route)
    loc = eng.count(g, route="local")
    assert (rep.route, rep.triangles) == ("distributed", loc.triangles)
    assert (rep.c1, rep.c2, rep.levels) == (None, None, None)
    assert (rep.num_horizontal, rep.k) == (loc.num_horizontal, loc.k)
    assert rep.comm.total == 0 and rep.per_device.tolist() == [
        loc.triangles]  # the engine's default shard group: p = 1
    assert tapi.TCOptions(route="distributed").route == "distributed"


@pytest.mark.parametrize("kw", [
    dict(query_chunk=0), dict(d_max=-3), dict(cap_h=0),
    dict(bucket_widths=(0, 32)), dict(row_mult=0), dict(route="nowhere"),
])
def test_option_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as je:
        japi.TCOptions(**kw)
    with pytest.raises(ValueError) as te:
        tapi.TCOptions(**kw)
    assert str(te.value) == str(je.value)


def test_backend_validation():
    with pytest.raises(ValueError, match="backend must be one of"):
        tapi.TCOptions(backend="pallas")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tapi.TriangleEngine(tapi.TCOptions(backend="cuda"),
                            device=CPU).count(gen.karate())
    with pytest.raises(TypeError, match="TCOptions"):
        tapi.TriangleEngine(dataclasses.asdict(tapi.TCOptions()),
                            device=CPU)
