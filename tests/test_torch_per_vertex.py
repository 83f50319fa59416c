"""Per-vertex triangle credit in the port, held bit for bit against the
JAX package and the brute-force oracle (``tests/oracle.py``):
``TriangleEngine(device="cpu").count(options=TCOptions(per_vertex=True))``
against ``repro.api.TriangleEngine().count`` — ``per_vertex``,
``degrees``, c1/c2, and the derived clustering, transitivity and top-k —
on the fixtures, the path/star/complete shapes and RMAT scale 10; the
dense reference's credit; ``query_chunk`` plans; the n = 0 report; and
``segment_sum``'s sentinel convention.  Inputs are numpy arrays made
from a seed; every comparison is exact."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import oracle
import pytest
import torch

import repro.api as japi
from repro.core import sequential as jseq
from repro.graph import csr as jcsr
from repro.graph.segment import segment_sum as j_segment_sum
from repro_torch import api as tapi
from repro_torch.core import intersect as tint
from repro_torch.core import sequential as tseq
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.graph.segment import segment_sum

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FIXTURES = {
    "karate": gen.karate(),
    "ring_of_cliques": gen.ring_of_cliques(5, 6),
    "er200": gen.erdos_renyi(200, 0.05, seed=3),
    "rmat8": gen.rmat(8, 8, seed=1),
    "dolphins_like": gen.dolphins_like(),
    "geometric": gen.random_geometric(80, 0.25, seed=2),
    "path": gen.path(12),
    "star": gen.star(10),
    "complete": gen.complete(9),
    "rmat10": gen.rmat(10, 16, seed=0),
}

PV = tapi.TCOptions(per_vertex=True)


def _reports(edges, n, jopts=None, topts=PV):
    jopts = jopts or japi.TCOptions(backend="jnp", per_vertex=True)
    jr = japi.TriangleEngine(jopts).count((edges, n), route="local")
    tr = tapi.TriangleEngine(topts, device=CPU).count((edges, n))
    return jr, tr


def _assert_credit_equal(jr, tr, exact=True):
    """Equal to the reference; on an exact run ``sum == 3T`` too (a lossy
    ``cap_h``/``d_max`` run drops hits and breaks it in both packages)."""
    assert (tr.triangles, tr.c1, tr.c2) == (jr.triangles, jr.c1, jr.c2)
    assert tr.per_vertex.dtype == np.int32 == jr.per_vertex.dtype
    assert tr.degrees.dtype == np.int32 == jr.degrees.dtype
    np.testing.assert_array_equal(tr.per_vertex, jr.per_vertex)
    np.testing.assert_array_equal(tr.degrees, jr.degrees)
    if exact:
        assert int(tr.per_vertex.sum()) == 3 * tr.triangles


@pytest.mark.parametrize("case", list(FIXTURES))
def test_per_vertex_matches_reference_and_oracle(case):
    edges, n = FIXTURES[case]
    jr, tr = _reports(edges, n)
    _assert_credit_equal(jr, tr)
    np.testing.assert_array_equal(tr.per_vertex,
                                  oracle.triangle_counts(edges, n))
    np.testing.assert_array_equal(tr.degrees, oracle.degrees(edges, n))
    # the plain count's c1/c2 (K1's path) equal the ones the mask gives
    plain = tapi.TriangleEngine(device=CPU).count((edges, n))
    assert (plain.c1, plain.c2, plain.per_vertex) == (tr.c1, tr.c2, None)


@pytest.mark.parametrize("case", ["karate", "ring_of_cliques"])
def test_per_vertex_matches_reference_pallas_interpret(case):
    edges, n = FIXTURES[case]
    jr, tr = _reports(edges, n, japi.TCOptions(
        backend="pallas", interpret=True, per_vertex=True))
    _assert_credit_equal(jr, tr)


@pytest.mark.parametrize("case", ["karate", "complete", "star", "rmat10"])
def test_derived_analytics_match_reference_and_oracle(case):
    edges, n = FIXTURES[case]
    jr, tr = _reports(edges, n)
    np.testing.assert_array_equal(tr.local_clustering(),
                                  jr.local_clustering())
    np.testing.assert_allclose(tr.local_clustering(),
                               oracle.local_clustering(edges, n),
                               rtol=0, atol=1e-15)
    assert tr.transitivity() == jr.transitivity()
    assert tr.transitivity() == pytest.approx(oracle.transitivity(edges, n),
                                              rel=1e-15)
    for k in (0, 1, 5, n + 3):
        np.testing.assert_array_equal(tr.top_k(k), jr.top_k(k))


def test_closed_forms_on_complete_and_star():
    r = tapi.TriangleEngine(PV, device=CPU).count(gen.complete(9))
    np.testing.assert_array_equal(r.local_clustering(), np.ones(9))
    assert r.transitivity() == 1.0
    s = tapi.TriangleEngine(PV, device=CPU).count(gen.star(10))
    assert not s.local_clustering().any() and s.transitivity() == 0.0


QUERY_CHUNK_CASES = [
    dict(query_chunk=64),
    dict(query_chunk=256, bucket_widths=(8, 64)),
    dict(d_max=16),
    dict(cap_h=500),
    dict(root=17),
]


@pytest.mark.parametrize("kw", QUERY_CHUNK_CASES,
                         ids=lambda kw: "-".join(map(str, kw)))
def test_per_vertex_plans_match_reference(kw):
    edges, n = FIXTURES["rmat10"]
    jr, tr = _reports(edges, n,
                      japi.TCOptions(backend="jnp", per_vertex=True, **kw),
                      tapi.TCOptions(per_vertex=True, **kw))
    _assert_credit_equal(jr, tr, exact=not tr.overflow)
    assert tr.overflow.h == jr.overflow.h


def test_per_vertex_is_unchanged_by_a_small_cell_budget(monkeypatch):
    edges, n = FIXTURES["rmat10"]
    eng = tapi.TriangleEngine(PV, device=CPU)
    r = eng.count((edges, n))
    monkeypatch.setattr(tint, "HIT_CELL_BUDGET", 1009)
    rc = eng.count((edges, n))
    assert (rc.c1, rc.c2) == (r.c1, r.c2)
    np.testing.assert_array_equal(rc.per_vertex, r.per_vertex)


@pytest.mark.parametrize("case,d_max", [
    ("karate", None), ("karate", 8), ("rmat8", None), ("rmat10", 20),
])
def test_dense_reference_credit_matches(case, d_max):
    edges, n = FIXTURES[case]
    jg = jcsr.from_edges(edges, n)
    dm = d_max or jcsr.max_degree(jg)
    ja = jseq.triangle_count_dense(jg, d_max=dm)
    ta = tseq.triangle_count_dense(tcsr.from_edges(edges, n, device=CPU),
                                   d_max=dm)
    assert (int(ta.c1), int(ta.c2)) == (int(ja.c1), int(ja.c2))
    np.testing.assert_array_equal(ta.per_vertex.numpy(),
                                  np.asarray(ja.per_vertex))
    if d_max is None:
        assert int(ta.per_vertex.sum()) == 3 * int(ta.triangles)
    # and through the engine's compact=False escape hatch
    jr, tr = _reports(edges, n,
                      japi.TCOptions(compact=False, d_max=d_max,
                                     per_vertex=True),
                      tapi.TCOptions(compact=False, d_max=d_max,
                                     per_vertex=True))
    _assert_credit_equal(jr, tr, exact=d_max is None)


def test_empty_graph_report_matches_reference():
    empty = (np.zeros((0, 2), np.int64), 0)
    jr = japi.TriangleEngine(japi.TCOptions(per_vertex=True)).count(empty)
    tr = tapi.TriangleEngine(PV, device=CPU).count(empty)
    for f in ("triangles", "c1", "c2", "num_horizontal", "plan_id"):
        assert getattr(tr, f) == getattr(jr, f), f
    for f in ("per_vertex", "degrees"):
        assert getattr(tr, f).shape == (0,) and getattr(tr, f).dtype == (
            getattr(jr, f).dtype)
    plain = tapi.TriangleEngine(device=CPU).count(empty)
    assert plain.per_vertex is None and plain.degrees is None


def test_reports_without_credit_refuse_analytics():
    r = tapi.TriangleEngine(device=CPU).count(gen.karate())
    for call in (r.local_clustering, r.transitivity, lambda: r.top_k(3)):
        with pytest.raises(ValueError, match="per_vertex=True"):
            call()


def test_run_plan_credit_has_the_throwaway_slot():
    edges, n = FIXTURES["karate"]
    res = tapi.TriangleEngine(PV, device=CPU).count_raw((edges, n))
    assert res.per_vertex.shape == (n,)
    g = tcsr.from_edges(edges, n, device=CPU)
    from repro_torch.core.edges import horizontal_queries

    qu, qw, *_ = horizontal_queries(g, res.levels, order="desc")
    eng = tint.run_plan(tint.CsrAdjacency.from_graph(g), qu, qw, res.plan,
                        level=res.levels, per_vertex=True)
    assert eng.per_vertex.shape == (n + 1,)
    assert torch.equal(eng.per_vertex[:n], res.per_vertex)
    assert tint.run_plan(tint.CsrAdjacency.from_graph(g), qu, qw,
                         res.plan, level=res.levels).per_vertex is None


@pytest.mark.parametrize("num_segments", [1, 7, 12])
def test_segment_sum_drops_out_of_range_ids_like_reference(num_segments):
    rng = np.random.default_rng(num_segments)
    ids = rng.integers(-3, num_segments + 3, size=200).astype(np.int32)
    data = rng.integers(-50, 50, size=(200, 3)).astype(np.int32)
    for d in (data, data[:, 0]):
        expect = np.asarray(j_segment_sum(jnp.asarray(d), jnp.asarray(ids),
                                          num_segments))
        got = segment_sum(torch.from_numpy(d), torch.from_numpy(ids),
                          num_segments)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), expect)
    # float32 sums run in another order than JAX's: equal to 1e-5
    f = rng.standard_normal(200).astype(np.float32)
    got = segment_sum(torch.from_numpy(f), torch.from_numpy(ids),
                      num_segments).numpy()
    expect = np.asarray(j_segment_sum(jnp.asarray(f), jnp.asarray(ids),
                                      num_segments))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_stage_clock_splits_the_per_vertex_probe():
    edges, n = FIXTURES["rmat10"]
    clock = tseq.StageClock(CPU)
    r = tapi.TriangleEngine(PV, device=CPU).count((edges, n), clock=clock)
    assert r.triangles == 75682
    assert set(clock.seconds) == {"csr", "bfs", "compact", "plan", "probe",
                                  "hit_list", "credit"}
