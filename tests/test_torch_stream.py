"""The port's stream route held bit for bit against the JAX package.

The same update streams, made from a numpy seed, go through
``repro.api.TriangleEngine(TCOptions(backend=...)).stream(...)`` and the
port's ``TriangleEngine(device="cpu").stream(...)``; after every
``apply`` each ``StreamUpdate`` field, ``stats()``, the live per-vertex
credit and every field of ``count()``'s report must be equal — integers
bit for bit, floats (``staleness``, ``k``, the ``ApproxEstimate``
fields) exactly.  The reference runs on its ``jnp`` probe (the conftest
fixtures and RMAT scale 10) and on its Pallas kernels in interpret mode
(the fixtures), which reach ``intersect_pallas_count``.  Also here: the
brute-force oracle after every batch, the mutable edge set, the delta
probes, the approximate lane, the empty graph, option refusals and the
padded snapshots."""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import oracle
import pytest
import torch
from conftest import FIXTURES

import repro.api as japi
from repro.stream import delta as jdelta
from repro.stream import state as jstate
from repro_torch import api as tapi
from repro_torch.core import intersect as tint
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.stream import delta as tdelta
from repro_torch.stream import state as tstate

CPU = "cpu"

GRAPHS = {**FIXTURES, "rmat10": gen.rmat(10, 16, seed=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mixed_stream(rng, edges: np.ndarray, n: int, *, n_ins: int,
                  n_del: int):
    """A shuffled mixed stream over the current ``(lo, hi)`` edges: net
    deletes of present edges, inserts of absent pairs, and one of each
    no-op — a repeated insert, a delete of an absent pair, a self loop,
    an out-of-range endpoint — plus an insert-then-delete flip-flop."""
    present = {(int(a), int(b)) for a, b in edges}
    ups = []
    if n_del and edges.shape[0]:
        take = rng.choice(edges.shape[0], min(n_del, edges.shape[0]),
                          replace=False)
        ups += [(-1, int(a), int(b)) for a, b in edges[take]]
    absent = []
    for _ in range(50 * (n_ins + 2)):
        if len(absent) == n_ins + 2:
            break
        u, v = (int(x) for x in rng.integers(n, size=2))
        pair = (min(u, v), max(u, v))
        if u != v and pair not in present:
            present.add(pair)
            absent.append(pair)
    ups += [(+1, v, u) for u, v in absent[:n_ins]]
    rng.shuffle(ups)
    if edges.shape[0]:
        a, b = (int(x) for x in edges[0])
        ups.append((+1, b, a))                       # noop-present
    if len(absent) > n_ins:
        ups.append((-1, *absent[n_ins]))             # noop-absent
    if len(absent) > n_ins + 1:
        ups += [(+1, *absent[n_ins + 1]), (-1, *absent[n_ins + 1])]
    ups += [(+1, 0, 0), (-1, n, 1)]                  # self loop, rejected
    return ups


def _same_float(a, b) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


def _assert_update_equal(tu, ju):
    for f in ("statuses", "applied", "delta_triangles", "triangles",
              "exact", "refreshed"):
        assert getattr(tu, f) == getattr(ju, f), f
    assert tu.staleness == ju.staleness


def _assert_report_equal(tr, jr):
    """Every field of the stream report but the options and backend
    names, which differ between the packages by design."""
    assert tr.route == jr.route == "stream"
    for f in ("triangles", "num_horizontal", "c1", "c2", "plan_id"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert _same_float(tr.k, jr.k)
    assert dataclasses.asdict(tr.overflow) == dataclasses.asdict(jr.overflow)
    assert dataclasses.asdict(tr.stream) == dataclasses.asdict(jr.stream)
    for f in ("levels", "per_vertex", "degrees"):
        a, b = getattr(tr, f), getattr(jr, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
    assert (tr.approx is None) == (jr.approx is None)
    if tr.approx is not None:
        assert dataclasses.asdict(tr.approx) == dataclasses.asdict(jr.approx)


def _assert_session_equal(ts, js):
    assert dataclasses.asdict(ts.stats()) == dataclasses.asdict(js.stats())
    assert ts.triangles == js.triangles
    assert (ts.per_vertex is None) == (js.per_vertex is None)
    if ts.per_vertex is not None:
        assert ts.per_vertex.dtype == js.per_vertex.dtype
        np.testing.assert_array_equal(ts.per_vertex, js.per_vertex)
    np.testing.assert_array_equal(ts.state.deg, js.state.deg)
    np.testing.assert_array_equal(ts.state.edges(), js.state.edges())
    _assert_report_equal(ts.count(), js.count())


def _assert_oracle_identical(sess):
    """The stream invariant: the session's totals equal a brute-force
    recount of its own edge set."""
    edges, n = sess.state.edges(), sess.n_nodes
    assert sess.triangles == oracle.total_triangles(edges, n)
    if sess.per_vertex is not None:
        np.testing.assert_array_equal(
            sess.per_vertex, oracle.triangle_counts(edges, n))


def _drive(name, jopts, topts, *, refresh_plan, n_ins=6, n_del=4,
           check_oracle=False, seed=0, graph=None):
    """Open both sessions on graph ``name`` (or ``graph``, an ``(edges,
    n)`` pair) and apply one mixed stream per entry of ``refresh_plan``
    (the ``refresh=`` argument), comparing everything after each
    ``apply``."""
    edges, n = graph or GRAPHS[name]
    js = japi.TriangleEngine(jopts).stream((edges, n), seed=seed)
    ts = tapi.TriangleEngine(topts, device=CPU).stream((edges, n), seed=seed)
    _assert_session_equal(ts, js)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for refresh in refresh_plan:
        ups = _mixed_stream(rng, js.state.edges(), n, n_ins=n_ins,
                            n_del=n_del)
        _assert_update_equal(ts.apply(ups, refresh=refresh),
                             js.apply(ups, refresh=refresh))
        _assert_session_equal(ts, js)
        if check_oracle:
            _assert_oracle_identical(ts)
    return ts, js


# ------------------------------------------------ sessions vs reference


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_session_matches_reference_jnp(name, per_vertex):
    _drive(name,
           japi.TCOptions(backend="jnp", per_vertex=per_vertex),
           tapi.TCOptions(per_vertex=per_vertex),
           refresh_plan=(False, None, True, False), check_oracle=True)


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_session_matches_reference_pallas_interpret(name, per_vertex):
    _drive(name,
           japi.TCOptions(backend="pallas", interpret=True,
                          per_vertex=per_vertex),
           tapi.TCOptions(per_vertex=per_vertex),
           refresh_plan=(False, None))


@pytest.mark.parametrize("kw", [
    {"stream_buffer": 3},
    {"stream_buffer": 5, "per_vertex": True},
    {"query_chunk": 64},
], ids=["buffer3", "buffer5_pv", "chunk64"])
def test_buffer_chunking_and_query_chunk_match_reference(kw):
    _drive("karate", japi.TCOptions(backend="jnp", **kw),
           tapi.TCOptions(**kw), refresh_plan=(False, False))


@pytest.mark.parametrize("name", ["karate", "er200", "rmat8"])
def test_approximate_lane_matches_reference(name):
    # a budget of two changed edges per batch: every mixed batch goes
    # over it, the session answers the reservoir estimate, and the
    # forced refresh brings it back to exact
    kw = dict(stream_exact_edges=2, stream_approx_rate=0.3)
    ts, js = _drive(name, japi.TCOptions(backend="jnp", **kw),
                    tapi.TCOptions(**kw), refresh_plan=(False, False, True),
                    seed=7)
    assert ts.approx_batches == js.approx_batches == 3
    assert ts.exact and ts.refreshes == 2
    _drive(name, japi.TCOptions(backend="jnp", **kw),
           tapi.TCOptions(**kw), refresh_plan=(False,), n_ins=1, n_del=0)


def test_approximate_report_carries_the_estimate():
    kw = dict(stream_exact_edges=1)
    edges, n = GRAPHS["er200"]
    js = japi.TriangleEngine(japi.TCOptions(backend="jnp", **kw)).stream(
        (edges, n), seed=3)
    ts = tapi.TriangleEngine(tapi.TCOptions(**kw), device=CPU).stream(
        (edges, n), seed=3)
    ups = _mixed_stream(np.random.default_rng(5), js.state.edges(), n,
                        n_ins=20, n_del=20)
    _assert_update_equal(ts.apply(ups, refresh=False),
                         js.apply(ups, refresh=False))
    tr, jr = ts.count(), js.count()
    assert not ts.exact and tr.approx is not None
    assert tr.plan_id.startswith("stream-reservoir/")
    _assert_report_equal(tr, jr)


# --------------------------------------------------------- oracle checks


def test_triangle_destroying_deletes_match_oracle():
    edges, n = gen.complete(9)
    sess = tapi.TriangleEngine(
        tapi.TCOptions(per_vertex=True, stream_staleness=1e9),
        device=CPU).stream((edges, n))
    assert sess.triangles == 84
    rng = np.random.default_rng(0)
    while sess.num_edges:
        present = sess.state.edges()
        take = rng.choice(present.shape[0], min(6, present.shape[0]),
                          replace=False)
        before = sess.triangles
        up = sess.delete(present[take])
        assert up.delta_triangles == sess.triangles - before <= 0
        _assert_oracle_identical(sess)
    assert sess.triangles == 0 and not sess.per_vertex.any()


def test_intra_batch_interactions_exactly_once():
    sess = tapi.TriangleEngine(
        tapi.TCOptions(per_vertex=True, stream_staleness=1e9),
        device=CPU).stream((np.array([[0, 1]]), 6))
    new = [(+1, u, v) for u in range(5) for v in range(u + 1, 5)
           if (u, v) != (0, 1)]
    assert sess.apply(new).delta_triangles == 10
    _assert_oracle_identical(sess)
    assert sess.apply([(-1, u, v) for _, u, v in new]).delta_triangles == -10
    assert sess.triangles == 0
    _assert_oracle_identical(sess)


# --------------------------------------------------- edges and refusals


def test_empty_graph_matches_reference():
    empty = (np.zeros((0, 2), np.int64), 0)
    for pv in (False, True):
        js = japi.TriangleEngine(
            japi.TCOptions(backend="jnp", per_vertex=pv)).stream(empty)
        ts = tapi.TriangleEngine(
            tapi.TCOptions(per_vertex=pv), device=CPU).stream(empty)
        _assert_session_equal(ts, js)
        ups = [(+1, 0, 1), (-1, 2, 2)]
        _assert_update_equal(ts.apply(ups), js.apply(ups))
        _assert_session_equal(ts, js)
        jr = japi.TriangleEngine(
            japi.TCOptions(backend="jnp", per_vertex=pv)).count(
                empty, route="stream")
        tr = tapi.TriangleEngine(
            tapi.TCOptions(per_vertex=pv), device=CPU).count(
                empty, route="stream")
        assert (tr.route, tr.triangles, tr.c1, tr.c2, tr.k) == (
            jr.route, jr.triangles, jr.c1, jr.c2, jr.k)
        np.testing.assert_array_equal(tr.levels, jr.levels)
    # edgeless but with vertices: the first probes see no slots
    for pv in (False, True):
        _drive("edgeless", japi.TCOptions(backend="jnp", per_vertex=pv),
               tapi.TCOptions(per_vertex=pv), refresh_plan=(False, False),
               graph=(np.zeros((0, 2), np.int64), 12))


def test_lossy_options_and_bad_stream_knobs_are_refused():
    eng = tapi.TriangleEngine(device=CPU)
    for kw in ({"d_max": 8}, {"cap_h": 4}):
        with pytest.raises(ValueError, match="exact counts"):
            eng.stream(gen.karate(), options=tapi.TCOptions(**kw))
        with pytest.raises(ValueError, match="exact counts"):
            japi.TriangleEngine().stream(gen.karate(),
                                         options=japi.TCOptions(**kw))
    for kw in ({"stream_buffer": 0}, {"stream_staleness": 0.0},
               {"stream_exact_edges": 0}, {"stream_approx_rate": 0.0},
               {"stream_approx_rate": 1.5}):
        with pytest.raises(ValueError, match=next(iter(kw))):
            tapi.TCOptions(**kw)
        with pytest.raises(ValueError, match=next(iter(kw))):
            japi.TCOptions(**kw)
    with pytest.raises(TypeError, match="TCOptions"):
        eng.stream(gen.karate(), options=japi.TCOptions())
    assert tapi.TCOptions(route="stream").route == "stream"
    assert tapi.TCOptions().stream_buffer == japi.TCOptions().stream_buffer
    # the approx route is ported (slice 10): it answers the reference's
    # estimate
    rep = eng.count(gen.karate(), route="approx")
    want = japi.TriangleEngine().count(gen.karate(), route="approx")
    assert (rep.route, rep.triangles, rep.plan_id) == (
        "approx", want.triangles, want.plan_id)


@pytest.mark.parametrize("name", ["karate", "ring_of_cliques", "rmat8"])
def test_count_route_stream_matches_reference(name):
    edges, n = GRAPHS[name]
    for pv in (False, True):
        jr = japi.TriangleEngine(
            japi.TCOptions(backend="jnp", per_vertex=pv)).count(
                (edges, n), route="stream")
        eng = tapi.TriangleEngine(tapi.TCOptions(per_vertex=pv),
                                  device=CPU)
        _assert_report_equal(eng.count((edges, n), route="stream"), jr)
        # a packed Graph opens the same session, padded slots or not
        g = tcsr.from_edges(edges, n, device=CPU)
        _assert_report_equal(eng.count(g, route="stream"), jr)
        g = tdelta.padded_graph(torch.from_numpy(np.asarray(edges)), n,
                                device=CPU)
        _assert_report_equal(eng.count(g, route="stream"), jr)


# --------------------------------------------------- state and snapshots


@pytest.mark.parametrize("name", ["karate", "er200", "rmat10"])
def test_mutable_graph_matches_reference(name):
    edges, n = GRAPHS[name]
    jm = jstate.MutableGraph(edges, n)
    tm = tstate.MutableGraph(torch.from_numpy(np.asarray(edges)), n,
                             device=CPU)
    rng = np.random.default_rng(1)
    for _ in range(3):
        ops, e = jstate.normalize_stream(
            _mixed_stream(rng, jm.edges(), n, n_ins=9, n_del=7))
        jr, tr = jm.apply(ops, e), tm.apply(ops, e)
        assert tr.statuses == jr.statuses and tr.counts == jr.counts
        np.testing.assert_array_equal(tr.net_inserted, jr.net_inserted)
        np.testing.assert_array_equal(tr.net_deleted, jr.net_deleted)
        assert tm.num_edges == jm.num_edges
        np.testing.assert_array_equal(tm.sorted_keys(), jm.sorted_keys())
        np.testing.assert_array_equal(tm.edges(), jm.edges())
        np.testing.assert_array_equal(tm.deg, jm.deg)
        probe = np.concatenate([e, [[n, 0], [-1, 2], [3, 3]]])
        np.testing.assert_array_equal(tm.has_edges(probe),
                                      jm.has_edges(probe))
        assert torch.equal(tm.device_edges(), torch.from_numpy(jm.edges()))


def test_normalize_stream_and_constructor_match_reference():
    for ups in ([("insert", 1, 2), ("-", 3, 4), (+1, 5, 5)],
                (np.array([1, -1, 0]), np.array([[0, 1], [1, 2], [2, 3]])),
                []):
        jo, je = jstate.normalize_stream(ups)
        to, te = tstate.normalize_stream(ups)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(te, je)
        assert to.dtype == jo.dtype and te.dtype == je.dtype
    with pytest.raises(ValueError, match="unknown stream op"):
        tstate.normalize_stream([("upsert", 1, 2)])
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        tstate.MutableGraph(np.array([[0, 5]]), 5, device=CPU)
    with pytest.raises(ValueError, match="n_nodes"):
        tstate.MutableGraph(np.zeros((0, 2)), -1, device=CPU)
    with pytest.raises(ValueError, match="mismatch"):
        tstate.MutableGraph(np.array([[0, 1]]), 3, device=CPU).apply(
            np.ones(2, np.int8), np.array([[0, 2]]))


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
@pytest.mark.parametrize("name", ["karate", "er200", "rmat10"])
def test_probe_sum_and_batch_delta_match_reference(name, per_vertex):
    edges, n = GRAPHS[name]
    jm = jstate.MutableGraph(edges, n)
    rng = np.random.default_rng(2)
    delta = jm.edges()[np.sort(rng.choice(jm.num_edges, 40, replace=False))]
    jg = jdelta.padded_graph(jm.edges(), n)
    tg = tdelta.padded_graph(torch.from_numpy(jm.edges()), n, device=CPU)
    js, jp = jdelta.probe_sum(jg, delta, jm.deg, per_vertex=per_vertex,
                              options=japi.TCOptions(backend="jnp"))
    ts, tp = tdelta.probe_sum(tg, delta, jm.deg, per_vertex=per_vertex,
                              options=tapi.TCOptions())
    assert ts == js
    if per_vertex:
        np.testing.assert_array_equal(tp, jp)
    # the delete phase of those 40 edges: small = without, big = with
    keep = np.ones(jm.num_edges, bool)
    keep[np.searchsorted(jm.sorted_keys(), delta[:, 0] * n + delta[:, 1])] = 0
    small = jm.edges()[keep]
    deg_small = jm.deg.copy()
    np.add.at(deg_small, delta.ravel(), -1)
    jd = jdelta.batch_delta(
        delta, g_small=jdelta.padded_graph(small, n), g_big=jg,
        deg_small=deg_small, deg_big=jm.deg, n_nodes=n,
        options=japi.TCOptions(backend="jnp"), per_vertex=per_vertex,
        sign=-1)
    td = tdelta.batch_delta(
        delta, g_small=tdelta.padded_graph(small, n, device=CPU), g_big=tg,
        deg_small=deg_small, deg_big=jm.deg, n_nodes=n,
        options=tapi.TCOptions(), per_vertex=per_vertex, sign=-1)
    assert (td.triangles, td.probes) == (jd.triangles, jd.probes)
    if per_vertex:
        np.testing.assert_array_equal(td.per_vertex, jd.per_vertex)
    assert -td.triangles == (oracle.total_triangles(jm.edges(), n)
                             - oracle.total_triangles(small, n))


@pytest.mark.parametrize("name", ["karate", "er200", "rmat10"])
def test_padded_snapshot_counts_like_the_unpadded_graph(name):
    edges, n = GRAPHS[name]
    eng = tapi.TriangleEngine(tapi.TCOptions(per_vertex=True), device=CPU)
    padded = tdelta.padded_graph(edges, n, device=CPU)
    plain = tcsr.from_edges(edges, n, device=CPU)
    assert padded.num_slots > plain.num_slots or padded.num_slots == 128
    jr = japi.TriangleEngine(
        japi.TCOptions(backend="jnp", per_vertex=True)).count(
            jdelta.padded_graph(np.asarray(edges), n), route="local")
    for rep in (eng.count(padded), eng.count(plain)):
        assert (rep.triangles, rep.c1, rep.c2, rep.num_horizontal) == (
            jr.triangles, jr.c1, jr.c2, jr.num_horizontal)
        assert rep.k == jr.k
        np.testing.assert_array_equal(rep.levels, jr.levels)
        np.testing.assert_array_equal(rep.per_vertex, jr.per_vertex)
    # the pad slots hold the sentinel n, and the sentinel row is empty
    m2 = plain.num_slots
    assert bool((padded.src[m2:] == n).all() and (padded.dst[m2:] == n).all())
    assert int(padded.row_offsets[n]) == m2
    assert int(padded.row_offsets[n + 1]) == padded.num_slots
    adj = tint.CsrAdjacency.from_graph(padded)
    assert int(adj.bounds(torch.tensor([n], dtype=torch.int32))[1][0]) == 0
