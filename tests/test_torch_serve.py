"""The port's triangle server (``repro_torch.launch.serve_tc``) held
against the reference's on the CPU: the reference's request mix, served
at batch sizes 1 and 8, equal by request id (triangles, c1, c2, n_h, k as
float32 bits, overflow and per-vertex credit, bit for bit); the
right-sized drain; malformed requests answered with a structured
rejection; an empty drain and the summary's keys; the named stream
sessions; the robustness knobs answered and the refusals of what is not
ported; and ``measure_serve`` and the command line on the CPU."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.launch import serve_tc as jserve
from repro_torch import api as tapi
from repro_torch.core import intersect as tint
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.launch import serve_tc as tserve

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def smoke_mix():
    return tserve.synth_requests(24, seed=0, smoke=True)


def test_synth_requests_and_lanes_ladder_match_reference(smoke_mix):
    want = jserve.synth_requests(24, seed=0, smoke=True)
    assert len(smoke_mix) == len(want)
    for (te, tn), (je, jn) in zip(smoke_mix, want):
        assert tn == jn
        np.testing.assert_array_equal(te, je)
    for b in (1, 2, 3, 8, 12, 16):
        assert tserve.lanes_ladder(b) == jserve.lanes_ladder(b)


def _serve(server, reqs):
    for e, n in reqs:
        server.submit(e, n)
    return {r.request_id: r for r in server.drain()}


@pytest.mark.parametrize("batch_size,per_vertex", [(1, True), (8, True),
                                                   (8, False)])
def test_server_matches_reference_by_request_id(smoke_mix, batch_size,
                                                per_vertex):
    jsrv = japi.TriangleEngine(japi.TCOptions(
        backend="jnp", per_vertex=per_vertex)).serve(batch_size=batch_size)
    tsrv = tapi.TriangleEngine(tapi.TCOptions(per_vertex=per_vertex),
                               device=CPU).serve(batch_size=batch_size)
    want, got = _serve(jsrv, smoke_mix), _serve(tsrv, smoke_mix)
    assert sorted(got) == sorted(want) == list(range(len(smoke_mix)))
    for rid, j in want.items():
        t = got[rid]
        assert (t.triangles, t.c1, t.c2, t.num_horizontal, t.n_nodes) == (
            j.triangles, j.c1, j.c2, j.num_horizontal, j.n_nodes)
        assert np.float32(t.k).tobytes() == np.float32(j.k).tobytes()
        assert t.overflow == j.overflow is False
        assert (t.budget.n_budget, t.budget.slot_budget) == (
            j.budget.n_budget, j.budget.slot_budget)
        assert t.route == j.route == "batched"
        if per_vertex:
            np.testing.assert_array_equal(t.per_vertex,
                                          np.asarray(j.per_vertex))
            assert int(t.per_vertex.sum()) == 3 * t.triangles
        else:
            assert t.per_vertex is None
    ts, js = tsrv.summary(), jsrv.summary()
    for k in ("requests", "completed", "rejected", "batches", "by_route",
              "size_flushes", "pending", "inflight"):
        assert ts[k] == js[k], k
    assert ts["plan_hit"] == js["plan_hit"]


def test_drain_right_sizes_partial_queues():
    eng = tapi.TriangleEngine(device=CPU)
    lanes = []
    real = eng.count_batch_raw

    def record(gb, **kw):
        lanes.append((gb.budget, gb.batch_size))
        return real(gb, **kw)

    eng.count_batch_raw = record
    srv = eng.serve(batch_size=8)
    small = [gen.complete(5), gen.complete(6), gen.complete(7)]
    big = gen.rmat(7, 8, seed=1)
    for e, n in (*small, big):
        srv.submit(e, n)
    assert srv.batches_run == 0 and srv.summary()["pending"] == 4
    res = srv.drain()
    assert len(res) == 4 and srv.summary()["pending"] == 0
    # three requests flush at 4 lanes, one at 1: the pow2 ladder
    assert sorted(b for _, b in lanes) == [1, 4]
    assert srv.summary()["inflight"] == 0
    by_id = {r.request_id: r for r in res}
    assert [by_id[i].triangles for i in range(3)] == [10, 20, 35]
    # a full queue flushes at submit, at batch_size lanes
    srv = eng.serve(batch_size=2, max_inflight=0)
    srv.submit(*small[0])
    srv.submit(*small[1])
    assert srv.batches_run == 1 and len(srv.results) == 2
    assert lanes[-1][1] == 2


@pytest.mark.parametrize("bad", ["out_of_range", "negative_id",
                                 "negative_n", "unparseable"])
def test_malformed_request_is_rejected_with_its_id(bad):
    edges, n = {"out_of_range": (np.array([[0, 7]]), 5),
                "negative_id": (np.array([[-1, 3]]), 5),
                "negative_n": (np.zeros((0, 2), np.int64), -2),
                "unparseable": (np.array([1, 2, 3]), 5)}[bad]
    jsrv = japi.TriangleEngine().serve()
    tsrv = tapi.TriangleEngine(device=CPU).serve()
    tsrv.submit(*gen.karate())
    jsrv.submit(*gen.karate())
    rid = tsrv.submit(edges, n)
    assert rid == jsrv.submit(edges, n) == 1
    got = {r.request_id: r for r in tsrv.drain()}
    want = {r.request_id: r for r in jsrv.drain()}
    assert got[0].triangles == 45
    t, j = got[rid], want[rid]
    assert isinstance(t, tserve.RejectedRequest)
    assert (t.route, t.reason, t.detail) == (j.route, j.reason, j.detail)
    assert tsrv.summary()["rejected"] == 1
    with pytest.raises(ValueError, match="request 0: "):
        tapi.TriangleEngine(device=CPU).serve(strict=True).submit(edges, n)
    with pytest.raises(ValueError, match="request 0: "):
        tapi.TriangleEngine(device=CPU).serve().submit(edges, n,
                                                       strict=True)


def test_empty_drain_and_summary_keys_match_reference():
    tsrv = tapi.TriangleEngine(device=CPU).serve()
    jsrv = japi.TriangleEngine().serve()
    assert tsrv.drain() == [] == jsrv.drain()
    ts, js = tsrv.summary(), jsrv.summary()
    assert set(ts) == set(js)
    assert ts["jit_compiles"] == 0  # no library loads on the CPU
    for k in js:
        assert ts[k] == js[k], k


def test_named_sessions_match_reference():
    """``tests/test_stream.py::test_server_named_sessions`` on both
    servers: the same updates, counts and closing stats."""
    edges, n = gen.karate()
    out = []
    for srv in (japi.TriangleEngine(japi.TCOptions(per_vertex=True)).serve(),
                tapi.TriangleEngine(tapi.TCOptions(per_vertex=True),
                                    device=CPU).serve()):
        srv.stream_session("karate", (edges, n))
        with pytest.raises(ValueError, match="already open"):
            srv.stream_session("karate", (edges, n))
        up = srv.mutate("karate", [(+1, 0, n - 1), (+1, 0, n - 1)])
        rep = srv.stream_count("karate")
        s = srv.summary()
        stats = srv.close_session("karate")
        with pytest.raises(KeyError, match="no open stream session"):
            srv.mutate("karate", [(+1, 0, 1)])
        out.append((up.statuses, up.delta_triangles, rep.triangles,
                    rep.route, np.asarray(rep.per_vertex).tolist(),
                    s["stream_sessions"], s["stream_mutations"],
                    stats.inserted, stats.noops,
                    srv.summary()["stream_sessions"]))
    assert out[1] == out[0]
    assert out[1][0][1] == "noop-present" and out[1][5:7] == (1, 2)


def test_unported_serving_knobs_name_their_items():
    eng = tapi.TriangleEngine(device=CPU)
    # the item-8 knobs are ported (slice 10), the distributed fault
    # classes, the timeout and a server over a capped grid too (slice 11,
    # item 10), prewarm and the recorder too (slice 12, item 11)
    from repro_torch.launch.robust import FaultPlan
    from repro_torch.tune import TraceRecorder

    assert eng.serve(faults=FaultPlan(fail_batch_every=3)).faults is not None
    assert eng.serve(faults=FaultPlan(fail_distributed_every=1)).faults \
        == FaultPlan(fail_distributed_every=1)
    warm = eng.serve(prewarm=True)  # no profile: nothing to prewarm
    assert eng.plan_cache_stats()["misses"] == 0
    assert (warm.summary()["plan_hit"], warm.summary()["jit_compiles"]) == (
        1.0, 0)
    rec = TraceRecorder()
    srv = eng.serve(recorder=rec)
    assert srv.recorder is rec
    rid = srv.submit(*gen.karate(), deadline_s=1.0)
    assert [(r.request_id, r.route, r.n_nodes, r.budget, r.deadline_s)
            for r in rec.records] == [(rid, "batch", 34,
                                       tcsr.ShapeBudget(64, 256), 1.0)]
    assert [r.triangles for r in srv.drain()] == [45]
    srv = eng.serve()
    rid = srv.submit(*gen.karate(), deadline_s=1.0)
    assert [(r.request_id, r.triangles) for r in srv.drain()] == [(rid, 45)]
    for kw in (dict(deadline_s=0.5), dict(admission_tokens=4),
               dict(approx_on_overload=False), dict(distributed_timeout_s=2.0)):
        assert tapi.TCOptions(**kw) == dataclasses.replace(tapi.TCOptions(),
                                                           **kw)
    capped = tapi.TriangleEngine(
        budgets=tcsr.BudgetGrid(max_nodes=256, max_slots=2048), device=CPU)
    srv = capped.serve()
    big = gen.rmat(9, 8, seed=0)
    rid = srv.submit(*big)
    (r,) = srv.drain()
    assert (r.request_id, r.route, r.c1, r.triangles) == (
        rid, "distributed", None, capped.count(big, route="local").triangles)
    assert srv.summary()["distributed_requests"] == 1
    with pytest.raises(ValueError, match="d_max/cap_h"):
        tapi.TriangleEngine(tapi.TCOptions(cap_h=8), device=CPU).serve()
    # a profile-less engine has nothing to prewarm: an empty compile set
    assert eng.compile_space(batch_size=8) == []
    pl = tint.PairListAdjacency(
        owners=torch.tensor([0, 0, 1, 5], dtype=torch.int32),
        values=torch.tensor([1, 2, 0, 5], dtype=torch.int32), n_nodes=4)
    starts, lens = pl.bounds(torch.tensor([0, 1, 2, 4, 5], dtype=torch.int32))
    assert (starts.tolist(), lens.tolist()) == ([0, 2, 3, 3, 3],
                                                [2, 1, 0, 0, 0])


@pytest.mark.parametrize("max_inflight", [0, 8])
def test_serve_answers_every_id_exactly_once(max_inflight):
    reqs = tserve.synth_requests(12, seed=3, smoke=True)
    srv = tapi.TriangleEngine(device=CPU).serve(batch_size=8,
                                                max_inflight=max_inflight)
    ids = [srv.submit(e, n) for e, n in reqs[:6]]
    ids.append(srv.submit(np.array([[0, 99]]), 4))  # malformed
    ids += [srv.submit(e, n) for e, n in reqs[6:]]
    res = srv.drain()
    assert sorted(r.request_id for r in res) == ids == list(range(13))
    assert srv.drain() is res and len(res) == 13  # a second drain adds none
    one = tapi.TriangleEngine(device=CPU)
    for r in res:
        if r.request_id != 6:
            e, n = reqs[r.request_id - (r.request_id > 6)]
            assert r.triangles == one.count((e, n)).triangles
            assert r.latency_s >= 0.0


def test_measure_serve_agrees_on_the_cpu():
    row = tserve.measure_serve(num_requests=10, batch_sizes=(1, 4),
                               seed=1, smoke=True, device=CPU)
    assert row["agree"] and row["device"] == "cpu"
    assert [e["batch_size"] for e in row["batched"]] == [1, 4]
    for e in row["batched"]:
        assert e["agree"] and e["plan_cache_hit_rate"] == 1.0
        assert e["triangles_total"] == row["sequential"]["triangles_total"]
    # a given request list replaces the synthetic mix
    reqs = [gen.karate(), gen.complete(9), gen.rmat(6, 8, seed=2)]
    row = tserve.measure_serve(requests=reqs, batch_sizes=(2,), device=CPU)
    assert row["agree"] and row["num_requests"] == 3
    rmat6 = tapi.TriangleEngine(device=CPU).count(reqs[2]).triangles
    assert row["sequential"]["triangles_total"] == 45 + 84 + rmat6


def test_main_writes_a_file_only_with_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--smoke", "--device", "cpu", "--requests", "6",
            "--batch-sizes", "2"]
    row = tserve.main(argv)
    assert row["agree"] and list(tmp_path.iterdir()) == []
    out = tmp_path / "sub" / "serve.json"
    tserve.main([*argv, "--out", str(out)])
    assert json.loads(out.read_text())["agree"] is True
