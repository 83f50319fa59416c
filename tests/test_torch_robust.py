"""The port's approx route and robust serving held against the JAX
package on the CPU: ``wedge_sample_estimate``, ``count_approx`` and
``count(route="approx")`` field for field; ``edge_exists`` and the wedge
baseline; the robustness knobs' validation; the reference's robust
serving tests that need no mesh, each run on both servers (malformed
rejection, ``summary``, deadline flushes, the admission ladder, failed
batches, drained partial lanes, the open-loop traces, ``FaultPlan`` and
``run_chaos``), every approx answer equal to the reference's
``count_approx`` at ``seed=request id``; and a chaos run of the port
under the plan's batch-path fault classes, its failed batches by the
reference's ordinal rule."""
from __future__ import annotations

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import approx as japprox
from repro.core import intersect as jint
from repro.core import wedge_baseline as jwedge
from repro.graph import csr as jcsr
from repro.launch import robust as jrobust
from repro.launch import serve_tc as jserve
from repro_torch import api as tapi
from repro_torch.core import approx as tapprox
from repro_torch.core import intersect as tint
from repro_torch.core import wedge_baseline as twedge
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.launch import robust as trobust
from repro_torch.launch import serve_tc as tserve

CPU = "cpu"

GRAPHS = {
    "karate": gen.karate(),
    "complete9": gen.complete(9),
    "er150": gen.erdos_renyi(150, 0.05, seed=11),
    "er200": gen.erdos_renyi(200, 0.05, seed=3),
    "rmat6": gen.rmat(6, 8, seed=4),
    "rmat8": gen.rmat(8, 8, seed=1),
    "ring_of_cliques": gen.ring_of_cliques(5, 6),
    "dolphins_like": gen.dolphins_like(),
    "geometric": gen.random_geometric(80, 0.25, seed=2),
    "star": gen.star(12),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(est) -> dict:
    """An ``ApproxEstimate``'s fields with their Python types."""
    d = dataclasses.asdict(est)
    return {k: (type(v), v) for k, v in d.items()}


def _both(opts=None, **serve_kw):
    """A reference server (``jnp``) and a port server (CPU) on the same
    options ``opts`` (a dict of ``TCOptions`` fields)."""
    opts = opts or {}
    return (
        japi.TriangleEngine(japi.TCOptions(backend="jnp", **opts)).serve(
            **serve_kw),
        tapi.TriangleEngine(tapi.TCOptions(**opts), device=CPU).serve(
            **serve_kw),
    )


def _pump_until_answered(server, count: int) -> None:
    t0 = time.perf_counter()
    while len(server.results) < count:
        server.pump()
        assert time.perf_counter() - t0 < 30.0, "never flushed"


def _approx_equals_reference(r, edges, n, samples) -> None:
    """An approx answer equals the reference's ``count_approx`` at
    ``seed=request id``."""
    want = japi.TriangleEngine(japi.TCOptions(backend="jnp")).count_approx(
        (edges, n), samples=samples, seed=r.request_id)
    assert r.route == "approx" and r.c1 is None and r.c2 is None
    assert np.isnan(r.k) and r.num_horizontal == 0 and r.per_vertex is None
    assert r.triangles == want.triangles
    assert _fields(r.approx) == _fields(want.approx)
    assert r.report.plan_id == want.plan_id


# ------------------------------------------------------------ estimator
@pytest.mark.parametrize("name", ["karate", "complete9", "er150", "rmat6",
                                  "rmat8", "ring_of_cliques", "geometric"])
def test_wedge_sample_estimate_matches_reference(name):
    e, n = GRAPHS[name]
    for seed in (0, 1, 17):
        for samples in (1, 100, 8192):
            want = japprox.wedge_sample_estimate(e, n, samples=samples,
                                                 seed=seed)
            got = tapprox.wedge_sample_estimate(e, n, samples=samples,
                                                seed=seed)
            assert _fields(got) == _fields(want), (seed, samples)
    np.testing.assert_array_equal(tapprox._normalize_host(e, n),
                                  japprox._normalize_host(e, n))


def test_wedge_sample_estimate_duplicates_and_self_loops():
    """Repeats, reversed repeats and self-loops collapse as the
    reference's host normalization collapses them."""
    rng = np.random.default_rng(5)
    e = rng.integers(0, 40, size=(600, 2))
    for seed in (0, 3):
        want = japprox.wedge_sample_estimate(e, 40, samples=2048, seed=seed)
        got = tapprox.wedge_sample_estimate(e, 40, samples=2048, seed=seed)
        assert _fields(got) == _fields(want)
    np.testing.assert_array_equal(tapprox._normalize_host(e, 40),
                                  japprox._normalize_host(e, 40))


@pytest.mark.parametrize("case", ["empty", "matching", "path2"])
def test_wedge_sample_estimate_zero_wedges_is_exact(case):
    e, n = {"empty": (np.zeros((0, 2), np.int64), 0),
            "matching": (np.array([[0, 1], [2, 3]]), 4),
            "path2": (np.array([[0, 1], [1, 1]]), 3)}[case]
    got = tapprox.wedge_sample_estimate(e, n, samples=64, seed=1)
    want = japprox.wedge_sample_estimate(e, n, samples=64, seed=1)
    assert _fields(got) == _fields(want)
    assert got == tapprox.ApproxEstimate(
        triangles=0.0, stderr=0.0, ci95=0.0, samples=0, closed=0,
        wedges=0.0, exact=True)


@pytest.mark.parametrize("bad", ["samples_zero", "samples_negative",
                                 "endpoint_n", "endpoint_negative"])
def test_wedge_sample_estimate_validates_input(bad):
    e, n, k = {"samples_zero": (np.array([[0, 1]]), 2, 0),
               "samples_negative": (np.array([[0, 1]]), 2, -4),
               "endpoint_n": (np.array([[0, 5]]), 5, 8),
               "endpoint_negative": (np.array([[-1, 2]]), 5, 8)}[bad]
    with pytest.raises(ValueError) as je:
        japprox.wedge_sample_estimate(e, n, samples=k)
    with pytest.raises(ValueError) as te:
        tapprox.wedge_sample_estimate(e, n, samples=k)
    assert str(te.value) == str(je.value)


# ------------------------------------------------------------ approx route
def _assert_approx_reports_equal(tr, jr):
    assert (tr.route, tr.triangles, tr.plan_id, tr.num_horizontal) == (
        jr.route, jr.triangles, jr.plan_id, jr.num_horizontal)
    assert tr.c1 is None and tr.c2 is None and tr.levels is None
    assert np.isnan(tr.k) and np.isnan(jr.k)
    assert tr.per_vertex is None and tr.degrees is None
    assert not tr.overflow and dataclasses.asdict(tr.overflow) == \
        dataclasses.asdict(jr.overflow)
    assert _fields(tr.approx) == _fields(jr.approx)


@pytest.mark.parametrize("name,samples,seed", [
    ("karate", 4096, 3), ("rmat8", None, 0), ("er200", 512, 9)])
def test_count_approx_matches_reference(name, samples, seed):
    e, n = GRAPHS[name]
    jr = japi.TriangleEngine(japi.TCOptions(backend="jnp")).count_approx(
        (e, n), samples=samples, seed=seed)
    teng = tapi.TriangleEngine(device=CPU)
    tr = teng.count_approx((e, n), samples=samples, seed=seed)
    _assert_approx_reports_equal(tr, jr)
    assert tr.backend == "torch"  # the engine's, for provenance
    # a packed Graph goes back to host edges first: the same estimate
    tg = tcsr.from_edges(e, n, device=CPU)
    _assert_approx_reports_equal(
        teng.count_approx(tg, samples=samples, seed=seed), jr)


@pytest.mark.parametrize("per_vertex", [False, True])
def test_count_route_approx_matches_reference(per_vertex):
    e, n = GRAPHS["karate"]
    jopts = japi.TCOptions(backend="jnp", approx_samples=4096,
                           per_vertex=per_vertex)
    topts = tapi.TCOptions(approx_samples=4096, per_vertex=per_vertex)
    jeng, teng = japi.TriangleEngine(jopts), tapi.TriangleEngine(
        topts, device=CPU)
    _assert_approx_reports_equal(teng.count((e, n), route="approx"),
                                 jeng.count((e, n), route="approx"))
    # the options' default route
    _assert_approx_reports_equal(
        teng.count((e, n), options=dataclasses.replace(topts,
                                                       route="approx")),
        jeng.count((e, n), route="approx"))
    # the empty graph answers at the facade, as the reference does
    empty = (np.zeros((0, 2), np.int64), 0)
    tr, jr = teng.count(empty, route="approx"), jeng.count(empty,
                                                           route="approx")
    assert (tr.route, tr.triangles, tr.plan_id, tr.k, tr.num_horizontal) == (
        jr.route, jr.triangles, jr.plan_id, jr.k, jr.num_horizontal)
    assert tr.c1 is tr.c2 is tr.levels is tr.per_vertex is tr.approx is None
    assert jr.c1 is jr.c2 is jr.levels is jr.per_vertex is jr.approx is None


# ------------------------------------------------- edge_exists, wedges
@pytest.mark.parametrize("name", ["karate", "er150", "rmat8",
                                  "ring_of_cliques", "star"])
def test_edge_exists_matches_reference(name):
    e, n = GRAPHS[name]
    jg, tg = jcsr.from_edges(e, n), tcsr.from_edges(e, n, device=CPU)
    rng = np.random.default_rng(n)
    qu = rng.integers(0, n + 4, size=2000)
    qv = rng.integers(0, n + 4, size=2000)
    # every real edge, both ways, is found
    qu = np.concatenate([qu, e[:, 0], e[:, 1]])
    qv = np.concatenate([qv, e[:, 1], e[:, 0]])
    want = np.asarray(jint.edge_exists(jg, jnp.asarray(qu, jnp.int32),
                                       jnp.asarray(qv, jnp.int32)))
    got = tint.edge_exists(tg, torch.as_tensor(qu), torch.as_tensor(qv))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    loops = np.concatenate([e[:, 0] == e[:, 1]] * 2)  # raw RMAT rows
    assert got[-2 * len(e):][torch.as_tensor(~loops)].all()
    assert not got[(torch.as_tensor(qu) >= n)
                   | (torch.as_tensor(qv) >= n)].any()


@pytest.mark.parametrize("name", ["karate", "complete9", "er150", "rmat8",
                                  "ring_of_cliques", "geometric"])
def test_wedge_triangle_count_matches_reference_and_local(name, monkeypatch):
    e, n = GRAPHS[name]
    jg, tg = jcsr.from_edges(e, n), tcsr.from_edges(e, n, device=CPU)
    d_max = tcsr.max_degree(tg)
    want = int(jwedge.wedge_triangle_count(jg, d_max=d_max))
    local = tapi.TriangleEngine(device=CPU).count((e, n)).triangles
    assert want == local
    # one chunk, then chunks of 7 and 64 slots, then one slot a chunk
    # (a cell budget below d_max)
    for budget in (twedge.WEDGE_CELL_BUDGET, 7 * d_max, 64 * d_max, 1):
        monkeypatch.setattr(twedge, "WEDGE_CELL_BUDGET", budget)
        got = twedge.wedge_triangle_count(tg, d_max=d_max)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == want, budget
    # a clamp below the max degree truncates as the reference does, in
    # chunks of 5 slots
    for d in (1, max(1, d_max // 2)):
        monkeypatch.setattr(twedge, "WEDGE_CELL_BUDGET", 5 * d)
        assert int(twedge.wedge_triangle_count(tg, d_max=d)) \
            == int(jwedge.wedge_triangle_count(jg, d_max=d))
    assert float(twedge.wedge_count(tg)) == float(jwedge.wedge_count(jg))


def test_wedge_baseline_refusals():
    """The parallel wedge baseline (item 10) runs over a shard group and
    refuses anything else."""
    from repro_torch.core.shards import LocalShards

    tg = tcsr.from_edges(*GRAPHS["karate"], device=CPU)
    with pytest.raises(AttributeError):
        twedge.parallel_wedge_triangle_count(tg, None)
    r = twedge.parallel_wedge_triangle_count(tg, LocalShards(4, CPU))
    assert (int(r.triangles), bool(r.overflow)) == (45, False)
    # every wedge is routed once: Table I's "Wedges" column
    assert int(r.wedges_routed) == int(
        jwedge.wedge_count(jcsr.from_edges(*GRAPHS["karate"]))) == 528


# ---------------------------------------------------------------- options
@pytest.mark.parametrize("kw", [
    dict(deadline_s=0.0), dict(deadline_s=-1.5), dict(admission_tokens=0),
    dict(admission_tokens=-2), dict(approx_samples=0),
    dict(approx_samples=-8)])
def test_robust_option_validation_matches_reference(kw):
    with pytest.raises(ValueError) as je:
        japi.TCOptions(**kw)
    with pytest.raises(ValueError) as te:
        tapi.TCOptions(**kw)
    assert str(te.value) == str(je.value)


def test_robust_options_answered_and_distributed_timeout_names_item_10():
    """The robustness knobs, ``distributed_timeout_s`` and the
    distributed fault classes (item 10) are answered."""
    o = tapi.TCOptions(deadline_s=0.25, admission_tokens=3,
                       approx_samples=100, approx_on_overload=False)
    assert (o.deadline_s, o.admission_tokens, o.approx_samples,
            o.approx_on_overload) == (0.25, 3, 100, False)
    assert tapi.TCOptions().approx_samples == japi.TCOptions().approx_samples
    # the robustness knobs are plan-irrelevant
    assert o.plan_view(CPU) == tapi.TCOptions().plan_view(CPU)
    assert tapi.TCOptions(distributed_timeout_s=2.0).distributed_timeout_s \
        == japi.TCOptions(distributed_timeout_s=2.0).distributed_timeout_s
    for v in (0.0, -1.0):
        with pytest.raises(ValueError, match="distributed_timeout_s"):
            tapi.TCOptions(distributed_timeout_s=v)
    capped = tapi.TriangleEngine(
        budgets=tcsr.BudgetGrid(max_nodes=256, max_slots=2048), device=CPU)
    srv = capped.serve(faults=trobust.FaultPlan(fail_distributed_every=1))
    big = gen.rmat(9, 8, seed=0)
    srv.submit(*big)
    (r,) = srv.drain()
    # attempt 0 failed, the ring retry answered exactly
    assert (r.route, r.triangles, r.c1) == (
        "distributed", capped.count(big, route="local").triangles, None)
    assert srv.summary()["distributed_retries"] == 1
    for kw in (dict(fail_distributed_every=1), dict(stall_distributed_every=2)):
        assert tapi.TriangleEngine(device=CPU).serve(
            faults=trobust.FaultPlan(**kw)).faults == trobust.FaultPlan(**kw)


# ------------------------------------------------ serving, both servers
def test_submit_malformed_returns_structured_rejection():
    good = GRAPHS["karate"]
    bad = [(np.array([[0, 9]]), 5), (np.array([[-2, 1]]), 5),
           (np.array([1, 2, 3]), 5), (np.array([[0, 1]]), -1)]
    out = []
    for srv in _both(batch_size=4):
        ids = [srv.submit(*good)] + [srv.submit(e, n) for e, n in bad]
        by_id = {r.request_id: r for r in srv.drain()}
        assert sorted(by_id) == ids
        out.append([(type(r).__name__, r.route, getattr(r, "reason", None),
                     getattr(r, "detail", None), getattr(r, "triangles",
                                                         None))
                    for r in (by_id[i] for i in ids)])
        with pytest.raises(ValueError, match="request"):
            srv.submit(np.array([[0, 9]]), 5, strict=True)
    assert out[1] == out[0]
    assert out[1][0][4] == 45 and all(o[2] == "malformed"
                                      for o in out[1][1:])


def test_summary_safe_on_empty_and_all_rejected():
    keys = ("requests", "completed", "rejected", "p50_ms", "p99_ms",
            "by_route", "failed_batches", "deadline_flushes",
            "size_flushes", "approx_answers", "pending", "inflight")
    out = []
    for srv in _both():
        empty = srv.summary()
        assert srv.drain() == []
        srv.submit(np.array([[0, 9]]), 5)
        srv.submit(np.array([[3, 9]]), 5)
        srv.drain()
        s = srv.summary()
        out.append(([empty[k] for k in keys], [s[k] for k in keys]))
    assert out[1] == out[0]
    assert out[1][1][:3] == [2, 0, 2] and out[1][1][5] == {"rejected": 2}


@pytest.mark.parametrize("where", ["options", "per_request"])
def test_deadline_flushes_partial_lane(where):
    """One request with a deadline is answered by a deadline flush, never
    waiting for ``batch_size``; a far-future per-request deadline does
    not fire early."""
    e, n = GRAPHS["karate"]
    okw = dict(deadline_s=0.01) if where == "options" else {}
    skw = {} if where == "options" else dict(deadline_s=0.01)
    out = []
    for srv in _both(okw, batch_size=8):
        rid = srv.submit(e, n, **skw)
        _pump_until_answered(srv, 1)
        (res,) = srv.results
        flushes = (srv.deadline_flushes, srv.size_flushes)
        srv.submit(e, n, deadline_s=1e9)
        srv.pump()
        still = len(srv.results)
        srv.drain()
        out.append((res.request_id == rid, res.triangles, res.c1, res.c2,
                    res.route, flushes, still, len(srv.results),
                    srv.summary()["size_flushes"]))
    assert out[1] == out[0]
    assert out[1][:2] == (True, 45) and out[1][4:] == ("batched", (1, 0),
                                                       1, 2, 1)


def test_admission_ladder_degrades_to_approx_then_sheds():
    e, n = GRAPHS["karate"]
    # rung 2: a full cell answers through the approx lane, at once
    out = []
    for srv in _both(dict(admission_tokens=1, approx_samples=8192),
                     batch_size=8):
        r0, r1 = srv.submit(e, n), srv.submit(e, n)
        now = [r for r in srv.results if r.request_id == r1]
        results = {r.request_id: r for r in srv.drain()}
        out.append((len(now), now[0].route, now[0].triangles,
                    _fields(now[0].approx), srv.approx_answers,
                    results[r0].route, results[r0].triangles))
        if isinstance(srv, tserve.TriangleServer):
            _approx_equals_reference(now[0], e, n, 8192)
    assert out[1] == out[0]
    assert out[1][:2] == (1, "approx") and out[1][5:] == ("batched", 45)
    # rung 3: approx off sheds; the drain releases the cell's token
    out = []
    kw = dict(admission_tokens=1, approx_on_overload=False)
    for srv in _both(kw, batch_size=8):
        srv.submit(e, n)
        r1 = srv.submit(e, n)
        shed = next(r for r in srv.results if r.request_id == r1)
        srv.drain()
        r2 = srv.submit(e, n)
        srv.drain()
        again = next(r for r in srv.results if r.request_id == r2)
        out.append((type(shed).__name__, shed.reason, shed.detail,
                    type(again).__name__, again.route, again.triangles,
                    srv.summary()["rejected"]))
    assert out[1] == out[0]
    assert out[1][:2] == ("RejectedRequest", "overloaded")
    assert out[1][3:] == ("TriangleAnalytics", "batched", 45, 1)


@pytest.mark.parametrize("approx_on_overload", [True, False])
def test_failed_batch_degrades_every_lane(approx_on_overload):
    """Injected failures at every dispatch answer every lane through the
    ladder: nothing raises, nothing is lost, the tokens come back."""
    e, n = GRAPHS["karate"]
    kw = dict(approx_samples=2048, approx_on_overload=approx_on_overload,
              admission_tokens=4)
    out = []
    # each server gets its own package's plan (and FaultInjected)
    jsrv = japi.TriangleEngine(japi.TCOptions(backend="jnp", **kw)).serve(
        batch_size=2, faults=jrobust.FaultPlan(fail_batch_every=1))
    tsrv = tapi.TriangleEngine(tapi.TCOptions(**kw), device=CPU).serve(
        batch_size=2, faults=trobust.FaultPlan(fail_batch_every=1))
    for srv in (jsrv, tsrv):
        ids = [srv.submit(e, n) for _ in range(6)]
        results = srv.drain()
        s = srv.summary()
        out.append((sorted(r.request_id for r in results) == ids,
                    [r.route for r in results],
                    [getattr(r, "reason", None) for r in results],
                    srv.failed_batches, s["approx_answers"], s["rejected"],
                    s["pending"], s["inflight"],
                    sorted(srv._tokens.values())))
    assert out[1] == out[0]
    assert out[1][0] and out[1][3] == 3 and out[1][8] == [0]
    if approx_on_overload:
        assert set(out[1][1]) == {"approx"}
        for r in tsrv.results:
            _approx_equals_reference(r, e, n, 2048)
    else:
        assert set(out[1][2]) == {"failed"}


class _DeadResult:
    """A batch result whose every field raises on access, as a read-back
    of a batch whose kernel faulted on the card does."""

    def __getattr__(self, name):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


@pytest.mark.parametrize("where", ["dispatch", "read_back"])
def test_device_error_propagates_instead_of_degrading(where, monkeypatch):
    """The port degrades only injected faults and packing errors: an
    error of the dispatch or of the read-back (a kernel that does not
    build, a CUDA error) leaves ``submit`` and answers nothing on the
    host, so a broken kernel cannot hide behind approx answers."""
    eng = tapi.TriangleEngine(tapi.TCOptions(approx_samples=512),
                              device=CPU)
    srv = eng.serve(batch_size=2)

    def broken(gb, plan=None):
        if where == "dispatch":
            raise RuntimeError("intersect.cu: nvcc exited with status 1")
        return _DeadResult()

    monkeypatch.setattr(eng, "count_batch_raw", broken)
    e, n = GRAPHS["karate"]
    srv.submit(e, n)
    with pytest.raises(RuntimeError, match="nvcc|CUDA error"):
        srv.submit(e, n)
    s = srv.summary()
    assert (s["failed_batches"], s["approx_answers"], s["rejected"],
            s["requests"]) == (0, 0, 0, 0)


def test_packing_error_degrades_the_batch(monkeypatch):
    """A ``ValueError`` of host-side packing fails its batch through the
    ladder, as an injected fault does; each approx answer equals the
    reference's at ``seed=request id``, and the tokens come back."""
    eng = tapi.TriangleEngine(tapi.TCOptions(approx_samples=1024,
                                             admission_tokens=4),
                              device=CPU)
    srv = eng.serve(batch_size=2)

    def bad_pack(*args, **kwargs):
        raise ValueError("lane does not fit its budget")

    monkeypatch.setattr(tserve, "from_edges_batch", bad_pack)
    e, n = GRAPHS["karate"]
    ids = [srv.submit(e, n) for _ in range(3)]
    results = srv.drain()
    assert sorted(r.request_id for r in results) == ids
    assert srv.failed_batches == 2 and srv.batches_run == 0
    assert sorted(srv._tokens.values()) == [0]
    for r in results:
        _approx_equals_reference(r, e, n, 1024)


def test_chaos_smoke_fails_on_a_failure_the_plan_did_not_inject(
        monkeypatch):
    """``robust.main`` holds ``failed_batches`` to the injected faults:
    one more failed batch (here a packing error) exits non-zero even
    though every id is answered."""
    real, calls = tserve.from_edges_batch, {"n": 0}

    def flaky_pack(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise ValueError("lane does not fit its budget")
        return real(*args, **kwargs)

    monkeypatch.setattr(tserve, "from_edges_batch", flaky_pack)
    with pytest.raises(SystemExit, match="the plan did not fail"):
        trobust.main(["--smoke", "--device", "cpu", "--requests", "24"])


def test_counting_fault_plan_records_its_injections():
    """``CountingFaultPlan`` raises what ``FaultPlan`` raises, at the same
    ordinals, and records each; ``ordinal_failures`` is the ordinal
    rule."""
    plain = trobust.FaultPlan(fail_batch_every=3)
    counting = trobust.CountingFaultPlan(fail_batch_every=3)
    fired = []
    for plan in (plain, counting):
        got = []
        for i in range(7):
            try:
                plan.before_batch(i)
                got.append(False)
            except tserve.FaultInjected:
                got.append(True)
        fired.append(got)
    assert fired[0] == fired[1] == [i % 3 == 2 for i in range(7)]
    assert counting.injected == [2, 5]
    assert counting == trobust.CountingFaultPlan(fail_batch_every=3)
    assert [trobust.ordinal_failures(plain, f) for f in range(5)] == \
        [0, 0, 0, 1, 2]
    assert trobust.ordinal_failures(trobust.FaultPlan(), 9) == 0


def test_drain_partial_lanes_bit_identity():
    """Mixed-budget queues drained mid-fill: every request answered once
    at right-sized flushes, each lane equal to the reference's by id."""
    graphs = [GRAPHS[k] for k in ("karate", "er200", "complete9",
                                  "geometric", "ring_of_cliques", "er150",
                                  "dolphins_like")]
    jsrv, tsrv = _both(batch_size=4)
    got, want = [], []
    for srv, acc in ((jsrv, want), (tsrv, got)):
        ids = [srv.submit(e, n) for e, n in graphs]
        by_id = {r.request_id: r for r in srv.drain()}
        assert sorted(by_id) == ids
        acc.append([(r.triangles, r.c1, r.c2, r.num_horizontal,
                     np.float32(r.k).tobytes(), r.overflow, r.route)
                    for r in (by_id[i] for i in ids)])
        acc.append((srv.batches_run, srv.summary()["size_flushes"]))
    assert got == want
    local = tapi.TriangleEngine(device=CPU)
    assert [g[0] for g in got[0]] == [local.count(x).triangles
                                      for x in graphs]


# -------------------------------------------------------- chaos harness
@pytest.mark.parametrize("arrival", ["poisson", "burst"])
def test_synth_requests_arrival_shapes_match_reference(arrival):
    kw = (dict(rate_hz=500) if arrival == "poisson"
          else dict(burst_len=8, burst_gap_s=0.05))
    tr = trobust.synth_requests(24, arrival=arrival, seed=2, smoke=True, **kw)
    jr = jrobust.synth_requests(24, arrival=arrival, seed=2, smoke=True, **kw)
    assert len(tr) == len(jr) == 24 and tr[0].t == 0.0
    assert [r.t for r in tr] == [r.t for r in jr]
    for a, b in zip(tr, jr):
        assert a.n_nodes == b.n_nodes
        np.testing.assert_array_equal(a.edges, b.edges)
    assert all(b.t >= a.t for a, b in zip(tr, tr[1:]))
    if arrival == "burst":
        gaps = np.diff([r.t for r in tr])
        assert gaps[7] > 10 * gaps.min() and gaps[15] > 10 * gaps.min()
    u = trobust.synth_requests(6, mix="uniform", seed=4)
    ju = jrobust.synth_requests(6, mix="uniform", seed=4)
    assert [(r.t, r.n_nodes, r.edges.tobytes()) for r in u] == [
        (r.t, r.n_nodes, r.edges.tobytes()) for r in ju]
    with pytest.raises(ValueError, match="arrival must be one of"):
        trobust.synth_requests(4, arrival="uniform")
    with pytest.raises(ValueError, match="mix must be"):
        trobust.synth_requests(4, mix="nope")


def test_fault_plan_is_deterministic_and_matches_reference():
    kw = dict(malformed_every=3, oversized_every=5, oversized_nodes=600,
              stall_batch_every=4, stall_s=0.0, fail_batch_every=6)
    tp, jp = trobust.FaultPlan(**kw), jrobust.FaultPlan(**kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    e, n = GRAPHS["karate"]
    for i in range(15):
        (te, tn), (je, jn) = tp.mutate(i, e, n), jp.mutate(i, e, n)
        assert tn == jn == tp.mutate(i, e, n)[1]
        np.testing.assert_array_equal(te, je)
    assert tp.mutate(2, e, n)[1] == n
    assert (tp.mutate(2, e, n)[0] == np.array([[0, n]])).all()
    assert tp.mutate(4, e, n)[1] == 600
    assert tp.mutate(0, e, n)[1] == n and tp.mutate(1, e, n)[1] == n

    def fires(plan, cls):
        out = []
        for b in range(20):
            try:
                plan.before_batch(b)
                out.append(False)
            except cls:
                out.append(True)
        return out

    assert fires(tp, tserve.FaultInjected) == fires(jp, jserve.FaultInjected)
    assert [i for i, f in enumerate(fires(tp, tserve.FaultInjected))
            if f] == [5, 11, 17]
    # the distributed hook keeps the reference's rule (nothing calls it)
    dp = trobust.FaultPlan(fail_distributed_every=2,
                           fail_distributed_attempts=2)
    dp.before_distributed(0, 0)
    with pytest.raises(tserve.FaultInjected, match="request 1 attempt 1"):
        dp.before_distributed(1, 1)
    dp.before_distributed(1, 2)


def test_run_chaos_plain_server_all_exact():
    trace = [(0.0, GRAPHS["karate"]), (0.0, GRAPHS["complete9"]),
             (0.001, GRAPHS["dolphins_like"])]
    out = []
    for srv, mod in zip(_both(batch_size=4), (jrobust, trobust)):
        audit = mod.run_chaos(srv, [mod.TimedRequest(t, *g)
                                    for t, g in trace])
        out.append({k: audit[k] for k in (
            "ok", "submitted", "answered", "unanswered", "duplicates",
            "exact", "approx", "rejected", "leaked_pending",
            "leaked_inflight")})
        out.append(sorted((r.request_id, r.triangles) for r in srv.results))
    assert out[2:] == out[:2]
    assert out[2]["ok"] and out[2]["exact"] == 3
    assert out[3] == [(0, 45), (1, 84), (2, out[1][2][1])]


def test_chaos_invariant_under_the_batch_fault_classes():
    """The port's acceptance gate on the CPU: a bursty open-loop trace
    under every batch-path fault class; every id answered once, all
    three categories, exact answers equal to the local route, approx
    answers equal to the reference's estimate at ``seed=id``, rejections
    exactly the malformed ordinals, and failed batches by the ordinal
    rule (``batches_run`` advances only on a dispatched flush, so every
    flush from ordinal ``fail_batch_every - 1`` on fails)."""
    plan = trobust.FaultPlan(malformed_every=7, oversized_every=11,
                             oversized_nodes=600, stall_batch_every=5,
                             stall_s=0.02, fail_batch_every=6)
    engine = tapi.TriangleEngine(
        tapi.TCOptions(deadline_s=0.05, admission_tokens=16,
                       approx_samples=4096), device=CPU)
    server = engine.serve(batch_size=8, faults=plan)
    trace = trobust.synth_requests(48, arrival="burst", rate_hz=400.0,
                                   burst_len=12, burst_gap_s=0.05, seed=0,
                                   smoke=True)
    audit = trobust.run_chaos(server, trace, faults=plan)
    assert audit["ok"], audit
    assert audit["answered"] == audit["submitted"] == 48
    assert not audit["unanswered"] and not audit["duplicates"]
    assert audit["exact"] > 0 and audit["approx"] > 0 and audit["rejected"] > 0
    assert audit["exact"] + audit["approx"] + audit["rejected"] == 48
    s = audit["summary"]
    flushes = s["deadline_flushes"] + s["size_flushes"]
    assert flushes >= plan.fail_batch_every
    assert s["batches"] == server.batches_run == plan.fail_batch_every - 1
    assert s["failed_batches"] == flushes - (plan.fail_batch_every - 1)
    assert s["approx_answers"] == audit["approx"]
    local = tapi.TriangleEngine(device=CPU)
    malformed = {i for i in range(48) if i % 7 == 6}
    for r in server.results:
        e, n = plan.mutate(r.request_id, trace[r.request_id].edges,
                           trace[r.request_id].n_nodes)
        if r.request_id in malformed:
            assert isinstance(r, tserve.RejectedRequest)
            assert r.reason == "malformed"
        elif r.route == "batched":
            assert r.triangles == local.count((e, n)).triangles
            assert not r.overflow
        else:
            _approx_equals_reference(r, e, n, 4096)
    assert audit["rejected"] == len(malformed)


def test_main_runs_the_chaos_smoke_on_the_cpu(capsys):
    audit = trobust.main(["--smoke", "--device", "cpu", "--requests", "24"])
    assert audit["ok"] and audit["submitted"] == 24
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("chaos,") and line.endswith("|ok=True")


def test_chaos_replay_with_interleaved_mutations():
    """``tests/test_stream.py``'s interleaved replay on the port: a live
    stream session mutates between pump ticks of a chaos replay; every
    id is answered once, and the session stays equal to a fresh count
    of its edges (total and per-vertex credit)."""
    eng = tapi.TriangleEngine(tapi.TCOptions(per_vertex=True), device=CPU)
    srv = eng.serve(batch_size=4)
    edges, n = GRAPHS["geometric"]
    sess = srv.stream_session("live", (edges, n))
    rng = np.random.default_rng(2)
    real_pump, ticks = srv.pump, {"n": 0}

    def random_stream(n_ins, n_del):
        """Inserts of absent pairs and deletes of present edges."""
        present = sess.state.edges()
        take = rng.choice(present.shape[0], n_del, replace=False)
        updates = [(-1, int(u), int(v)) for u, v in present[take]]
        while n_ins:
            u, v = (int(x) for x in rng.integers(n, size=2))
            if u != v and not sess.state.has_edges([(u, v)])[0]:
                updates.append((+1, u, v))
                n_ins -= 1
        return updates

    def chaotic_pump():
        ticks["n"] += 1
        if ticks["n"] % 3 == 0:  # mutate mid-replay, between arrivals
            srv.mutate("live", random_stream(2, 1))
        real_pump()

    srv.pump = chaotic_pump
    names = ("karate", "complete9", "dolphins_like", "ring_of_cliques",
             "er200")
    trace = [trobust.TimedRequest(0.05 * i, *GRAPHS[k])
             for i, k in enumerate(names)]
    audit = trobust.run_chaos(srv, trace)
    srv.pump = real_pump
    assert audit["ok"] and audit["exact"] == len(trace), audit
    assert srv.stream_mutations > 0  # the interleaving really happened
    by_id = {r.request_id: r.triangles for r in srv.results}
    assert [by_id[i] for i in range(len(names))] == [
        eng.count(GRAPHS[k]).triangles for k in names]
    fresh = eng.count((sess.state.edges(), n))
    rep = srv.stream_count("live")
    assert rep.triangles == fresh.triangles
    np.testing.assert_array_equal(rep.per_vertex, fresh.per_vertex)
