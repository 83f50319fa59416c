"""``StageClock`` on the local route, on the CPU: the stages tile the
facade's ``count`` span with ``report`` last, the plan's host pass nests
in ``plan``, and the counters of host waits and read-back bytes
(``core/hostio.py``) count what the card would wait for and read back;
with no clock the audit's census of the local route is what it was."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import hostsync
from repro_torch.analysis.routes import enumerate_route_specs
from repro_torch.api import TCOptions, TriangleEngine
from repro_torch.core.hostio import HOST_IO
from repro_torch.core.sequential import StageClock
from repro_torch.graph import generators as gen

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]

#: host waits of a local count besides one a BFS sweep: the graph build's
#: copy in, self-loop mask, ``unique``, ``bincount`` and scalar write of
#: the last offset (5); the BFS's scalar write of the root (1); the
#: plan's ``n_h`` and the two halves of its degree profile (3); the
#: report's six scalars and its levels (7)
LOCAL_COUNT_WAITS = 16

#: bytes of the report's six scalars: triangles, c1, c2, n_h (int32), k
#: (float32) and the overflow flag (bool)
REPORT_SCALAR_BYTES = 5 * 4 + 1

#: (graph, its BFS sweeps from vertex 0)
GRAPHS = {
    "star": (gen.star(10), 2),
    "karate": (gen.karate(), 4),
    "rmat10": (gen.rmat(10, 16, seed=0), 5),
    "path": (gen.path(12), 12),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clocked(graph, per_vertex=False):
    clock = StageClock(CPU)
    rep = TriangleEngine(device=CPU).count(
        graph, options=TCOptions(per_vertex=per_vertex), clock=clock)
    return rep, clock


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
def test_local_stages_tile_the_facade_span_with_report_last(per_vertex):
    _, clock = _clocked(GRAPHS["rmat10"][0], per_vertex)
    (facade,) = [m for m in clock.timeline if m[0] == "count"]
    stages = [m for m in clock.timeline if "." not in m[0]
              and m[0] != "count"]
    names = [m[0] for m in stages]
    assert names[:4] == ["csr", "bfs", "compact", "plan"]
    assert names[-1] == "report" and names.count("report") == 1
    assert set(names[4:-1]) == ({"probe", "hit_list", "credit"}
                                if per_vertex else {"probe"})
    assert facade[1] <= stages[0][1] and stages[-1][2] <= facade[2]
    for (_, _, end), (_, begin, _) in zip(stages, stages[1:]):
        assert begin == end       # each lap begins where the last ended
    assert set(clock.seconds) == set(names) | {"plan.host"}


def test_plan_host_lies_inside_plan():
    _, clock = _clocked(GRAPHS["karate"][0])
    (host,) = [m for m in clock.timeline if m[0] == "plan.host"]
    (plan,) = [m for m in clock.timeline if m[0] == "plan"]
    assert plan[1] <= host[1] <= host[2] <= plan[2]
    assert 0.0 < clock.seconds["plan.host"] <= clock.seconds["plan"]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_host_syncs_less_sweeps_is_a_constant(name):
    graph, sweeps = GRAPHS[name]
    before = HOST_IO["syncs"]
    _, clock = _clocked(graph)
    assert clock.counts["bfs_sweeps"] == sweeps
    assert clock.counts["host_syncs"] - sweeps == LOCAL_COUNT_WAITS
    # every wait of the answer lies in some stage
    assert HOST_IO["syncs"] - before == clock.counts["host_syncs"]
    assert clock.counts["host_syncs.bfs"] == sweeps + 1
    assert clock.counts["host_syncs.report"] == 7
    assert clock.counts["probe_launches"] == 0    # the CPU's plain probe


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
def test_readback_bytes_are_the_tensors_read_back(per_vertex):
    graph, sweeps = GRAPHS["rmat10"]
    rep, clock = _clocked(graph, per_vertex)
    n, n_h = rep.levels.shape[0], rep.num_horizontal
    c = clock.counts
    assert c["readback_bytes.csr"] == 0
    assert c["readback_bytes.bfs"] == sweeps          # a bool a sweep
    assert c["readback_bytes.plan"] == 4 + 2 * 4 * n_h
    report = REPORT_SCALAR_BYTES + 4 * n + (2 * 4 * n if per_vertex else 0)
    assert c["readback_bytes.report"] == report
    probe = 0
    if per_vertex:
        # one int64 cell count a bucket slice of K2's chunking
        plan = TriangleEngine(device=CPU).count_raw(
            graph, options=TCOptions(per_vertex=True)).plan
        probe = 8 * sum(1 for b in plan.buckets if b.rows)
    assert c["readback_bytes.probe"] == probe
    assert c["readback_bytes"] == (sweeps + 4 + 8 * n_h + report + probe)


def test_counters_count_the_same_without_a_clock():
    graph, _ = GRAPHS["karate"]
    eng = TriangleEngine(device=CPU)
    before = dict(HOST_IO)
    eng.count(graph)
    unclocked = {k: HOST_IO[k] - before[k] for k in HOST_IO}
    _, clock = _clocked(graph)
    assert unclocked == {"syncs": clock.counts["host_syncs"],
                         "d2h_bytes": clock.counts["readback_bytes"]}


@pytest.mark.parametrize("route", ["local/torch", "local/torch/pv"])
def test_no_clock_leaves_the_census_unchanged(route):
    (spec,) = [s for s in enumerate_route_specs() if s.name == route]
    record, sweeps = hostsync.record_route(spec, CPU)
    got = {f.site for f in hostsync.census_findings(route, record, sweeps)}
    base = json.loads(
        (ROOT / "results" / "AUDIT_torch_baseline.json").read_text())
    want = {f["site"] for f in base["findings"]
            if f["site"].startswith(f"census:{route}:")}
    assert got == want and want
