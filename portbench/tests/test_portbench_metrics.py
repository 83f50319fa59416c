"""Each metric reader, on a recorded ``StageClock`` and on a profiler
stub, and the trace arithmetic behind them."""
import _setup  # noqa: F401
import json

import pytest
import torch

from portbench import devtrace, harness
from portbench.graphs import load_module

S = 1_000_000_000   # ns a second


def read(name, outcome):
    return load_module("metrics", name).read(outcome)


def outcome(**kw):
    base = {"attempted": 0, "failed": 0, "error": None, "answers": 0,
            "window_s": 0.0, "setup_s": 0.0, "peak_bytes": 0, "stages": [],
            "counts": [], "trace": None, "work": [], "checks": {}}
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def recorded():
    """Two answers' ``StageClock``s of the port's CPU count at karate,
    one with the per-vertex stages."""
    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.sequential import StageClock
    from repro_torch.graph import generators as gen

    eng = TriangleEngine(device="cpu")
    clocks = []
    for pv in (False, True):
        c = StageClock(torch.device("cpu"))
        eng.count(gen.karate(), route="local",
                  options=TCOptions(per_vertex=pv), clock=c)
        clocks.append(c)
    return clocks


def test_stage_readers_on_a_recorded_clock(recorded):
    out = outcome(stages=[dict(c.seconds) for c in recorded],
                  counts=[dict(c.counts) for c in recorded])
    for st in ("csr", "bfs", "compact", "plan", "probe"):
        want = sum(c.seconds[st] for c in recorded) / 2
        assert read(f"{st}_s", out) == pytest.approx(want)
    pv = recorded[1].seconds
    assert read("credit_s", out) == pytest.approx(pv["hit_list"]
                                                 + pv["credit"])
    assert read("bfs_sweeps", out) == 4          # karate from vertex 0
    assert "credit" not in recorded[0].seconds


def test_stage_readers_read_nothing_untraced():
    out = outcome()
    for name in ("csr_s", "bfs_s", "compact_s", "plan_s", "probe_s",
                 "credit_s", "bfs_sweeps", "probe_roofline_pct",
                 "device_idle_pct"):
        assert read(name, out) is None


def test_end_to_end_readers():
    out = outcome(answers=4, window_s=10.0, setup_s=12.5,
                  peak_bytes=2_463_906_304)
    assert read("count_s", out) == 2.5
    assert read("setup_s", out) == 12.5
    assert read("peak_mem_gb", out) == 2.463906304
    assert read("count_s", outcome()) is None
    assert read("peak_mem_gb", outcome()) is None


def stub_trace():
    """Two answers' stage spans and device records on a 10 s stretch:
    probe kernels of 0.2 s and 0.1 s, BFS kernels overlapping each
    other, a kernel between answers."""
    spans = [("csr", 0, 1 * S), ("bfs", 1 * S, 3 * S),
             ("probe", 3 * S, 4 * S),
             ("csr", 5 * S, 6 * S), ("probe", 6 * S, 8 * S)]
    events = [("copy", 0, S // 2),
              ("scan", 1 * S, 2 * S), ("scan", 3 * S // 2, 5 * S // 2),
              ("k1", 3 * S, 3 * S + S // 5),
              ("gap_fill", 9 * S // 2, 9 * S // 2 + S // 10),
              ("k1", 7 * S, 7 * S + S // 10)]
    return {"events": events, "spans": spans, "t0": 0, "t1": 10 * S}


def test_device_readers_on_a_profiler_stub():
    tr = stub_trace()
    # busy: 0.5 + 1.5 (overlap merged) + 0.2 + 0.1 + 0.1 = 2.4 s of 10
    assert devtrace.busy_ns(tr["events"], 0, 10 * S) == 2.4 * S
    out = outcome(trace=tr, work=[{"least_s": 0.003}, {"least_s": 0.0015}])
    assert read("device_idle_pct", out) == pytest.approx(76.0)
    # probe device time 0.2 + 0.1 s; least time 4.5 ms
    assert read("probe_roofline_pct", out) == pytest.approx(1.5)
    assert read("probe_roofline_pct", outcome(trace=tr)) is None


def test_breakdown_names_ops_and_gaps_by_stage():
    tr = stub_trace()
    top = devtrace.top_ops(tr["events"])
    assert top[0] == ["scan", 2.0] and top[1] == ["copy", 0.5]
    assert top[2][0] == "k1" and top[2][1] == pytest.approx(0.3)
    gaps = devtrace.idle_gaps(tr["events"], tr["spans"], 0, 10 * S)
    assert gaps[0] == ["harness", 2.9]            # 7.1 s .. 10 s
    assert gaps[1][0] == "csr" and gaps[1][1] == pytest.approx(2.4)
    assert gaps[2][0] == "probe" and gaps[2][1] == pytest.approx(1.3)
    assert len(gaps) <= 10 and all(a[1] >= b[1] for a, b in
                                   zip(gaps, gaps[1:]))


def test_every_metric_has_a_reader():
    bench = json.loads((_setup.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load_module("metrics", m["name"]).read)


def test_result_line_keeps_checks_last_and_only_the_cells_metrics():
    bench = json.loads((_setup.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(name="rmat22-count", config={}, traffic={}, seed=1,
                        seconds=1, trace=True, device=None, t_process=0.0)
    out = outcome(answers=2, attempted=2, window_s=1.0,
                  stages=[{"probe": 0.5, "hit_list": 0.1}],
                  checks={"count_mismatches": (0, 0)})
    line = harness.result_line(bench, cell, out, {"platform": "gpu"})
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert "credit_s" not in line["metrics"]      # not this cell's metric
    assert line["metrics"]["probe_s"] == {"value": 0.5, "unit": "s"}
