"""The readers of the program's own trace of an answer (``StageClock``'s
``report`` and ``plan.host`` spans and its host-wait, read-back and
launch counters), and their entries in ``BENCHMARK.json``."""
import _setup  # noqa: F401
import json

import pytest
import torch

from portbench.graphs import load_module

BENCH = json.loads((_setup.ROOT / "BENCHMARK.json").read_text())

#: the metrics that read the program's own trace of an answer:
#: (source, layer), in the order they were appended
PROGRAM_TRACE = {
    "report_s": ("program_span", "facade"),
    "plan_host_s": ("program_span", "plan"),
    "host_syncs": ("program_counter", "host-card boundary"),
    "readback_mb": ("program_counter", "host-card boundary"),
    "probe_launches": ("program_counter", "probe"),
}


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


def test_readers_on_a_recorded_clock(recorded):
    out = outcome(stages=[dict(c.seconds) for c in recorded],
                  counts=[dict(c.counts) for c in recorded])

    def mean(d, key):
        return sum(getattr(c, d)[key] for c in recorded) / 2

    assert read("report_s", out) == pytest.approx(mean("seconds", "report"))
    assert read("plan_host_s", out) == pytest.approx(
        mean("seconds", "plan.host"))
    assert read("host_syncs", out) == mean("counts", "host_syncs")
    assert read("readback_mb", out) == pytest.approx(
        mean("counts", "readback_bytes") / 1e6)
    assert read("probe_launches", out) == 0      # the CPU's plain probe


def test_readers_on_synthetic_outcomes():
    out = outcome(
        stages=[{"plan": 1.0, "plan.host": 0.6, "report": 0.02},
                {"plan": 1.2, "plan.host": 0.8, "report": 0.04}],
        counts=[{"host_syncs": 23, "readback_bytes": 1_500_000_000,
                 "probe_launches": 1},
                {"host_syncs": 25, "readback_bytes": 1_400_000_000,
                 "probe_launches": 3}])
    assert read("report_s", out) == pytest.approx(0.03)
    assert read("plan_host_s", out) == pytest.approx(0.7)
    assert read("host_syncs", out) == 24
    assert read("readback_mb", out) == 1450.0
    assert read("probe_launches", out) == 2


@pytest.mark.parametrize("name", list(PROGRAM_TRACE))
def test_readers_read_nothing_from_an_older_program(name):
    """A program whose clock keeps none of them (as before ``report``,
    ``plan.host`` and the counters), or an untraced run: nothing, and no
    error."""
    older = outcome(stages=[{"csr": 0.1, "plan": 1.0, "probe": 0.2}],
                    counts=[{"bfs_sweeps": 7}])
    assert read(name, older) is None
    assert read(name, outcome()) is None


def test_entries_are_appended_for_every_cell():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    for name, (source, layer) in PROGRAM_TRACE.items():
        m = per[name]
        assert (m["source"], m["layer"], m["moves"]) == (source, layer,
                                                         "count_s")
        assert "workloads" not in m
    assert [m["name"] for m in BENCH["per_layer"]][-5:] == list(
        PROGRAM_TRACE)
