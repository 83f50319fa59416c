"""``correct`` against faults: the rest of a run, driven on the CPU at a
small size past the harness's look for a card, with the timed path
broken underneath.  The sound program comes out correct; the control
(the program's own lossy clamp) and each fault that a cell can have come
out not correct."""
import _setup  # noqa: F401
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.graphs import load_module

CFG = {"name": "rmat8", "generator": "rmat", "scale": 8, "edge_factor": 16,
       "a": 0.57, "b": 0.19, "c": 0.19, "d": 0.05, "pool_seeds": [1, 2],
       "control": {"options": {"d_max": 4}}}


def traffic(per_vertex):
    return {"driver": "closed_loop", "options": {"per_vertex": per_vertex}}


def run(per_vertex=False, override=None, trace=False):
    cell = harness.Cell(name="t", config=CFG, traffic=traffic(per_vertex),
                        seed=2**31 + 5, seconds=0.3, trace=trace,
                        device=torch.device("cpu"),
                        t_process=time.perf_counter(),
                        options_override=override)
    return load_module("drivers", "closed_loop").run(cell)


@pytest.fixture
def engine(monkeypatch):
    """Patch ``TriangleEngine.count`` with ``wrap(real, self, graph,
    **kw)``."""
    from repro_torch.api import TriangleEngine

    real = TriangleEngine.count

    def patch(wrap):
        monkeypatch.setattr(
            TriangleEngine, "count",
            lambda self, g, **kw: wrap(real, self, g, **kw))
    return patch


@pytest.mark.parametrize("per_vertex", [False, True])
def test_sound_program_is_correct(per_vertex):
    out = run(per_vertex)
    assert harness.judge(out) and out["answers"] >= 2
    assert {v for v, _ in out["checks"].values()} == {0}
    assert ("vertex_mismatches" in out["checks"]) == per_vertex


@pytest.mark.parametrize("per_vertex", [False, True])
def test_control_is_not_correct(per_vertex):
    out = run(per_vertex, override=CFG["control"]["options"])
    assert not harness.judge(out)
    assert out["checks"]["count_mismatches"][0] == out["answers"]


@pytest.mark.parametrize("per_vertex", [False, True])
def test_state_returned_unchanged(engine, per_vertex):
    """Every request answered with the first answer the engine gave."""
    first = {}

    def stale(real, self, g, **kw):
        if "rep" not in first:
            first["rep"] = real(self, g, **kw)
        return first["rep"]

    engine(stale)
    assert not harness.judge(run(per_vertex))


@pytest.mark.parametrize("per_vertex", [False, True])
def test_half_the_input_left_out(engine, per_vertex):
    def half(real, self, g, **kw):
        edges, n = g
        return real(self, (edges[: len(edges) // 2], n), **kw)

    engine(half)
    assert not harness.judge(run(per_vertex))


def test_answer_altered_where_it_is_produced(engine):
    def plus_one(real, self, g, **kw):
        rep = real(self, g, **kw)
        return dataclasses.replace(rep, triangles=rep.triangles + 1)

    engine(plus_one)
    out = run()
    assert not harness.judge(out)
    assert out["checks"]["count_mismatches"][0] == out["answers"]


def test_one_vertex_altered_where_it_is_produced(engine):
    def shift(real, self, g, **kw):
        rep = real(self, g, **kw)
        pv = rep.per_vertex.copy()
        pv[0] += 1
        pv[1] -= 1            # the sum, and so the count, unchanged
        return dataclasses.replace(rep, per_vertex=pv)

    engine(shift)
    out = run(per_vertex=True)
    assert out["checks"]["count_mismatches"][0] == 0
    assert out["checks"]["vertex_mismatches"][0] == 2 * out["answers"]
    assert not harness.judge(out)


def test_an_answer_that_never_comes(engine):
    def boom(real, self, g, **kw):
        raise RuntimeError("lost")

    calls = {"n": 0}

    def second_fails(real, self, g, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            return boom(real, self, g, **kw)
        return real(self, g, **kw)

    engine(second_fails)
    out = run()
    assert out["failed"] == 1 and out["answers"] == 0
    assert not harness.judge(out)


def test_traced_run_on_the_cpu_reads_stages_and_no_device():
    out = run(per_vertex=True, trace=True)
    assert harness.judge(out)
    assert out["trace"] is None and out["stages"]
    assert all("credit" in s and "bfs" in s for s in out["stages"])


def test_run_exits_nonzero_and_silent_without_a_card(tmp_path):
    # the whole command, and the same from a directory that holds only
    # BENCHMARK.json and the benchmark's folder (no program beside it)
    import shutil

    shutil.copy(_setup.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_setup.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (_setup.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "rmat22-count", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""


def test_pool_answers_differ_between_requests():
    from portbench import graphs

    pool, warm = graphs.make_pool(CFG, 9, torch.device("cpu"))
    assert not np.array_equal(pool[0][0], pool[1][0])
    # the warm-up asks none of the window's graphs
    assert not any(np.array_equal(warm[0], e) for e, _ in pool)
    json.dumps(CFG)   # a configuration is plain data
