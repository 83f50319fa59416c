"""A closed loop with one answer in flight, over a pool of graphs.

Set-up makes the pool and the warm-up graph (``graphs.make_pool``),
builds one ``TriangleEngine``, and answers one warm-up request on the
warm-up graph, which loads the kernels from ``build/`` (building them on
a checkout's first run).  The window then hands the pool's graphs to
``TriangleEngine.count`` on the local route in turn, as host edge lists,
from the first request after the warm-up until the answer in flight at
``seconds`` completes.

With ``trace`` every answer of the window carries a ``StageClock`` that
also keeps each stage's span on the profiler's clock, and the first
answers, until ``TRACE_MIN_S`` of the window has passed, run under the
device profiler.  Stage means are taken over the answers the profiler
did not slow, where there are any.

Once the window has closed and the engine is freed, the plain reference
(``reference.py``) counts each graph of the pool again from its edge
list, and every answer is compared with it: the triangle count, and with
``per_vertex`` every vertex's count, exactly.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback

import torch

from portbench import devtrace, graphs, reference, work

#: the exact comparison: how many answers (or vertices) may differ from
#: the reference
LIMITS = {"count_mismatches": 0, "vertex_mismatches": 0}

#: the route every request takes: one graph, one card
ROUTE = "local"

#: seconds of the traced run's window, from its start, under the profiler
TRACE_MIN_S = 1.0


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _span_clock(StageClock):
    class SpanClock(StageClock):
        """The program's ``StageClock`` that also keeps ``(stage,
        begin_ns, end_ns)`` spans on ``time.time_ns()``'s clock, each
        taken after the stage's closing synchronize."""

        def __init__(self, device):
            super().__init__(device)
            self.spans: list = []
            self._b = time.time_ns()

        def start(self) -> None:
            super().start()
            self._b = time.time_ns()

        def lap(self, stage: str) -> None:
            super().lap(stage)
            now = time.time_ns()
            self.spans.append((stage, self._b, now))
            self._b = now

    return SpanClock


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell) -> dict:
    """Run ``cell`` (``harness.Cell``) and return its outcome (the keys
    the metric readers read; ``harness.py``)."""
    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.sequential import StageClock

    dev = cell.device
    traffic = cell.traffic
    t = time.perf_counter()
    pool, warm = graphs.make_pool(cell.config, cell.seed, dev)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"pool of {len(pool)} graphs, {[len(e) for e, _ in pool]} edge "
        f"rows, made in {time.perf_counter() - t:.3f} s")
    opts = dict(traffic.get("options", {}))
    opts.update(cell.options_override or {})
    options = TCOptions(**opts)
    per_vertex = bool(options.per_vertex)
    eng = TriangleEngine(device=dev)

    def ask(graph, clock=None):
        return eng.count(graph, route=ROUTE, options=options, clock=clock)

    t = time.perf_counter()
    ask(warm)
    del warm
    _sync(dev)
    log(f"warm-up answer {time.perf_counter() - t:.3f} s")
    profiler = None
    if cell.trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CUDA])
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)   # the profiler's own start-up
            _sync(dev)
    SpanClock = _span_clock(StageClock)
    setup_s = time.perf_counter() - cell.t_process

    answers: list = []        # (slot, triangles, per_vertex, n_h, sweeps)
    records: list = []        # (profiled, clock)
    failed, error = 0, None
    trace_t0 = trace_t1 = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if profiler is not None:
        profiler.start()
        trace_t0 = time.time_ns()
    i = 0
    took: list = []           # each answer's seconds, for the log
    while True:
        clock = SpanClock(dev) if cell.trace else None
        t_ask = time.perf_counter()
        profiled = trace_t0 is not None and trace_t1 is None
        try:
            rep = ask(pool[i % len(pool)], clock)
        except Exception as err:  # an answer that never comes
            failed += 1
            error = f"{type(err).__name__}: {err}"
            log(f"request {i} failed:\n{traceback.format_exc()}")
            break
        took.append(time.perf_counter() - t_ask)
        answers.append((i % len(pool), rep.triangles, rep.per_vertex,
                        rep.num_horizontal,
                        clock.counts.get("bfs_sweeps") if clock else None))
        if clock is not None:
            records.append((profiled, clock))
        i += 1
        if profiled and time.time_ns() - trace_t0 >= TRACE_MIN_S * 1e9:
            trace_t1 = time.time_ns()
            profiler.stop()
        if time.perf_counter() - t0 >= cell.seconds:
            break
    t1 = time.perf_counter()
    if profiler is not None and trace_t1 is None:
        trace_t1 = time.time_ns()
        profiler.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"{len(answers)} answers in {t1 - t0:.4f} s; each "
        f"{[round(x, 4) for x in took]}")
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    want: dict = {}
    for slot in sorted({a[0] for a in answers}):
        edges, n = pool[slot]
        tri, pv = reference.triangles(edges, n, device=dev,
                                      per_vertex=per_vertex)
        want[slot] = (tri, pv.cpu().numpy() if pv is not None else None)
    count_bad = vertex_bad = 0
    for slot, tri, pv, _, _ in answers:
        count_bad += int(tri != want[slot][0])
        if per_vertex:
            ref_pv = want[slot][1]
            if pv is None or pv.shape != ref_pv.shape:
                vertex_bad += ref_pv.shape[0]
            else:
                vertex_bad += int((pv != ref_pv).sum())
    log(f"reference over {len(want)} graphs {time.perf_counter() - t:.3f} s"
        f"; triangles {[want[s][0] for s in sorted(want)]}")
    wrong = sorted({(slot, int(tri)) for slot, tri, _, _, _ in answers
                    if tri != want[slot][0]})
    if wrong:
        log("answers unlike the reference (graph, program, reference): "
            f"{[(s, tri, want[s][0]) for s, tri in wrong[:8]]}")
    checks = {"count_mismatches": count_bad}
    if per_vertex:
        checks["vertex_mismatches"] = vertex_bad

    stage_src = [c for p, c in records if not p] or [c for _, c in records]
    outcome = {
        "attempted": len(answers) + failed,
        "failed": failed,
        "error": error,
        "answers": len(answers),
        "window_s": t1 - t0,
        "setup_s": setup_s,
        "peak_bytes": int(peak),
        "stages": [dict(c.seconds) for c in stage_src],
        "counts": [dict(c.counts) for c in stage_src],
        "trace": None,
        "work": [],
        "checks": {k: (v, LIMITS[k]) for k, v in checks.items()},
    }
    if profiler is not None:
        outcome["trace"], outcome["work"] = _trace_outcome(
            profiler, records, answers, pool, trace_t0, trace_t1, dev)
    return outcome


def _trace_outcome(profiler, records, answers, pool, t0, t1, dev):
    """The profiled stretch's device records and stage spans, and the
    intersection work of each profiled answer's graph, from the
    reference's BFS levels."""
    events = devtrace.device_events(profiler)
    spans = [s for p, c in records if p for s in c.spans]
    work_rows = []
    for (slot, _, _, n_h, sweeps), (p, _) in zip(answers, records):
        if not p:
            continue
        edges, n = pool[slot]
        lo, hi = reference.simple_graph(edges, n, dev)
        level, ref_sweeps = reference.bfs_levels(lo, hi, n)
        w = work.intersection_work(lo, hi, n, level)
        least, bound_by = work.least_seconds(w)
        work_rows.append(dict(w, least_s=least, bound_by=bound_by))
        log(f"work of graph {slot}: {w}, least {least:.6e} s by {bound_by}"
            f"; horizontal {w['horizontal']} (program {n_h}), sweeps "
            f"{ref_sweeps} (program {sweeps})")
        del lo, hi, level
    inside = sum(1 for _, s, _ in events
                 if devtrace.stage_at(spans, s, "") != "")
    log(f"profiled {t1 - t0} ns: {len(events)} device records, {inside} "
        f"inside a stage span, {len(spans)} spans")
    return {"events": events, "spans": spans, "t0": t0, "t1": t1}, work_rows
