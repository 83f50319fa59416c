#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the exact local count (Algorithm
1), triangle finding and per-vertex credit end to end on one NVIDIA
H100, through the hand-written Hopper kernels K1 and K2.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero; nothing is caught and skipped):

  1. setup   — versions, toolchain, the card's name and power limit, and
               the build of every CUDA source with nvcc (timed);
  2. kernel  — K1 and K2 against their plain PyTorch versions on the same
               CUDA tensors: every row of every bucket of RMAT scale 16,
               and a seeded sample of 4,096 rows from each bucket at full
               size;
  3. small   — ``TriangleEngine(device="cuda").count`` on karate and RMAT
               scales 10, 12 and 16, each count asserted; the per-vertex
               credit and the found list at scale 12 against the port's
               CPU path;
  4. full    — RMAT scale 20 (Graph500, edge factor 16, seed 0), the
               largest scale at which the int32 c1/c2 contract holds.
               Three main paths, each a warm-up run with the launch
               counters set to 0 just before and read just after, then
               timed runs (per-stage seconds, peak device memory):
               the count (K1), the per-vertex count (K2; credit summing
               to 3T), and ``find`` with a buffer of every triangle (K2;
               unique, closed triangles whose corners are the per-vertex
               credit); one profiled run of each for the device's busy
               share.  Per
               bucket: each kernel's milliseconds from CUDA events at the
               main path's launch shapes (K1 one launch per bucket, K2
               one per chunk of the cell budget) beside its bound, and
               the plain version on the same rows, timed and compared.
  5. summary — one JSON line per kernel, the card's name and power
               limit, and the final ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package.  Without a usable card,
or without the repository around it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM at the 700 W limit: HBM rate from NVIDIA's data sheet; int32
#: rate from the H100 architecture white paper, 64 INT32 lanes per SM x
#: 132 SMs x the 1.98 GHz boost clock (the data sheet gives none)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

#: expected (triangles, horizontal queries) of rmat(s, 16, seed=0):
#: scales 10 and 12 as the JAX package records them
#: (results/BENCH_tc.json), 16 and 20 from an independent scipy count
#: (ROADMAP Queue 3)
EXPECTED = {
    10: (75682, 8139),
    12: (483937, 26048),
    16: (15673932, 528985),
    20: (424277826, 8074612),
}

SAMPLE_ROWS = 4096


def log(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def sh(*cmd: str) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs after
    one warm-up, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bucket_bound(flat, levels, ops, d_cand: int, d_targ: int):
    """K1's least time on the card for one bucket's call, from this
    run's operands: ``(bound_ms, bound_by, bytes, ops, row_bytes_ms)``.

    ``bound_ms`` is the larger of (a) the bytes of the call with each
    input read once and each output written once — the flat adjacency,
    the level array, five int32 operands and two int32 outputs per row —
    over HBM's 3.35 TB/s, and (b) its integer operations over the card's
    int32 rate: per clamped candidate, a compare and a select for each of
    the ``ceil(log2(l_l + 1))`` binary-search steps, and one equality
    compare at the end.
    ``row_bytes_ms`` is the per-row gathered volume, each row's clamped
    candidates, their levels and its clamped target list, (2 l_s + l_l)
    int32, plus 8 B out per row, over the same 3.35 TB/s: the bytes a
    kernel that shares nothing between rows moves."""
    s_s, l_s, s_l, l_l, lev_u = ops
    ls = l_s.clamp(max=d_cand).to(torch.int64)
    ll = l_l.clamp(max=d_targ).to(torch.int64)
    q = s_s.shape[0]
    once = (flat.numel() + levels.numel()) * 4 + q * 7 * 4
    rows = int(((2 * ls + ll) * 4).sum().item()) + q * 8
    steps = torch.ceil(torch.log2(ll.to(torch.float64) + 1))
    nops = int((ls.to(torch.float64) * (2 * steps + 1)).sum().item())
    t_bytes = once / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    row_ms = rows / HBM_BYTES_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", once, nops, row_ms
    return t_ops, "operations", once, nops, row_ms


def hits_bound(flat, ops, d_cand: int, d_targ: int):
    """K2's least time on the card for one bucket's call, from this run's
    operands: ``(bound_ms, bound_by, bytes, ops, row_bytes_ms, cells)``.

    Bytes: the flat adjacency, four int32 operands (s_s, l_s, s_l, l_l)
    and the int64 offset in per row, and one byte out per clamped
    candidate, over 3.35 TB/s.
    Operations: as K1's (:func:`bucket_bound`), a compare and a select
    per binary-search step and one final compare, per clamped candidate,
    over the int32 rate.  ``row_bytes_ms`` is the per-row gathered
    volume, each row's clamped candidates and clamped target list,
    (l_s + l_l) int32, plus its operands, offset and output bytes."""
    s_s, l_s, s_l, l_l = ops[:4]
    ls = l_s.clamp(max=d_cand).to(torch.int64)
    ll = l_l.clamp(max=d_targ).to(torch.int64)
    q = s_s.shape[0]
    cells = int(ls.sum().item())
    once = flat.numel() * 4 + q * 4 * 4 + (q + 1) * 8 + cells
    rows = int(((ls + ll) * 4).sum().item()) + q * (4 * 4 + 8) + cells
    steps = torch.ceil(torch.log2(ll.to(torch.float64) + 1))
    nops = int((ls.to(torch.float64) * (2 * steps + 1)).sum().item())
    t_bytes = once / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    row_ms = rows / HBM_BYTES_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, once, nops, row_ms, cells


def compare_hits(flat, ops, b, rows=None):
    """``(max |kernel - plain|, hits, kernel_ms, plain_ms)`` of K2's
    ragged mask (offsets and bytes) over ``rows`` (all if None), both
    timed once with CUDA events; these launches are comparisons, not the
    main path."""
    from repro_torch.kernels.intersect.intersect import intersect_hits
    from repro_torch.kernels.intersect.ref import intersect_hits_ref

    ops = ops[:4] if rows is None else tuple(x[rows] for x in ops[:4])
    kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    ko, kh = intersect_hits(flat, *ops, **kw)
    ev[1].record()
    ev[2].record()
    ro, rh = intersect_hits_ref(flat, *ops, **kw)
    ev[3].record()
    torch.cuda.synchronize()
    err = 0
    if not torch.equal(ko, ro):
        err = max(err, int((ko - ro).abs().max().item()))
    if kh.shape != rh.shape:
        err = max(err, 1)
    elif kh.numel():
        err = max(err, int((kh.to(torch.int8) - rh.to(torch.int8))
                           .abs().max().item()))
    return (err, int(kh.sum().item()), ev[0].elapsed_time(ev[1]),
            ev[2].elapsed_time(ev[3]))


def check_found(tri, g, n: int):
    """Every row of ``tri`` a triangle of ``g``, each once: rows sorted,
    packed into int64 keys ``a<<40 | b<<20 | c`` (vertex ids < 2**20) and
    checked unique; each of the three edges looked up among the CSR's
    sorted ``src * n + dst`` keys.  Returns ``(unique, closed)``."""
    t = torch.sort(tri, dim=1).values
    col = [t[:, i].to(torch.int64) for i in range(3)]
    keys = torch.sort((col[0] << 40) | (col[1] << 20) | col[2]).values
    unique = bool((keys[1:] != keys[:-1]).all().item())
    del keys
    slots = g.src.to(torch.int64) * n + g.dst
    closed = True
    for a, b in ((0, 1), (0, 2), (1, 2)):
        k = col[a] * n + col[b]
        i = torch.searchsorted(slots, k).clamp_(max=slots.numel() - 1)
        closed &= bool((slots[i] == k).all().item())
    return unique, closed


def device_busy(run):
    """One ``run()`` under ``torch.profiler``: ``(busy_ms, wall_s,
    top)``, the summed durations of every CUDA kernel, copy and fill (one
    stream, so they do not overlap), the profiled wall time, and the five
    largest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return (sum(per.values()) / 1e3, wall,
            [(name[:60], us / 1e3) for name, us in top])


def bucket_operands(g, levels, plan):
    """``[(bucket, ops)]``: K1's operands of every bucket the main path
    probes, rebuilt from the count's own levels and plan."""
    from repro_torch.core import intersect as tint
    from repro_torch.core.edges import horizontal_queries

    qu, qw, *_ = horizontal_queries(g, levels, order="desc")
    adj = tint.CsrAdjacency.from_graph(g)
    out = []
    for b, base, qu_b, qw_b, bounds in tint.bucket_slices(adj, qu, qw, plan):
        out.append((b, tint.probe_operands(adj, qu_b, qw_b, bounds, base,
                                           b.count, levels)))
    return adj.flat, out


def compare(flat, levels, ops, b, rows=None):
    """``(max |kernel - plain|, c1, c2, plain_ms)`` over the per-row
    c1/c2 of ``rows`` (all if None), the plain version timed with CUDA
    events; the kernel's launches here are comparisons, not the main
    path."""
    from repro_torch.kernels.intersect.intersect import intersect_levels
    from repro_torch.kernels.intersect.ref import intersect_levels_ref

    if rows is not None:
        ops = tuple(x[rows] for x in ops)
    s_s, l_s, s_l, l_l, lev_u = ops
    kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
    k1, k2 = intersect_levels(flat, s_s, l_s, s_l, l_l, levels, lev_u, **kw)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    r1, r2 = intersect_levels_ref(flat, s_s, l_s, s_l, l_l, levels, lev_u,
                                  **kw)
    stop.record()
    torch.cuda.synchronize()
    err = max(int((k1 - r1).abs().max().item()) if len(k1) else 0,
              int((k2 - r2).abs().max().item()) if len(k2) else 0)
    return (err, int(k1.sum().item()), int(k2.sum().item()),
            start.elapsed_time(stop))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20, choices=sorted(EXPECTED),
                    help="RMAT scale of the full-size phase (default 20); "
                         "only scales whose count is known")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed full-size runs of each path after its "
                         "warm-up")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import TCOptions, TriangleEngine
    from repro_torch.core.intersect import cell_chunks
    from repro_torch.core.sequential import StageClock
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import from_edges
    from repro_torch.kernels import build
    from repro_torch.kernels.intersect import intersect as kmod
    from repro_torch.kernels.intersect.ref import intersect_levels_ref

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    launches = kmod.LAUNCHES
    pv_opts = TCOptions(per_vertex=True)

    def reset_launches():
        for k in launches:
            launches[k] = 0

    def main_path(run):
        """``run(clock)`` once with every launch counter set to 0 just
        before and read just after: ``(result, seconds, clock, launches,
        memory)``, ``memory`` the device bytes allocated before the run
        and at its peak."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem = {"allocated_before": torch.cuda.memory_allocated()}
        reset_launches()
        clock = StageClock(dev)
        t0 = time.perf_counter()
        res = run(clock)
        dt = time.perf_counter() - t0
        got = dict(launches)
        mem["max_allocated"] = torch.cuda.max_memory_allocated()
        return res, dt, clock, got, mem

    def timed_runs(tag, run, agrees):
        """``args.runs`` timed runs of ``run(clock)``, each checked by
        ``agrees``; logs and returns the median line."""
        runs = []
        for i in range(args.runs):
            clock = StageClock(dev)
            t0 = time.perf_counter()
            r = run(clock)
            dt = time.perf_counter() - t0
            if not agrees(r):
                raise SystemExit(f"{tag}: timed run {i} disagrees")
            runs.append((dt, clock))
            log("timed_run", path=tag, run=i, seconds=dt,
                stages=clock.seconds, counts=clock.counts)
        med_clock = sorted(runs, key=lambda x: x[0])[len(runs) // 2][1]
        line = dict(path=tag, graph=f"rmat{args.scale}",
                    median_seconds=statistics.median(dt for dt, _ in runs),
                    seconds=[dt for dt, _ in runs],
                    median_run_stages=med_clock.seconds,
                    bfs_sweeps=med_clock.counts.get("bfs_sweeps"))
        log("end_to_end", **line)
        return line

    # ---------------------------------------------------------- 1. setup
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")
    log("setup", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)),
        nvidia_smi=card,
        nvcc=sh(build.nvcc_path(), "--version").splitlines()[-1])
    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.library(name)
    log("build", seconds=time.perf_counter() - t0,
        sources={k: {"nvcc_seconds": s, "ptxas": e.strip().splitlines()}
                 for k, (s, e) in build.BUILD_LOG.items()})
    eng = TriangleEngine(device=dev)
    max_err = 0
    max_err_hits = 0

    # ----------------------------- 2. kernels vs plain, rmat(16) every row
    e16, n16 = gen.rmat(16, 16, seed=0)
    res16 = eng.count_raw((e16, n16))
    flat, buckets = bucket_operands(from_edges(e16, n16, device=dev),
                                    res16.levels, res16.plan)
    before = dict(launches)
    for b, ops in buckets:
        err, s1, s2, _ = compare(flat, res16.levels, ops, b)
        err_h, hits, _, _ = compare_hits(flat, ops, b)
        max_err = max(max_err, err)
        max_err_hits = max(max_err_hits, err_h)
        log("kernel_vs_plain", graph="rmat16", rows=b.rows, d_cand=b.d_cand,
            d_targ=b.d_targ, max_abs_err=err, c1=s1, c2=s2,
            hits_max_abs_err=err_h, hits=hits)
        if hits != s1 + s2:
            raise SystemExit(f"rmat16: K2 found {hits} hits, K1 {s1 + s2}")
    if any(launches[k] <= before[k] for k in launches) or max(
            max_err, max_err_hits):
        raise SystemExit(f"rmat16 kernel check failed: err={max_err}, "
                         f"{max_err_hits}, launches {before} -> {launches}")

    # ----------------------------------------------- 3. small graphs
    small = [("karate", gen.karate(), (45, None))]
    small += [(f"rmat{s}", gen.rmat(s, 16, seed=0), EXPECTED[s])
              for s in (10, 12, 16)]
    for name, (edges, n), (tri, nh) in small:
        reset_launches()
        t0 = time.perf_counter()
        r = eng.count((edges, n))
        dt = time.perf_counter() - t0
        log("small", graph=name, triangles=r.triangles,
            num_horizontal=r.num_horizontal, backend=r.backend,
            launches=dict(launches), seconds=dt)
        if (r.triangles != tri or (nh is not None and r.num_horizontal != nh)
                or r.backend != "cuda" or r.overflow
                or launches["intersect_levels"] == 0
                or launches["intersect_hits"]):
            raise SystemExit(f"{name}: wrong count or path: {r}")
    # the card's per-vertex credit and found list at rmat12 against the
    # port's CPU path, array for array
    e12, n12 = gen.rmat(12, 16, seed=0)
    cpu = TriangleEngine(device="cpu")
    t0 = time.perf_counter()
    pv_gpu = eng.count((e12, n12), options=pv_opts)
    tri_gpu, cnt_gpu = eng.find((e12, n12), max_triangles=EXPECTED[12][0])
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv_cpu = cpu.count((e12, n12), options=pv_opts)
    tri_cpu, cnt_cpu = cpu.find((e12, n12), max_triangles=EXPECTED[12][0])
    cpu_s = time.perf_counter() - t0
    same12 = (np.array_equal(pv_gpu.per_vertex, pv_cpu.per_vertex)
              and np.array_equal(pv_gpu.degrees, pv_cpu.degrees)
              and (pv_gpu.c1, pv_gpu.c2) == (pv_cpu.c1, pv_cpu.c2)
              and int(cnt_gpu) == int(cnt_cpu) == EXPECTED[12][0]
              and torch.equal(tri_gpu.cpu(), tri_cpu))
    log("rmat12_gpu_vs_cpu", per_vertex_sum=int(pv_gpu.per_vertex.sum()),
        triangles=pv_gpu.triangles, found=int(cnt_gpu), equal=same12,
        gpu_seconds=gpu_s, cpu_seconds=cpu_s)
    if not same12:
        raise SystemExit("rmat12: the card's per-vertex credit or found "
                         "list differs from the CPU path")

    # -------------------------------------------------- 4. full size
    scale = args.scale
    t0 = time.perf_counter()
    edges, n = gen.rmat(scale, 16, seed=0)
    log("data", graph=f"rmat{scale}", n_nodes=n, edge_rows=len(edges),
        generate_seconds=time.perf_counter() - t0)
    expect = EXPECTED[scale]
    n_tri = expect[0]
    e2e = {}

    # 4a. the count: K1 only
    report, warm_s, clock, count_launches, mem = main_path(
        lambda c: eng.count((edges, n), clock=c))
    memory = {"count": mem}
    log("main_path", path="count", graph=f"rmat{scale}", memory=mem,
        triangles=report.triangles, num_horizontal=report.num_horizontal,
        k=report.k, c1=report.c1, c2=report.c2,
        overflow_h=report.overflow.h, backend=report.backend,
        plan_id=report.plan_id, launches=count_launches, seconds=warm_s,
        stages=clock.seconds, counts=clock.counts)
    if (count_launches["intersect_levels"] == 0
            or count_launches["intersect_hits"]
            or report.backend != "cuda"):
        raise SystemExit(f"the count did not go through K1 alone: "
                         f"{count_launches}")
    if (report.triangles, report.num_horizontal) != expect:
        raise SystemExit(f"rmat{scale}: got {report.triangles} triangles, "
                         f"{report.num_horizontal} horizontal; "
                         f"expected {expect}")
    if report.overflow.h:
        raise SystemExit(f"rmat{scale}: overflow flag set")
    e2e["count"] = timed_runs(
        "count", lambda c: eng.count((edges, n), clock=c),
        lambda r: (r.triangles, r.c1, r.c2) == (report.triangles, report.c1,
                                                report.c2))

    # 4b. the per-vertex count: K2 only
    pv, warm_s, clock, pv_launches, mem = main_path(
        lambda c: eng.count((edges, n), options=pv_opts, clock=c))
    memory["per_vertex"] = mem
    pv_sum = int(pv.per_vertex.astype(np.int64).sum())
    log("main_path", path="per_vertex", graph=f"rmat{scale}", memory=mem,
        triangles=pv.triangles, c1=pv.c1, c2=pv.c2, per_vertex_sum=pv_sum,
        top_k=pv.top_k(5).tolist(), transitivity=pv.transitivity(),
        launches=pv_launches, seconds=warm_s, stages=clock.seconds,
        counts=clock.counts)
    if pv_launches["intersect_hits"] == 0 or pv_launches["intersect_levels"]:
        raise SystemExit(f"the per-vertex count did not go through K2 "
                         f"alone: {pv_launches}")
    if ((pv.triangles, pv.c1, pv.c2) != (report.triangles, report.c1,
                                         report.c2)
            or pv_sum != 3 * n_tri):
        raise SystemExit(f"rmat{scale} per-vertex: triangles "
                         f"{pv.triangles}, c1/c2 {pv.c1}/{pv.c2}, sum "
                         f"{pv_sum}")
    e2e["per_vertex"] = timed_runs(
        "per_vertex",
        lambda c: eng.count((edges, n), options=pv_opts, clock=c),
        lambda r: np.array_equal(r.per_vertex, pv.per_vertex))

    # 4c. find, with a buffer of every triangle: K2 only.  The triangles
    # are unique and closed, and their corners are the per-vertex credit.
    (tri, cnt), warm_s, clock, find_launches, mem = main_path(
        lambda c: eng.find((edges, n), max_triangles=n_tri, clock=c))
    memory["find"] = mem
    g = from_edges(edges, n, device=dev)
    t0 = time.perf_counter()
    unique, closed = check_found(tri, g, n)
    found = sum(torch.bincount(tri[:, i], minlength=n) for i in range(3))
    pv_found = bool(torch.equal(
        found, torch.from_numpy(pv.per_vertex).to(dev, torch.int64)))
    del found
    log("main_path", path="find", graph=f"rmat{scale}", memory=mem,
        count=int(cnt), rows=tri.shape[0], unique=unique, closed=closed,
        per_vertex_equals_bincount=pv_found, launches=find_launches,
        seconds=warm_s, stages=clock.seconds, counts=clock.counts,
        check_seconds=time.perf_counter() - t0)
    if find_launches["intersect_hits"] == 0 or find_launches[
            "intersect_levels"]:
        raise SystemExit(f"find did not go through K2 alone: "
                         f"{find_launches}")
    if (int(cnt) != n_tri or not (unique and closed and pv_found)
            or tri.device.type != "cuda"):
        raise SystemExit(f"rmat{scale} find: count {int(cnt)}, unique "
                         f"{unique}, closed {closed}, per-vertex credit "
                         f"equals its bincount {pv_found}")
    e2e["find"] = timed_runs(
        "find", lambda c: eng.find((edges, n), max_triangles=n_tri, clock=c),
        lambda r: int(r[1]) == n_tri and torch.equal(r[0], tri))
    del tri

    # 4d. the device's busy share on each path: one profiled run each,
    # its device time over the unprofiled median wall time
    for tag, run in (
        ("count", lambda: eng.count((edges, n))),
        ("per_vertex", lambda: eng.count((edges, n), options=pv_opts)),
        ("find", lambda: eng.find((edges, n), max_triangles=n_tri)),
    ):
        busy_ms, wall_s, top = device_busy(run)
        med = e2e[tag]["median_seconds"]
        e2e[tag]["device_busy_ms"] = busy_ms
        log("device_busy", path=tag, busy_ms=busy_ms,
            profiled_seconds=wall_s, median_seconds=med,
            busy_share=busy_ms / 1e3 / med if busy_ms else None,
            top_device_ms=top)

    # 4e. per bucket: each kernel's time, bound, plain time and
    # agreement, on the operands the main path gives it
    levels = torch.from_numpy(report.levels).to(dev)
    plan = eng.count_raw(g).plan
    log("plan", buckets=[vars(b) for b in plan.buckets],
        probe_rows=plan.probe_rows, probe_cells=plan.probe_cells,
        peak_rows=plan.peak_rows)
    flat, buckets = bucket_operands(g, levels, plan)
    rng = np.random.default_rng(0)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, row_bytes_bound_ms=0.0)
    tot_h = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, row_bytes_bound_ms=0.0,
                 sample_ms=0.0, sample_plain_ms=0.0, sample_rows=0,
                 launches=0)
    bound_by, bound_by_h = [], []
    top_sample = None
    for b, ops in buckets:
        kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
        call = (flat, *ops[:4], levels, ops[4])
        ms = cuda_ms(lambda: kmod.intersect_levels(*call, **kw))
        bound, by, nbytes, nops, row_ms = bucket_bound(flat, levels, ops,
                                                       b.d_cand, b.d_targ)
        err_full, s1, s2, plain_ms = compare(flat, levels, ops, b)
        rows = torch.from_numpy(np.sort(rng.choice(
            b.count, size=min(SAMPLE_ROWS, b.count), replace=False))).to(dev)
        err_sample = compare(flat, levels, ops, b, rows)[0]
        max_err = max(max_err, err_full, err_sample)
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["row_bytes_bound_ms"] += row_ms
        bound_by.append((bound, by))
        log("bucket", kernel="intersect_levels", graph=f"rmat{scale}",
            start=b.start, count=b.count, rows=b.rows, d_cand=b.d_cand,
            d_targ=b.d_targ, kernel_ms=ms, bound_ms=bound, bound_by=by,
            bytes=nbytes, ops=nops, row_bytes_bound_ms=row_ms,
            plain_ms=plain_ms,
            max_abs_err_all_rows=err_full, max_abs_err_sample=err_sample,
            c1=s1, c2=s2)
        top_sample = (b, tuple(x[rows] for x in ops))

        # K2 at the main path's own launch shapes: one call of the
        # wrapper per chunk of the cell budget (its offsets cumsum and
        # one sync included), each timed and held against the plain
        # version on the same rows; the times summed over the chunks
        ms_h = p_ms_h = 0.0
        n_hits = err_all = 0
        chunks = cell_chunks(ops[1], d_cand=b.d_cand)
        for r0, r1 in chunks:
            cops = tuple(x[r0:r1] for x in ops[:4])
            ms_h += cuda_ms(lambda: kmod.intersect_hits(flat, *cops, **kw))
            err_c, hits_c, _, p_c = compare_hits(flat, cops, b)
            err_all = max(err_all, err_c)
            n_hits += hits_c
            p_ms_h += p_c
        bound_h, by_h, nbytes_h, nops_h, row_ms_h, cells = hits_bound(
            flat, ops, b.d_cand, b.d_targ)
        err_h, _, k_ms, p_ms = compare_hits(flat, ops, b, rows)
        max_err_hits = max(max_err_hits, err_all, err_h)
        for key, v in (("ms", ms_h), ("plain_ms", p_ms_h),
                       ("bound_ms", bound_h),
                       ("row_bytes_bound_ms", row_ms_h),
                       ("sample_ms", k_ms), ("sample_plain_ms", p_ms),
                       ("sample_rows", len(rows)),
                       ("launches", len(chunks))):
            tot_h[key] += v
        bound_by_h.append((bound_h, by_h))
        log("bucket", kernel="intersect_hits", graph=f"rmat{scale}",
            count=b.count, rows=b.rows, d_cand=b.d_cand, d_targ=b.d_targ,
            cells=cells, hits=n_hits, main_path_launches=len(chunks),
            kernel_ms=ms_h, bound_ms=bound_h, bound_by=by_h,
            bytes=nbytes_h, ops=nops_h, row_bytes_bound_ms=row_ms_h,
            plain_ms=p_ms_h, max_abs_err_all_rows=err_all,
            sample_rows=len(rows), sample_kernel_ms=k_ms,
            sample_plain_ms=p_ms, max_abs_err_sample=err_h,
            library_ms=None)
        if n_hits != s1 + s2:
            raise SystemExit(f"rmat{scale}: K2 found {n_hits} hits in a "
                             f"bucket, K1 {s1 + s2}")
    # the plain version of K1 on the top bucket's sample, beside the kernel
    b, sops = top_sample
    kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
    scall = (flat, *sops[:4], levels, sops[4])
    s_kernel = cuda_ms(lambda: kmod.intersect_levels(*scall, **kw))
    s_plain = cuda_ms(lambda: intersect_levels_ref(*scall, **kw), reps=1)
    log("top_bucket_sample", rows=len(sops[0]), d_cand=b.d_cand,
        d_targ=b.d_targ, kernel_ms=s_kernel, plain_ms=s_plain,
        library_ms=None)
    if max_err or max_err_hits:
        raise SystemExit(f"a kernel disagrees with its plain version: "
                         f"K1 {max_err}, K2 {max_err_hits}")

    # ---------------------------------------------------------- 5. summary
    log("summary", end_to_end={k: v["median_seconds"] for k, v in e2e.items()},
        device_busy_ms={k: v["device_busy_ms"] for k, v in e2e.items()},
        memory=memory, seconds=time.perf_counter() - t_all)
    src = "src/repro_torch/kernels/intersect/csrc/intersect.cu"
    kernels = [{
        "name": "intersect_levels",
        "route": "cuda",
        "source": src,
        "replaces": "src/repro/kernels/intersect/intersect.py:79",
        "replaces_function":
            "repro.kernels.intersect.intersect.intersect_pallas",
        "launches": count_launches["intersect_levels"],
        "matches_plain": max_err == 0,
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "sample_rows": len(sops[0]),
        "sample_ms": s_kernel,
        "sample_plain_ms": s_plain,
        "bound_ms": tot["bound_ms"],
        "bound_by": max(bound_by)[1],
        "row_bytes_bound_ms": tot["row_bytes_bound_ms"],
        "library_ms": None,
        "shape": f"rmat{scale} plan, {len(buckets)} buckets",
    }, {
        "name": "intersect_hits",
        "route": "cuda",
        "source": src,
        "replaces": "src/repro/kernels/intersect/intersect.py:211",
        "replaces_function":
            "repro.kernels.intersect.intersect.intersect_pallas_hits",
        "launches": (find_launches["intersect_hits"]
                     + pv_launches["intersect_hits"]),
        "launches_find": find_launches["intersect_hits"],
        "launches_per_vertex": pv_launches["intersect_hits"],
        "matches_plain": max_err_hits == 0,
        "max_abs_err": max_err_hits,
        "ms": tot_h["ms"],
        "plain_ms": tot_h["plain_ms"],
        "sample_rows": tot_h["sample_rows"],
        "sample_ms": tot_h["sample_ms"],
        "sample_plain_ms": tot_h["sample_plain_ms"],
        "bound_ms": tot_h["bound_ms"],
        "bound_by": max(bound_by_h)[1],
        "row_bytes_bound_ms": tot_h["row_bytes_bound_ms"],
        "library_ms": None,
        "shape": f"rmat{scale} plan, {len(buckets)} buckets, "
                 f"{tot_h['launches']} launches at the main path's chunk "
                 f"shapes",
    }]
    print(json.dumps({"kernels": kernels}))
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
