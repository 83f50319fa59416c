#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the exact local count (Algorithm
1) end to end on one NVIDIA H100, through its hand-written Hopper kernel.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero; nothing is caught and skipped):

  1. setup   — versions, toolchain, the card's name and power limit, and
               the build of every CUDA source with nvcc (timed);
  2. kernel  — K1 against its plain PyTorch version on the same CUDA
               tensors: every bucket of RMAT scale 16 in full, and a
               seeded sample of 4,096 rows from each bucket at full size;
  3. small   — ``TriangleEngine(device="cuda").count`` on karate and RMAT
               scales 10, 12 and 16, each count asserted;
  4. full    — RMAT scale 20 (Graph500, edge factor 16, seed 0), the
               largest scale at which the int32 c1/c2 contract holds: one
               warm-up count with the launch counters reset just before
               and read just after (the main path), then 3 timed counts;
               per-stage seconds, per-bucket kernel milliseconds from CUDA
               events beside the byte bound, the plain version on every
               row of every bucket (timed, compared), peak device memory.
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
                    help="timed full-size counts after the warm-up")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import TriangleEngine
    from repro_torch.core.sequential import StageClock
    from repro_torch.graph import generators as gen
    from repro_torch.graph.csr import from_edges
    from repro_torch.kernels import build
    from repro_torch.kernels.intersect import intersect as k1mod
    from repro_torch.kernels.intersect.ref import intersect_levels_ref

    dev = torch.device("cuda")
    t_all = time.perf_counter()

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

    # --------------------------------- 2a. kernel vs plain, rmat(16) full
    e16, n16 = gen.rmat(16, 16, seed=0)
    res16 = eng.count_raw((e16, n16))
    flat, buckets = bucket_operands(from_edges(e16, n16, device=dev),
                                    res16.levels, res16.plan)
    before = k1mod.LAUNCHES
    for b, ops in buckets:
        err, s1, s2, _ = compare(flat, res16.levels, ops, b)
        max_err = max(max_err, err)
        log("kernel_vs_plain", graph="rmat16", rows=b.rows, d_cand=b.d_cand,
            d_targ=b.d_targ, max_abs_err=err, c1=s1, c2=s2)
    if k1mod.LAUNCHES <= before or max_err:
        raise SystemExit(f"rmat16 kernel check failed: err={max_err}, "
                         f"launches {before} -> {k1mod.LAUNCHES}")

    # ----------------------------------------------- 3. small graphs
    small = [("karate", gen.karate(), (45, None))]
    small += [(f"rmat{s}", gen.rmat(s, 16, seed=0), EXPECTED[s])
              for s in (10, 12, 16)]
    for name, (edges, n), (tri, nh) in small:
        k1mod.LAUNCHES = 0
        t0 = time.perf_counter()
        r = eng.count((edges, n))
        dt = time.perf_counter() - t0
        log("small", graph=name, triangles=r.triangles,
            num_horizontal=r.num_horizontal, backend=r.backend,
            launches=k1mod.LAUNCHES, seconds=dt)
        if (r.triangles != tri or (nh is not None and r.num_horizontal != nh)
                or r.backend != "cuda" or r.overflow
                or k1mod.LAUNCHES == 0):
            raise SystemExit(f"{name}: wrong count or path: {r}")

    # -------------------------------------------------- 4. full size
    scale = args.scale
    t0 = time.perf_counter()
    edges, n = gen.rmat(scale, 16, seed=0)
    log("data", graph=f"rmat{scale}", n_nodes=n, edge_rows=len(edges),
        generate_seconds=time.perf_counter() - t0)
    expect = EXPECTED[scale]
    torch.cuda.reset_peak_memory_stats()

    # the main path: counters to 0 just before, read just after
    k1mod.LAUNCHES = 0
    clock = StageClock(dev)
    t0 = time.perf_counter()
    report = eng.count((edges, n), clock=clock)
    warm_s = time.perf_counter() - t0
    main_launches = {"intersect_levels": k1mod.LAUNCHES}
    log("main_path", graph=f"rmat{scale}", triangles=report.triangles,
        num_horizontal=report.num_horizontal, k=report.k, c1=report.c1,
        c2=report.c2, overflow_h=report.overflow.h, backend=report.backend,
        plan_id=report.plan_id, launches=main_launches, seconds=warm_s,
        stages=clock.seconds, counts=clock.counts)
    if main_launches["intersect_levels"] == 0 or report.backend != "cuda":
        raise SystemExit("the main path did not launch the kernel")
    if (report.triangles, report.num_horizontal) != expect:
        raise SystemExit(f"rmat{scale}: got {report.triangles} triangles, "
                         f"{report.num_horizontal} horizontal; "
                         f"expected {expect}")
    if report.overflow.h:
        raise SystemExit(f"rmat{scale}: overflow flag set")

    runs = []
    for i in range(args.runs):
        clock = StageClock(dev)
        t0 = time.perf_counter()
        r = eng.count((edges, n), clock=clock)
        dt = time.perf_counter() - t0
        if (r.triangles, r.c1, r.c2) != (report.triangles, report.c1,
                                         report.c2):
            raise SystemExit(f"timed run {i} disagrees: {r}")
        runs.append((dt, clock))
        log("timed_run", run=i, seconds=dt, stages=clock.seconds,
            counts=clock.counts)
    med = statistics.median(dt for dt, _ in runs)
    med_clock = sorted(runs, key=lambda x: x[0])[len(runs) // 2][1]
    log("end_to_end", graph=f"rmat{scale}", median_seconds=med,
        seconds=[dt for dt, _ in runs], median_run_stages=med_clock.seconds,
        bfs_sweeps=med_clock.counts.get("bfs_sweeps"),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        num_horizontal=report.num_horizontal, k=report.k)

    # per-bucket kernel time, bound, plain time and agreement, on the
    # operands the main path gives the kernel
    g = from_edges(edges, n, device=dev)
    levels = torch.from_numpy(report.levels).to(dev)
    raw = eng.count_raw(g)
    plan = raw.plan
    log("plan", buckets=[vars(b) for b in plan.buckets],
        probe_rows=plan.probe_rows, probe_cells=plan.probe_cells,
        peak_rows=plan.peak_rows)
    flat, buckets = bucket_operands(g, levels, plan)
    rng = np.random.default_rng(0)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, row_bytes_bound_ms=0.0)
    bound_by = []
    top_sample = None
    for b, ops in buckets:
        kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
        call = (flat, *ops[:4], levels, ops[4])
        ms = cuda_ms(lambda: k1mod.intersect_levels(*call, **kw))
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
        log("bucket", graph=f"rmat{scale}", start=b.start, count=b.count,
            rows=b.rows, d_cand=b.d_cand, d_targ=b.d_targ, kernel_ms=ms,
            bound_ms=bound, bound_by=by, bytes=nbytes, ops=nops,
            row_bytes_bound_ms=row_ms,
            plain_ms=plain_ms,
            max_abs_err_all_rows=err_full, max_abs_err_sample=err_sample,
            c1=s1, c2=s2)
        top_sample = (b, tuple(x[rows] for x in ops))
    # the plain version on the top bucket's sample, beside the kernel
    b, sops = top_sample
    kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
    scall = (flat, *sops[:4], levels, sops[4])
    s_kernel = cuda_ms(lambda: k1mod.intersect_levels(*scall, **kw))
    s_plain = cuda_ms(lambda: intersect_levels_ref(*scall, **kw), reps=1)
    log("top_bucket_sample", rows=len(sops[0]), d_cand=b.d_cand,
        d_targ=b.d_targ, kernel_ms=s_kernel, plain_ms=s_plain,
        library_ms=None)
    if max_err:
        raise SystemExit(f"kernel disagrees with its plain version: {max_err}")

    # ---------------------------------------------------------- 5. summary
    log("done", seconds=time.perf_counter() - t_all)
    kernels = [{
        "name": "intersect_levels",
        "route": "cuda",
        "source": "src/repro_torch/kernels/intersect/csrc/intersect.cu",
        "replaces": "src/repro/kernels/intersect/intersect.py:79",
        "replaces_function":
            "repro.kernels.intersect.intersect.intersect_pallas",
        "launches": main_launches["intersect_levels"],
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
