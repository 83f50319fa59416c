"""Distributed cover-edge triangle counting (the paper's Algorithm 2) on
the PyTorch port, against the wedge-query baseline it replaces, through
the ``TriangleEngine`` front door's distributed route.

The p shards are ``LocalShards(p, device)``: p logical shards stacked on
one device (the card unless ``--device cpu``), whose collectives the
shard group records, so the wire bytes of a p-device run are measured
from its own calls.  ``plan_hedge_rounds`` lays out the static degree
buckets of the horizontal rounds on the host, and every round runs that
plan against the transposed pair lists (K3 on the card).

    PYTHONPATH=src python examples/torch/distributed_tc.py
    PYTHONPATH=src python examples/torch/distributed_tc.py --device cpu \\
        --scale 9
"""
from __future__ import annotations

import argparse

from repro_torch.api import TCOptions, TriangleEngine
from repro_torch.core import comm_instrument as ci
from repro_torch.core import comm_model as cm
from repro_torch.core.parallel_tc import plan_hedge_rounds
from repro_torch.core.shards import LocalShards
from repro_torch.core.wedge_baseline import (
    parallel_wedge_triangle_count,
    wedge_count,
)
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import from_edges


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=11,
                    help="RMAT scale (edge factor 16, seed 0)")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    p = args.shards
    mesh = LocalShards(p, args.device)
    edges, n = gen.rmat(args.scale, 16, seed=0)
    engine = TriangleEngine(device=args.device, mesh=mesh)
    g = from_edges(edges, n, device=engine.device)
    m = int(g.n_edges_dir) // 2

    # hedge_chunk is both the probe slice and the bucket-row granularity:
    # without it the whole per-round buffer is one bucket
    chunk = 512
    opts = TCOptions(mode="ring", hedge_chunk=chunk)
    plan = plan_hedge_rounds(g, p, mode="ring", hedge_chunk=chunk)
    print(f"RMAT scale {args.scale}: n={n} m={m}")
    print("planned horizontal rounds (one engine bucket per line):")
    for b in plan.buckets:
        print(f"  rows={b.rows:>6}  candidate width={b.d_cand:>4}  "
              f"target width={b.d_targ}")

    rep = engine.count(g, route="distributed", options=opts)
    wres = parallel_wedge_triangle_count(g, mesh)
    wedge_t = int(wres.triangles)
    if wedge_t != rep.triangles:
        raise SystemExit(f"cover-edge counts {rep.triangles}, the wedge "
                         f"baseline {wedge_t}")
    print(f"cover-edge (ring): T={rep.triangles}  k={rep.k:.3f}"
          f"  per-device={rep.per_device.tolist()}")
    print(f"  measured horizontal fraction k = {rep.k:.3f} "
          f"({rep.num_horizontal} of {m} undirected edges)")
    print(f"  overflow flags: transpose={rep.overflow.transpose} "
          f"hedge={rep.overflow.hedge} (static capacities held)")
    print(f"  unified report: route={rep.route} plan={rep.plan_id} "
          f"c1={rep.c1} c2={rep.c2} (Alg 2 has no apex-level split)")
    print(f"wedge baseline:    T={wedge_t}  "
          f"wedges routed={int(wres.wedges_routed)}")

    new = cm.cover_edge_comm(n, m, rep.k, p).total_bytes
    old = cm.wedge_comm_bits(float(wedge_count(g)), n) / 8
    print(f"\nmodelled comm: wedge={cm.fmt_bytes(old)} "
          f"cover-edge={cm.fmt_bytes(new)} -> {old/new:.1f}x reduction")

    # the measured loop: the shard group records every collective of a
    # run, and its priced record must match the run's tally
    raw = engine.count_distributed_raw(g, options=opts)
    tally = raw.comm.phase_bytes()
    sweeps = int(raw.comm.bfs_sweeps)
    repm = ci.comm_report(n, int(g.n_edges_dir), p, sweeps=sweeps,
                          calls=raw.collectives, mode="ring")
    print(f"\nmeasured wire bytes (ring, p={p}, {sweeps} BFS sweeps):")
    for ph, row in repm["phases"].items():
        agree = "==" if row["measured"] == tally[ph] else "!="
        print(f"  {ph:>9}: measured={row['measured']:>10} {agree} "
              f"tally={tally[ph]:>10}  modeled={row['modeled']:.0f}")
    if not all(r["measured"] == tally[ph]
               for ph, r in repm["phases"].items()):
        raise SystemExit("measured wire bytes differ from the tally")
    return dict(n=n, m=m, triangles=rep.triangles, k=rep.k,
                num_horizontal=rep.num_horizontal,
                per_device=rep.per_device.tolist(), plan_id=rep.plan_id,
                buckets=[(b.rows, b.d_cand, b.d_targ) for b in plan.buckets],
                wedge_triangles=wedge_t,
                wedges_routed=int(wres.wedges_routed),
                modelled_bytes=dict(wedge=old, cover_edge=new),
                wire_bytes=repm["phases"])


if __name__ == "__main__":
    main()
