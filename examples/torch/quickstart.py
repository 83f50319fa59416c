"""Quickstart on the PyTorch port: cover-edge triangle counting through
the one front door (``repro_torch.api.TriangleEngine``, Algorithm 1
under the hood), on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch/quickstart.py            # H100
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

Each count is held against an independent one: networkx's where
networkx imports, else a set intersection per edge (numpy only); the
printed line names which.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import TriangleEngine
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import from_edges

GRAPHS = {
    "karate": gen.karate,
    "dolphins-like (62 vertices)": gen.dolphins_like,
    "Graph500 RMAT scale 10": lambda: gen.rmat(10, 16, seed=0),
}


def networkx_triangles(edges: np.ndarray, n: int) -> int:
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(np.asarray(edges).tolist())
    g.remove_edges_from(nx.selfloop_edges(g))
    return sum(nx.triangles(g).values()) // 3


def set_triangles(edges: np.ndarray, n: int) -> int:
    """|N(u) ∩ N(v)| over the undirected edges u < v, summed, over 3."""
    adj = [set() for _ in range(n)]
    for u, v in np.asarray(edges).tolist():
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    return sum(len(adj[u] & adj[v]) for u in range(n) for v in adj[u]
               if u < v) // 3


def pick_oracle():
    """``(name, count)``: networkx's count where it imports, else the
    set intersection's."""
    try:
        import networkx  # noqa: F401
    except ImportError:
        return "sets", set_triangles
    return "networkx", networkx_triangles


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    engine = TriangleEngine(device=args.device)
    oracle_name, oracle = pick_oracle()
    out = {"counts": {}, "oracle": oracle_name}
    for name, make in GRAPHS.items():
        edges, n = make()
        rep = engine.count((edges, n))  # Graph objects work too
        want = oracle(edges, n)
        if rep.triangles != want:
            raise SystemExit(f"{name}: {rep.triangles} triangles, "
                             f"{oracle_name} counts {want}")
        out["counts"][name] = dict(
            triangles=rep.triangles, oracle=want, k=rep.k, c1=rep.c1,
            c2=rep.c2, route=rep.route, backend=rep.backend,
            plan_id=rep.plan_id)
        print(f"{name}:")
        print(f"  triangles = {rep.triangles} ({oracle_name}: {want})")
        print(f"  horizontal-edge fraction k = {rep.k:.3f}")
        print(f"  c1 (apex off-level) = {rep.c1}, "
              f"c2 (all-same-level, triple-counted) = {rep.c2}")
        print(f"  provenance: route={rep.route} backend={rep.backend} "
              f"plan={rep.plan_id}")
    # triangle FINDING on karate: same engine, same options
    edges, n = gen.karate()
    tri, cnt = engine.find(from_edges(edges, n, device=engine.device),
                           max_triangles=64)
    found = tri[:int(cnt)].cpu().numpy()
    out["found"] = found
    print(f"\nfirst 5 of {int(cnt)} karate triangles: "
          f"{found[:5].tolist()}")
    # BATCHED counting: many small query graphs in one call (one budget
    # cell, one cached plan, one probe launch a bucket for every lane)
    batch = [gen.karate(), gen.complete(9), gen.erdos_renyi(60, 0.1, seed=1)]
    reports = engine.count_batch(batch)
    out["batch"] = [r.triangles for r in reports]
    print(f"\ncount_batch of {len(batch)} graphs "
          f"(plan {reports[0].plan_id}):")
    for i, rep in enumerate(reports):
        print(f"  graph {i}: n={batch[i][1]} "
              f"triangles={rep.triangles} k={rep.k:.3f}")
    out["plan_cache"] = engine.plan_cache_stats()
    print(f"plan cache: {out['plan_cache']}")
    return out


if __name__ == "__main__":
    main()
