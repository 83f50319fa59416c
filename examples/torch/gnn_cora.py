"""Full-batch GAT training on a synthetic Cora-shaped graph on the
PyTorch port, with triangle analytics as extra structural node features:
the paper's algorithm feeding the GNN substrate it shares.  Two columns
come from one engine pass: the BFS level (a by-product of the cover-edge
plan) and the per-vertex triangle count (``TCOptions(per_vertex=True)``,
K2 on the card), log-compressed since triangle participation is
heavy-tailed.  GAT's softmax denominators and aggregations run on K4 on
the card.

    PYTHONPATH=src python examples/torch/gnn_cora.py
    PYTHONPATH=src python examples/torch/gnn_cora.py --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.api import TCOptions, TriangleEngine
from repro_torch.configs.data import gnn_batch
from repro_torch.configs.registry import arch_module
from repro_torch.graph.csr import from_edges
from repro_torch.launch import steps as steps_mod
from repro_torch.train.optimizer import OptConfig, opt_init


def triangle_features(edges: np.ndarray, n: int, device):
    """``(features, report)``: float32[n, 2] structural columns from ONE
    engine pass on ``device``, BFS level (scaled) and log1p per-vertex
    triangle count, and that pass's report.  Checks the attribution:
    non-negative and summing to 3T."""
    rep = TriangleEngine(device=device).count(
        from_edges(edges, n, device=device),
        options=TCOptions(per_vertex=True))
    pv = np.asarray(rep.per_vertex)
    if pv.shape != (n,) or not (pv >= 0).all():
        raise SystemExit(f"per-vertex counts: shape {pv.shape}, "
                         f"min {pv.min() if n else 0}")
    if int(pv.sum()) != 3 * int(rep.triangles):
        raise SystemExit(f"per-vertex credit sums to {int(pv.sum())}, not "
                         f"3 x {rep.triangles}")
    levels = torch.as_tensor(rep.levels, dtype=torch.float32) / 10.0
    tri = torch.log1p(torch.as_tensor(pv, dtype=torch.float32))
    print(f"graph triangles: {rep.triangles}  k={rep.k:.3f}  "
          f"max per-vertex: {int(pv.max()) if n else 0}")
    return torch.stack([levels, tri], dim=1).to(device), rep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = dataclasses.replace(arch_module("gat-cora").SMOKE, d_in=10,
                              n_classes=3)
    batch = gnn_batch("gat-cora", cfg, n_nodes=300, n_edges_und=1200,
                      d_feat=8, seed=1, device=dev)
    edges = torch.stack([batch.src, batch.dst], 1).cpu().numpy()
    feats, rep = triangle_features(edges, 300, dev)
    batch = dataclasses.replace(
        batch, node_feat=torch.cat([batch.node_feat, feats], dim=1))

    model = steps_mod.init_for("gat-cora", cfg, 0, dev)
    opt_cfg = OptConfig(lr=5e-3, warmup=5, total_steps=args.steps)
    opt = opt_init(opt_cfg, dict(model.named_parameters()))
    step = steps_mod.gnn_train_step("gat-cora", cfg, opt_cfg)
    losses = []
    for i in range(args.steps):
        opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % 20 == 0:
            print(f"step {i+1}: loss {losses[-1]:.4f}")
    return dict(triangles=rep.triangles, k=rep.k, levels=rep.levels,
                per_vertex=rep.per_vertex, features=feats.cpu(),
                losses=losses)


if __name__ == "__main__":
    main()
