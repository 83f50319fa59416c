"""Synthetic, seeded data builders, the counterparts of
``repro.configs.data``.

``gnn_batch`` makes the same numpy draws as the reference, so its
arrays equal the reference's byte for byte; the edges are packed on the
batch's device by ``graph.csr.from_edges``.  ``lm_batch`` draws its
tokens from ``models.layers.seeded_generator(seed, cursor)``: the
reference's ``jax.random`` draws cannot be reproduced, so the tokens
differ from its (a deliberate difference).  ``bst_batch`` draws the same
way, from ``seeded_generator(seed, cursor)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import from_edges
from repro_torch.models.gnn.common import GraphBatch, build_triplets
from repro_torch.models.layers import seeded_generator


def lm_batch(cfg, batch: int, seq: int, seed: int = 0, *, cursor: int = 0,
             device: str | torch.device = "cuda"):
    """``(tokens, labels)``, int64 [batch, seq] each on ``device``: a
    pure function of ``(seed, cursor)``; uniform ids in ``[0, vocab)``
    drawn on the CPU, ``labels`` the tokens shifted by one."""
    gen = seeded_generator(seed, cursor)
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen)
    toks = toks.to(resolve_device(device))
    return toks[:, :-1], toks[:, 1:]


def gnn_batch(
    arch: str, cfg, *, n_nodes: int, n_edges_und: int, d_feat: int,
    n_graphs: int = 1, triplet_factor: int = 8, seed: int = 0,
    need_triplets: bool | None = None,
    device: str | torch.device = "cuda",
) -> GraphBatch:
    """Synthesize a GraphBatch of the given topology size on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if n_graphs > 1:
        # batched small graphs (molecule shape): disjoint union
        per = n_nodes
        edges_list = []
        for gi in range(n_graphs):
            e, _ = gen.random_geometric(per, 0.45, seed=seed + gi)
            if len(e) > n_edges_und:
                e = e[:n_edges_und]
            edges_list.append(e + gi * per)
        edges = np.concatenate(edges_list)
        n_total = per * n_graphs
        graph_id = np.repeat(np.arange(n_graphs), per).astype(np.int32)
    else:
        scale = max(2, int(np.ceil(np.log2(max(n_nodes, 4)))))
        ef = max(1, n_edges_und // n_nodes)
        edges, _ = gen.rmat(scale, ef, seed=seed)
        edges = edges % n_nodes
        edges = edges[edges[:, 0] != edges[:, 1]][:n_edges_und]
        n_total = n_nodes
        graph_id = np.zeros(n_total, np.int32)
    total_edges_und = n_edges_und * (n_graphs if n_graphs > 1 else 1)
    g = from_edges(edges, n_total, num_slots=2 * total_edges_und,
                   device=dev)
    need_trip = (
        need_triplets if need_triplets is not None else arch == "dimenet"
    )
    if need_trip:
        cap = triplet_factor * g.num_slots
        kj, ji = build_triplets(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                                n_total, cap=cap)
        trip_kj = torch.from_numpy(kj).to(dev)
        trip_ji = torch.from_numpy(ji).to(dev)
    else:
        trip_kj = trip_ji = None
    molecular = arch in ("schnet", "dimenet")
    n_classes = getattr(cfg, "n_classes", 2)
    labels = (
        rng.standard_normal(n_graphs).astype(np.float32)
        if molecular
        else rng.integers(0, n_classes, n_total).astype(np.int32)
    )
    node_feat = None if molecular else (
        rng.standard_normal((n_total, d_feat)).astype(np.float32))
    positions = (
        np.concatenate([gen.positions_for(n_nodes, seed=seed + i)
                        for i in range(n_graphs)])
        if n_graphs > 1 else gen.positions_for(n_total, seed=seed)
    ) if molecular else None
    atom_type = (rng.integers(0, 20, n_total).astype(np.int32)
                 if molecular else None)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    return GraphBatch(
        src=g.src,
        dst=g.dst,
        node_feat=put(node_feat),
        positions=put(positions),
        atom_type=put(atom_type),
        graph_id=put(graph_id),
        labels=put(labels),
        label_mask=None if molecular else torch.ones(
            (n_total,), dtype=torch.bool, device=dev),
        trip_kj=trip_kj,
        trip_ji=trip_ji,
    )


def bst_batch(cfg, batch: int, seed: int = 0, *, cursor: int = 0,
              device: str | torch.device = "cuda"):
    """``(history, target, profile_idx, profile_bag, labels)`` on
    ``device``, a pure function of ``(seed, cursor)``: history int64
    [batch, seq_len - 1] and target int64 [batch] uniform in ``[0,
    item_vocab)``, profile_idx int64 [batch * profile_bag] uniform in
    ``[0, profile_vocab)``, profile_bag ``repeat(arange(batch),
    profile_bag)`` and labels float32 [batch], Bernoulli(0.3), as the
    reference's; drawn on the CPU."""
    gen = seeded_generator(seed, cursor)
    hist = torch.randint(0, cfg.item_vocab, (batch, cfg.seq_len - 1),
                         generator=gen)
    target = torch.randint(0, cfg.item_vocab, (batch,), generator=gen)
    pidx = torch.randint(0, cfg.profile_vocab, (batch * cfg.profile_bag,),
                         generator=gen)
    pbag = torch.arange(batch).repeat_interleave(cfg.profile_bag)
    labels = (torch.rand((batch,), generator=gen) < 0.3).float()
    dev = resolve_device(device)
    return tuple(t.to(dev) for t in (hist, target, pidx, pbag, labels))
