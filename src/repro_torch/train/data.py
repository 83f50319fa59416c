"""Deterministic synthetic data streams, the counterparts of
``repro.train.data``.

A stream is a function of ``(seed, cursor)``: restart-safe (a checkpoint
stores the cursor) and position-addressable, so a stream restarted at
cursor c yields the c-th batch of a fresh one.  ``GNNSampledStream``
samples ``minibatch_lg`` blocks (``graph/sampler.py``) on the base
graph's device; ``block_batch`` turns a block into the ``GraphBatch``
the GNNs consume.  ``LMStream`` yields ``configs.data.lm_batch`` at its
cursor: uniform token ids from ``seeded_generator(seed, cursor)``, which
cannot reproduce the reference's ``jax.random`` draws (a deliberate
difference, as for ``GNNSampledStream``).  ``BSTStream`` yields
``configs.data.bst_batch`` at its cursor the same way (the reference
seeds its batch c with ``seed + c``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.data import bst_batch, lm_batch
from repro_torch.device import resolve_device
from repro_torch.graph.sampler import sample_blocks
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.layers import seeded_generator


class GNNSampledStream:
    """``minibatch_lg``: seeded fanout sampling over a fixed base graph
    (a ``graph.csr.Graph`` or anything with ``row_offsets``, ``dst`` and
    ``deg``).  Each ``next()`` returns ``sample_blocks``' ``(nodes, src,
    dst, seed_mask)`` for ``seeds_per_batch`` seeds drawn uniformly from
    ``[0, n_nodes)``; seeds and uniforms come from
    ``seeded_generator(seed, cursor)`` on the CPU and are moved to the
    graph's device, so the card and the CPU sample the same block."""

    def __init__(self, graph, seeds_per_batch: int, fanouts, n_nodes: int,
                 *, seed: int = 0, cursor: int = 0):
        self.graph, self.fanouts = graph, tuple(fanouts)
        self.bs, self.n = seeds_per_batch, n_nodes
        self.seed, self.cursor = seed, cursor

    def __next__(self):
        gen = seeded_generator(self.seed, self.cursor)
        self.cursor += 1
        seeds = torch.randint(0, self.n, (self.bs,), generator=gen,
                              dtype=torch.int32)
        return sample_blocks(gen, self.graph.row_offsets, self.graph.dst,
                             self.graph.deg, seeds, self.fanouts, self.n)

    def __iter__(self):
        return self


def block_batch(block, node_feat: torch.Tensor,
                labels: torch.Tensor) -> GraphBatch:
    """A sampled block ``(nodes, src, dst, seed_mask)`` as a node-
    classification ``GraphBatch`` in local ids: each local node's row of
    the base graph's ``node_feat`` [n, F] and ``labels`` [n] (zeros and
    label 0 for a sentinel node), the loss on the seeds only."""
    nodes, src, dst, seed_mask = block
    n = node_feat.shape[0]
    inside = nodes < n
    rows = nodes.clamp(0, n - 1).long()
    feat = node_feat.index_select(0, rows) * inside[:, None].to(
        node_feat.dtype)
    lab = torch.where(inside, labels.index_select(0, rows),
                      torch.zeros((), dtype=labels.dtype,
                                  device=labels.device))
    return GraphBatch(src=src, dst=dst, node_feat=feat, positions=None,
                      atom_type=None, graph_id=None, labels=lab,
                      label_mask=seed_mask, trip_kj=None, trip_ji=None)


class LMStream:
    """Next-token batches ``(tokens, labels)``, each int64 [batch, seq] on
    ``device``: batch c is ``configs.data.lm_batch(cfg, batch, seq,
    seed, cursor=c)``, so a stream restarted at cursor c resumes the
    batches of a fresh one."""

    def __init__(self, cfg, batch: int, seq: int, *, seed: int = 0,
                 cursor: int = 0, device: str | torch.device = "cuda"):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.cursor = seed, cursor
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self):
        out = lm_batch(self.cfg, self.batch, self.seq, self.seed,
                       cursor=self.cursor, device=self.device)
        self.cursor += 1
        return out


class BSTStream:
    """BST batches ``(history, target, profile_idx, profile_bag,
    labels)`` on ``device``: batch c is ``configs.data.bst_batch(cfg,
    batch, seed, cursor=c)``, so a stream restarted at cursor c resumes
    the batches of a fresh one."""

    def __init__(self, cfg, batch: int, *, seed: int = 0, cursor: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg, self.batch = cfg, batch
        self.seed, self.cursor = seed, cursor
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self):
        out = bst_batch(self.cfg, self.batch, self.seed, cursor=self.cursor,
                        device=self.device)
        self.cursor += 1
        return out
