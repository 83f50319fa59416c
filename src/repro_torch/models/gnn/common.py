"""Shared GNN containers, the counterparts of ``repro.models.gnn.common``.

``GraphBatch`` is the one static-shape structure every GNN consumes: an
edge list in local ids (the sentinel ``n_nodes`` drops out of segment
ops), optional node features, 3-D positions and atom types for the
molecular nets, a graph id per node for batched small graphs, and a
triplet table (k->j, j->i edge-index pairs) for DimeNet, built on the
host by ``build_triplets``.  The molecular nets (SchNet, DimeNet) share
``edge_vectors`` (each edge's unit vector and length) and
``graph_readout`` (the per-graph energy sum, through K4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.segsum.ops import segment_sum


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    src: torch.Tensor                      # int32[E] (pad = n_nodes)
    dst: torch.Tensor                      # int32[E]
    node_feat: Optional[torch.Tensor]      # f32[N, F]
    positions: Optional[torch.Tensor]      # f32[N, 3]
    atom_type: Optional[torch.Tensor]      # int32[N]
    graph_id: Optional[torch.Tensor]       # int32[N] (pad = n_graphs)
    labels: Optional[torch.Tensor]         # task-dependent
    label_mask: Optional[torch.Tensor]     # bool[N] (loss-bearing nodes)
    trip_kj: Optional[torch.Tensor]        # int32[T] edge ids (pad = E)
    trip_ji: Optional[torch.Tensor]        # int32[T]

    @property
    def n_nodes(self) -> int:
        for t in (self.node_feat, self.positions, self.atom_type):
            if t is not None:
                return t.shape[0]
        raise ValueError("a GraphBatch needs node_feat, positions or "
                         "atom_type")

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]

    def to(self, device: str | torch.device) -> "GraphBatch":
        """Every tensor of the batch on ``device``."""
        dev = resolve_device(device)
        return GraphBatch(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)})


def build_triplets(
    src: np.ndarray, dst: np.ndarray, n_nodes: int, *, cap: int
) -> tuple[np.ndarray, np.ndarray]:
    """DimeNet triplet table: for each directed edge j->i (id eji) and each
    in-edge k->j (id ekj, k != i), one (ekj, eji) row.  Host-side numpy,
    built once per topology; truncated at ``cap`` with sentinel padding
    (truncation count is the caller's to report)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    E = len(src)
    valid = (src < n_nodes) & (dst < n_nodes)
    # in-edges of each node: ids of edges whose dst == v
    order = np.argsort(np.where(valid, dst, n_nodes), kind="stable")
    sorted_dst = np.where(valid, dst, n_nodes)[order]
    starts = np.searchsorted(sorted_dst, np.arange(n_nodes + 1))
    kj_list, ji_list = [], []
    for eji in range(E):
        if not valid[eji]:
            continue
        j = src[eji]
        in_j = order[starts[j]: starts[j + 1]]  # edges k->j
        for ekj in in_j:
            if src[ekj] != dst[eji]:  # k != i
                kj_list.append(ekj)
                ji_list.append(eji)
            if len(kj_list) >= cap:
                break
        if len(kj_list) >= cap:
            break
    t = len(kj_list)
    kj = np.full(cap, E, dtype=np.int32)
    ji = np.full(cap, E, dtype=np.int32)
    kj[:t] = kj_list
    ji[:t] = ji_list
    return kj, ji


def edge_vectors(g: GraphBatch):
    """``(unit, dist, ok)`` per edge ``j -> i``: the unit vector from
    ``positions[src]`` to ``positions[dst]`` [E, 3], its length
    ``sqrt(max(|v|^2, 1e-12))`` [E], and ``ok``, true for a real edge
    (both ends below ``n_nodes``); a padded edge gets length 1, so
    nothing downstream divides by 0."""
    n = g.n_nodes
    ps = g.positions.index_select(0, g.src.clamp(0, n - 1).long())
    pd = g.positions.index_select(0, g.dst.clamp(0, n - 1).long())
    vec = pd - ps
    dist = torch.sqrt(torch.clamp_min((vec * vec).sum(-1), 1e-12))
    ok = (g.src < n) & (g.dst < n)
    dist = torch.where(ok, dist, torch.ones((), dtype=dist.dtype,
                                            device=dist.device))
    return vec / dist[:, None], dist, ok


def graph_readout(atom_e: torch.Tensor, g: GraphBatch) -> torch.Tensor:
    """The per-graph sum of ``atom_e`` [N, 1] by ``graph_id`` (all zeros
    when the batch has none), through K4 as ``[N, 1]``: [n_graphs], with
    ``n_graphs`` the label count (1 without labels)."""
    gid = g.graph_id if g.graph_id is not None else torch.zeros(
        (g.n_nodes,), dtype=torch.int32, device=atom_e.device)
    num_graphs = int(g.labels.shape[0]) if g.labels is not None else 1
    return segment_sum(atom_e, gid, num_graphs)[:, 0]
