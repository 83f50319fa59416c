"""GAT (Veličković et al., arXiv:1710.10903), Cora config: 2 layers,
8 hidden units x 8 heads, then 1 output head; the counterpart of
``repro.models.gnn.gat``.

Each layer: SDDMM edge scores ``leaky_relu(a_src·Wh[j] + a_dst·Wh[i])``,
a softmax over each destination's in-edges, a weighted sum of the
sources' ``Wh`` rows, then ELU between layers.  One ``nn.Module`` per
layer, weights ``[d_in, d_out]`` applied as ``x @ w``.  The forward
groups the edges by destination once (one ``SegsumLayout``) and every
K4 launch shares it: per layer the softmax's denominator
(``graph/segment.py:segment_softmax``, F = heads) and the aggregation
(F = heads x d_out), 4 launches a forward at 2 layers.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.graph.segment import segment_softmax
from repro_torch.kernels.segsum.ops import build_layout, segment_sum
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.layers import dense_init, softmax_xent

#: the per-layer weights; the reference names them ``{leaf}{i}``
LAYER_LEAVES = ("W", "a_src", "a_dst")


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: str = "float32"


def layer_shape(cfg: GATConfig, i: int) -> tuple[int, int, int]:
    """``(d_in, heads, d_out)`` of layer ``i``: the last layer has one
    head of ``n_classes``."""
    last = i == cfg.n_layers - 1
    d_in = cfg.d_in if i == 0 else cfg.n_heads * cfg.d_hidden
    return (d_in, 1 if last else cfg.n_heads,
            cfg.n_classes if last else cfg.d_hidden)


class GATLayer(nn.Module):
    def __init__(self, d_in: int, heads: int, d_out: int, slope: float,
                 dtype: torch.dtype):
        super().__init__()
        self.heads, self.d_out, self.slope = heads, d_out, slope
        self.W = nn.Parameter(torch.zeros((d_in, heads * d_out), dtype=dtype))
        self.a_src = nn.Parameter(torch.zeros((heads, d_out), dtype=dtype))
        self.a_dst = nn.Parameter(torch.zeros((heads, d_out), dtype=dtype))

    def forward(self, h, src_c, dst_c, seg_dst, layout):
        n = h.shape[0]
        wh = (h @ self.W).reshape(-1, self.heads, self.d_out)
        s_src = torch.einsum("nhd,hd->nh", wh, self.a_src)
        s_dst = torch.einsum("nhd,hd->nh", wh, self.a_dst)
        scores = F.leaky_relu(s_src.index_select(0, src_c)
                              + s_dst.index_select(0, dst_c), self.slope)
        alpha = segment_softmax(scores, seg_dst, n, layout=layout)  # [E, H]
        msgs = alpha[:, :, None] * wh.index_select(0, src_c)
        return segment_sum(msgs.reshape(-1, self.heads * self.d_out),
                           seg_dst, n, layout=layout)


class GAT(nn.Module):
    """Node classification logits [N, n_classes] of a ``GraphBatch``."""

    def __init__(self, cfg: GATConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        self.layers = nn.ModuleList(
            GATLayer(*layer_shape(cfg, i), cfg.negative_slope, dt)
            for i in range(cfg.n_layers))

    def forward(self, g: GraphBatch) -> torch.Tensor:
        n = g.n_nodes
        h = g.node_feat.to(self.layers[0].W.dtype)
        src_c = g.src.clamp(0, n - 1).long()
        dst_c = g.dst.clamp(0, n - 1).long()
        seg_dst = torch.where(g.dst < n, g.dst, n)
        layout = build_layout(seg_dst, n)
        for i, layer in enumerate(self.layers):
            agg = layer(h, src_c, dst_c, seg_dst, layout)
            h = agg if i == len(self.layers) - 1 else F.elu(agg)
        return h


def loss_fn(model: GAT, g: GraphBatch) -> torch.Tensor:
    """Mean cross-entropy over the labelled nodes (``label_mask``)."""
    return softmax_xent(model(g), g.labels, mask=g.label_mask)


@torch.no_grad()
def init_params(cfg: GATConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> GAT:
    """A model with random weights drawn from ``torch.Generator`` seeded
    with ``seed`` on the CPU (the reference's initialisers: ``dense_init``
    for ``W``, ``normal * 0.1`` for ``a_src``, zeros for ``a_dst``), then
    moved to ``device``."""
    dev = resolve_device(device)
    model = GAT(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    for i, layer in enumerate(model.layers):
        d_in, heads, d_out = layer_shape(cfg, i)
        layer.W.copy_(dense_init(gen, d_in, heads * d_out, dt))
        layer.a_src.copy_(torch.randn((heads, d_out), generator=gen,
                                      dtype=dt) * 0.1)
    return model.to(dev)
