"""GatedGCN (Bresson & Laurent, arXiv:1711.07553; benchmarking config of
arXiv:2003.00982: 16 layers, d_hidden=70, gated edge aggregation), the
counterpart of ``repro.models.gnn.gatedgcn``.

    e_ij' = e_ij + ReLU(N(A h_i + B h_j + C e_ij))
    h_i'  = h_i + ReLU(N(U h_i + Σ_j σ(e_ij') ⊙ V h_j / (Σ_j σ(e_ij') + ε)))

One ``nn.Module`` per layer, looped over in Python (the reference scans
over stacked ``[L, ...]`` leaves; ``models/convert.py`` unstacks them),
weights ``[d_in, d_out]`` applied as ``x @ w``.  Both aggregations of
every layer go through
:func:`repro_torch.kernels.segsum.ops.segment_sum`: K4 on the card, its
plain version on the CPU.  The forward groups the edges by destination
once (one ``SegsumLayout``) and every launch shares it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.segsum.ops import build_layout, segment_sum
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.layers import dense_init, layernorm, softmax_xent

#: the per-layer weights, in the reference's leaf names
LAYER_LEAVES = ("A", "B", "C", "U", "V", "ln_h_w", "ln_h_b", "ln_e_w",
                "ln_e_b")


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    n_classes: int = 16
    dtype: str = "float32"


class GatedGCNLayer(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        for name in ("A", "B", "C", "U", "V"):
            setattr(self, name, nn.Parameter(torch.zeros((d, d),
                                                         dtype=dtype)))
        for part in ("h", "e"):
            setattr(self, f"ln_{part}_w",
                    nn.Parameter(torch.ones((d,), dtype=dtype)))
            setattr(self, f"ln_{part}_b",
                    nn.Parameter(torch.zeros((d,), dtype=dtype)))

    def forward(self, h, e, src_c, dst_c, seg_dst, layout):
        n = h.shape[0]
        hi = h.index_select(0, dst_c)   # receiving endpoint i (j -> i)
        hj = h.index_select(0, src_c)
        e_new = e + F.relu(layernorm(hi @ self.A + hj @ self.B + e @ self.C,
                                     self.ln_e_w, self.ln_e_b))
        gate = torch.sigmoid(e_new)
        num = segment_sum(gate * (hj @ self.V), seg_dst, n, layout=layout)
        den = segment_sum(gate, seg_dst, n, layout=layout) + 1e-6
        h_new = h + F.relu(layernorm(h @ self.U + num / den, self.ln_h_w,
                                     self.ln_h_b))
        return h_new, e_new


class GatedGCN(nn.Module):
    """Node classification logits [N, n_classes] of a ``GraphBatch``."""

    def __init__(self, cfg: GatedGCNConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_hidden
        self.embed_h = nn.Parameter(torch.zeros((cfg.d_in, d), dtype=dt))
        self.embed_e = nn.Parameter(torch.zeros((1, d), dtype=dt))
        self.layers = nn.ModuleList(GatedGCNLayer(d, dt)
                                    for _ in range(cfg.n_layers))
        self.readout = nn.Parameter(torch.zeros((d, cfg.n_classes),
                                                dtype=dt))

    def forward(self, g: GraphBatch) -> torch.Tensor:
        n = g.n_nodes
        h = g.node_feat.to(self.embed_h.dtype) @ self.embed_h
        e = self.embed_e.expand(g.n_edges, self.cfg.d_hidden)
        src_c = g.src.clamp(0, n - 1).long()
        dst_c = g.dst.clamp(0, n - 1).long()
        # padded slots (dst = n) still compute e_new but join no sum
        seg_dst = torch.where(g.dst < n, g.dst, n)
        layout = build_layout(seg_dst, n)
        for layer in self.layers:
            h, e = layer(h, e, src_c, dst_c, seg_dst, layout)
        return h @ self.readout


def loss_fn(model: GatedGCN, g: GraphBatch) -> torch.Tensor:
    """Mean cross-entropy over the labelled nodes (``label_mask``)."""
    return softmax_xent(model(g), g.labels, mask=g.label_mask)


@torch.no_grad()
def init_params(cfg: GatedGCNConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> GatedGCN:
    """A model with random weights drawn from ``torch.Generator`` seeded
    with ``seed`` on the CPU (the reference's initialisers: ``dense_init``
    for the matrices, zeros for ``embed_e`` and the norm biases, ones for
    the norm scales), then moved to ``device``: the same weights on
    every device."""
    dev = resolve_device(device)
    model = GatedGCN(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_hidden
    model.embed_h.copy_(dense_init(gen, cfg.d_in, d, dt))
    for layer in model.layers:
        for name in ("A", "B", "C", "U", "V"):
            getattr(layer, name).copy_(dense_init(gen, d, d, dt))
    model.readout.copy_(dense_init(gen, d, cfg.n_classes, dt))
    return model.to(dev)
