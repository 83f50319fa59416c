"""DimeNet (Gasteiger et al., arXiv:2003.03123): directional message
passing with radial-Bessel and angular bases over edge-edge triplets,
the counterpart of ``repro.models.gnn.dimenet``.  Config: 6 blocks,
d = 128, 8 bilinear units, 7 angular x 6 radial basis functions.

The basis is the reference's separable one (DESIGN.md §2): radial
Bessel ⊗ ``cos(l·θ)`` in the angle, of the original's tensor shape
(n_spherical x n_radial), not its spherical Bessel x spherical
harmonics.  The triplet table (k->j edges interacting with j->i edges)
is built on the host once per topology (``common.build_triplets``) and
padded with the sentinel E.

One ``nn.Module`` per block, looped over in Python.  Every segment sum
goes through :func:`repro_torch.kernels.segsum.ops.segment_sum` (K4 on
the card): each block's triplet sum into the E edges (F = d), over one
layout shared by all blocks, then the readouts edges -> atoms (F = d)
and atoms -> graphs (``[N, 1]``); 8 launches a forward at 6 blocks.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.segsum.ops import build_layout, segment_sum
from repro_torch.models.gnn.common import (
    GraphBatch,
    edge_vectors,
    graph_readout,
)
from repro_torch.models.layers import dense_init

#: one block's weights, in the reference's leaf names
BLOCK_LEAVES = ("w_sbf", "w_kj", "bilinear", "w_rbf", "w_msg1", "w_msg2")
TOP_LEAVES = ("embed", "w_edge_in", "w_out1", "w_out2")


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 10.0
    n_atom_types: int = 100
    dtype: str = "float32"


def bessel_rbf(dist: torch.Tensor, n_radial: int,
               cutoff: float) -> torch.Tensor:
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=dist.device)
    d = torch.clamp(dist / cutoff, 1e-4, 1.0)
    return (2.0 / cutoff) ** 0.5 * torch.sin(
        math.pi * n[None, :] * d[:, None]) / (d[:, None] * cutoff)


def angular_basis(cos_angle: torch.Tensor, n_spherical: int) -> torch.Tensor:
    """``cos(l·θ)``, l = 0 .. n_spherical - 1 (the separable stand-in for
    the spherical-harmonic factor)."""
    theta = torch.arccos(torch.clamp(cos_angle, -1.0 + 1e-6, 1.0 - 1e-6))
    ls = torch.arange(n_spherical, dtype=torch.float32,
                      device=cos_angle.device)
    return torch.cos(theta[:, None] * ls[None, :])


class DimeNetBlock(nn.Module):
    def __init__(self, cfg: DimeNetConfig, dtype: torch.dtype):
        super().__init__()
        d, nb = cfg.d_hidden, cfg.n_bilinear
        shapes = {"w_sbf": (cfg.n_spherical * cfg.n_radial, nb),
                  "w_kj": (d, nb), "bilinear": (nb, nb, d),
                  "w_rbf": (cfg.n_radial, d), "w_msg1": (d, d),
                  "w_msg2": (d, d)}
        for name in BLOCK_LEAVES:
            setattr(self, name, nn.Parameter(torch.zeros(shapes[name],
                                                         dtype=dtype)))

    def forward(self, m, sbf, rbf, kj, seg_ji, layout):
        # directional interaction: messages k->j modulate j->i
        a = sbf @ self.w_sbf                               # [T, nb]
        b = (m @ self.w_kj).index_select(0, kj)            # [T, nb]
        inter = torch.einsum("ta,tb,abd->td", a, b, self.bilinear)
        agg = segment_sum(inter, seg_ji, m.shape[0], layout=layout)  # [E, d]
        upd = torch.tanh(rbf @ self.w_rbf) * torch.tanh(
            (m + agg) @ self.w_msg1)
        return m + upd @ self.w_msg2


class DimeNet(nn.Module):
    """Per-graph energies [n_graphs] of a molecular ``GraphBatch`` with a
    triplet table."""

    def __init__(self, cfg: DimeNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_hidden
        self.embed = nn.Parameter(torch.zeros((cfg.n_atom_types, d),
                                              dtype=dt))
        self.w_edge_in = nn.Parameter(torch.zeros((2 * d + cfg.n_radial, d),
                                                  dtype=dt))
        self.blocks = nn.ModuleList(DimeNetBlock(cfg, dt)
                                    for _ in range(cfg.n_blocks))
        self.w_out1 = nn.Parameter(torch.zeros((d, d), dtype=dt))
        self.w_out2 = nn.Parameter(torch.zeros((d, 1), dtype=dt))

    def forward(self, g: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        n, e = g.n_nodes, g.n_edges
        x = self.embed.index_select(
            0, g.atom_type.clamp(0, cfg.n_atom_types - 1).long())
        unit, dist, ok = edge_vectors(g)
        okf = ok[:, None].to(dist.dtype)
        rbf = bessel_rbf(dist, cfg.n_radial, cfg.cutoff) * okf
        src_c = g.src.clamp(0, n - 1).long()
        dst_c = g.dst.clamp(0, n - 1).long()
        # initial edge message m_ji from endpoint embeddings + rbf
        m = torch.tanh(torch.cat([x.index_select(0, src_c),
                                  x.index_select(0, dst_c), rbf], -1)
                       @ self.w_edge_in) * okf

        # triplet geometry: angle at j between (j->i) and (j->k) = -(k->j)
        kj = g.trip_kj.clamp(0, e - 1).long()
        ji = g.trip_ji.clamp(0, e - 1).long()
        t_ok = (g.trip_kj < e) & (g.trip_ji < e)
        cos_angle = torch.sum(unit.index_select(0, ji)
                              * (-unit.index_select(0, kj)), -1)
        ang = angular_basis(cos_angle, cfg.n_spherical)         # [T, S]
        sbf = (ang[:, :, None] * bessel_rbf(
            dist.index_select(0, kj), cfg.n_radial, cfg.cutoff)[:, None, :]
        ).reshape(-1, cfg.n_spherical * cfg.n_radial)
        sbf = sbf * t_ok[:, None].to(sbf.dtype)
        seg_ji = torch.where(t_ok, g.trip_ji, e)
        layout = build_layout(seg_ji, e)
        for block in self.blocks:
            m = block(m, sbf, rbf, kj, seg_ji, layout)
        # readout: edge messages -> receiving atoms -> graph energy
        seg_dst = torch.where((g.dst < n) & ok, g.dst, n)
        atom = segment_sum(torch.tanh(m @ self.w_out1), seg_dst, n)
        return graph_readout(atom @ self.w_out2, g)


def loss_fn(model: DimeNet, g: GraphBatch) -> torch.Tensor:
    """Mean squared error of the per-graph energies against ``labels``."""
    energy = model(g)
    return torch.mean((energy - g.labels.to(torch.float32)) ** 2)


@torch.no_grad()
def init_params(cfg: DimeNetConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> DimeNet:
    """A model with random weights drawn from ``torch.Generator`` seeded
    with ``seed`` on the CPU (the reference's initialisers: ``normal *
    0.1`` for ``embed``, ``normal * 0.05`` for ``bilinear``,
    ``dense_init`` for the matrices), then moved to ``device``."""
    dev = resolve_device(device)
    model = DimeNet(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    model.embed.copy_(torch.randn(model.embed.shape, generator=gen,
                                  dtype=dt) * 0.1)
    model.w_edge_in.copy_(dense_init(gen, *model.w_edge_in.shape, dt))
    for block in model.blocks:
        for name in BLOCK_LEAVES:
            w = getattr(block, name)
            w.copy_(torch.randn(w.shape, generator=gen, dtype=dt) * 0.05
                    if name == "bilinear" else dense_init(gen, *w.shape, dt))
    model.w_out1.copy_(dense_init(gen, *model.w_out1.shape, dt))
    model.w_out2.copy_(dense_init(gen, *model.w_out2.shape, dt))
    return model.to(dev)
