"""SchNet (Schütt et al., arXiv:1706.08566): continuous-filter
convolutions over interatomic distances, the counterpart of
``repro.models.gnn.schnet``.  Config: 3 interaction blocks, d = 64, 300
RBF centres, 10 Å cutoff; energy regression per graph.

One ``nn.Module`` per interaction block, looped over in Python (the
reference scans over ``vmap``-initialised ``[L, ...]`` leaves;
``models/convert.py`` unstacks them).  Each block's message sum (F = d)
and the per-graph readout (as ``[N, 1]``) go through
:func:`repro_torch.kernels.segsum.ops.segment_sum`: K4 on the card, its
plain version on the CPU; 4 launches a forward at 3 blocks.
"""
from __future__ import annotations

import base64
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.segsum.ops import build_layout, segment_sum
from repro_torch.models.gnn.common import (
    GraphBatch,
    edge_vectors,
    graph_readout,
)
from repro_torch.models.layers import dense_init

#: one interaction block's weights, in the reference's leaf names
BLOCK_LEAVES = ("filter_w1", "filter_b1", "filter_w2", "filter_b2", "in_w",
                "out_w1", "out_b1", "out_w2", "out_b2")
TOP_LEAVES = ("embed", "head_w1", "head_b1", "head_w2")


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    dtype: str = "float32"


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log 2`` (torch returns x above 20, within float32
    rounding of ``jax.nn.softplus``)."""
    return F.softplus(x) - math.log(2.0)


#: the reference's RBF centres ``jnp.linspace(0, cutoff, n_rbf)`` as its
#: float32 arithmetic gives them on the CPU, for the registry's two
#: widths (little-endian float32, base64): they differ from the exactly
#: rounded formula of :func:`linspace` by up to 2 ulp in 174 of the 300
#: centres, so the port copies them
REFERENCE_CENTRES = {
    (300, 10.0): (
        "AAAAAG79CD1u/Yg9JXzNPW79CD7KPCs+JXxNPoC7bz5u/Yg+HB2aPso8qz53XLw+JX"
        "zNPtOb3j6Au+8+l20AP279CD9FjRE/HB0aP/OsIj/KPCs/oMwzP3dcPD9O7EQ/JXxN"
        "P/wLVj/Tm14/qitnP4C7bz9XS3g/l22AP4O1hD9u/Yg/WUWNP0WNkT8w1ZU/HB2aPw"
        "dlnj/zrKI/3vSmP8o8qz+1hK8/oMyzP4wUuD93XLw/Y6TAP07sxD86NMk/JXzNPxDE"
        "0T/8C9Y/51PaP9Ob3j++4+I/qivnP5Vz6z+Au+8/bAP0P1dL+D9Dk/w/l20AQI2RAk"
        "CDtQRAeNkGQG79CEBkIQtAWUUNQE9pD0BFjRFAO7ETQDDVFUAm+RdAHB0aQBFBHEAH"
        "ZR5A/YggQPOsIkDo0CRA3vQmQNQYKUDKPCtAv2AtQLWEL0CrqDFAoMwzQJbwNUCMFD"
        "hAgjg6QHdcPEBtgD5AY6RAQFjIQkBO7ERARBBHQDo0SUAvWEtAJXxNQBugT0AQxFFA"
        "BuhTQPwLVkDyL1hA51NaQN13XEDTm15AyL9gQL7jYkC0B2VAqitnQJ9PaUCVc2tAi5"
        "dtQIC7b0B233FAbAN0QGIndkBXS3hATW96QEOTfEA5t35Al22AQJJ/gUCNkYJAiKOD"
        "QIO1hEB9x4VAeNmGQHPrh0Bu/YhAaQ+KQGQhi0BfM4xAWUWNQFRXjkBPaY9ASnuQQE"
        "WNkUBAn5JAO7GTQDXDlEAw1ZVAK+eWQCb5l0AhC5lAHB2aQBcvm0ARQZxADFOdQAdl"
        "nkACd59A/YigQPiaoUDzrKJA7b6jQOjQpEDj4qVA3vSmQNkGqEDUGKlAzyqqQMo8q0"
        "DETqxAv2CtQLpyrkC1hK9AsJawQKuosUCmurJAoMyzQJvetECW8LVAkQK3QIwUuECH"
        "JrlAgji6QHxKu0B3XLxAcm69QG2AvkBokr9AY6TAQF62wUBYyMJAU9rDQE7sxEBJ/s"
        "VARBDHQD8iyEA6NMlANEbKQC9Yy0AqasxAJXzNQCCOzkAboM9AFrLQQBDE0UAL1tJA"
        "BujTQAH61ED8C9ZA9x3XQPIv2EDsQdlA51PaQOJl20Ddd9xA2IndQNOb3kDOrd9AyL"
        "/gQMPR4UC+4+JAufXjQLQH5UCvGeZAqivnQKQ96ECfT+lAmmHqQJVz60CQhexAi5ft"
        "QIap7kCAu+9Ae83wQHbf8UBx8fJAbAP0QGcV9UBiJ/ZAXTn3QFdL+EBSXflATW/6QE"
        "iB+0BDk/xAPqX9QDm3/kAzyf9Al20AQZX2AEGSfwFBjwgCQY2RAkGKGgNBiKMDQYUs"
        "BEGDtQRBgD4FQX3HBUF7UAZBeNkGQXZiB0Fz6wdBcXQIQW79CEFrhglBaQ8KQWaYCk"
        "FkIQtBYaoLQV8zDEFcvAxBWUUNQVfODUFUVw5BUuAOQU9pD0FN8g9BSnsQQUcEEUFF"
        "jRFBQhYSQUCfEkE9KBNBO7ETQTg6FEE1wxRBM0wVQTDVFUEuXhZBK+cWQSlwF0Em+R"
        "dBI4IYQSELGUEelBlBHB0aQRmmGkEXLxtBFLgbQRFBHEEPyhxBDFMdQQrcHUEHZR5B"
        "Be4eQQJ3H0EAACBB"
    ),
    (20, 10.0): (
        "AAAAAKK8Bj+ivIY/8xrKP6K8BkDKayhA8xpKQBzKa0CivIZANpSXQMprqEBfQ7lA8x"
        "rKQIfy2kAcyutAsKH8QKK8BkFsKA9BNpQXQQAAIEE="
    ),
}


def linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 ``start * (1 - t) + stop * t`` with ``t = i / (num - 1)``,
    then ``stop``: ``jnp.linspace``'s formula, exactly rounded."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32) / div
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32)])


def rbf_centres(n_rbf: int, cutoff: float) -> torch.Tensor:
    """The ``n_rbf`` centres on [0, cutoff], float32 on the CPU: the
    reference's own values where ``REFERENCE_CENTRES`` has them, else
    :func:`linspace`."""
    raw = REFERENCE_CENTRES.get((n_rbf, float(cutoff)))
    if raw is None:
        return linspace(0.0, cutoff, n_rbf)
    return torch.from_numpy(np.frombuffer(base64.b64decode(raw), "<f4")
                            .astype(np.float32))


def rbf_expand(dist: torch.Tensor, centers: torch.Tensor,
               cutoff: float) -> torch.Tensor:
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


class InteractionBlock(nn.Module):
    def __init__(self, cfg: SchNetConfig, dtype: torch.dtype):
        super().__init__()
        d, r = cfg.d_hidden, cfg.n_rbf
        shapes = {"filter_w1": (r, d), "filter_b1": (d,), "filter_w2": (d, d),
                  "filter_b2": (d,), "in_w": (d, d), "out_w1": (d, d),
                  "out_b1": (d,), "out_w2": (d, d), "out_b2": (d,)}
        for name in BLOCK_LEAVES:
            setattr(self, name, nn.Parameter(torch.zeros(shapes[name],
                                                         dtype=dtype)))

    def forward(self, x, rbf, src_c, seg_dst, layout):
        w = shifted_softplus(rbf @ self.filter_w1 + self.filter_b1)
        w = w @ self.filter_w2 + self.filter_b2  # [E, d] filters
        msgs = (x @ self.in_w).index_select(0, src_c) * w
        agg = segment_sum(msgs, seg_dst, x.shape[0], layout=layout)
        v = shifted_softplus(agg @ self.out_w1 + self.out_b1)
        return x + (v @ self.out_w2 + self.out_b2)


class SchNet(nn.Module):
    """Per-graph energies [n_graphs] of a molecular ``GraphBatch``."""

    def __init__(self, cfg: SchNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_hidden
        self.embed = nn.Parameter(torch.zeros((cfg.n_atom_types, d),
                                              dtype=dt))
        self.blocks = nn.ModuleList(InteractionBlock(cfg, dt)
                                    for _ in range(cfg.n_interactions))
        self.head_w1 = nn.Parameter(torch.zeros((d, d // 2), dtype=dt))
        self.head_b1 = nn.Parameter(torch.zeros((d // 2,), dtype=dt))
        self.head_w2 = nn.Parameter(torch.zeros((d // 2, 1), dtype=dt))
        self.register_buffer("centers", rbf_centres(cfg.n_rbf, cfg.cutoff),
                             persistent=False)

    def forward(self, g: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        n = g.n_nodes
        x = self.embed.index_select(
            0, g.atom_type.clamp(0, cfg.n_atom_types - 1).long())
        _, dist, ok = edge_vectors(g)
        rbf = rbf_expand(dist, self.centers, cfg.cutoff)
        # smooth cosine cutoff envelope
        env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                     + 1.0)
        rbf = rbf * torch.where(ok, env, torch.zeros_like(env))[:, None]
        src_c = g.src.clamp(0, n - 1).long()
        seg_dst = torch.where(g.dst < n, g.dst, n)
        layout = build_layout(seg_dst, n)
        for block in self.blocks:
            x = block(x, rbf, src_c, seg_dst, layout)
        atom_e = shifted_softplus(x @ self.head_w1 + self.head_b1)
        atom_e = atom_e @ self.head_w2  # [N, 1]
        return graph_readout(atom_e, g)


def loss_fn(model: nn.Module, g: GraphBatch) -> torch.Tensor:
    """Mean squared error of the per-graph energies against ``labels``."""
    energy = model(g)
    return torch.mean((energy - g.labels.to(torch.float32)) ** 2)


@torch.no_grad()
def init_params(cfg: SchNetConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> SchNet:
    """A model with random weights drawn from ``torch.Generator`` seeded
    with ``seed`` on the CPU (the reference's initialisers: ``normal *
    0.1`` for ``embed``, ``dense_init`` for the matrices, zeros for the
    biases), then moved to ``device``."""
    dev = resolve_device(device)
    model = SchNet(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_hidden
    model.embed.copy_(torch.randn((cfg.n_atom_types, d), generator=gen,
                                  dtype=dt) * 0.1)
    for block in model.blocks:
        for name in ("filter_w1", "filter_w2", "in_w", "out_w1", "out_w2"):
            w = getattr(block, name)
            w.copy_(dense_init(gen, *w.shape, dt))
    model.head_w1.copy_(dense_init(gen, d, d // 2, dt))
    model.head_w2.copy_(dense_init(gen, d // 2, 1, dt))
    return model.to(dev)
