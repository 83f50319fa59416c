"""The architectures the port runs, by ``--arch`` name: the counterpart of
``repro.configs.registry``'s ``ARCH_MODULES`` and ``arch_module``.

Every architecture of the reference resolves: the LMs (dense and MoE,
trained and served), the four GNNs, the recsys BST (trained, served and
scored) and ``cover-edge-tc``, the paper's own workload (counted by
``repro_torch.api.TriangleEngine``; it trains nothing).
``GNN_FWD_FLOPS`` carries the reference's rough forward FLOP formulas of
the GNNs (``repro.configs.registry._GNN_FWD_FLOPS``).
"""
from __future__ import annotations

import importlib

ARCH_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "gat-cora": "repro_torch.configs.gat_cora",
    "schnet": "repro_torch.configs.schnet",
    "dimenet": "repro_torch.configs.dimenet",
    "bst": "repro_torch.configs.bst",
    "cover-edge-tc": "repro_torch.configs.cover_edge_tc",
}


def arch_module(name: str):
    """The config module of ``name`` (``CONFIG``, ``SMOKE``, ``FAMILY``)."""
    if name in ARCH_MODULES:
        return importlib.import_module(ARCH_MODULES[name])
    raise KeyError(f"unknown --arch {name!r}; the port runs "
                   f"{sorted(ARCH_MODULES)}")


# ------------------------------------------------------------------- GNN
# rough per-layer dense + edge costs of one forward, the reference's
# formulas: n nodes, e edge slots, t triplet slots (DimeNet)


def gatedgcn_fwd_flops(cfg, n: int, e: int) -> int:
    return cfg.n_layers * (5 * n * cfg.d_hidden ** 2
                           + 6 * e * cfg.d_hidden) * 2


def gat_fwd_flops(cfg, n: int, e: int) -> int:
    return (n * cfg.d_in * cfg.d_hidden * cfg.n_heads * 2
            + n * cfg.d_hidden * cfg.n_heads * cfg.n_classes * 2
            + 8 * e * cfg.d_hidden * cfg.n_heads)


def schnet_fwd_flops(cfg, n: int, e: int) -> int:
    return cfg.n_interactions * (
        4 * n * cfg.d_hidden ** 2 * 2 + 2 * e * cfg.n_rbf * cfg.d_hidden
        + 4 * e * cfg.d_hidden)


def dimenet_fwd_flops(cfg, n: int, e: int, t: int = 0) -> int:
    """``t``: the triplet budget of the shape."""
    return cfg.n_blocks * (
        2 * t * (cfg.d_hidden * cfg.n_bilinear           # w_kj gather-side
                 + cfg.n_spherical * cfg.n_radial * cfg.n_bilinear
                 + cfg.n_bilinear ** 2 * cfg.d_hidden)   # bilinear einsum
        + 6 * e * cfg.d_hidden ** 2 * 2)


GNN_FWD_FLOPS = {
    "gatedgcn": gatedgcn_fwd_flops,
    "gat-cora": gat_fwd_flops,
    "schnet": schnet_fwd_flops,
    "dimenet": dimenet_fwd_flops,
}
