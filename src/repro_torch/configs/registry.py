"""The architectures the port runs, by ``--arch`` name: the counterpart of
``repro.configs.registry``'s ``ARCH_MODULES`` and ``arch_module``.

The port serves the dense LMs and trains GatedGCN.  Every other
architecture of the reference raises and names the ROADMAP item that
brings it.
"""
from __future__ import annotations

import importlib

ARCH_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "gatedgcn": "repro_torch.configs.gatedgcn",
}

#: the reference's other architectures -> the ROADMAP item that ports them
NOT_PORTED = {
    "qwen2-moe-a2.7b": "ROADMAP Queue 1 item 13 (MoE)",
    "phi3.5-moe-42b-a6.6b": "ROADMAP Queue 1 item 13 (MoE)",
    "gat-cora": "ROADMAP Queue 1 item 13 (GAT, with segment_softmax)",
    "dimenet": "ROADMAP Queue 1 item 13 (DimeNet, with edge_vectors)",
    "schnet": "ROADMAP Queue 1 item 13 (SchNet, with edge_vectors)",
    "bst": "ROADMAP Queue 1 item 13 (recsys BST)",
    "cover-edge-tc": "ROADMAP Queue 1 item 13 (configs; the engine itself "
                     "is repro_torch.api.TriangleEngine)",
}


def arch_module(name: str):
    """The config module of ``name`` (``CONFIG``, ``SMOKE``, ``FAMILY``)."""
    if name in ARCH_MODULES:
        return importlib.import_module(ARCH_MODULES[name])
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"--arch {name} is not ported yet: {NOT_PORTED[name]}")
    raise KeyError(f"unknown --arch {name!r}; the port runs "
                   f"{sorted(ARCH_MODULES)}")
