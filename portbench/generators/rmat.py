"""Graph500's Kronecker (R-MAT) edge generator, on the device of ``gen``.

A copy of the program's ``graph/generators.py:rmat`` moved onto torch, so
that it runs on the card (numpy takes ~13 s for scale 20 on the host).
The steps are the same: ``edge_factor * 2**scale`` edges, each choosing
one quadrant per bit with the initiator probabilities A/B/C/D, then a
random permutation of the vertex labels (Graph500 specification, "Graph
Generation"; the paper's section V-C).
"""
from __future__ import annotations

import torch


def make(cfg: dict, gen: torch.Generator) -> tuple[torch.Tensor, int]:
    """``(edges int64[m, 2], n)`` on ``gen``'s device for the sizes and
    initiator of ``cfg`` (keys ``scale``, ``edge_factor``, ``a``, ``b``,
    ``c``; ``d = 1 - a - b - c``)."""
    scale = int(cfg["scale"])
    n = 1 << scale
    m = int(cfg["edge_factor"]) * n
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    if min(a, b, c) < 0 or a + b + c > 1 + 1e-9 or a + b <= 0 or a + b >= 1:
        raise ValueError(f"bad R-MAT initiator a={a}, b={b}, c={c}")
    dev = gen.device
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(scale):
        r1 = torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
        r2 = torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
        src_bit = r1 > ab
        dst_bit = torch.where(src_bit, r2 > c_norm, r2 > a_norm)
        src |= src_bit.to(torch.int64) << bit
        dst |= dst_bit.to(torch.int64) << bit
    perm = torch.randperm(n, generator=gen, device=dev)
    return torch.stack([perm[src], perm[dst]], dim=1), n
