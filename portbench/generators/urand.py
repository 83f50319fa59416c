"""The GAP Benchmark Suite's ``urand`` graph, on the device of ``gen``.

Both endpoints of each of the ``degree * 2**scale`` edges are drawn
uniformly at random (Beamer, Asanovic, Patterson, arXiv:1508.03619,
section on the input graphs; GAP's generator, ``-u scale -k degree``).
Self-loops and repeats are left in, as GAP's generator leaves them to
the graph build.
"""
from __future__ import annotations

import torch


def make(cfg: dict, gen: torch.Generator) -> tuple[torch.Tensor, int]:
    """``(edges int64[m, 2], n)`` on ``gen``'s device for ``cfg``'s
    ``scale`` and ``degree``."""
    n = 1 << int(cfg["scale"])
    m = int(cfg["degree"]) * n
    edges = torch.randint(0, n, (m, 2), generator=gen, device=gen.device,
                          dtype=torch.int64)
    return edges, n
