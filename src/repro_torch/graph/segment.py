"""Segment sum with the framework-wide sentinel convention.

Counterpart of ``repro.graph.segment.segment_sum`` for the triangle
engine's integer per-vertex credit scatters.  The GNNs' float
aggregation goes through ``kernels/segsum/ops.py`` (K4 on the card).
``segment_max``, ``segment_mean``, ``segment_softmax`` and
``embedding_bag`` wait for GAT and BST (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows grouped by ``segment_ids``:
    ``out[s] = sum(data[i] for i with segment_ids[i] == s)``, of
    ``data``'s dtype and shape ``[num_segments, *data.shape[1:]]``.

    Sentinel convention: ids outside ``[0, num_segments)`` — the
    sentinel ``num_segments`` and negative pads such as the intersection
    engine's ``CAND_PAD`` — are dropped and contribute nothing, as
    ``jax.ops.segment_sum`` drops them."""
    num_segments = int(num_segments)
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    return out.index_add_(0, segment_ids[keep].long(), data[keep])
