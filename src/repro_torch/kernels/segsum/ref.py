"""Plain PyTorch segment sum: what K4 computes.

Counterpart of ``repro.kernels.segsum.ref.segment_sum_ref`` (which is
``jax.ops.segment_sum`` over the ungrouped edge stream):

    out[n] = sum of msgs[e] over the e with seg[e] == n

``msgs`` is ``[E, F]``; ids ``< 0`` or ``>= N`` are dropped.  ``out`` is
``[N, F]`` in float32 (the Pallas kernel's ``out_shape``), or float64 for
float64 messages.  It runs on the CPU, and on the card only when a
caller asks for it by name (``ops.segment_sum(..., backend="torch")``).
"""
from __future__ import annotations

import torch


def segment_sum_ref(msgs: torch.Tensor, seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """msgs float[E, F], seg int[E] (out-of-range ids dropped)."""
    num_segments = int(num_segments)
    dt = torch.promote_types(msgs.dtype, torch.float32)
    out = torch.zeros((num_segments, msgs.shape[1]), dtype=dt,
                      device=msgs.device)
    keep = (seg >= 0) & (seg < num_segments)
    return out.index_add_(0, seg[keep].long(), msgs[keep].to(dt))
