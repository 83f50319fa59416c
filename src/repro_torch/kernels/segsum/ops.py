"""The segment-sum entry point that the GNNs call.

Counterpart of ``repro.kernels.segsum.ops``.  ``build_layout`` groups the
edges once per topology; ``segment_sum`` sums by it.  The reference's
TPU tile sizes (``block_n``, ``block_e``) size its one-hot MXU tiles and
have no counterpart here: K4 walks each segment's own edge list.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.segsum.segsum import SegmentSum, SegsumLayout

BACKENDS = ("auto", "cuda", "torch")


def build_layout(seg_ids: torch.Tensor, num_segments: int) -> SegsumLayout:
    """The edges of ``seg_ids`` grouped by segment, on its device (see
    :class:`~repro_torch.kernels.segsum.segsum.SegsumLayout`)."""
    return SegsumLayout(seg_ids, num_segments)


def segment_sum(
    msgs: torch.Tensor,
    seg: Optional[torch.Tensor],
    num_segments: int,
    *,
    layout: Optional[SegsumLayout] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """``out[n] = sum(msgs[e] for e with seg[e] == n)``, float32 ``[N, F]``
    (ids outside ``[0, N)`` dropped), differentiable in ``msgs``.

    ``layout`` (from :func:`build_layout` over ``seg``) is built here when
    not given; ``seg`` may be None when it is.  ``backend``: ``"auto"`` is
    K4 on a CUDA tensor and the plain version on the CPU; ``"cuda"`` is
    K4 and raises on a CPU tensor; ``"torch"`` is the plain version on
    any device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got "
                         f"{backend!r}")
    if layout is None:
        if seg is None:
            raise ValueError("segment_sum needs seg or a layout")
        layout = build_layout(seg, num_segments)
    elif layout.num_segments != int(num_segments):
        raise ValueError(f"the layout has {layout.num_segments} segments; "
                         f"asked for {num_segments}")
    dev = msgs.device.type
    if backend == "cuda" and dev != "cuda":
        raise ValueError(f"backend 'cuda' needs a CUDA tensor; got {dev}")
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {msgs.device}")
    return SegmentSum.apply(msgs, layout, dev == "cuda" and backend != "torch")
