"""Segment ops with the framework-wide sentinel convention, the
counterparts of ``repro.graph.segment``.

``segment_sum`` is the triangle engine's integer per-vertex credit
scatter.  ``segment_max``, ``segment_mean`` and ``segment_softmax`` (the
GAT edge-softmax primitive) follow the reference's conventions: ids
outside ``[0, num_segments)`` are dropped, an empty segment's max is the
dtype's identity and its mean exactly 0.  The GNNs' float aggregations
go through ``kernels/segsum/ops.py`` (K4 on the card), and so do the
softmax's denominator when a K4 layout is given and ``embedding_bag``'s
bag sum (BST's profile features).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hostio import note_wait
from repro_torch.kernels.segsum import ops as segops
from repro_torch.kernels.segsum.segsum import SegsumLayout


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
    note_wait(2)  # the two bool masks' sizes
    return out.index_add_(0, segment_ids[keep].long(), data[keep])


def _spare_row_ids(segment_ids: torch.Tensor, num_segments: int):
    """int64 ids with every dropped id sent to the spare row
    ``num_segments``, which the caller slices off (no host sync)."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max per segment, ``[num_segments, *data.shape[1:]]`` of ``data``'s
    dtype; an empty segment holds the dtype's identity (``-inf`` for
    floats, the minimum for ints).  Same sentinel convention as
    ``segment_sum``."""
    n = int(num_segments)
    ident = (float("-inf") if data.dtype.is_floating_point
             else torch.iinfo(data.dtype).min)
    out = torch.full((n + 1, *data.shape[1:]), ident, dtype=data.dtype,
                     device=data.device)
    ids = _spare_row_ids(segment_ids, n)
    idx = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)[:n]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean per segment; an empty segment is exactly 0 (the count is
    clamped at 1, which changes nothing for a non-empty one).  Dropped
    ids join neither the sum nor the count."""
    n = int(num_segments)
    ids = _spare_row_ids(segment_ids, n)
    s = torch.zeros((n + 1, *data.shape[1:]), dtype=data.dtype,
                    device=data.device).index_add(0, ids, data)[:n]
    cnt = torch.zeros((n + 1,), dtype=s.dtype, device=data.device)
    cnt = cnt.index_add(0, ids, torch.ones_like(ids, dtype=s.dtype))[:n]
    cnt = cnt.clamp_min(1)
    return s / cnt.reshape(cnt.shape + (1,) * (s.dim() - 1))


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, *,
                    layout: Optional[SegsumLayout] = None) -> torch.Tensor:
    """Numerically stable softmax of ``scores`` (per edge, trailing dims
    arbitrary) over the edges of each segment.

    A segment's max that is not finite (an empty or all ``-inf``
    segment) is replaced by 0 and the denominator is clamped at 1e-9, so
    no NaN comes out; dropped ids join no denominator and their rows are
    the caller's to mask.  The max is taken without gradient: the
    softmax does not depend on the shift, so the gradient through it is
    zero up to rounding (the reference differentiates through
    ``jax.ops.segment_max``).

    With ``layout`` (a K4 layout over ``segment_ids``) the denominator is
    :func:`repro_torch.kernels.segsum.ops.segment_sum` — K4 on the card,
    its plain version on the CPU — over the scores flattened to
    ``[E, prod(trailing dims)]``; without one it is the plain sum."""
    n = int(num_segments)
    with torch.no_grad():
        seg_max = segment_max(scores, segment_ids, n)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              torch.zeros((), dtype=seg_max.dtype,
                                          device=seg_max.device))
    clipped = segment_ids.long().clamp(0, n - 1)
    exp = torch.exp(scores - seg_max.index_select(0, clipped))
    if layout is not None:
        flat = exp.reshape(exp.shape[0], -1)
        denom = segops.segment_sum(flat, None, n, layout=layout).reshape(
            (n, *exp.shape[1:])).to(exp.dtype)
    else:
        ids = _spare_row_ids(segment_ids, n)
        denom = torch.zeros((n + 1, *exp.shape[1:]), dtype=exp.dtype,
                            device=exp.device).index_add(0, ids, exp)[:n]
    denom = denom.clamp_min(1e-9)
    return exp / denom.index_select(0, clipped)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int, *,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` over flat multi-hot lookups: the rows of
    ``table`` at ``indices`` (clipped to the table), times the
    per-lookup ``weights`` when given, reduced by ``bag_ids`` into
    ``[num_bags, d]`` of the table's dtype.

    A lookup whose bag id is outside ``[0, num_bags)`` is dropped.
    ``"sum"`` is :func:`repro_torch.kernels.segsum.ops.segment_sum`: K4
    on a CUDA tensor, its plain version on the CPU; ``"mean"`` follows
    :func:`segment_mean` (an empty bag is exactly 0, a dropped lookup
    joins neither the sum nor the count); ``"max"`` is
    :func:`segment_max` (an empty bag holds ``-inf``).  The gradient of
    ``table`` is the gather's backward, an ``index_add_`` of the rows'
    gradients."""
    reduce = {"sum": lambda r, b, n: segops.segment_sum(r, b, n).to(
                  table.dtype),
              "mean": segment_mean, "max": segment_max}.get(mode)
    if reduce is None:
        raise ValueError(f"unknown mode {mode!r}")
    idx = indices.long().clamp(0, table.shape[0] - 1)
    rows = table.index_select(0, idx)
    if weights is not None:
        rows = rows * weights[:, None]
    return reduce(rows, bag_ids, num_bags)
