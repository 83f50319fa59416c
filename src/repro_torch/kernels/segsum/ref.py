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


def segment_sum_chunked_ref(msgs: torch.Tensor, layout) -> torch.Tensor:
    """K4's order of sums in plain PyTorch, float32 ``[N, F]``.

    ``layout`` is a :class:`~repro_torch.kernels.segsum.segsum.SegsumLayout`
    over ``msgs``' rows.  Its sorted positions are cut into chunks of
    ``CHUNK``; each run of one segment inside a chunk is summed in
    position order; a segment inside one chunk is that sum, a crossing
    one the sum of its pieces in chunk order, an empty one zeros.  Every
    add is one float32 add in the kernel's order, so on the same operands
    this gives the kernel's bits."""
    from repro_torch.kernels.segsum.segsum import CHUNK, KIND_CROSSING

    n, e, f = layout.num_segments, layout.n_edges, msgs.shape[1]
    dev = msgs.device
    out = torch.zeros((n, f), dtype=torch.float32, device=dev)
    if e == 0 or n == 0:
        return out
    rows = msgs.to(torch.float32)
    seg = layout.sorted_seg.long()
    perm = layout.perm.long()
    pos = torch.arange(e, device=dev)
    starts = (pos % CHUNK == 0) | (seg != torch.roll(seg, 1))
    run = torch.cumsum(starts.long(), 0) - 1
    run_start = pos[starts]
    rank = pos - run_start[run]
    valid = seg < n
    acc = torch.zeros((run_start.numel(), f), dtype=torch.float32,
                      device=dev)
    for r in range(CHUNK):  # one add per run and rank, in position order
        sel = valid & (rank == r)
        acc[run[sel]] += rows[perm[sel]]
    run_seg = seg[run_start]
    live = run_seg < n
    crossing = torch.zeros_like(live)
    crossing[live] = layout.kind.long()[run_seg[live]] == KIND_CROSSING
    inside = live & ~crossing
    out[run_seg[inside]] = acc[inside]
    # the pieces of the crossing segments, by (chunk, slot): slot 0 for
    # the run that starts its chunk, 1 for the chunk's last run
    n_chunks = layout.n_chunks
    pieces = torch.zeros((n_chunks, 2, f), dtype=torch.float32, device=dev)
    slot = (run_start % CHUNK != 0).long()
    pieces[run_start[crossing] // CHUNK, slot[crossing]] = acc[crossing]
    cross = torch.nonzero(layout.kind.long() == KIND_CROSSING).flatten()
    if cross.numel():
        lo = layout.offsets[cross].long()
        hi = layout.offsets[cross + 1].long()
        c0, c1 = lo // CHUNK, (hi - 1) // CHUNK
        total = pieces[c0, (lo % CHUNK != 0).long()].clone()
        for j in range(1, int((c1 - c0).max()) + 1):
            more = c0 + j <= c1
            total[more] += pieces[(c0 + j)[more], 0]
        out[cross] = total
    return out
