"""Wrapper of K4 (``csrc/segsum.cu``), the Hopper port of
``repro.kernels.segsum.segsum.segment_sum_pallas``.

:class:`SegsumLayout` groups the edges by segment once per topology, on
the device the ids live on and with no host round trip (E and N are
known, so nothing reads a size back): ``perm``, the valid edge ids
stably sorted by segment, their segments ``sorted_seg``, ``offsets``
int32[N + 1], and ``kind``, which says for each segment what K4's second
pass does (``KIND_INSIDE``: its sum was written by the chunk pass;
``KIND_EMPTY``: zeros; ``KIND_CROSSING``: the sum of its pieces).  It
replaces the reference's host loop over node blocks and its padded tile
tables.

K4 cuts the sorted positions into chunks of ``CHUNK`` edges (a warp
each), so the work per warp does not depend on the skew; a segment that
crosses a chunk boundary leaves one float32 piece per chunk in scratch,
and a second launch adds them in chunk order.
:func:`~repro_torch.kernels.segsum.ref.segment_sum_chunked_ref` is that
order in plain PyTorch.

:func:`segment_sum_cuda` launches K4 on the current stream or raises; it
never falls back.  ``LAUNCHES`` counts its launches (one per call: the
chunk pass and the fix-up together), and nothing else, so a run can
show that its path went through the kernel.
:class:`SegmentSum` is the ``torch.autograd.Function`` around either
version: its backward is the plain gather ``d msgs[e] = d out[seg[e]]``
(0 for a dropped id), as autodiff of ``jax.ops.segment_sum`` is a gather
in the reference, which has no backward kernel either.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.segsum.ref import segment_sum_ref

#: kernel name -> number of times it was launched in this process
LAUNCHES = {"segment_sum": 0}

_DTYPES = (torch.float32, torch.bfloat16)
#: edges per chunk of K4's first pass (``kChunk`` in ``csrc/segsum.cu``)
CHUNK = 32

#: ``SegsumLayout.kind``: what K4's second pass does for a segment
KIND_INSIDE, KIND_EMPTY, KIND_CROSSING = 0, 1, 2

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P]
_FN: list = []


def _launcher():
    if not _FN:
        from repro_torch.kernels.build import library

        fn = library("segsum").segsum_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


class SegsumLayout:
    """The edges of ``seg_ids`` (int[E]) grouped by segment, built once
    per topology on ``seg_ids``' device and shared by every launch over
    it.

    Attributes: ``seg`` (the ids as given), ``valid`` bool[E] (id in
    ``[0, N)``), ``gather`` int64[E] (the id, 0 where dropped: the
    backward's gather index), ``perm`` int32[E] (valid edge ids stably
    sorted by segment, then the dropped ones, which no segment owns),
    ``sorted_seg`` int32[E] (the segment of each position of ``perm``,
    N where dropped), ``offsets`` int32[N + 1] (segment n owns
    ``perm[offsets[n] : offsets[n + 1]]``; ``offsets[N]`` is the valid
    count), ``kind`` int8[N] (``KIND_EMPTY`` for a segment without
    edges, ``KIND_CROSSING`` for one whose positions fall in more than
    one chunk of ``CHUNK``, else ``KIND_INSIDE``), and ``num_segments``,
    ``n_edges``, ``n_chunks`` (``ceil(E / CHUNK)``)."""

    def __init__(self, seg_ids: torch.Tensor, num_segments: int):
        n = int(num_segments)
        e = seg_ids.shape[0]
        if seg_ids.dim() != 1:
            raise ValueError(f"seg_ids must be 1-D; got shape "
                             f"{tuple(seg_ids.shape)}")
        if max(n, e) >= 2**31:
            raise ValueError(f"K4's layout is int32: N={n}, E={e}")
        seg = seg_ids.to(torch.int64)
        self.num_segments = n
        self.n_edges = e
        self.seg = seg_ids
        self.valid = (seg >= 0) & (seg < n)
        key = torch.where(self.valid, seg, n).to(torch.int32)
        self.gather = torch.where(self.valid, seg, 0)
        order = torch.sort(key, stable=True)
        self.perm = order.indices.to(torch.int32)
        self.sorted_seg = order.values
        self.n_chunks = -(-e // CHUNK)
        bounds = torch.arange(n + 1, dtype=torch.int32, device=key.device)
        self.offsets = torch.searchsorted(order.values, bounds,
                                          out_int32=True)
        lo, hi = self.offsets[:-1], self.offsets[1:]
        crossing = torch.div(lo, CHUNK, rounding_mode="floor") != torch.div(
            hi - 1, CHUNK, rounding_mode="floor")
        self.kind = torch.where(
            lo == hi, KIND_EMPTY,
            torch.where(crossing, KIND_CROSSING, KIND_INSIDE)).to(torch.int8)


def _check(msgs: torch.Tensor, layout: SegsumLayout) -> None:
    if not isinstance(msgs, torch.Tensor) or msgs.dim() != 2:
        raise ValueError("msgs must be a 2-D tensor [E, F]")
    if msgs.shape[0] != layout.n_edges:
        raise ValueError(f"msgs has {msgs.shape[0]} rows; the layout "
                         f"{layout.n_edges} edges")
    if msgs.device != layout.perm.device:
        raise ValueError(f"msgs on {msgs.device}, the layout on "
                         f"{layout.perm.device}")


def segment_sum_cuda(msgs: torch.Tensor,
                     layout: SegsumLayout) -> torch.Tensor:
    """K4: ``out[n] = sum(msgs[e] for e with seg[e] == n)``, float32
    ``[N, F]``, from CUDA ``msgs`` [E, F] (float32 or bfloat16, any
    strides) grouped by ``layout``: the chunk pass and the fix-up, on
    float32 scratch ``[n_chunks, 2, F]`` allocated here."""
    _check(msgs, layout)
    if msgs.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors; got {msgs.device}")
    if msgs.dtype not in _DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16; got {msgs.dtype}")
    n, f = layout.num_segments, msgs.shape[1]
    if f >= 2**31 or min(msgs.stride()) < 0:
        raise ValueError(f"K4 does not take F={f} or strides "
                         f"{msgs.stride()}")
    out = torch.empty((n, f), dtype=torch.float32, device=msgs.device)
    if n == 0 or f == 0:
        return out
    scratch = torch.empty((layout.n_chunks, 2, f), dtype=torch.float32,
                          device=msgs.device)
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        err = _launcher()(
            msgs.data_ptr(), layout.perm.data_ptr(),
            layout.sorted_seg.data_ptr(), layout.offsets.data_ptr(),
            layout.kind.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            layout.n_edges, n, f, msgs.stride(0), msgs.stride(1),
            int(msgs.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err} "
                           f"(N={n}, E={layout.n_edges}, F={f}, "
                           f"{msgs.dtype})")
    LAUNCHES["segment_sum"] += 1
    return out


class SegmentSum(torch.autograd.Function):
    """``out = segment_sum(msgs)`` by ``layout``, through K4 when
    ``kernel`` is true and through the plain version otherwise; the
    backward is the plain gather of ``d out`` at each valid edge's id."""

    @staticmethod
    def forward(ctx, msgs: torch.Tensor, layout: SegsumLayout,
                kernel: bool) -> torch.Tensor:
        _check(msgs, layout)
        ctx.layout = layout
        ctx.msgs_dtype = msgs.dtype
        if kernel:
            return segment_sum_cuda(msgs, layout)
        return segment_sum_ref(msgs, layout.seg, layout.num_segments)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        lay = ctx.layout
        if lay.num_segments == 0:  # every id dropped
            return (grad_out.new_zeros((lay.n_edges, grad_out.shape[1]),
                                       dtype=ctx.msgs_dtype), None, None)
        g = grad_out.index_select(0, lay.gather)
        g = torch.where(lay.valid[:, None], g, torch.zeros((), dtype=g.dtype,
                                                           device=g.device))
        return g.to(ctx.msgs_dtype), None, None
