"""Wrappers of K1, K2 and K3 (``csrc/intersect.cu``), the Hopper ports of
``repro.kernels.intersect.intersect.intersect_pallas``,
``intersect_pallas_hits`` and ``intersect_pallas_count``.

:func:`intersect_levels`, :func:`intersect_hits` and
:func:`intersect_count` have the signatures of their plain versions
(:func:`~repro_torch.kernels.intersect.ref.intersect_levels_ref`,
:func:`~repro_torch.kernels.intersect.ref.intersect_hits_ref`,
:func:`~repro_torch.kernels.intersect.ref.intersect_count_ref`).  On
CPU tensors they run that plain version; on CUDA tensors they launch
the kernel on the current stream or raise — they never fall back.
``LAUNCHES`` counts each kernel's launches (and nothing else), so a run
can show which kernel its path went through.

K1 and K2 choose by the call's shape: a bucket no wider than
``WALK_MAX_CAND``, or a call of fewer than ``BITMAP_MIN_ROWS`` rows,
keeps the row walk (a binary search of the target) on every row; a
wider and longer one builds an :class:`ItemLayout`, on the operands'
device with plain torch ops and no read-back (the live rows stably
sorted by target and cut into work items of whole rows), and every live
row goes to the bitmap kernel (an item's target read once into a bitmap
in shared memory, one lookup a candidate).  ``path="bitmap"`` or
``"walk"`` forces one side on any bucket (:func:`item_layout`).
:func:`~repro_torch.kernels.intersect.ref.probe_items_ref` is the item
walk in plain PyTorch.

K3 chooses among three kernels (:func:`count_path`): the row walk on a
bucket no wider than ``WALK_MAX_CAND``, the bitmap items on a wider
call of at least ``COUNT_BITMAP_MIN_ROWS`` rows, and on any other call
(a stream probe's) a walk balanced by the rows' own lengths: the call's
clamped candidate cells cut into tiles of ``COUNT_TILE`` by their
running sum (the launch's own, in the wrapper's scratch), whatever rows
they fall in.  ``path`` forces any of the three (``COUNT_PATHS``).
:func:`~repro_torch.kernels.intersect.ref.count_tiles_ref` is that walk
in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hostio import note_read_back
from repro_torch.kernels.intersect.ref import (
    hit_offsets,
    intersect_count_ref,
    intersect_hits_ref,
    intersect_levels_ref,
)

#: kernel name -> number of times it was launched in this process
LAUNCHES = {"intersect_levels": 0, "intersect_hits": 0, "intersect_count": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "intersect_levels": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                         _I, _I, _P, _P, _P],
    "intersect_hits": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                       _P],
    "intersect_count": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _P, _P],
}
_FNS: dict = {}

#: most candidate cells in one work item of several rows
ITEM_CELLS = 1 << 18
#: most rows in one work item (``kItemRows`` in ``csrc/intersect.cu``)
ITEM_ROWS = 512
#: 32-bit words of the bitmap kernel's shared memory (``kBitmapWords``):
#: one window covers ``BITMAP_WORDS * 32`` ids
BITMAP_WORDS = 53248
#: widest bucket whose rows all take the row walk, with no layout
WALK_MAX_CAND = 256
#: fewest rows of a call that builds a layout: its ~70 queued torch ops
#: cost the host more than the walk of a shorter call takes
BITMAP_MIN_ROWS = 1 << 12
#: K3's fewest rows of a call wider than ``WALK_MAX_CAND`` that takes the
#: bitmap (fewer take the tiles).  Set by ``chip_smoke.py`` on one H100
#: (700 W): the 32,768-row delete probes of a 65,536-update stream buffer
#: take ~0.24 ms of device time on the tiles against ~0.9 on the bitmap
#: (its layout ~1.2-1.5 ms host-paced), RMAT scale 20's 2,921,462-row
#: wide bucket ~56 ms on the tiles against ~10 on the bitmap
COUNT_BITMAP_MIN_ROWS = 1 << 16
#: candidate cells of one tile of K3's tiles (``kTile``: 6 a lane)
COUNT_TILE = 192
#: rows of one chunk of K3's running sum (``kScanRows``): its scratch
#: holds the sum and one total a chunk
COUNT_SCAN_ROWS = 2048
PATHS = ("auto", "bitmap", "walk")
#: K3's paths: K1's and K2's, and its tiles
COUNT_PATHS = PATHS + ("tiles",)

_DEAD = 2**31 - 1  # sort key of a row with no candidates


class ItemLayout:
    """The work of one K1 or K2 call on the bitmap kernel: its live rows
    (``min(l_s, d_cand) > 0``) stably sorted by target ``(s_l, min(l_l,
    d_targ))`` and cut into items.

    The kernel reads a row's candidates in 16-byte groups aligned in
    memory: with ``F = s_s + align`` (``align``, the flat pointer's
    offset from 16 bytes in ints), a row of ``l`` candidates spans
    ``(F % 4 + l + 3) // 4`` groups.  A run of one target is cut into
    items of whole rows: at most ``ITEM_CELLS`` cells (counted as 4 a
    group) and ``ITEM_ROWS`` rows each, a row that crosses a multiple of
    ``ITEM_CELLS`` of its run an item of its own.

    Attributes (on the operands' device, nothing read back): ``perm``
    int32[Q] (the live rows, then the dead ones), ``cum`` int64[Q + 1]
    (groups before each position), ``item_start`` int32[Q + 1] (item i
    owns ``perm[item_start[i] : item_start[i + 1]]`` for i below the item
    count), ``n_items`` int32[1]."""

    def __init__(self, s_s, l_s, s_l, l_l, *, d_cand: int, d_targ: int,
                 align: int = 0):
        q = l_s.shape[0]
        dev = l_s.device
        ls = l_s.clamp(0, max(0, int(d_cand)))
        # an int32 key sorts in half the passes of an int64 one; a run of
        # one s_l whose clamped l_l changes is cut where it changes, so a
        # run (and an item) has one target on any operands
        key = torch.where(ls > 0, s_l.clamp(max=_DEAD - 1), _DEAD)
        key, order = torch.sort(key, stable=True)
        lso = ls[order]
        llo = l_l[order].clamp(0, max(0, int(d_targ)))
        live = key != _DEAD  # a prefix: the dead rows sort last
        # 16-byte groups a row spans (only the live rows' are read)
        groups = ((((s_s[order] & 3) + align) & 3) + lso + 3) >> 2
        pos = torch.arange(q, device=dev)
        first = torch.ones(q, dtype=torch.bool, device=dev)
        first[1:] = (key.diff() != 0) | (llo.diff() != 0)
        gid = torch.cumsum(first, 0)
        gstart = torch.searchsorted(gid, gid)
        # item cuts within each run, by its groups and rows
        self.cum = _exclusive_cumsum(groups)
        a = self.cum[:-1] - self.cum[gstart]
        shift = (ITEM_CELLS // 4).bit_length() - 1  # a power of two
        blk = a >> shift
        cross = live & (blk != (a + groups - 1) >> shift)
        blk += ((pos - gstart) // ITEM_ROWS) << 40  # and by rows
        cut = first | cross
        cut[1:] |= cross[:-1] | (blk.diff() != 0)
        new_item = cut & live
        self.perm = order.to(torch.int32)
        item = torch.where(live, torch.cumsum(new_item, 0) - 1, q + 1)
        self.item_start = torch.searchsorted(
            item, torch.arange(q + 1, device=dev), out_int32=True)
        self.n_items = new_item.sum().to(torch.int32).reshape(1)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(x, 0, dtype=torch.int64, out=out[1:])
    return out


def _launcher(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("intersect"), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(name: str, dev: torch.device, *args, shape: str) -> None:
    """Launch kernel ``name`` on ``dev``'s current stream; raise on a
    refused launch, count an accepted one."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({shape})")
    LAUNCHES[name] += 1


def _check(d_cand, d_targ, per_row, **ts) -> torch.device:
    """Validate the 1-D int32 operands ``ts`` (the ``per_row`` ones
    share ``s_s``'s row count) and the widths; return their one
    device."""
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32; got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D; got shape "
                             f"{tuple(t.shape)}")
    q = ts["s_s"].shape[0]
    for name in per_row:
        if ts[name].shape[0] != q:
            raise ValueError(
                f"{name} has {ts[name].shape[0]} rows; s_s has {q}"
            )
    devs = {t.device for t in ts.values()}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device; got {devs}")
    if int(d_cand) < 0 or int(d_targ) < 0:
        raise ValueError(f"d_cand/d_targ must be >= 0; got {d_cand}, "
                         f"{d_targ}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and max(t.shape[0] for t in ts.values()) >= 2**31:
        raise ValueError("operands exceed int32 indexing")
    return dev


def item_layout(s_s, l_s, s_l, l_l, *, d_cand: int, d_targ: int,
                path: str = "auto", align: int = 0,
                min_rows: int | None = None):
    """The :class:`ItemLayout` of a K1, K2 or K3 call, or None where
    every row takes the row walk: ``path="walk"``, or ``"auto"`` on a
    bucket no wider than ``WALK_MAX_CAND`` or of fewer than ``min_rows``
    rows (default ``BITMAP_MIN_ROWS``; K3 passes
    ``COUNT_BITMAP_MIN_ROWS``)."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}; got {path!r}")
    if int(d_cand) >= 2**31 or int(d_targ) >= 2**31:
        raise ValueError(f"d_cand/d_targ exceed int32: {d_cand}, {d_targ}")
    if min_rows is None:
        min_rows = BITMAP_MIN_ROWS
    if path == "walk" or (path == "auto" and (
            d_cand <= WALK_MAX_CAND or s_s.shape[0] < min_rows)):
        return None
    return ItemLayout(s_s, l_s, s_l, l_l, d_cand=d_cand, d_targ=d_targ,
                      align=align)


def count_path(q: int, d_cand: int, path: str = "auto") -> str:
    """The kernel that a K3 call of ``q`` rows and width ``d_cand`` runs:
    ``path`` where it is forced, else by shape ``"walk"`` (a warp per
    row) up to ``WALK_MAX_CAND``, ``"bitmap"`` from
    ``COUNT_BITMAP_MIN_ROWS`` rows, ``"tiles"`` between."""
    if path not in COUNT_PATHS:
        raise ValueError(f"path must be one of {COUNT_PATHS}; got {path!r}")
    if path != "auto":
        return path
    if d_cand <= WALK_MAX_CAND:
        return "walk"
    return "bitmap" if q >= COUNT_BITMAP_MIN_ROWS else "tiles"


def _align(flat: torch.Tensor) -> int:
    """``flat``'s offset from a 16-byte boundary, in int32s."""
    return flat.data_ptr() // 4 % 4


def _layout_ptrs(lay) -> tuple:
    if lay is None:
        return None, None, None, None
    return (lay.perm.data_ptr(), lay.cum.data_ptr(),
            lay.item_start.data_ptr(), lay.n_items.data_ptr())


def intersect_levels(flat, s_s, l_s, s_l, l_l, level, lev_u, *,
                     d_cand: int, d_targ: int, path: str = "auto"):
    """Per-row ``(c1, c2)`` int32[Q]: candidates
    ``flat[s_s : s_s + min(l_s, d_cand)]`` found in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]``, split by whether
    ``level[cand]`` differs from (c1) or equals (c2) ``lev_u``.

    Every operand is a 1-D int32 tensor on one device.  On the card
    ``path`` chooses the kernel (:func:`item_layout`); the result does
    not depend on it."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}; got {path!r}")
    dev = _check(d_cand, d_targ, ("l_s", "s_l", "l_l", "lev_u"),
                 flat=flat, s_s=s_s, l_s=l_s, s_l=s_l, l_l=l_l, level=level,
                 lev_u=lev_u)
    if dev.type == "cpu":
        return intersect_levels_ref(
            flat, s_s, l_s, s_l, l_l, level, lev_u,
            d_cand=d_cand, d_targ=d_targ,
        )
    ts = dict(zip(("flat", "s_s", "l_s", "s_l", "l_l", "level", "lev_u"), (
        t.contiguous() for t in (flat, s_s, l_s, s_l, l_l, level, lev_u))))
    q = s_s.shape[0]
    c1 = torch.zeros(q, dtype=torch.int32, device=dev)
    c2 = torch.zeros(q, dtype=torch.int32, device=dev)
    if q == 0:
        return c1, c2
    lay = item_layout(ts["s_s"], ts["l_s"], ts["s_l"], ts["l_l"],
                      d_cand=d_cand, d_targ=d_targ, path=path,
                      align=_align(ts["flat"]))
    _launch(
        "intersect_levels", dev,
        *(ts[k].data_ptr() for k in ("flat", "s_s", "l_s", "s_l", "l_l",
                                     "level")),
        int(level.shape[0]), ts["lev_u"].data_ptr(), *_layout_ptrs(lay),
        int(q), int(d_cand), int(d_targ), c1.data_ptr(), c2.data_ptr(),
        shape=f"q={q}, d_cand={d_cand}, d_targ={d_targ}, path={path}",
    )
    return c1, c2


def intersect_hits(flat, s_s, l_s, s_l, l_l, *, d_cand: int, d_targ: int,
                   path: str = "auto"):
    """Ragged membership mask ``(offsets int64[Q + 1], hits
    bool[offsets[-1]])``: row r's candidates ``flat[s_s : s_s + min(l_s,
    d_cand)]``, each marked found or not in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]``, at ``hits[offsets[r] + j]``.

    Every operand is a 1-D int32 tensor on one device.  On the card the
    output's size is read back before the launch (one wait, on its copy
    alone), and ``path`` chooses the kernel as for
    :func:`intersect_levels`."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}; got {path!r}")
    dev = _check(d_cand, d_targ, ("l_s", "s_l", "l_l"),
                 flat=flat, s_s=s_s, l_s=l_s, s_l=s_l, l_l=l_l)
    if dev.type == "cpu":
        return intersect_hits_ref(flat, s_s, l_s, s_l, l_l,
                                  d_cand=d_cand, d_targ=d_targ)
    ts = dict(zip(("flat", "s_s", "l_s", "s_l", "l_l"), (
        t.contiguous() for t in (flat, s_s, l_s, s_l, l_l))))
    q = s_s.shape[0]
    offsets = hit_offsets(ts["l_s"], d_cand=d_cand)
    # the size's read-back waits on its own copy only: the layout, queued
    # behind it, keeps the card busy while the host waits
    size = torch.empty(1, dtype=torch.int64, pin_memory=True)
    with torch.cuda.device(dev):
        size.copy_(offsets[-1:], non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
    lay = item_layout(ts["s_s"], ts["l_s"], ts["s_l"], ts["l_l"],
                      d_cand=d_cand, d_targ=d_targ, path=path,
                      align=_align(ts["flat"])) if q else None
    copied.synchronize()
    note_read_back(size)
    hits = torch.empty(int(size[0]), dtype=torch.bool, device=dev)
    if q == 0:
        return offsets, hits
    _launch(
        "intersect_hits", dev,
        *(ts[k].data_ptr() for k in ("flat", "s_s", "l_s", "s_l", "l_l")),
        offsets.data_ptr(), *_layout_ptrs(lay), int(q),
        int(d_cand), int(d_targ), hits.data_ptr(),
        shape=f"q={q}, d_cand={d_cand}, d_targ={d_targ}, "
              f"cells={hits.shape[0]}, path={path}",
    )
    return offsets, hits


def intersect_count(flat, s_s, l_s, s_l, l_l, *, d_cand: int, d_targ: int,
                    path: str = "auto"):
    """Per-row hit count int32[Q]: how many of the candidates
    ``flat[s_s : s_s + min(l_s, d_cand)]`` are found in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]`` — K1's ``c1 + c2`` without the
    level split.

    Every operand is a 1-D int32 tensor on one device.  On the card
    ``path`` chooses the kernel (:func:`count_path`); the result does not
    depend on it.  One call is one launch (the bitmap's: its layout's
    torch ops, a memset and the items); the tiles' scratch comes from
    ``torch.empty``."""
    if path not in COUNT_PATHS:
        raise ValueError(f"path must be one of {COUNT_PATHS}; got {path!r}")
    dev = _check(d_cand, d_targ, ("l_s", "s_l", "l_l"),
                 flat=flat, s_s=s_s, l_s=l_s, s_l=s_l, l_l=l_l)
    if dev.type == "cpu":
        return intersect_count_ref(flat, s_s, l_s, s_l, l_l,
                                   d_cand=d_cand, d_targ=d_targ)
    ts = dict(zip(("flat", "s_s", "l_s", "s_l", "l_l"), (
        t.contiguous() for t in (flat, s_s, l_s, s_l, l_l))))
    q = s_s.shape[0]
    cnt = torch.empty(q, dtype=torch.int32, device=dev)  # zeroed on the card
    if q == 0:
        return cnt
    which = count_path(q, d_cand, path)
    lay = item_layout(ts["s_s"], ts["l_s"], ts["s_l"], ts["l_l"],
                      d_cand=d_cand, d_targ=d_targ,
                      path="bitmap" if which == "bitmap" else "walk",
                      align=_align(ts["flat"]))
    scratch = None if which != "tiles" else torch.empty(
        q + -(-q // COUNT_SCAN_ROWS), dtype=torch.int64, device=dev)
    _launch(
        "intersect_count", dev,
        *(ts[k].data_ptr() for k in ("flat", "s_s", "l_s", "s_l", "l_l")),
        None if scratch is None else scratch.data_ptr(), *_layout_ptrs(lay),
        int(q), int(d_cand), int(d_targ), cnt.data_ptr(),
        shape=f"q={q}, d_cand={d_cand}, d_targ={d_targ}, path={which}",
    )
    return cnt
