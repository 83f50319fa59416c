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
"""
from __future__ import annotations

import ctypes

import torch

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
    "intersect_levels": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P,
                         _P],
    "intersect_hits": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "intersect_count": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
}
_FNS: dict = {}


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


def intersect_levels(flat, s_s, l_s, s_l, l_l, level, lev_u, *,
                     d_cand: int, d_targ: int):
    """Per-row ``(c1, c2)`` int32[Q]: candidates
    ``flat[s_s : s_s + min(l_s, d_cand)]`` found in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]``, split by whether
    ``level[cand]`` differs from (c1) or equals (c2) ``lev_u``.

    Every operand is a 1-D int32 tensor on one device."""
    dev = _check(d_cand, d_targ, ("l_s", "s_l", "l_l", "lev_u"),
                 flat=flat, s_s=s_s, l_s=l_s, s_l=s_l, l_l=l_l, level=level,
                 lev_u=lev_u)
    if dev.type == "cpu":
        return intersect_levels_ref(
            flat, s_s, l_s, s_l, l_l, level, lev_u,
            d_cand=d_cand, d_targ=d_targ,
        )
    flat, s_s, l_s, s_l, l_l, level, lev_u = (
        t.contiguous() for t in (flat, s_s, l_s, s_l, l_l, level, lev_u)
    )
    q = s_s.shape[0]
    c1 = torch.empty(q, dtype=torch.int32, device=dev)
    c2 = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0:
        return c1, c2
    _launch(
        "intersect_levels", dev,
        flat.data_ptr(), s_s.data_ptr(), l_s.data_ptr(), s_l.data_ptr(),
        l_l.data_ptr(), level.data_ptr(), int(level.shape[0]),
        lev_u.data_ptr(), int(q), int(d_cand), int(d_targ),
        c1.data_ptr(), c2.data_ptr(),
        shape=f"q={q}, d_cand={d_cand}, d_targ={d_targ}",
    )
    return c1, c2


def intersect_hits(flat, s_s, l_s, s_l, l_l, *, d_cand: int, d_targ: int):
    """Ragged membership mask ``(offsets int64[Q + 1], hits
    bool[offsets[-1]])``: row r's candidates ``flat[s_s : s_s + min(l_s,
    d_cand)]``, each marked found or not in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]``, at ``hits[offsets[r] + j]``.

    Every operand is a 1-D int32 tensor on one device.  On the card the
    output's size is read back before the launch (one sync)."""
    dev = _check(d_cand, d_targ, ("l_s", "s_l", "l_l"),
                 flat=flat, s_s=s_s, l_s=l_s, s_l=s_l, l_l=l_l)
    if dev.type == "cpu":
        return intersect_hits_ref(flat, s_s, l_s, s_l, l_l,
                                  d_cand=d_cand, d_targ=d_targ)
    flat, s_s, l_s, s_l, l_l = (
        t.contiguous() for t in (flat, s_s, l_s, s_l, l_l)
    )
    offsets = hit_offsets(l_s, d_cand=d_cand)
    hits = torch.empty(int(offsets[-1].item()), dtype=torch.bool,
                       device=dev)
    q = s_s.shape[0]
    if q == 0:
        return offsets, hits
    _launch(
        "intersect_hits", dev,
        flat.data_ptr(), s_s.data_ptr(), l_s.data_ptr(), s_l.data_ptr(),
        l_l.data_ptr(), offsets.data_ptr(), int(q), int(d_cand),
        int(d_targ), hits.data_ptr(),
        shape=f"q={q}, d_cand={d_cand}, d_targ={d_targ}, "
              f"cells={hits.shape[0]}",
    )
    return offsets, hits


def intersect_count(flat, s_s, l_s, s_l, l_l, *, d_cand: int, d_targ: int):
    """Per-row hit count int32[Q]: how many of the candidates
    ``flat[s_s : s_s + min(l_s, d_cand)]`` are found in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]`` — K1's ``c1 + c2`` without the
    level split.

    Every operand is a 1-D int32 tensor on one device."""
    dev = _check(d_cand, d_targ, ("l_s", "s_l", "l_l"),
                 flat=flat, s_s=s_s, l_s=l_s, s_l=s_l, l_l=l_l)
    if dev.type == "cpu":
        return intersect_count_ref(flat, s_s, l_s, s_l, l_l,
                                   d_cand=d_cand, d_targ=d_targ)
    flat, s_s, l_s, s_l, l_l = (
        t.contiguous() for t in (flat, s_s, l_s, s_l, l_l)
    )
    q = s_s.shape[0]
    cnt = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0:
        return cnt
    _launch(
        "intersect_count", dev,
        flat.data_ptr(), s_s.data_ptr(), l_s.data_ptr(), s_l.data_ptr(),
        l_l.data_ptr(), int(q), int(d_cand), int(d_targ), cnt.data_ptr(),
        shape=f"q={q}, d_cand={d_cand}, d_targ={d_targ}",
    )
    return cnt
