"""Wrapper of K1 (``csrc/intersect.cu``), the Hopper port of
``repro.kernels.intersect.intersect.intersect_pallas``.

:func:`intersect_levels` has the signature of its plain version
(:func:`~repro_torch.kernels.intersect.ref.intersect_levels_ref`).  On
CPU tensors it runs that plain version; on CUDA tensors it launches the
kernel on the current stream or raises — it never falls back.
``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.intersect.ref import intersect_levels_ref

#: number of times the CUDA kernel was launched in this process
LAUNCHES = 0

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import library

        fn = library("intersect").intersect_levels_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, p, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(flat, s_s, l_s, s_l, l_l, level, lev_u, d_cand, d_targ):
    ts = {"flat": flat, "s_s": s_s, "l_s": l_s, "s_l": s_l, "l_l": l_l,
          "level": level, "lev_u": lev_u}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32; got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D; got shape "
                             f"{tuple(t.shape)}")
    q = s_s.shape[0]
    for name in ("l_s", "s_l", "l_l", "lev_u"):
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
    return devs.pop()


def intersect_levels(flat, s_s, l_s, s_l, l_l, level, lev_u, *,
                     d_cand: int, d_targ: int):
    """Per-row ``(c1, c2)`` int32[Q]: candidates
    ``flat[s_s : s_s + min(l_s, d_cand)]`` found in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]``, split by whether
    ``level[cand]`` differs from (c1) or equals (c2) ``lev_u``.

    Every operand is a 1-D int32 tensor on one device."""
    global LAUNCHES
    dev = _check(flat, s_s, l_s, s_l, l_l, level, lev_u, d_cand, d_targ)
    if dev.type == "cpu":
        return intersect_levels_ref(
            flat, s_s, l_s, s_l, l_l, level, lev_u,
            d_cand=d_cand, d_targ=d_targ,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if level.shape[0] > 2**31 - 1 or flat.shape[0] > 2**31 - 1:
        raise ValueError("flat/level exceed int32 indexing")
    ops = [t.contiguous() for t in (flat, s_s, l_s, s_l, l_l, level, lev_u)]
    flat, s_s, l_s, s_l, l_l, level, lev_u = ops
    q = s_s.shape[0]
    c1 = torch.empty(q, dtype=torch.int32, device=dev)
    c2 = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0:
        return c1, c2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            flat.data_ptr(), s_s.data_ptr(), l_s.data_ptr(), s_l.data_ptr(),
            l_l.data_ptr(), level.data_ptr(), int(level.shape[0]),
            lev_u.data_ptr(), int(q), int(d_cand), int(d_targ),
            c1.data_ptr(), c2.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"intersect_levels launch failed: cudaError {err} "
            f"(q={q}, d_cand={d_cand}, d_targ={d_targ})"
        )
    LAUNCHES += 1
    return c1, c2
