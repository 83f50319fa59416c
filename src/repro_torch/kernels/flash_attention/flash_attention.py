"""Wrapper of K5 (``csrc/flash_attention.cu``), the Hopper port of
``repro.kernels.flash_attention.flash_attention.flash_attention``.

:func:`flash_attention` has the signature of its plain version,
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`.  On CPU
tensors it runs that plain version; on CUDA tensors it launches the kernel
on the current stream or raises — it never falls back.  ``LAUNCHES``
counts the kernel's launches (and nothing else), so a run can show that
its path went through the kernel.

The kernel reads each operand through its batch, head and sequence
strides, so ``[B, H, S, D]`` views of ``[B, S, H, D]`` tensors (the
transformer's q and KV cache) are taken as they are.  The output is the
``[B, Hq, S, D]`` view of a ``[B, S, Hq, D]`` buffer, so the transformer's
transpose back is free.

A prefill (S > 1) is one launch (float32 on the CUDA cores' FMA, bf16 on
the tensor cores).  A decode step (S = 1) is two: the live keys are cut into splits
(:func:`decode_splits`, planned here from ``kv_offset`` and ``window``,
which are host ints), each split's blocks write float32 parts to
scratch allocated here, and a second launch merges them in order;
:func:`~repro_torch.kernels.flash_attention.ref.attention_split_ref` is
that split-then-combine in plain PyTorch.  Either is one call and one
count in ``LAUNCHES``.

Training: when a gradient is wanted (grad mode on and q, k or v requires
grad), :func:`flash_attention` goes through :class:`FlashAttention`, whose
forward asks the prefill launch for each row's log-sum-exp and whose
backward is K5's backward (``csrc/flash_attention_bwd.cu``, launched by
:func:`flash_attention_bwd`: three launches, one count in
``LAUNCHES["flash_attention_bwd"]``) on the card, or
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref` on the
CPU.  The backward takes S = T and ``kv_offset`` 0 (training never
decodes).  Without a gradient the launch is the serving one, with no
log-sum-exp.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_ref,
)

#: kernel name -> number of times it was launched in this process
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

#: head widths the kernel is instantiated for
HEAD_DIMS = (16, 32, 48, 64, 128, 256)

#: the decode kernel's shape (``Decode`` in ``csrc/flash_attention.cu``):
#: keys per staged tile by head width, query heads and warps per block
DECODE_TILE_KEYS = {16: 64, 32: 64, 48: 64, 64: 64, 128: 32, 256: 16}
DECODE_ROWS = 4
DECODE_WARPS = 2

#: decode blocks the split planner aims at: two per SM of an H100 (132)
DECODE_TARGET_BLOCKS = 2 * 132

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, *([_L] * 12), *([_I] * 10), ctypes.c_float,
             _I, _I, _I, _P, _P, _P]
_BWD_ARGTYPES = [*([_P] * 10), *([_L] * 24), *([_I] * 8), ctypes.c_float,
                 _P]
_FN: dict = {}


def _launcher(bwd: bool = False):
    key = "flash_attention_bwd" if bwd else "flash_attention"
    if key not in _FN:
        from repro_torch.kernels.build import library

        fn = getattr(library(key), f"{key}_launch")
        fn.argtypes = _BWD_ARGTYPES if bwd else _ARGTYPES
        fn.restype = ctypes.c_int
        _FN[key] = fn
    return _FN[key]


def _check(q, k, v, window) -> None:
    """Validate what both versions take: ``q`` [B, Hq, S, D] and ``k``,
    ``v`` [B, Hkv, T, D] of one dtype on one device, Hkv dividing Hq."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D; got shape "
                             f"{tuple(t.shape)}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be [{b}, Hkv, T, {d}]; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v must share a device; got {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1; got {window}")


def check_kernel_operands(q, k, v) -> None:
    """Raise on what the kernel does not take, whatever the device: a head
    width outside ``HEAD_DIMS``, a dtype other than float32 or bfloat16,
    or sizes past its int32 grid and row arithmetic."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"K5 is built for head widths {HEAD_DIMS}; got "
                         f"{d}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"K5 takes float32 or bfloat16; got {q.dtype}")
    row_tiles = -(-(hq // hkv) // DECODE_ROWS)
    if (b > 65535 or hkv * row_tiles > 65535 or s * hq >= 2**31
            or t >= 2**31):
        raise ValueError(f"K5's grid does not cover B={b}, Hkv={hkv}, "
                         f"S*Hq={s * hq}, T={t}")


def decode_splits(t_len: int, kv_offset: int, *, causal: bool,
                  window: int | None, units: int, d: int
                  ) -> tuple[int, int, int]:
    """How a decode step's live keys are cut: ``(start, length, count)``,
    split i covering keys ``[start + i * length, start + (i + 1) *
    length)`` (clipped to the live range by the kernel).

    The live keys of position ``kv_offset`` are ``[lo, hi)``: from the
    window's edge to the causal frontier.  ``start`` is ``lo`` rounded
    down to a tile of ``DECODE_TILE_KEYS[d]`` keys, ``length`` a whole
    number of tiles, and ``count`` the fewest splits of that length that
    cover the range while ``units * count`` (``units``: the blocks per
    split, batch x kv heads x head tiles) reaches
    ``DECODE_TARGET_BLOCKS`` where the range has enough tiles.  An empty
    range is one split that writes zeros."""
    tile = DECODE_TILE_KEYS[d]
    lo = max(0, kv_offset - window + 1) if window else 0
    hi = min(t_len, kv_offset + 1) if causal else t_len
    if hi <= lo:
        return 0, tile, 1
    start = lo - lo % tile
    tiles = -(-(hi - start) // tile)
    want = max(1, -(-DECODE_TARGET_BLOCKS // max(units, 1)))
    per = -(-tiles // min(tiles, want))
    return start, per * tile, -(-tiles // per)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides (head
    dim contiguous, the rest and the base aligned to 16 bytes, as its
    16-byte copies need); otherwise an aligned contiguous copy."""
    per = 16 // t.element_size()
    ok = (t.stride(3) == 1
          and all(t.stride(i) % per == 0 for i in range(3))
          and t.data_ptr() % 16 == 0)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    kv_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Masked softmax attention, [B, Hq, S, D] in q's dtype: query row i
    sits at position ``i + kv_offset`` and sees key t when ``t <= pos``
    (``causal``) and ``pos - t < window`` (when given).  ``kv_offset`` and
    ``window`` are plain run-time ints: a decode step's position changes
    every step and rebuilds nothing.  Differentiable through
    :class:`FlashAttention` when grad mode is on and q, k or v requires
    grad."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, kv_offset,
                                    scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               kv_offset=kv_offset, scale=scale)[0]


class FlashAttention(torch.autograd.Function):
    """K5 with its gradient: the forward saves q, k, v, the output and
    each row's log-sum-exp; the backward is :func:`flash_attention_bwd`
    (K5's backward on the card, its plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_offset, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, kv_offset=kv_offset,
                                       scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, kv_offset=kv_offset,
                      scale=scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, grad_out, lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_fwd(q, k, v, *, causal=True, window=None, kv_offset=0,
                        scale=None, with_lse=False):
    """``(out, lse)`` with no autograd: the plain version on CPU tensors,
    else one K5 launch; ``lse``, each row's log-sum-exp (float32
    [B, Hq, S]), only when ``with_lse`` (a prefill launch that also
    writes it; S = T and ``kv_offset`` 0, as the backward needs), else
    None."""
    if q.device.type == "cpu":
        res = attention_ref(q, k, v, causal=causal, window=window,
                            kv_offset=kv_offset, scale=scale,
                            return_lse=with_lse)
        return res if with_lse else (res, None)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_kernel_operands(q, k, v)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if with_lse:
        check_backward_operands(q, k, kv_offset)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or s == 0:
        return out, lse
    scale = scale if scale is not None else d ** -0.5
    split, part = (0, 0, 0), None
    if s == 1 and not with_lse:
        units = b * hkv * -(-(hq // hkv) // DECODE_ROWS)
        split = decode_splits(t, int(kv_offset), causal=causal,
                              window=window, units=units, d=d)
        part = torch.empty((b * hq, split[2] * DECODE_WARPS, d + 2),
                           dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, hq, hkv, s, t, d,
            int(q.dtype == torch.bfloat16), int(causal),
            0 if window is None else int(window), int(kv_offset),
            float(scale), *split, 0 if part is None else part.data_ptr(),
            0 if lse is None else lse.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: cudaError {err} (B={b}, "
            f"Hq={hq}, Hkv={hkv}, S={s}, T={t}, D={d}, {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def check_backward_operands(q, k, kv_offset: int) -> None:
    """Raise on what K5's backward does not take: S != T or a
    ``kv_offset``.  At S = T with ``kv_offset`` 0 every query row sees at
    least its own key, so no row's log-sum-exp is empty."""
    s, t = q.shape[2], k.shape[2]
    if s != t or int(kv_offset) != 0:
        raise ValueError(f"K5's backward takes S = T and kv_offset 0 (a "
                         f"training forward); got S={s}, T={t}, "
                         f"kv_offset={kv_offset}")


def flash_attention_bwd(
    q: torch.Tensor,     # [B, Hq, S, D]
    k: torch.Tensor,     # [B, Hkv, T, D]
    v: torch.Tensor,
    o: torch.Tensor,     # [B, Hq, S, D], the forward's output
    do: torch.Tensor,    # [B, Hq, S, D], its gradient
    lse: torch.Tensor,   # float32 [B, Hq, S], the forward's log-sum-exp
    *,
    causal: bool = True,
    window: int | None = None,
    kv_offset: int = 0,
    scale: float | None = None,
):
    """``(dq, dk, dv)`` of :func:`flash_attention`, each in its input's
    dtype: :func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`
    on CPU tensors; on CUDA tensors K5's backward (three launches, one
    count) or an error.  ``dq`` is the ``[B, Hq, S, D]`` view of a
    ``[B, S, Hq, D]`` buffer, ``dk`` and ``dv`` of ``[B, T, Hkv, D]``
    ones, the layouts the transformer's projections come from."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                 window=window, kv_offset=kv_offset,
                                 scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_kernel_operands(q, k, v)
    check_backward_operands(q, k, kv_offset)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be like q {tuple(q.shape)} "
                             f"{q.dtype}; got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{b}, {hq}, {s}]; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    q, k, v, o, do = (_aligned(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    dq = torch.empty((b, s, hq, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    if b == 0 or s == 0:
        return dq, dk, dv
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else d ** -0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(bwd=True)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3],
            b, hq, hkv, s, d, int(q.dtype == torch.bfloat16), int(causal),
            0 if window is None else int(window), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: cudaError {err} (B={b}, "
            f"Hq={hq}, Hkv={hkv}, S={s}, D={d}, {q.dtype})")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
