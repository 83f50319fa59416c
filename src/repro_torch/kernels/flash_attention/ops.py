"""The attention entry point that the transformer calls.

Counterpart of ``repro.kernels.flash_attention.ops.attention`` without its
``use_pallas`` switch: a CUDA tensor goes to K5, a CPU tensor to the plain
version, and nothing else chooses.  A call that needs a gradient goes
through ``FlashAttention`` on either device, so its backward is K5's
backward on the card and the plain backward on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    kv_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Masked softmax attention, [B, Hq, S, D] in q's dtype (see
    :func:`~repro_torch.kernels.flash_attention.flash_attention.flash_attention`)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_offset=kv_offset, scale=scale)
