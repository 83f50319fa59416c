"""Plain PyTorch attention: the masked softmax that K5 computes.

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref``, with
its mask semantics:

  causal:   q_pos >= k_pos           (q_pos = query index + kv_offset)
  window:   q_pos - k_pos < window   (sliding window, gemma3 local layers)

GQA: the query heads are a multiple of the KV heads, and query head h
reads KV head ``h // (Hq // Hkv)``.  The softmax is float32; the output
is in q's dtype.
"""
from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,  # [B, Hkv, T, D]
    *,
    causal: bool = True,
    window: int | None = None,
    kv_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    b, hq, s, d = q.shape
    t = k.shape[2]
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = probs.sum(-1, keepdim=True)
    out = torch.einsum("bhst,bhtd->bhsd", probs / denom.clamp_min(1e-30),
                       v.float())
    return out.to(q.dtype)
