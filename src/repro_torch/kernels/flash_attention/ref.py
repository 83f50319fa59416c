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


def attention_split_ref(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,  # [B, Hkv, T, D]
    *,
    splits: tuple[int, int, int],
    causal: bool = True,
    window: int | None = None,
    kv_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """K5's decode order in plain PyTorch: the keys cut into ``splits``
    ``(start, length, count)`` (split i covers ``[start + i * length,
    start + (i + 1) * length)``; keys outside every split are not read),
    each split's running max, sum and float32 accumulator over its live
    keys, then the splits merged in order with the log-sum-exp rescale.
    An empty split has max -inf and sum 0 and adds nothing; a row with no
    live key is zeros, as in the kernel."""
    b, hq, s, d = q.shape
    t = k.shape[2]
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k) * scale
    qpos = torch.arange(s, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    start, length, count = splits
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    m_all = torch.full((b, hq, s), float("-inf"), device=q.device)
    l_all = torch.zeros((b, hq, s), device=q.device)
    o_all = torch.zeros((b, hq, s, d), device=q.device)
    for i in range(count):  # each split alone, then merged in order
        keys = (kpos >= start + i * length) & (kpos < start + (i + 1) * length)
        live = mask & keys
        part = torch.where(live, logits, neg_inf)
        m = part.amax(-1)
        ok = torch.isfinite(m)
        p = torch.where(live, torch.exp(part - torch.where(ok, m, 0)[..., None]),
                        0.0)
        l = p.sum(-1)
        o = torch.einsum("bhst,bhtd->bhsd", p, v)
        mx = torch.maximum(m_all, m)
        w_all = torch.where(torch.isfinite(m_all), torch.exp(m_all - mx), 0.0)
        w = torch.where(ok, torch.exp(m - mx), 0.0)
        l_all = l_all * w_all + l * w
        o_all = o_all * w_all[..., None] + o * w[..., None]
        m_all = mx
    out = o_all / l_all.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)
