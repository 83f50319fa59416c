"""Plain PyTorch attention: the masked softmax that K5 computes.

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref``, with
its mask semantics:

  causal:   q_pos >= k_pos           (q_pos = query index + kv_offset)
  window:   q_pos - k_pos < window   (sliding window, gemma3 local layers)

GQA: the query heads are a multiple of the KV heads, and query head h
reads KV head ``h // (Hq // Hkv)``.  The softmax is float32 (float64 for
float64 inputs); the output is in q's dtype.

:func:`attention_bwd_ref` is the gradient of that function, written as
FlashAttention-2's backward step by step from the forward's output and
its log-sum-exp: the plain version of K5's backward.
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
    return_lse: bool = False,
):
    """Masked softmax attention, [B, Hq, S, D] in q's dtype; with
    ``return_lse`` also each query row's log-sum-exp of its scaled,
    masked scores, float32 [B, Hq, S] (float64 for float64 inputs;
    ``-inf`` for a row with no live key), as ``(out, lse)``."""
    b, hq, s, d = q.shape
    t = k.shape[2]
    rep = hq // k.shape[1]
    acc = _acc_dtype(q)
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(acc), k.to(acc)) * scale
    mask = attention_mask(s, t, causal=causal, window=window,
                          kv_offset=kv_offset, device=q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    probs = torch.exp(logits - m)
    denom = probs.sum(-1, keepdim=True)
    out = torch.einsum("bhst,bhtd->bhsd", probs / denom.clamp_min(1e-30),
                       v.to(acc)).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(denom))[..., 0]
    return out, lse


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def attention_mask(s: int, t: int, *, causal: bool, window: int | None,
                   kv_offset: int, device) -> torch.Tensor:
    """bool [S, T]: key t is visible to query row i (position i +
    kv_offset)."""
    qpos = torch.arange(s, device=device)[:, None] + kv_offset
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def attention_bwd_ref(
    q: torch.Tensor,     # [B, Hq, S, D]
    k: torch.Tensor,     # [B, Hkv, T, D]
    v: torch.Tensor,     # [B, Hkv, T, D]
    o: torch.Tensor,     # [B, Hq, S, D], the forward's output
    do: torch.Tensor,    # [B, Hq, S, D], the gradient of the output
    lse: torch.Tensor,   # float32 [B, Hq, S], the forward's log-sum-exp
    *,
    causal: bool = True,
    window: int | None = None,
    kv_offset: int = 0,
    scale: float | None = None,
):
    """``(dq, dk, dv)`` of :func:`attention_ref`, each in its input's
    dtype, by FlashAttention-2's backward (float32 sums; float64 for
    float64 inputs):

      P  = exp(S * scale - lse) on the visible keys, 0 elsewhere
      D  = rowsum(dO * O)
      dV = P^T dO
      dS = P * (dO V^T - D)
      dQ = dS K * scale
      dK = dS^T Q * scale

    GQA sums dK and dV over the ``Hq / Hkv`` query heads that share a kv
    head.  ``lse`` must be finite on every row (each row sees a key)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    acc = _acc_dtype(q)
    scale = scale if scale is not None else d ** -0.5
    qf, of, dof = q.to(acc), o.to(acc), do.to(acc)
    kf = k.to(acc).repeat_interleave(rep, dim=1)
    vf = v.to(acc).repeat_interleave(rep, dim=1)
    mask = attention_mask(s, t, causal=causal, window=window,
                          kv_offset=kv_offset, device=q.device)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    p = torch.where(mask, torch.exp(logits - lse.to(acc)[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dk = dk.view(b, hkv, rep, t, d).sum(2)
    dv = dv.view(b, hkv, rep, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    mask = attention_mask(s, t, causal=causal, window=window,
                          kv_offset=kv_offset, device=q.device)
    kpos = torch.arange(t, device=q.device)[None, :]
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
