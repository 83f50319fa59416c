"""Decoder-only transformer LM (llama / gemma3 families), the counterpart
of ``repro.models.transformer`` for serving: prefill into a KV cache, then
one-token decode steps.

* one ``nn.Module`` per layer, looped over in Python (the reference scans
  over stacked ``[L, ...]`` leaves; ``models/convert.py`` unstacks them);
* the per-layer window is ``LMConfig.layer_windows`` (gemma3's 5:1
  local:global pattern; ``None`` for a global layer, which sees every
  causal key, as the reference's window of the full length does);
* GQA, RoPE, RMSNorm, SwiGLU / GeGLU, weights ``[d_in, d_out]``;
* every attention call goes through
  :func:`repro_torch.kernels.flash_attention.ops.attention`: K5 on the
  card, its plain version on the CPU.  ``attn_impl`` "dense" and
  "chunked" name two XLA formulations of the same function in the
  reference and take the same path here;
* the KV cache is ``(k, v)``, each ``[L, B, T, Hkv, D]`` as in the
  reference, and a decode step writes its position in place rather than
  returning a new cache.

A config with ``moe`` raises ``NotImplementedError``: MoE layers come with
ROADMAP Queue 1 item 13.  The reference's sharding hint
(``distributed.constrain.maybe_constrain``) has no meaning on one card and
is dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    embed_init,
    glu_mlp,
    glu_mlp_init,
    rmsnorm,
    rope_freqs,
)

MOE_QUEUE = "ROADMAP Queue 1 item 13"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "silu"
    window: Optional[int] = None   # sliding window of local layers
    global_every: int = 0          # gemma3: every 6th layer global (5:1)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    qk_norm: bool = False
    tie_embeddings: bool = True
    moe: Optional[object] = None   # MoE layers are not ported yet
    dtype: str = "float32"
    attn_impl: str = "dense"       # "dense" | "chunked": the same function
    act_dtype: str = "float32"     # compute/activation dtype

    @property
    def layer_windows(self) -> list[int | None]:
        if self.window is None or self.global_every <= 0:
            return [self.window] * self.n_layers
        return [
            None if (i + 1) % self.global_every == 0 else self.window
            for i in range(self.n_layers)
        ]


def _check_config(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet ({MOE_QUEUE})")
    if cfg.attn_impl not in ("dense", "chunked"):
        raise ValueError(f"attn_impl must be 'dense' or 'chunked'; got "
                         f"{cfg.attn_impl!r}")
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"{cfg.n_heads} heads are not a multiple of "
                         f"{cfg.n_kv_heads} kv heads")


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype))


class Layer(nn.Module):
    """One decoder block's weights (reference: one slice of the stacked
    ``params["layers"]``)."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        d, hq = cfg.d_model, cfg.n_heads * cfg.d_head
        hk = cfg.n_kv_heads * cfg.d_head
        self.ln_attn = _param(d, dtype=dt)
        self.ln_mlp = _param(d, dtype=dt)
        self.wq = _param(d, hq, dtype=dt)
        self.wk = _param(d, hk, dtype=dt)
        self.wv = _param(d, hk, dtype=dt)
        self.wo = _param(hq, d, dtype=dt)
        if cfg.qk_norm:
            self.q_norm = _param(cfg.d_head, dtype=dt)
            self.k_norm = _param(cfg.d_head, dtype=dt)
        self.mlp = nn.ParameterDict({
            "w_gate": _param(d, cfg.d_ff, dtype=dt),
            "w_up": _param(d, cfg.d_ff, dtype=dt),
            "w_down": _param(cfg.d_ff, d, dtype=dt),
        })


class TransformerLM(nn.Module):
    """The LM's weights and its three entry points: :meth:`forward` (the
    whole sequence, no cache), :meth:`prefill` and :meth:`decode_step`.
    Built with zero weights; :func:`init_params` draws them and
    ``models/convert.py`` copies them from the reference."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.windows = cfg.layer_windows
        dt = getattr(torch, cfg.dtype)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.n_layers))
        self.embed = _param(cfg.vocab, cfg.d_model, dtype=dt)
        self.ln_final = _param(cfg.d_model, dtype=dt)
        self.register_parameter(
            "unembed", None if cfg.tie_embeddings
            else _param(cfg.vocab, cfg.d_model, dtype=dt))

    # ------------------------------------------------------------ pieces

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.embed.device)
        x = self.embed[tokens].to(getattr(torch, self.cfg.act_dtype))
        return x * (self.cfg.d_model ** 0.5)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.ln_final, eps=self.cfg.norm_eps)
        unembed = self.embed if self.unembed is None else self.unembed
        dt = torch.promote_types(x.dtype, unembed.dtype)
        return x.to(dt) @ unembed.to(dt).T

    def _rope(self, positions: torch.Tensor):
        """(cos, sin) [B, S, 1, D/2] of ``positions`` [B, S], shared by
        every layer."""
        cos, sin = rope_freqs(self.cfg.d_head, self.cfg.rope_theta, positions)
        return cos[:, :, None, :], sin[:, :, None, :]

    def _layer(self, i: int, x: torch.Tensor, *, rope, cache=None,
               cache_index: int = 0) -> torch.Tensor:
        cfg, lp = self.cfg, self.layers[i]
        b, s, _ = x.shape
        act = getattr(torch, cfg.act_dtype)

        def w(p):  # mixed precision: matrices in act_dtype, as the reference
            return p.to(act)

        h = rmsnorm(x, lp.ln_attn, eps=cfg.norm_eps)
        q = (h @ w(lp.wq)).view(b, s, cfg.n_heads, cfg.d_head)
        k = (h @ w(lp.wk)).view(b, s, cfg.n_kv_heads, cfg.d_head)
        v = (h @ w(lp.wv)).view(b, s, cfg.n_kv_heads, cfg.d_head)
        if cfg.qk_norm:
            q = rmsnorm(q, lp.q_norm, eps=cfg.norm_eps)
            k = rmsnorm(k, lp.k_norm, eps=cfg.norm_eps)
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
        kv_offset = 0
        if cache is not None:
            ck, cv = cache[0][i], cache[1][i]  # [B, T, Hkv, D]
            ck[:, cache_index:cache_index + s] = k
            cv[:, cache_index:cache_index + s] = v
            k, v, kv_offset = ck, cv, cache_index
        attn = attn_ops.attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=self.windows[i], kv_offset=kv_offset,
        )  # [B, Hq, S, D]
        attn = attn.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
        x = x + attn @ w(lp.wo)
        h = rmsnorm(x, lp.ln_mlp, eps=cfg.norm_eps)
        mlp = {name: w(p) for name, p in lp.mlp.items()}
        return x + glu_mlp(mlp, h, act=cfg.act)

    # ------------------------------------------------------------ entry points

    def forward(self, tokens: torch.Tensor):
        """tokens int[B, S] -> (logits f32[B, S, V], aux loss 0.0)."""
        x = self._embed(tokens)
        b, s, _ = x.shape
        rope = self._rope(torch.arange(s, device=x.device).expand(b, s))
        for i in range(self.cfg.n_layers):
            x = self._layer(i, x, rope=rope)
        return self._logits(x), 0.0

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int):
        """Run the prompt int[B, S]: (last-position logits [B, V], the
        cache ``(k, v)``, each [L, B, max_len, Hkv, D], filled to S)."""
        x = self._embed(tokens)
        b, s, _ = x.shape
        if not 0 < s <= max_len:
            raise ValueError(f"prompt length {s} must be in [1, {max_len}]")
        rope = self._rope(torch.arange(s, device=x.device).expand(b, s))
        cache = init_cache(self.cfg, b, max_len, x.dtype, x.device)
        for i in range(self.cfg.n_layers):
            x = self._layer(i, x, rope=rope, cache=cache, cache_index=0)
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache, token: torch.Tensor, index: int):
        """One token int[B, 1] at position ``index``: (logits [B, V], the
        cache with position ``index`` written, in place)."""
        x = self._embed(token)
        b = x.shape[0]
        t = cache[0].shape[2]
        index = int(index)
        if not 0 <= index < t:
            raise ValueError(f"decode position {index} is outside the "
                             f"cache of length {t}")
        rope = self._rope(torch.full((b, 1), index, dtype=torch.int32,
                                     device=x.device))
        for i in range(self.cfg.n_layers):
            x = self._layer(i, x, rope=rope, cache=cache, cache_index=index)
        return self._logits(x)[:, 0], cache


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.float32, device: str | torch.device = "cuda"):
    """An empty KV cache ``(k, v)``, each [L, batch, max_len, Hkv, D], on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


@torch.no_grad()
def init_params(cfg: LMConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> TransformerLM:
    """A model with random weights drawn from ``torch.Generator`` seeded
    with ``seed`` on the CPU (the reference's initialisers: ``dense_init``
    for matrices, ``embed_init`` for embeddings, zeros for norms), then
    moved to ``device`` — the same weights on every device."""
    dev = resolve_device(device)
    model = TransformerLM(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d, hq = cfg.d_model, cfg.n_heads * cfg.d_head
    hk = cfg.n_kv_heads * cfg.d_head
    for lp in model.layers:
        lp.wq.copy_(dense_init(gen, d, hq, dt))
        lp.wk.copy_(dense_init(gen, d, hk, dt))
        lp.wv.copy_(dense_init(gen, d, hk, dt))
        lp.wo.copy_(dense_init(gen, hq, d, dt))
        for name, val in glu_mlp_init(gen, d, cfg.d_ff, dt).items():
            lp.mlp[name].copy_(val)
    model.embed.copy_(embed_init(gen, cfg.vocab, d, dt))
    if model.unembed is not None:
        model.unembed.copy_(embed_init(gen, cfg.vocab, d, dt))
    return model.to(dev)
