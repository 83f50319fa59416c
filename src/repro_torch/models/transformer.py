"""Decoder-only transformer LM (llama / gemma3 families, and the MoE LMs
qwen2-moe and phi3.5-moe), the counterpart of ``repro.models.transformer``:
training (``forward`` and ``loss_fn``) and serving (prefill into a KV
cache, then one-token decode steps).

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
  reference and take the same path here.  Under a gradient the call is
  differentiable through K5's backward (on the card) or the plain
  backward (on the CPU);
* a config with ``moe`` replaces each layer's GLU by
  :func:`repro_torch.models.moe.moe_ffn` (its combine on K4), and
  ``forward`` sums the layers' aux losses, as the reference's scan does;
* ``remat="block"`` (the reference's default) recomputes each layer in
  the backward (``torch.utils.checkpoint``, non-reentrant), as the
  reference's ``jax.checkpoint`` of the scanned block: a training step
  then runs each layer's K5 forward twice;
* the KV cache is ``(k, v)``, each ``[L, B, T, Hkv, D]`` as in the
  reference, and a decode step writes its position in place rather than
  returning a new cache.

The reference's sharding hint (``distributed.constrain.maybe_constrain``)
stays at its call site and returns its input: eager PyTorch has no
partitioner to pin a layout for.  A MoE config with ``dispatch="a2a"``
under ``distributed/constrain.py:use_mesh`` runs its MoE layers on
``models/moe_a2a.py``'s explicit expert parallelism.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.constrain import maybe_constrain
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    draw_parallel,
    embed_init,
    glu_mlp,
    rmsnorm,
    rope_freqs,
    softmax_xent,
)
from repro_torch.models.moe import MoE, MoEConfig, moe_ffn, moe_init_tasks


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
    moe: Optional[MoEConfig] = None
    dtype: str = "float32"
    remat: str = "block"           # "block" | "none": recompute per layer
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

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq = self.n_heads * self.d_head
        hk = self.n_kv_heads * self.d_head
        attn = d * hq + 2 * d * hk + hq * d
        ffn = self.moe.param_count(d) if self.moe is not None else 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Parameters a token passes through: top-k of the routed
        experts."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        per_layer_ffn = (self.moe.active_param_count(d)
                         - self.moe.param_count(d))
        return self.param_count() + self.n_layers * per_layer_ffn


def _check_config(cfg: LMConfig) -> None:
    if cfg.remat not in ("block", "none"):
        raise ValueError(f"remat must be 'block' or 'none'; got "
                         f"{cfg.remat!r}")
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
        if cfg.moe is not None:
            self.moe = MoE(cfg.moe, d, dtype=dt)
        else:
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
               cache_index: int = 0):
        """One decoder block: ``(x, aux)``, ``aux`` the MoE layer's loss
        (None for a dense layer)."""
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
            # the reference pins the one-token k/v of a decode step here
            k, v = maybe_constrain((k, v), None, None, None, None)
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
        if cfg.moe is not None:
            ff, aux = moe_ffn(lp.moe.leaves(w), cfg.moe, h)
            return x + ff, aux
        mlp = {name: w(p) for name, p in lp.mlp.items()}
        return x + glu_mlp(mlp, h, act=cfg.act), None

    # ------------------------------------------------------------ entry points

    def forward(self, tokens: torch.Tensor):
        """tokens int[B, S] -> (logits f32[B, S, V], aux loss): the sum of
        the MoE layers' aux losses (0.0 for a dense model).  With
        ``remat="block"`` and a gradient wanted, each layer is
        recomputed in the backward."""
        x = self._embed(tokens)
        b, s, _ = x.shape
        rope = self._rope(torch.arange(s, device=x.device).expand(b, s))
        remat = self.cfg.remat == "block" and torch.is_grad_enabled()
        aux = 0.0
        for i in range(self.cfg.n_layers):
            if remat:
                x, a = checkpoint(self._layer, i, x, rope=rope,
                                  use_reentrant=False)
            else:
                x, a = self._layer(i, x, rope=rope)
            if a is not None:
                aux = aux + a
        return self._logits(x), aux

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
            x, _ = self._layer(i, x, rope=rope, cache=cache, cache_index=0)
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
            x, _ = self._layer(i, x, rope=rope, cache=cache,
                               cache_index=index)
        return self._logits(x)[:, 0], cache


def loss_fn(model: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The reference's ``loss_fn``: the mean next-token cross-entropy of
    ``forward``'s logits plus 0.01 x the summed MoE aux loss."""
    logits, aux = model(tokens)
    return softmax_xent(logits, labels) + 0.01 * aux


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.float32, device: str | torch.device = "cuda"):
    """An empty KV cache ``(k, v)``, each [L, batch, max_len, Hkv, D], on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def _layer_tasks(cfg: LMConfig) -> list:
    """One layer's draws in the reference's order of leaves: ``(name,
    index, d_in, d_out)`` (``name`` a path into the layer, ``index`` an
    expert slot or None), each a ``dense_init`` draw."""
    d, hq = cfg.d_model, cfg.n_heads * cfg.d_head
    hk = cfg.n_kv_heads * cfg.d_head
    tasks = [(("wq",), None, d, hq), (("wk",), None, d, hk),
             (("wv",), None, d, hk), (("wo",), None, hq, d)]
    if cfg.moe is not None:
        return tasks + [(("moe",) + path, idx, di, do) for path, idx, di, do
                        in moe_init_tasks(cfg.moe, d)]
    return tasks + [(("mlp", "w_gate"), None, d, cfg.d_ff),
                    (("mlp", "w_up"), None, d, cfg.d_ff),
                    (("mlp", "w_down"), None, cfg.d_ff, d)]


def _leaf(module: nn.Module, path: tuple) -> torch.Tensor:
    for name in path:
        module = module[name] if isinstance(module, nn.ParameterDict) \
            else getattr(module, name)
    return module


@torch.no_grad()
def init_params(cfg: LMConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> TransformerLM:
    """A model with random weights (the reference's initialisers:
    ``dense_init`` for matrices, ``embed_init`` for embeddings, zeros for
    norms), built on ``device`` and filled one layer at a time, so the
    host never holds the whole model (a 15 B-parameter MoE is 60.6 GB of
    float32).  Each leaf (each expert's matrix apart) is drawn on the CPU
    from its own generator, seeded by ``(seed, layer, leaf)`` through
    ``SeedSequence`` (the embeddings by ``(seed, n_layers, 0 or 1)``), on a
    pool of threads: the same weights on every device, whatever the
    threads.  ``model.init_seconds`` holds the draw's seconds."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with torch.device(dev):
        model = TransformerLM(cfg)
    dt = getattr(torch, cfg.dtype)
    tasks = _layer_tasks(cfg)
    for li, lp in enumerate(model.layers):
        vals = draw_parallel([
            ((seed, li, ti), lambda g, di=di, do=do: dense_init(g, di, do, dt))
            for ti, (_, _, di, do) in enumerate(tasks)])
        for (path, idx, _, _), val in zip(tasks, vals):
            leaf = _leaf(lp, path)
            (leaf if idx is None else leaf[idx]).copy_(val)
        del vals
    n = cfg.n_layers
    embeds = [(model.embed, (seed, n, 0))]
    if model.unembed is not None:
        embeds.append((model.unembed, (seed, n, 1)))
    vals = draw_parallel([(words, lambda g: embed_init(g, cfg.vocab,
                                                        cfg.d_model, dt))
                          for _, words in embeds])
    for (leaf, _), val in zip(embeds, vals):
        leaf.copy_(val)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    model.init_seconds = time.perf_counter() - t0
    return model
