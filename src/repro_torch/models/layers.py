"""Building blocks of the port's models, counterparts of
``repro.models.layers``: initialisers drawn from an explicit
``torch.Generator``, RMSNorm with its ``(1 + weight)`` scale, LayerNorm,
rotary embeddings (split halves), the gated MLP, the plain MLP stack,
the masked softmax cross-entropy and the binary cross-entropy on logits.

Weights keep the reference's layout, ``[d_in, d_out]`` applied as
``x @ w``, so a JAX parameter tree carries across as it is
(``models/convert.py``).  Initialisers draw on the CPU generator they are
given; the caller moves the result to its device, so one seed gives the
same weights on the CPU and on the card.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------- init utils


def seeded_generator(*words: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded by numpy's ``SeedSequence(words)``:
    the same draws on every host and for every device they feed."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2**63 - 1))


def draw_parallel(jobs) -> list:
    """Run ``jobs``, each ``(words, fn)``, as ``fn(seeded_generator(
    *words))`` on a pool of threads (at most 8, one per CPU): each draw
    has its own generator and releases the GIL, so the results do not
    depend on the threads, only on the words."""
    threads = min(8, os.cpu_count() or 1)

    def one(job):
        words, fn = job
        return fn(seeded_generator(*words))

    if len(jobs) <= 1 or threads <= 1:
        return [one(j) for j in jobs]
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(one, jobs))


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return torch.randn((d_in, d_out), generator=gen, dtype=dtype) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=dtype) * 0.02


# ---------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight)).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, its statistics in float32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


# ---------------------------------------------------------------- rope


def rope_freqs(d_head: int, theta: float, positions: torch.Tensor):
    """positions int[...]; returns (cos, sin) of shape positions.shape +
    (d_head/2,), float32."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=positions.device) / d_head
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin broadcastable to [..., S, 1, D/2]."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- mlp


def glu_mlp(params, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """``params`` maps ``w_gate``, ``w_up``, ``w_down`` to weights."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if act == "silu":
        gate = F.silu(gate)
    elif act == "gelu":
        gate = F.gelu(gate, approximate="tanh")
    elif act == "relu":
        gate = F.relu(gate)
    else:
        raise ValueError(act)
    return (gate * up) @ params["w_down"]


def mlp_stack_init(gen: torch.Generator, dims: tuple[int, ...],
                   dtype=torch.float32) -> dict[str, torch.Tensor]:
    """``w{i}`` [dims[i], dims[i + 1]] (``dense_init``, in order) and
    ``b{i}`` zeros [dims[i + 1]] for each of the ``len(dims) - 1``
    layers."""
    n = len(dims) - 1
    return ({f"w{i}": dense_init(gen, dims[i], dims[i + 1], dtype)
             for i in range(n)}
            | {f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype)
               for i in range(n)})


def mlp_stack(params, x: torch.Tensor, *, n: int) -> torch.Tensor:
    """``n`` layers ``x @ w{i} + b{i}``, ReLU between them and none after
    the last (the reference's defaults; no caller sets its ``act`` or
    ``final_act``)."""
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = F.relu(x)
    return x


# ---------------------------------------------------------------- losses


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over the kept rows: logits [..., V] (float32
    upcast), labels int[...] (-1 = ignore), ``mask`` bool[...] also
    drops rows; 0 when no row is kept."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.long().clamp(0, logits.shape[-1] - 1)[..., None]
    nll = lse - torch.gather(logits, -1, idx)[..., 0]
    keep = labels >= 0
    if mask is not None:
        keep = keep & mask
    nll = torch.where(keep, nll, torch.zeros((), dtype=nll.dtype,
                                             device=nll.device))
    return nll.sum() / keep.sum().clamp_min(1)


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of ``logits`` against ``labels`` in
    [0, 1], in float32, in the stable form ``max(x, 0) - x y +
    log1p(exp(-|x|))``."""
    x = logits.float()
    return (x.clamp_min(0) - x * labels
            + torch.log1p(torch.exp(-x.abs()))).mean()
