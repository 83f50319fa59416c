"""AdamW and Adafactor (factored second moment), global-norm clipping and
a linear-warmup cosine schedule: the counterparts of
``repro.train.optimizer``, with its arithmetic in its order.

Parameters, gradients and moments are dicts of tensors keyed by name (a
module's ``named_parameters()``).  The updates run under
``torch.no_grad()`` and write the parameters and the state in place
(the reference returns new trees; in place keeps one copy of each on
the card); ``opt_update`` returns them all the same.  AdamW goes through
``torch._foreach_*``: a handful of launches per step, not a handful per
tensor.  The step ``count`` is a host int and the schedule a host
float32, so an update reads nothing back from the card.

``torch.optim.AdamW`` is not used: it schedules and orders its
arithmetic differently, and has no matching Adafactor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: int) -> float:
    """The learning rate at ``step`` (1-based), in float32 as the
    reference computes it."""
    f = np.float32
    step = f(step)
    warm = min(step / f(max(cfg.warmup, 1)), f(1.0))
    prog = np.clip((step - f(cfg.warmup))
                   / f(max(cfg.total_steps - cfg.warmup, 1)), f(0), f(1))
    return float(f(cfg.lr) * warm * f(0.5) * (f(1) + np.cos(f(math.pi)
                                                             * prog)))


@torch.no_grad()
def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``; returns ``(grads, norm)``, the norm before clipping as
    a 0-d float32 tensor (left on its device)."""
    gs = list(grads.values())
    norms = torch._foreach_norm([g.float() for g in gs])
    gn = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    torch._foreach_mul_(gs, scale)
    return grads, gn


# ------------------------------------------------------------------ adamw

def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
    return {"mu": zeros(), "nu": zeros(), "count": 0}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    state["count"] += 1
    count = state["count"]
    lr = schedule(cfg, count)
    f = np.float32
    bc1 = float(f(1) - f(cfg.b1) ** f(count))
    bc2 = float(f(1) - f(cfg.b2) ** f(count))
    names = list(params)
    p = [params[k] for k in names]
    g = [grads[k].float() for k in names]
    mu = [state["mu"][k] for k in names]
    nu = [state["nu"][k] for k in names]
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(g, 1 - cfg.b2), g))
    step = torch._foreach_div(mu, bc1)
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(step, den)
    p32 = [x.float() for x in p]
    torch._foreach_add_(step, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_sub_(p32, torch._foreach_mul(step, lr))
    for dst, src in zip(p, p32):
        if dst is not src:
            dst.copy_(src)
    return params, state


# ------------------------------------------------------------------ adafactor

def adafactor_init(params: dict[str, torch.Tensor]) -> dict:
    def one(p):
        if p.dim() >= 2:
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                  device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                  dtype=torch.float32, device=p.device),
            }
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    return {"v": {k: one(p) for k, p in params.items()}, "count": 0}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    state["count"] += 1
    count = state["count"]
    lr = schedule(cfg, count)
    beta2 = float(np.float32(1) - np.float32(count) ** np.float32(-0.8))
    for k, p in params.items():
        g32 = grads[k].float()
        v = state["v"][k]
        if p.dim() >= 2:
            v["vr"].mul_(beta2).add_((1 - beta2) * (g32 * g32).mean(-1))
            v["vc"].mul_(beta2).add_((1 - beta2) * (g32 * g32).mean(-2))
            r = v["vr"] / v["vr"].mean(-1, keepdim=True).clamp_min(1e-30)
            denom = torch.sqrt(r[..., None] * v["vc"][..., None, :]
                               + cfg.eps)
            step = g32 / denom
        else:
            v["v"].mul_(beta2).add_((1 - beta2) * g32 * g32)
            step = g32 / torch.sqrt(v["v"] + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, state


# ------------------------------------------------------------------ facade

def opt_init(cfg: OptConfig, params: dict[str, torch.Tensor]) -> Any:
    return (adafactor_init(params) if cfg.kind == "adafactor"
            else adamw_init(params))


@torch.no_grad()
def opt_update(cfg: OptConfig, grads, state, params):
    """Clip ``grads`` to ``cfg.clip_norm``, then one optimizer step on
    ``params`` and ``state`` (in place); returns ``(params, state,
    grad_norm)``."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    if cfg.kind == "adafactor":
        params, state = adafactor_update(cfg, grads, state, params)
    else:
        params, state = adamw_update(cfg, grads, state, params)
    return params, state, gn
