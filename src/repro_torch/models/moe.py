"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch,
the counterpart of ``repro.models.moe``'s ``MoEConfig``,
``moe_ffn_init`` and ``moe_ffn``.

The reference's steps, in its order:

  1. the router's logits in ``router_dtype``, padded expert slots masked
     to -1e30; softmax, top-k (ties to the lower index, as
     ``jax.lax.top_k``: a stable descending sort), the gates
     renormalised;
  2. the Switch aux loss, taken before any drop, with e = ``n_phys``;
  3. the (token, expert, gate) entries sorted stably by expert, each
     entry's position inside its expert from a left ``searchsorted``;
     entries at ``pos >= capacity`` dropped (``capacity = max(1,
     int(n_tok * k * cf / n_experts))`` in Python arithmetic);
  4. the kept entries' tokens written into an ``[E, C, D]`` buffer (a
     dropped entry writes nothing), the expert GEMMs ``ecd,edf->ecf``
     (``torch.bmm``: the reference leaves them to XLA, outside any
     Pallas kernel) and SiLU-GLU;
  5. each entry's expert output gathered back (zero for a dropped entry),
     scaled by its gate and summed per token: a segment sum over the T
     tokens of T * k rows of width d_model, through
     :func:`repro_torch.kernels.segsum.ops.segment_sum` (K4 on the card,
     its plain version on the CPU; float32, cast back to the
     activations' dtype), whose backward is a gather;
  6. the shared GLU branch (qwen2-moe's 4 shared experts as one GLU).

No step reads a value back to the host: the aux loss counts each
expert's entries by ``scatter_add_`` into ``n_phys`` slots, a dropped
entry is written to a spare buffer row that is cut off, and gathered
from a spare zero row.

``dispatch="a2a"`` is the reference's explicit expert parallelism,
:mod:`repro_torch.models.moe_a2a`: it applies under a mesh
(``distributed/constrain.py:use_mesh``) with a ``model`` axis that
divides the sequence and the expert slots.  Without such a mesh (decode
at S = 1 among them) the layer takes the sort-based path here, as the
reference does (``repro/models/moe.py:91-96``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.constrain import current_mesh, maybe_constrain
from repro_torch.kernels.segsum.ops import segment_sum
from repro_torch.models.layers import glu_mlp


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0       # qwen2-moe: 4 shared experts == one 4x GLU
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # physical expert slots (qwen2's 60 routed experts -> 64); the router
    # masks the padded slots so the semantics stay at n_experts
    pad_experts_to: int = 0
    # "gspmd" (the sort-based path) or "a2a" (models/moe_a2a.py under a
    # mesh with a model axis; the sort-based path elsewhere)
    dispatch: str = "gspmd"

    @property
    def n_phys(self) -> int:
        return max(self.n_experts, self.pad_experts_to)

    def param_count(self, d_model: int) -> int:
        p = self.n_experts * 3 * d_model * self.d_ff_expert
        p += d_model * self.n_experts  # router
        if self.d_ff_shared:
            p += 3 * d_model * self.d_ff_shared
        return p

    def active_param_count(self, d_model: int) -> int:
        p = self.top_k * 3 * d_model * self.d_ff_expert
        p += d_model * self.n_experts
        if self.d_ff_shared:
            p += 3 * d_model * self.d_ff_shared
        return p


class MoE(nn.Module):
    """One MoE FFN's weights (reference: ``moe_ffn_init``'s tree):
    ``router`` [d, E], ``experts`` ``w_gate``/``w_up`` [E, d, f] and
    ``w_down`` [E, f, d] over the ``n_phys`` slots, and ``shared`` (a GLU
    of ``d_ff_shared``) when the config has one.  Zeros until drawn
    (``transformer.init_params``, by :func:`moe_init_tasks`) or copied
    (``models/convert.py``)."""

    def __init__(self, cfg: MoEConfig, d_model: int, dtype=torch.float32):
        super().__init__()
        e, f = cfg.n_phys, cfg.d_ff_expert

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype))

        self.router = zeros(d_model, e)
        self.experts = nn.ParameterDict({
            "w_gate": zeros(e, d_model, f),
            "w_up": zeros(e, d_model, f),
            "w_down": zeros(e, f, d_model),
        })
        self.shared = None
        if cfg.d_ff_shared:
            self.shared = nn.ParameterDict({
                "w_gate": zeros(d_model, cfg.d_ff_shared),
                "w_up": zeros(d_model, cfg.d_ff_shared),
                "w_down": zeros(cfg.d_ff_shared, d_model),
            })

    def leaves(self, fn=lambda t: t) -> dict:
        """The weights as the reference's nested dict, each passed
        through ``fn`` (the transformer's cast to its compute dtype)."""
        out = {"router": fn(self.router),
               "experts": {k: fn(v) for k, v in self.experts.items()}}
        if self.shared is not None:
            out["shared"] = {k: fn(v) for k, v in self.shared.items()}
        return out


def moe_init_tasks(cfg: MoEConfig, d_model: int) -> list:
    """The MoE leaves' draws in the reference's order (``router``, then
    each expert's ``w_gate``, ``w_up``, ``w_down``, then ``shared``'s):
    ``(path, index, d_in, d_out)``, ``index`` the expert slot or None.
    Each is a ``dense_init`` draw."""
    e, f = cfg.n_phys, cfg.d_ff_expert
    tasks: list = [(("router",), None, d_model, e)]
    for i in range(e):
        tasks += [(("experts", "w_gate"), i, d_model, f),
                  (("experts", "w_up"), i, d_model, f),
                  (("experts", "w_down"), i, f, d_model)]
    if cfg.d_ff_shared:
        s = cfg.d_ff_shared
        tasks += [(("shared", "w_gate"), None, d_model, s),
                  (("shared", "w_up"), None, d_model, s),
                  (("shared", "w_down"), None, s, d_model)]
    return tasks


# ------------------------------------------------------------------ routing


class Routing(NamedTuple):
    """What the router decides for the ``n_tok`` tokens, before the
    expert products (the reference's intermediate values)."""
    probs: torch.Tensor       # [T, E] softmax over the slots
    expert_idx: torch.Tensor  # int64 [T, k]
    aux: torch.Tensor         # the Switch loss, 0-d
    se: torch.Tensor          # int64 [T*k] entries' experts, sorted
    stok: torch.Tensor        # int64 [T*k] their tokens
    sgate: torch.Tensor       # [T*k] their gates
    pos: torch.Tensor         # int64 [T*k] position inside the expert
    keep: torch.Tensor        # bool [T*k] pos < capacity
    stats: torch.Tensor       # [E] frac_routed * frac_prob (aux = e * sum)


def capacity_for(cfg: MoEConfig, n_tok: int) -> int:
    """The reference's capacity: Python arithmetic on host ints."""
    return max(1, int(n_tok * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


def route(router: torch.Tensor, cfg: MoEConfig, tokens: torch.Tensor,
          capacity: int) -> Routing:
    """Steps 1-3 of the module's docstring for ``tokens`` [T, D]."""
    n_tok = tokens.shape[0]
    e, k = cfg.n_phys, cfg.top_k
    logits = (tokens @ router).to(getattr(torch, cfg.router_dtype))
    if cfg.n_phys > cfg.n_experts:  # mask the padded expert slots
        pad = torch.arange(e, device=logits.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # top-k as jax.lax.top_k: the k largest, ties to the lower index
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top.values[:, :k], top.indices[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # the aux load-balance loss, before any drop
    # (counted by scatter_add_ into e slots: bincount would read the
    # indices' range back to the host)
    flat_expert = expert_idx.reshape(-1)
    counts = torch.zeros(e, device=probs.device).scatter_add_(
        0, flat_expert, torch.ones(n_tok * k, device=probs.device))
    frac_routed = counts / (n_tok * k)
    frac_prob = probs.float().mean(0)
    stats = frac_routed * frac_prob
    aux = e * stats.sum()

    # sort-based dispatch
    flat_token = torch.arange(n_tok, device=tokens.device)[:, None].expand(
        n_tok, k).reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    se, stok = flat_expert[order], flat_token[order]
    sgate = gate_vals.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=se.device))
    pos = torch.arange(n_tok * k, device=se.device) - starts[se.clamp(0,
                                                                      e - 1)]
    keep = pos < capacity
    return Routing(probs, expert_idx, aux, se, stok, sgate, pos, keep, stats)


def moe_ffn(params: dict, cfg: MoEConfig, x: torch.Tensor, *,
            capacity: Optional[int] = None):
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux loss 0-d).
    ``params`` is :meth:`MoE.leaves` (the matrices already in the
    compute dtype); ``capacity`` overrides the reference's formula.
    With ``cfg.dispatch == "a2a"`` under a mesh whose ``model`` axis
    applies (``moe_a2a.a2a_applicable``) the layer is
    :func:`repro_torch.models.moe_a2a.moe_ffn_a2a`, which takes its own
    per-slice capacity."""
    if cfg.dispatch == "a2a":
        from repro_torch.models.moe_a2a import a2a_applicable, moe_ffn_a2a

        mesh = current_mesh()
        if mesh is not None and a2a_applicable(cfg, x, mesh[0]):
            return moe_ffn_a2a(params, cfg, x, layout=mesh[0],
                               shards=mesh[1])
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    n_tok = b * s
    e = cfg.n_phys
    if capacity is None:
        capacity = capacity_for(cfg, n_tok)
    r = route(params["router"], cfg, tokens, capacity)

    # the expert buffer: a dropped entry goes to the spare row e, cut off
    row = torch.where(r.keep, r.se, e)
    col = torch.where(r.keep, r.pos, 0)
    buf = tokens.new_zeros((e + 1, capacity, d))
    buf = buf.index_put((row, col), tokens[r.stok])[:e]
    buf = maybe_constrain(buf, "model", ("pod", "data"), None)

    ex = params["experts"]
    h = F.silu(torch.bmm(buf, ex["w_gate"])) * torch.bmm(buf, ex["w_up"])
    y = torch.bmm(h, ex["w_down"])                       # [E, C, D]

    # combine: gather back (a dropped entry reads the zero row e), gate,
    # and sum per token on K4
    y = torch.cat([y, y.new_zeros((1, capacity, d))])
    gathered = y[row, col]                               # [T*k, D]
    gate = r.sgate.masked_fill(~r.keep, 0.0)
    msgs = gathered * gate[:, None].to(y.dtype)
    out = segment_sum(msgs, r.stok, n_tok).to(x.dtype).reshape(b, s, d)
    if cfg.d_ff_shared:
        out = out + glu_mlp(params["shared"], x, act="silu")
    return out, r.aux
