"""Expert-parallel MoE dispatch with an explicit all-to-all over the shard
group of the mesh's ``model`` axis, the counterpart of
``repro.models.moe_a2a`` (``shard_map`` over ``model``).

The reference's steps, per data group of the batch and model peer:

  1. the peer takes its 1/n_model slice of the sequence (the data
     group's rows are the same on every model peer; the slice splits the
     routing work between them);
  2. it routes its ``t_loc`` tokens locally (``models/moe.py:route``)
     with the per-slice capacity ``max(1, int(t_loc * k * cf /
     n_experts))`` and writes the send buffer ``[E_phys, cap, D]``;
  3. ``shards.all_to_all`` gives each peer its ``E_phys / n_model``
     experts' slots from every peer: ``[senders, E_loc, cap, D]``;
  4. the local experts' SiLU-GLU (``torch.bmm``), the reverse
     all-to-all, the gather back and the gate combine: a segment sum on
     K4 (``kernels/segsum/ops.segment_sum``, one launch a data group for
     all the shards this process holds), then the shared GLU on the
     slice;
  5. the output comes back as ``[B, S, D]`` with the slices in shard
     order.

The aux loss is ``n_experts * sum(pmean(frac_routed * frac_prob))`` over
every data group and model peer: the reference's form, not the sort
path's ``n_phys * sum(...)``.  Capacity is per (sender slice, expert),
stricter than the sort path's global capacity at equal cf: at cf 1.0 the
two paths drop different entries (documented in the reference).

On one card the shard group is ``LocalShards(n_model)`` (the all-to-all a
transpose of the stacked shards) and the data axis is a loop over the
batch's data groups.  On ``GroupShards`` (one rank a model peer) every
rank holds the whole input and the whole weights, as the reference's
replicated ``in_specs``; the collectives carry their own backward (the
all-to-all's is the reverse all-to-all), and each replicated input's
gradient is summed over the group, as ``shard_map``'s transpose does,
so every rank ends with the full gradient of a loss it computes the
same as the others.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.segsum.ops import segment_sum
from repro_torch.models import moe as _moe
from repro_torch.models.layers import glu_mlp


def a2a_applicable(cfg, x, layout) -> bool:
    """The layout has a ``model`` axis that divides the sequence of ``x``
    [B, S, D] and the physical expert slots."""
    shape = getattr(layout, "shape", {})
    if "model" not in shape:
        return False
    n_model = shape["model"]
    return x.shape[1] % n_model == 0 and cfg.n_phys % n_model == 0


def _in_process(shards) -> bool:
    """Every shard of the group lives in this process (``LocalShards``)."""
    return shards.local == shards.p


class _AllToAll(torch.autograd.Function):
    """``shards.all_to_all``; its backward is the reverse all-to-all,
    the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return shards.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shards.all_to_all(g.contiguous()), None


class _Psum(torch.autograd.Function):
    """``shards.psum``, replicated; each shard's term receives the
    cotangent."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.local = x.shape[0]
        return shards.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.local, *g.shape), None


class _Gather(torch.autograd.Function):
    """Output assembly across processes (``shards.gather_result``); the
    backward keeps this process's own slices of the cotangent."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return shards.gather_result(x)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.shards.shard_ids], None


class _Replicated(torch.autograd.Function):
    """A replicated input of the group's processes: the identity, whose
    backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shards.psum(g.contiguous()[None]), None


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def moe_ffn_a2a(params, cfg, x: torch.Tensor, *, layout, shards=None):
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux loss 0-d) over the
    shard group ``shards`` of ``layout``'s ``model`` axis
    (``LocalShards(n_model, x.device)`` when None).  ``params`` is
    :meth:`repro_torch.models.moe.MoE.leaves`; the batch must divide over
    the layout's data axes."""
    from repro_torch.core.shards import LocalShards

    n_model = layout.shape["model"]
    if shards is None:
        shards = LocalShards(n_model, x.device)
    if shards.p != n_model:
        raise ValueError(f"the shard group has {shards.p} shards; the "
                         f"layout's model axis {n_model}")
    n_data = math.prod(layout.shape[a] for a in ("pod", "data")
                       if a in layout.shape)
    b, s, d = x.shape
    if b % n_data or s % n_model or cfg.n_phys % n_model:
        raise ValueError(f"x {tuple(x.shape)} and {cfg.n_phys} expert "
                         f"slots do not divide over {layout.shape}")
    if not _in_process(shards):
        params = _tree(lambda t: _Replicated.apply(t, shards), params)
        x = _Replicated.apply(x, shards)
    b_loc, s_loc = b // n_data, s // n_model
    e_phys, k = cfg.n_phys, cfg.top_k
    e_loc = e_phys // n_model
    t_loc = b_loc * s_loc
    cap = max(1, int(t_loc * k * cfg.capacity_factor / cfg.n_experts))
    local = shards.local

    def mine(t):  # this process's shards of a [n_model, ...] view
        return t if _in_process(shards) else t[shards.shard_ids]

    # this process's experts: [local * e_loc, ...] (a view in-process)
    ex = {name: mine(w.reshape(n_model, e_loc, *w.shape[1:])).reshape(
        local * e_loc, *w.shape[1:]) for name, w in params["experts"].items()}
    seg_base = (torch.arange(local, device=x.device) * t_loc)[:, None]
    outs, stats = [], []
    for g in range(n_data):
        xl = x[g * b_loc:(g + 1) * b_loc]
        xs = mine(xl.reshape(b_loc, n_model, s_loc, d).transpose(0, 1))
        tokens = xs.reshape(local, t_loc, d)
        sends, rows, cols, stoks, gates, stat = [], [], [], [], [], []
        for i in range(local):
            r = _moe.route(params["router"], cfg, tokens[i], cap)
            row = torch.where(r.keep, r.se, e_phys)
            col = torch.where(r.keep, r.pos, 0)
            buf = tokens.new_zeros((e_phys + 1, cap, d))
            sends.append(buf.index_put((row, col),
                                       tokens[i][r.stok])[:e_phys])
            rows.append(row)
            cols.append(col)
            stoks.append(r.stok)
            gates.append(r.sgate.masked_fill(~r.keep, 0.0))
            stat.append(r.stats)
        # dispatch all-to-all: [local, n_model (dest), e_loc, cap, D]
        send = torch.stack(sends).reshape(local, n_model, e_loc, cap, d)
        recv = _AllToAll.apply(send, shards)   # [local, sender, e_loc, ...]
        grouped = recv.transpose(1, 2).reshape(local * e_loc,
                                               n_model * cap, d)
        h = (F.silu(torch.bmm(grouped, ex["w_gate"]))
             * torch.bmm(grouped, ex["w_up"]))
        y = torch.bmm(h, ex["w_down"])         # [local * e_loc, n*cap, D]
        # combine: the reverse all-to-all, back to each sender's slots
        y = y.reshape(local, e_loc, n_model, cap, d).transpose(1, 2)
        back = _AllToAll.apply(y.contiguous(), shards).reshape(
            local, e_phys, cap, d)
        back = torch.cat([back, back.new_zeros((local, 1, cap, d))], dim=1)
        msgs = torch.stack([
            back[i][rows[i], cols[i]] * gates[i][:, None].to(back.dtype)
            for i in range(local)])            # [local, t_loc * k, D]
        seg = torch.stack(stoks) + seg_base
        out = segment_sum(msgs.reshape(-1, d), seg.reshape(-1),
                          local * t_loc).to(x.dtype)
        out = out.reshape(local, b_loc, s_loc, d)
        if cfg.d_ff_shared:
            out = out + glu_mlp(params["shared"], xs, act="silu")
        if not _in_process(shards):
            out = _Gather.apply(out, shards)   # [n_model, b_loc, s_loc, D]
        outs.append(out.transpose(0, 1).reshape(b_loc, s, d))
        stats.append(_Psum.apply(torch.stack(stat), shards))
    aux = cfg.n_experts * (torch.stack(stats).sum(0)
                           / (n_data * n_model)).sum()
    return torch.cat(outs), aux
