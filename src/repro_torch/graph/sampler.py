"""Fanout neighbour sampler (GraphSAGE-style), the ``minibatch_lg`` path:
the counterpart of ``repro.graph.sampler``.

Static shapes: for seeds ``[B]`` and fanouts ``(f1, f2, ...)`` it samples
``f_h`` neighbours per frontier node per hop, with replacement, and
returns the layered block subgraph in *local* ids:

  nodes     int32[n_sub]   global ids, sentinel-padded
  src, dst  int32[e_sub]   local-id edges (sampled neighbour -> frontier node)
  seed_mask bool[n_sub]    which local nodes are the loss-bearing seeds

It runs on the device the graph's tensors live on, with no host sync.
The reference draws its uniforms with ``jax.random``, which torch cannot
reproduce; this function takes them as given (one float32
``[len(frontier_h), f_h]`` tensor per hop) or draws them from a
``torch.Generator``, and given the reference's uniforms it returns the
reference's four arrays bit for bit: ``pick = (u * max(deg, 1))`` is the
same float32 product, truncated to int32, in both packages.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

Uniforms = Union[torch.Generator, Sequence[torch.Tensor]]


def _uniforms(draws: Uniforms, hop: int, shape: tuple[int, int],
              device: torch.device) -> torch.Tensor:
    """Hop ``hop``'s float32 uniforms in [0, 1) on ``device``: drawn from
    the generator (on its own device), or the ``hop``-th given tensor."""
    if isinstance(draws, torch.Generator):
        u = torch.rand(shape, generator=draws, dtype=torch.float32,
                       device=draws.device)
    else:
        u = draws[hop]
        if tuple(u.shape) != shape or u.dtype != torch.float32:
            raise ValueError(f"hop {hop}: uniforms {tuple(u.shape)} "
                             f"{u.dtype}; the sampler needs float32 {shape}")
    return u.to(device)


def sample_blocks(
    draws: Uniforms,
    row_offsets: torch.Tensor,
    dst: torch.Tensor,
    deg: torch.Tensor,
    seeds: torch.Tensor,
    fanouts: tuple[int, ...],
    n_nodes: int,
):
    """Sample a layered subgraph around ``seeds`` (int[B], global ids;
    ids ``>= n_nodes`` are sentinels) over a CSR graph (``graph.csr.Graph``
    fields ``row_offsets``, ``dst``, ``deg``).  ``draws``: a
    ``torch.Generator`` or one float32 uniform tensor per hop (see the
    module's docstring).  Returns ``(nodes, src, dst, seed_mask)``.

    An isolated or sentinel frontier node samples the sentinel vertex,
    and the resulting padded edges carry local dst id ``n_sub`` (dropped
    by the segment ops downstream)."""
    if len(fanouts) == 0:
        raise ValueError("sample_blocks needs at least one fanout")
    dev = dst.device
    n = int(n_nodes)
    frontiers = [seeds.to(device=dev, dtype=torch.int32)]
    pads, dst_local = [], []
    offset = 0
    last = dst.shape[0] - 1
    for hop, f in enumerate(fanouts):
        frontier = frontiers[-1].long()
        m = frontier.shape[0]
        u = _uniforms(draws, hop, (m, int(f)), dev)
        inside = frontier < n
        fc = frontier.clamp(0, n - 1)
        fdeg = torch.where(inside, deg.index_select(0, fc),
                           torch.zeros((), dtype=deg.dtype, device=dev))
        pick = (u * fdeg.clamp_min(1)[:, None]).to(torch.int32)
        starts = row_offsets.index_select(0, fc)
        idx = (starts[:, None].long() + pick).clamp(0, last)
        nbrs = dst.index_select(0, idx.reshape(-1)).reshape(m, int(f))
        valid = (fdeg[:, None] > 0) & inside[:, None]
        nbrs = torch.where(valid, nbrs.to(torch.int32),
                           torch.full((), n, dtype=torch.int32, device=dev))
        pads.append(nbrs.reshape(-1) >= n)
        dst_local.append((offset + torch.arange(m, device=dev))[:, None]
                         .expand(m, int(f)).reshape(-1))
        offset += m
        frontiers.append(nbrs.reshape(-1))
    nodes = torch.cat(frontiers)
    n_sub = nodes.shape[0]
    # local src ids: the neighbours of hop h lead frontier h + 1
    src_local, off = [], 0
    for h, f in enumerate(fanouts):
        off += frontiers[h].shape[0]
        src_local.append(off + torch.arange(frontiers[h].shape[0] * int(f),
                                            device=dev))
    src_l = torch.cat(src_local).to(torch.int32)
    dst_l = torch.cat(dst_local).to(torch.int32)
    dst_l = torch.where(torch.cat(pads), n_sub, dst_l)
    seed_mask = torch.zeros((n_sub,), dtype=torch.bool, device=dev)
    seed_mask[: seeds.shape[0]] = frontiers[0] < n
    return nodes, src_l, dst_l, seed_mask
