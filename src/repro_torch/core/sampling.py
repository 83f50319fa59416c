"""Regular-sampling splitter selection and value repartition ("the
transpose"), counterpart of ``repro.core.sampling``: the paper's lines
6-28 as a shard-group primitive (``core/shards.py``).

* ``select_splitters`` — each shard contributes p samples from its sorted
  local values (positions ``j·z // (p + 1)``, the Helman–Bader–JáJá
  regular-sampling rule, which bounds any receiver at 2x the average),
  one ``all_gather`` of the samples, and the ``p - 1`` splitters at
  positions ``j·p`` of their sort;
* ``repartition_by_value`` — buckets ``(value, carry)`` pairs by splitter
  range (``searchsorted``, left side) into ``[p, cap_chunk]`` staging,
  in each shard's own order, and exchanges it with ONE ``all_to_all``
  per array; a bucket past ``cap_chunk`` drops its tail and raises the
  overflow flag.

Per-shard tensors carry the group's leading shard axis.  Every sort the
reference's order depends on is stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.shards import ShardGroup


class Repartitioned(NamedTuple):
    values: torch.Tensor     # int32[local, p * cap_chunk], sorted, inf-padded
    carry: torch.Tensor      # int32[local, p * cap_chunk], co-sorted
    count: torch.Tensor      # int32[local]: valid received entries
    overflow: torch.Tensor   # bool (replicated): some chunk exceeded cap_chunk
    splitters: torch.Tensor  # int32[p - 1] (replicated)


def select_splitters(local_sorted: torch.Tensor, local_count: torch.Tensor,
                     p: int, shards: ShardGroup, *, inf: int) -> torch.Tensor:
    """``p - 1`` splitters from p samples a shard (paper lines 6-20).
    ``local_sorted`` is ``[local, z_cap]`` ascending, ``local_count``
    ``[local]`` its valid prefix lengths."""
    z = local_count.to(torch.int64)[:, None]
    j = torch.arange(1, p + 1, dtype=torch.int64, device=z.device)[None, :]
    pos = ((j * z) // (p + 1)).clamp(0, local_sorted.shape[1] - 1)
    samples = torch.where(z > 0, local_sorted.gather(1, pos),
                          torch.full_like(pos, inf, dtype=local_sorted.dtype))
    flat = torch.sort(shards.all_gather(samples).reshape(-1)).values
    take = torch.arange(1, p, device=flat.device) * p
    return flat[take]


def repartition_by_value(values: torch.Tensor, carry: torch.Tensor,
                         valid: torch.Tensor, p: int, cap_chunk: int,
                         shards: ShardGroup, *, inf: int,
                         splitters: Optional[torch.Tensor] = None
                         ) -> Repartitioned:
    """Exchange ``(values, carry)`` (``[local, L]`` each) so shard ``i``
    receives exactly the valid pairs with ``splitters[i-1] < value <=
    splitters[i]``; received pairs come back sorted by ``(carry, value)``
    with invalid slots (value ``inf``) last, ready for a pair-list
    adjacency.  ``splitters`` may be given (the wedge baseline's owner
    bounds); by default they come from regular sampling."""
    local, L = values.shape
    dev = values.device
    keyed = torch.where(valid, values, inf)
    if splitters is None:
        order = torch.sort(keyed, dim=1, stable=True).indices
        v_sorted = values.gather(1, order)
        count = valid.sum(1, dtype=torch.int32)
        splitters = select_splitters(v_sorted, count, p, shards, inf=inf)
    if splitters.numel():
        bucket = torch.searchsorted(
            splitters.to(keyed.dtype).expand(local, -1).contiguous(),
            keyed.contiguous(), right=False)
    else:  # one shard: every value goes to it
        bucket = torch.zeros(keyed.shape, dtype=torch.int64, device=dev)
    bucket = torch.where(valid, bucket.clamp(0, p - 1), p)  # p = drop lane
    b_sorted, order = torch.sort(bucket, dim=1, stable=True)
    lanes = torch.arange(p, dtype=b_sorted.dtype, device=dev)
    starts = torch.searchsorted(b_sorted.contiguous(),
                                lanes.expand(local, -1).contiguous())
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :] \
        - starts.gather(1, b_sorted.clamp(0, p - 1))
    real = b_sorted < p
    overflow_send = ((pos >= cap_chunk) & real).any(1)
    ok = real & (pos < cap_chunk)
    # one flat staging buffer per array, plus a dump slot for every entry
    # that is not sent (out of range rows are dropped, as mode="drop")
    cells = local * p * cap_chunk
    shard = torch.arange(local, dtype=torch.int64, device=dev)[:, None]
    slot = torch.where(ok, (shard * p + b_sorted) * cap_chunk + pos, cells)

    def stage(x):
        flat = torch.full((cells + 1,), inf, dtype=x.dtype, device=dev)
        flat.scatter_(0, slot.reshape(-1), x.gather(1, order).reshape(-1))
        return flat[:cells].view(local, p, cap_chunk)

    recv_v = shards.all_to_all(stage(values)).reshape(local, -1)
    recv_c = shards.all_to_all(stage(carry)).reshape(local, -1)
    recv_valid = recv_v < inf
    # lexsort by (carry, value): one int64 key, both below inf + 1
    key = (torch.where(recv_valid, recv_c, inf).to(torch.int64) * (inf + 1)
           + recv_v.to(torch.int64))
    idx = torch.sort(key, dim=1).indices
    overflow = shards.pmax(overflow_send.to(torch.int32)) > 0
    return Repartitioned(
        values=recv_v.gather(1, idx),
        carry=recv_c.gather(1, idx),
        count=recv_valid.sum(1, dtype=torch.int32),
        overflow=overflow,
        splitters=splitters,
    )
