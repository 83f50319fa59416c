"""The shard group: the port's stand-in for ``shard_map`` and its
``jax.lax`` collectives, over which Algorithm 2's per-shard body is
written once (``core/parallel_tc.py``, ``core/sampling.py``,
``core/bfs.py:bfs_levels_sharded``, ``core/wedge_baseline.py``).

Per-shard tensors carry a leading axis of the shards this process holds,
``local`` of them: all ``p`` for :class:`LocalShards`, one for
:class:`GroupShards`.  A value every shard agrees on (the result of a
reduction or a gather) is *replicated*: it has no shard axis and is the
same on every process.  The five collectives:

* ``all_gather(x [local, ...]) -> [p, ...]`` replicated, in shard order;
* ``all_to_all(x [local, p, ...]) -> [local, p, ...]``: shard ``j``'s
  row ``i`` of the staging becomes shard ``i``'s row ``j``;
* ``ppermute(x [local, ...], perm)``: shard ``d`` receives shard ``s``'s
  ``x`` for each ``(s, d)`` of ``perm``; a shard no pair names receives
  zeros (as ``jax.lax.ppermute``);
* ``psum`` / ``pmax(x [local, ...]) -> [...]`` replicated.  ``psum``
  keeps ``x``'s dtype (an int32 sum wraps, as the reference's does).

Two implementations:

* :class:`LocalShards` holds all ``p`` shards on one device, stacked on
  the leading axis: ``all_to_all`` is a transpose of the ``[p_src,
  p_dst, ...]`` staging, ``all_gather`` the tensor itself, ``ppermute``
  an index of the shard axis and ``psum``/``pmax`` a reduction over it.
  This is how one H100 runs Algorithm 2: p logical shards on one card
  (NCCL cannot put two ranks on one device).
* :class:`GroupShards` is one shard per rank of a ``torch.distributed``
  process group: gloo on the CPU (the tests), NCCL with one rank per
  card where several cards exist.

Both record every collective call inside :meth:`ShardGroup.recording`:
its kind, its per-shard payload shape and bytes, whether it ran inside
the BFS loop (:meth:`ShardGroup.bfs_loop`) and, for a permutation, its
cross pairs.  ``core/comm_instrument.py`` prices that record with
``comm_model``'s wire pricers ("measured") and holds it against the
analytic tally and the closed-form model.  The record is per thread, so
an abandoned attempt on a worker thread never writes into another
run's record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import torch

__all__ = [
    "CollectiveCall",
    "GroupShards",
    "LocalShards",
    "ShardGroup",
]


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective of a run: ``kind`` (``all_gather``, ``all_to_all``,
    ``ppermute``, ``psum`` or ``pmax``), ``shape`` and ``dtype`` of ONE
    shard's payload, ``nbytes`` its bytes, ``in_bfs`` whether it ran
    inside the BFS sweep loop, and ``cross`` the ``(src, dst)`` pairs of
    a ``ppermute`` with ``src != dst`` (0 for every other kind)."""

    kind: str
    shape: tuple
    dtype: str
    nbytes: int
    in_bfs: bool = False
    cross: int = 0


class ShardGroup:
    """The interface of the module docstring; subclasses implement the
    unrecorded ``_all_gather``, ``_all_to_all``, ``_ppermute``,
    ``_reduce`` and ``gather_result``."""

    #: number of shards in the group
    p: int
    #: shards this process holds (the leading axis of per-shard tensors)
    local: int
    device: torch.device

    def __init__(self):
        self._tls = threading.local()

    # ------------------------------------------------------ the record
    @contextlib.contextmanager
    def recording(self):
        """Record every collective this thread runs until the block ends;
        yields the list the calls are appended to."""
        prev = getattr(self._tls, "record", None)
        record: list[CollectiveCall] = []
        self._tls.record = record
        try:
            yield record
        finally:
            self._tls.record = prev

    @contextlib.contextmanager
    def bfs_loop(self):
        """Mark the collectives of the block as inside the BFS loop."""
        prev = getattr(self._tls, "in_bfs", False)
        self._tls.in_bfs = True
        try:
            yield
        finally:
            self._tls.in_bfs = prev

    def _note(self, kind: str, x: torch.Tensor, cross: int = 0) -> None:
        record = getattr(self._tls, "record", None)
        if record is None:
            return
        shard = x.shape[1:]
        numel = 1
        for d in shard:
            numel *= int(d)
        record.append(CollectiveCall(
            kind=kind, shape=tuple(int(d) for d in shard),
            dtype=str(x.dtype).replace("torch.", ""),
            nbytes=numel * x.element_size(),
            in_bfs=bool(getattr(self._tls, "in_bfs", False)), cross=cross,
        ))

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != self.local:
            raise ValueError(
                f"a per-shard tensor needs a leading axis of {self.local} "
                f"shards; got shape {tuple(x.shape)}")

    # ------------------------------------------------- the collectives
    @property
    def shard_ids(self) -> torch.Tensor:
        """int64[local]: the ids of the shards this process holds."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        self._note("all_gather", x)
        return self._all_gather(x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        if x.dim() < 2 or x.shape[1] != self.p:
            raise ValueError(f"all_to_all stages [local, p={self.p}, ...]; "
                             f"got shape {tuple(x.shape)}")
        self._note("all_to_all", x)
        return self._all_to_all(x)

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        self._check(x)
        perm = [(int(s), int(d)) for s, d in perm]
        self._note("ppermute", x, cross=sum(1 for s, d in perm if s != d))
        return self._ppermute(x, perm)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        self._note("psum", x)
        return self._reduce(x, "sum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        self._note("pmax", x)
        return self._reduce(x, "max")

    def gather_result(self, x: torch.Tensor) -> torch.Tensor:
        """Assemble a per-shard result ``[local, ...]`` into ``[p, ...]``
        on every process: the counterpart of ``shard_map``'s sharded
        ``out_specs``, which is output assembly, not a collective of the
        program, so it is not recorded."""
        raise NotImplementedError

    def _all_gather(self, x):
        raise NotImplementedError

    def _all_to_all(self, x):
        raise NotImplementedError

    def _ppermute(self, x, perm):
        raise NotImplementedError

    def _reduce(self, x, op: str):
        raise NotImplementedError


class LocalShards(ShardGroup):
    """All ``p`` shards on one device, stacked on the leading axis."""

    def __init__(self, p: int, device: "str | torch.device" = "cuda"):
        super().__init__()
        if int(p) <= 0:
            raise ValueError(f"p must be positive; got {p}")
        self.p = int(p)
        self.local = self.p
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return f"LocalShards(p={self.p}, device={str(self.device)!r})"

    @property
    def shard_ids(self) -> torch.Tensor:
        return torch.arange(self.p, device=self.device)

    def gather_result(self, x):
        return x

    def _all_gather(self, x):
        return x

    def _all_to_all(self, x):
        return x.transpose(0, 1).contiguous()

    def _ppermute(self, x, perm):
        out = torch.zeros_like(x)
        if perm:
            src = torch.tensor([s for s, _ in perm], device=x.device)
            dst = torch.tensor([d for _, d in perm], device=x.device)
            out[dst] = x[src]
        return out

    def _reduce(self, x, op):
        if op == "sum":
            return x.sum(0, dtype=x.dtype)
        return x.amax(0)


class GroupShards(ShardGroup):
    """One shard per rank of a ``torch.distributed`` process group
    (``None`` = the default group); tensors live on ``device``, which
    defaults to what the group's backend carries: the rank's current
    card for NCCL, the CPU for gloo."""

    def __init__(self, process_group=None,
                 device: "str | torch.device | None" = None):
        import torch.distributed as dist

        super().__init__()
        if not dist.is_initialized():
            raise RuntimeError("GroupShards needs an initialized "
                               "torch.distributed process group")
        self._dist = dist
        self.group = process_group
        self.p = dist.get_world_size(process_group)
        self.rank = dist.get_rank(process_group)
        self.local = 1
        if device is None:
            nccl = dist.get_backend(process_group) == "nccl"
            device = (torch.device("cuda", torch.cuda.current_device())
                      if nccl else "cpu")
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return (f"GroupShards(p={self.p}, rank={self.rank}, "
                f"device={str(self.device)!r})")

    @property
    def shard_ids(self) -> torch.Tensor:
        return torch.tensor([self.rank], device=self.device)

    def _gather(self, x):
        parts = [torch.empty_like(x[0]) for _ in range(self.p)]
        self._dist.all_gather(parts, x[0].contiguous(), group=self.group)
        return torch.stack(parts)

    def gather_result(self, x):
        return self._gather(x)

    def _all_gather(self, x):
        return self._gather(x)

    def _all_to_all(self, x):
        out = torch.empty_like(x[0])
        self._dist.all_to_all_single(out, x[0].contiguous(),
                                     group=self.group)
        return out[None]

    def _ppermute(self, x, perm):
        dist = self._dist
        out = torch.zeros_like(x[0])
        ops = []
        for s, d in perm:
            if s == d == self.rank:
                out = x[0].clone()
            elif s == self.rank:
                ops.append(dist.P2POp(dist.isend, x[0].contiguous(),
                                      self._peer(d), self.group))
            elif d == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, self._peer(s),
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out[None]

    def _peer(self, shard: int) -> int:
        """The global rank of shard ``shard`` (its rank in the group)."""
        if self.group is None:
            return shard
        return self._dist.get_global_rank(self.group, shard)

    def _reduce(self, x, op):
        dist = self._dist
        out = x[0].clone()
        if out.dtype == torch.bool:
            raise TypeError("reduce a bool tensor as an integer one")
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        return out


def as_shards(mesh: Optional[ShardGroup], device) -> ShardGroup:
    """The engine's shard group: ``mesh`` itself, or one shard on
    ``device`` (``None``).  A group on another device type than
    ``device`` raises: the route would otherwise move the engine's work
    to the group's device unasked."""
    if mesh is None:
        return LocalShards(1, device)
    if not isinstance(mesh, ShardGroup):
        raise TypeError(
            f"mesh must be a shard group (LocalShards, GroupShards) or "
            f"None; got {type(mesh).__name__}")
    if mesh.device.type != torch.device(device).type:
        raise ValueError(f"the shard group lives on {mesh.device}; this "
                         f"engine runs on {device}")
    return mesh
