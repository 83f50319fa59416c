"""Mutable-graph state for the stream route (counterpart of
``repro.stream.state``).

A :class:`MutableGraph` is the source of truth of a stream session: the
*simple undirected graph* as a sorted int64 tensor of packed edge keys
(``lo * n + hi`` — the key space ``graph.csr._normalize_edges`` dedups
on, so a CSR snapshot of these keys and ``from_edges`` of the same edge
list are the same graph) on the session's device, plus the live degree
array on the host.  Mutations are applied **in stream order** with a
structured per-update status, with the reference's semantics: inserting
an edge that is already present and deleting one that is absent are
idempotent no-ops, reported as such.

``apply`` looks the batch's keys up in the device key tensor with one
``torch.searchsorted``, runs the stream-order logic over the batch (at
most ``TCOptions.stream_buffer`` updates) in a small host overlay, and
rebuilds the key tensor on the device: the net deletes are masked out
and the net inserts merged in at their ``searchsorted`` positions, with
no sort of the whole set.  The degrees stay a host int64 array, updated
per update as in the reference, because the delta probes price their
widths from them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "EDGE_STATUSES",
    "MutableGraph",
    "MutationResult",
    "normalize_stream",
]

#: Every structured per-update status ``MutableGraph.apply`` can report:
#:
#:   ``inserted`` / ``deleted``   — the update changed the edge set;
#:   ``noop-present``             — insert of an edge already present;
#:   ``noop-absent``              — delete of an edge not present;
#:   ``noop-self-loop``           — a ``(v, v)`` update (simple graphs
#:                                  carry no self loops);
#:   ``rejected``                 — an endpoint outside ``[0, n)`` (the
#:                                  packed-key arithmetic would alias it
#:                                  onto another edge).
EDGE_STATUSES = (
    "inserted",
    "deleted",
    "noop-present",
    "noop-absent",
    "noop-self-loop",
    "rejected",
)

#: ops accepted by ``normalize_stream`` for one update
_INSERT_OPS = frozenset({1, +1, "+", "insert", "ins", "add"})
_DELETE_OPS = frozenset({-1, "-", "delete", "del", "remove"})


def normalize_stream(
    updates: Union[Sequence, tuple],
) -> tuple[np.ndarray, np.ndarray]:
    """Normalize an edge-mutation stream to ``(ops int8[k], edges
    int64[k, 2])`` with ``ops`` in {+1, -1}.

    Accepts either an iterable of ``(op, u, v)`` triples (``op`` any of
    ``+1/-1``, ``"+"/"-"``, ``"insert"/"delete"``) or a pre-split
    ``(ops, edges)`` array pair.  Order is preserved — the stream is
    applied sequentially, so ``[(+1, u, v), (-1, u, v)]`` really does
    insert then delete.
    """
    if (isinstance(updates, tuple) and len(updates) == 2
            and not np.isscalar(updates[0])
            and np.asarray(updates[0]).ndim == 1
            and np.asarray(updates[1]).ndim == 2):
        ops = np.asarray(updates[0])
        edges = np.asarray(updates[1], dtype=np.int64).reshape(-1, 2)
        if ops.shape[0] != edges.shape[0]:
            raise ValueError(
                f"ops/edges length mismatch: {ops.shape[0]} vs "
                f"{edges.shape[0]}"
            )
        out_ops = np.where(ops.astype(np.int64) >= 0, 1, -1)
        return out_ops.astype(np.int8), edges
    ops_l, edges_l = [], []
    for item in updates:
        op, u, v = item
        if op in _INSERT_OPS:
            ops_l.append(1)
        elif op in _DELETE_OPS:
            ops_l.append(-1)
        else:
            raise ValueError(
                f"unknown stream op {op!r}; use +1/'insert' or "
                f"-1/'delete'"
            )
        edges_l.append((int(u), int(v)))
    ops = np.asarray(ops_l, dtype=np.int8)
    edges = (np.asarray(edges_l, dtype=np.int64).reshape(-1, 2)
             if edges_l else np.zeros((0, 2), dtype=np.int64))
    return ops, edges


@dataclasses.dataclass(frozen=True)
class MutationResult:
    """One applied mutation batch, fully accounted for.

    ``statuses`` is aligned with the input stream (one entry per update,
    in order — see :data:`EDGE_STATUSES`).  ``net_inserted`` /
    ``net_deleted`` are the *net* set changes as host ``int64[·, 2]``
    ``(lo, hi)`` arrays in key order: an edge inserted then deleted
    inside the same batch appears in neither."""

    statuses: tuple[str, ...]
    net_inserted: np.ndarray
    net_deleted: np.ndarray

    @property
    def counts(self) -> dict:
        c: dict = {}
        for s in self.statuses:
            c[s] = c.get(s, 0) + 1
        return c

    @property
    def changed(self) -> int:
        return int(self.net_inserted.shape[0] + self.net_deleted.shape[0])


def remove_keys(keys: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """``keys`` (sorted, unique) without ``drop`` (a subset of them)."""
    if drop.numel() == 0:
        return keys
    keep = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    keep[torch.searchsorted(keys, drop)] = False
    return keys[keep]


def _merge_keys(keys: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """Sorted union of ``keys`` and ``add`` (both sorted, disjoint): each
    added key lands at its ``searchsorted`` position shifted by the added
    keys before it."""
    if add.numel() == 0:
        return keys
    total = keys.shape[0] + add.shape[0]
    pos = torch.searchsorted(keys, add) + torch.arange(
        add.shape[0], device=keys.device)
    out = torch.empty(total, dtype=torch.int64, device=keys.device)
    is_add = torch.zeros(total, dtype=torch.bool, device=keys.device)
    is_add[pos] = True
    out[pos] = add
    out[~is_add] = keys
    return out


class MutableGraph:
    """A simple undirected graph as a sorted device tensor of packed edge
    keys plus live host degrees, with stream-ordered ``apply`` and
    snapshots back into the CSR world (``keys``, ``device_edges``)."""

    def __init__(self, edges, n_nodes: int, *,
                 device: Union[str, torch.device] = "cuda"):
        n = int(n_nodes)
        if n < 0:
            raise ValueError(f"n_nodes must be >= 0; got {n}")
        self.n_nodes = n
        self.device = resolve_device(device)
        if isinstance(edges, torch.Tensor):
            e = edges.to(self.device, torch.int64).reshape(-1, 2)
        else:
            e = torch.as_tensor(
                np.asarray(edges, dtype=np.int64).reshape(-1, 2)
            ).to(self.device)
        self._keys = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.deg = np.zeros(n, dtype=np.int64)
        self._sorted_keys: Optional[np.ndarray] = None
        if e.numel():
            lo_e, hi_e = int(e.min().item()), int(e.max().item())
            if lo_e < 0 or hi_e >= n:
                raise ValueError(
                    f"edge endpoints must lie in [0, {n}); "
                    f"got [{lo_e}, {hi_e}]"
                )
            e = e[e[:, 0] != e[:, 1]]
            lo = torch.minimum(e[:, 0], e[:, 1])
            hi = torch.maximum(e[:, 0], e[:, 1])
            self._keys = torch.unique(lo * n + hi, sorted=True)
            if self._keys.numel():
                deg = (torch.bincount(self._keys // n, minlength=n)
                       + torch.bincount(self._keys % n, minlength=n))
                self.deg = deg.cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------ views
    @property
    def num_edges(self) -> int:
        return int(self._keys.shape[0])

    @property
    def keys(self) -> torch.Tensor:
        """Sorted int64 packed keys of the current edge set, on the
        session's device."""
        return self._keys

    def sorted_keys(self) -> np.ndarray:
        """The keys as a host array (cached until the next change) — the
        closure oracle of the approximate lane's estimator."""
        if self._sorted_keys is None:
            self._sorted_keys = self._keys.cpu().numpy()
        return self._sorted_keys

    def device_edges(self) -> torch.Tensor:
        """Current undirected edges as ``int64[m, 2]`` ``(lo, hi)`` rows in
        key order, on the session's device."""
        return keys_to_edges(self._keys, self.n_nodes)

    def edges(self) -> np.ndarray:
        """Current undirected edges as host ``int64[m, 2]`` ``(lo, hi)``
        rows in key order — ``from_edges(self.edges(), self.n_nodes)`` is
        the graph's CSR snapshot."""
        k = self.sorted_keys()
        if not k.size:
            return np.zeros((0, 2), dtype=np.int64)
        n = np.int64(self.n_nodes)
        return np.stack([k // n, k % n], axis=1)

    def _present(self, keys: np.ndarray) -> np.ndarray:
        """Host bool[k]: which of the packed ``keys`` (negative = none)
        are in the edge set — one ``searchsorted`` on the device."""
        m = self._keys.shape[0]
        if m == 0 or keys.size == 0:
            return np.zeros(keys.shape[0], dtype=bool)
        q = torch.from_numpy(keys).to(self.device)
        pos = torch.searchsorted(self._keys, q).clamp_(max=m - 1)
        return (self._keys[pos] == q).cpu().numpy()

    def _batch_keys(self, e: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(ok, key)`` per row: endpoints in ``[0, n)``, and the packed
        key (``-1`` for a rejected row or a self loop)."""
        n = self.n_nodes
        ok = (e >= 0).all(axis=1) & (e < n).all(axis=1)
        lo, hi = e.min(axis=1), e.max(axis=1)
        key = np.where(ok & (lo != hi), lo * np.int64(n) + hi, -1)
        return ok, key

    def has_edges(self, edges) -> np.ndarray:
        """bool[k]: membership of each (either-direction) pair."""
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return self._present(self._batch_keys(e)[1])

    # ------------------------------------------------------------ apply
    def apply(self, ops: np.ndarray, edges: np.ndarray) -> MutationResult:
        """Apply one mutation batch in stream order.

        Every update gets a structured status (:data:`EDGE_STATUSES`) and
        the result carries the batch's *net* set changes for the delta
        engine.  Degrees are updated live, per update."""
        ops = np.asarray(ops)
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if ops.shape[0] != e.shape[0]:
            raise ValueError(
                f"ops/edges length mismatch: {ops.shape[0]} vs {e.shape[0]}"
            )
        n = self.n_nodes
        ok, key = self._batch_keys(e)
        before = self._present(key)
        inserted: set[int] = set()   # net-new keys this batch
        deleted: set[int] = set()    # net-removed keys this batch
        statuses: list[str] = []
        for op, good, k, was in zip(ops.tolist(), ok.tolist(), key.tolist(),
                                    before.tolist()):
            if not good:
                statuses.append("rejected")
                continue
            if k < 0:
                statuses.append("noop-self-loop")
                continue
            lo, hi = divmod(k, n)
            present = (was or k in inserted) and k not in deleted
            if op >= 0:
                if present:
                    statuses.append("noop-present")
                else:
                    statuses.append("inserted")
                    deleted.discard(k)
                    if not was:
                        inserted.add(k)
                    self.deg[lo] += 1
                    self.deg[hi] += 1
            else:
                if not present:
                    statuses.append("noop-absent")
                else:
                    statuses.append("deleted")
                    if k in inserted:
                        inserted.discard(k)
                    else:
                        deleted.add(k)
                    self.deg[lo] -= 1
                    self.deg[hi] -= 1
        ins = np.sort(np.fromiter(inserted, dtype=np.int64))
        dels = np.sort(np.fromiter(deleted, dtype=np.int64))
        if ins.size or dels.size:
            keys = remove_keys(self._keys,
                               torch.from_numpy(dels).to(self.device))
            self._keys = _merge_keys(keys,
                                     torch.from_numpy(ins).to(self.device))
            self._sorted_keys = None
        return MutationResult(
            statuses=tuple(statuses),
            net_inserted=self._decode(ins),
            net_deleted=self._decode(dels),
        )

    def _decode(self, keys: np.ndarray) -> np.ndarray:
        if not keys.size:
            return np.zeros((0, 2), dtype=np.int64)
        n = np.int64(self.n_nodes)
        return np.stack([keys // n, keys % n], axis=1)


def keys_to_edges(keys: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Packed ``lo * n + hi`` keys as ``int64[m, 2]`` ``(lo, hi)`` rows."""
    if keys.numel() == 0:
        return torch.zeros((0, 2), dtype=torch.int64, device=keys.device)
    return torch.stack([keys // n_nodes, keys % n_nodes], dim=1)
