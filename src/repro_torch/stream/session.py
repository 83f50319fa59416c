"""The stream route's session handle (counterpart of
``repro.stream.session``): a mutable graph and live counts behind the
``TriangleEngine`` facade.

A :class:`StreamSession` (``TriangleEngine.stream()``) owns

* a :class:`~repro_torch.stream.state.MutableGraph` (the edge set as
  sorted keys on the engine's device),
* the current CSR snapshot (rebuilt on the device per applied batch,
  reused by the next batch's "before" probes),
* exact running totals: ``triangles`` and, with
  ``TCOptions(per_vertex=True)``, the live per-vertex credit array, both
  maintained by the delta engine (``stream.delta``),
* the *lazily refreshed* cover-edge state — BFS levels, the ``c1/c2``
  apex split, ``k`` and ``num_horizontal`` from the last full count —
  re-derived with one full count only once the touched-vertex fraction
  passes ``TCOptions.stream_staleness``,
* the approximate lane: a reservoir-backed
  :class:`~repro_torch.core.approx.StreamingWedgeEstimator`, which
  answers once one batch changes more than ``TCOptions.
  stream_exact_edges`` edges, until the next refresh.

An ``apply`` stream longer than ``TCOptions.stream_buffer`` is split
into buffer-sized batches, each applied and probed on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.approx import StreamingWedgeEstimator
from repro_torch.graph.csr import Graph
from repro_torch.stream.delta import batch_delta, padded_graph
from repro_torch.stream.state import (
    MutableGraph,
    MutationResult,
    keys_to_edges,
    normalize_stream,
    remove_keys,
)

__all__ = ["StreamSession", "StreamStats", "StreamUpdate"]


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """The stream route's report payload (``TriangleReport.stream``).

    ``staleness`` is the touched-vertex fraction since the last refresh,
    ``refreshes`` how many cover-set re-derivations have run, ``exact``
    whether the session's count is exactly maintained (False only after
    an over-budget batch, until the next refresh)."""

    batches: int
    updates: int
    inserted: int
    deleted: int
    noops: int
    rejected: int
    staleness: float
    stale_threshold: float
    refreshes: int
    probes: int
    approx_batches: int
    exact: bool


@dataclasses.dataclass(frozen=True)
class StreamUpdate:
    """One ``apply`` call's structured outcome.

    ``statuses`` has one entry per submitted update, in stream order.
    ``delta_triangles`` is the exact signed count change (``None`` when a
    batch took the approximate lane); ``triangles`` the session total
    after the call; ``refreshed`` whether this call re-derived the cover
    set."""

    statuses: tuple[str, ...]
    applied: int
    delta_triangles: Optional[int]
    triangles: int
    exact: bool
    staleness: float
    refreshed: bool


class StreamSession:
    """Mutable-graph session handle — construct via
    ``TriangleEngine.stream((edges, n_nodes))`` (or a packed ``Graph``).

    The session runs on its engine's device with the engine's options (or
    the explicit override); ``per_vertex=True`` keeps a live credit
    array."""

    def __init__(self, engine, graph_or_edges, *,
                 options=None, seed: int = 0):
        from repro_torch.api import TCOptions, _graph_edges

        o = options or engine.options
        if not isinstance(o, TCOptions):
            raise TypeError(
                f"options must be a TCOptions; got {type(o).__name__}"
            )
        if o.d_max is not None or o.cap_h is not None:
            raise ValueError(
                "stream sessions maintain exact counts; the lossy "
                "d_max/cap_h clamps only apply to the local route's "
                "one-shot exact planning"
            )
        self.engine = engine
        self.options = o
        if isinstance(graph_or_edges, Graph):
            edges, n_nodes = _graph_edges(graph_or_edges)
        else:
            edges, n_nodes = graph_or_edges
            n_nodes = int(n_nodes)
        self.state = MutableGraph(edges, n_nodes, device=engine.device)
        self._graph: Optional[Graph] = None  # CSR snapshot, rebuilt lazily
        self._clock = None
        # -- exact running totals -------------------------------------
        self.triangles = 0
        self.per_vertex: Optional[np.ndarray] = (
            np.zeros(n_nodes, dtype=np.int64) if o.per_vertex else None
        )
        # -- lazy cover-edge state (valid only between refresh and the
        #    first mutation after it) ---------------------------------
        self._levels: Optional[np.ndarray] = None
        self._c1: Optional[int] = None
        self._c2: Optional[int] = None
        self._k: float = float("nan")
        self._num_horizontal: int = 0
        self._touched = np.zeros(n_nodes, dtype=bool)
        # -- counters --------------------------------------------------
        self.batches = 0
        self.updates = 0
        self.inserted = 0
        self.deleted = 0
        self.noops = 0
        self.rejected = 0
        self.refreshes = 0
        self.probes = 0
        self.approx_batches = 0
        self.exact = True
        # -- approximate lane ------------------------------------------
        rate = float(o.stream_approx_rate)
        cap = max(64, int(rate * max(self.state.num_edges, 1024)))
        self.estimator = StreamingWedgeEstimator(
            n_nodes, reservoir=cap, seed=seed
        )
        self.estimator.reseed(self.state.sorted_keys())
        # the session opens refreshed: one full count derives the cover
        # set, seeds the exact totals, and prices every later delta
        self.refresh()

    # ------------------------------------------------------------ views
    @property
    def n_nodes(self) -> int:
        return self.state.n_nodes

    @property
    def num_edges(self) -> int:
        return self.state.num_edges

    @property
    def staleness(self) -> float:
        """Touched-vertex fraction since the last cover-set refresh."""
        n = self.state.n_nodes
        return int(self._touched.sum()) / n if n else 0.0

    @property
    def graph(self) -> Graph:
        """The current CSR snapshot (rebuilt on the device after
        mutations, cached), pow2-padded as the reference pads it."""
        if self._graph is None:
            self._graph = padded_graph(self.state.device_edges(),
                                       self.state.n_nodes,
                                       device=self.state.device)
        return self._graph

    def stats(self) -> StreamStats:
        return StreamStats(
            batches=self.batches, updates=self.updates,
            inserted=self.inserted, deleted=self.deleted,
            noops=self.noops, rejected=self.rejected,
            staleness=self.staleness,
            stale_threshold=float(self.options.stream_staleness),
            refreshes=self.refreshes, probes=self.probes,
            approx_batches=self.approx_batches, exact=self.exact,
        )

    def _lap(self, stage: str) -> None:
        if self._clock is not None:
            self._clock.lap(stage)

    # ------------------------------------------------------------ apply
    def apply(self, updates, *, refresh: Optional[bool] = None,
              clock=None) -> StreamUpdate:
        """Apply an edge-mutation stream and maintain the counts.

        ``updates`` is an iterable of ``(op, u, v)`` triples or a
        pre-split ``(ops, edges)`` pair, applied in order in batches of
        ``TCOptions.stream_buffer`` updates.  ``refresh=False`` pins the
        lazy refresh off for this call (``None`` = the staleness
        threshold decides, ``True`` forces a refresh at the end).  A
        ``clock`` (``core.sequential.StageClock``) splits the call into
        ``state`` (the edge-set update), ``snapshot`` (CSR builds),
        ``probe`` (the delta probes), ``host`` (degree and credit
        bookkeeping) and ``refresh``."""
        ops, edges = normalize_stream(updates)
        o = self.options
        total = ops.shape[0]
        statuses: list[str] = []
        delta_sum: Optional[int] = 0
        cap = int(o.stream_buffer)
        self._clock = clock
        if clock is not None:
            clock.start()
        try:
            for lo in range(0, total, cap):
                d = self._apply_batch(ops[lo:lo + cap], edges[lo:lo + cap],
                                      statuses)
                if d is None:
                    delta_sum = None
                elif delta_sum is not None:
                    delta_sum += d
            applied = statuses.count("inserted") + statuses.count("deleted")
            refreshed = False
            if refresh is True or (
                refresh is None
                and self.staleness > float(o.stream_staleness)
            ):
                self.refresh()
                refreshed = True
                self._lap("refresh")
        finally:
            self._clock = None
        return StreamUpdate(
            statuses=tuple(statuses),
            applied=applied,
            delta_triangles=delta_sum,
            triangles=self.triangles,
            exact=self.exact,
            staleness=self.staleness,
            refreshed=refreshed,
        )

    def insert(self, edges, **kw) -> StreamUpdate:
        """Convenience: ``apply`` with every row an insertion."""
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return self.apply((np.ones(e.shape[0], np.int8), e), **kw)

    def delete(self, edges, **kw) -> StreamUpdate:
        """Convenience: ``apply`` with every row a deletion."""
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return self.apply((-np.ones(e.shape[0], np.int8), e), **kw)

    def _apply_batch(self, ops, edges, statuses: list[str]) -> Optional[int]:
        """One capacity-bounded batch: mutate the edge set, then either
        the exact two-phase delta (deletes first, then inserts) or the
        approximate lane when the batch is over the exact budget.
        Returns the exact signed delta, or ``None`` on the approximate
        lane."""
        o = self.options
        g_before = self.graph if self.exact else None
        res: MutationResult = self.state.apply(ops, edges)
        self._lap("state")
        statuses.extend(res.statuses)
        self.batches += 1
        self.updates += int(ops.shape[0])
        c = res.counts
        self.inserted += c.get("inserted", 0)
        self.deleted += c.get("deleted", 0)
        self.noops += (c.get("noop-present", 0) + c.get("noop-absent", 0)
                       + c.get("noop-self-loop", 0))
        self.rejected += c.get("rejected", 0)
        if res.changed == 0:
            return 0
        self._graph = None  # CSR snapshot invalidated
        if o.stream_exact_edges is not None or not self.exact:
            # the reservoir answers only once a batch can exceed the
            # exact budget; with no budget the per-edge feed is skipped
            for u, v in res.net_deleted:
                self.estimator.delete(int(u), int(v))
            for u, v in res.net_inserted:
                self.estimator.insert(int(u), int(v))
            if self.estimator.hollow:
                self.estimator.reseed(self.state.sorted_keys())
        self._touched[res.net_inserted.ravel()] = True
        self._touched[res.net_deleted.ravel()] = True
        # mutations leave the exact *total* intact (the delta rule is
        # level-free) but stale the cover classification immediately
        self._levels = None
        self._c1 = self._c2 = None
        self._k = float("nan")
        self._num_horizontal = 0
        over_budget = (
            o.stream_exact_edges is not None
            and res.changed > int(o.stream_exact_edges)
        )
        if over_budget or not self.exact:
            self.exact = False
            self.approx_batches += 1
            self._lap("host")
            return None
        self._lap("host")
        return self._exact_delta(res, g_before)

    def _exact_delta(self, res: MutationResult, g_before: Graph) -> int:
        """The two-phase exactly-once delta (``stream.delta``)."""
        o = self.options
        pv = o.per_vertex
        n = self.state.n_nodes
        deg_after = self.state.deg
        delta = 0
        g_after = self.graph
        self._lap("snapshot")
        if res.net_deleted.shape[0]:
            # phase 1: deletes.  g_mid = before minus the deleted edges;
            # its degrees are the after-degrees minus the inserts
            deg_before = deg_after.copy()
            np.add.at(deg_before, res.net_deleted[:, 0], 1)
            np.add.at(deg_before, res.net_deleted[:, 1], 1)
            np.add.at(deg_before, res.net_inserted[:, 0], -1)
            np.add.at(deg_before, res.net_inserted[:, 1], -1)
            deg_mid = deg_before.copy()
            np.add.at(deg_mid, res.net_deleted[:, 0], -1)
            np.add.at(deg_mid, res.net_deleted[:, 1], -1)
            self._lap("host")
            if res.net_inserted.shape[0]:
                g_mid = padded_graph(self._edges_without(res.net_inserted),
                                     n, device=self.state.device)
                self._lap("snapshot")
            else:
                g_mid = g_after  # after == mid when nothing inserted
            d = batch_delta(
                res.net_deleted, g_small=g_mid, g_big=g_before,
                deg_small=deg_mid, deg_big=deg_before, n_nodes=n,
                options=o, per_vertex=pv, sign=-1,
            )
            self._lap("probe")
            self.probes += d.probes
            delta += d.triangles
            if pv:
                self.per_vertex += d.per_vertex
        else:
            g_mid = g_before
            deg_mid = deg_after.copy()
            np.add.at(deg_mid, res.net_inserted[:, 0], -1)
            np.add.at(deg_mid, res.net_inserted[:, 1], -1)
        self._lap("host")
        if res.net_inserted.shape[0]:
            d = batch_delta(
                res.net_inserted, g_small=g_mid, g_big=g_after,
                deg_small=deg_mid, deg_big=deg_after, n_nodes=n,
                options=o, per_vertex=pv, sign=+1,
            )
            self._lap("probe")
            self.probes += d.probes
            delta += d.triangles
            if pv:
                self.per_vertex += d.per_vertex
        self.triangles += delta
        self._lap("host")
        return delta

    def _edges_without(self, minus: np.ndarray):
        """Current edges minus the given ``(lo, hi)`` rows, as a device
        ``int64[m, 2]`` tensor — the intermediate ``G_mid`` of a mixed
        batch (deletes applied, inserts not yet)."""
        n = self.state.n_nodes
        drop = torch.from_numpy(minus[:, 0] * np.int64(n) + minus[:, 1])
        keys = remove_keys(self.state.keys, drop.to(self.state.device))
        return keys_to_edges(keys, n)

    # ---------------------------------------------------------- refresh
    def refresh(self) -> None:
        """Re-derive the cover-edge state with one full count (BFS
        levels, c1/c2 split, k), resync the exact totals (this is also
        what brings an approximate-lane session back to exact), and clear
        the staleness ledger."""
        o = self.options
        n = self.state.n_nodes
        if n == 0:
            self._levels = np.zeros((0,), np.int32)
            self._c1 = self._c2 = 0
            self._k, self._num_horizontal = 0.0, 0
            self.triangles = 0
            if o.per_vertex:
                self.per_vertex = np.zeros(0, dtype=np.int64)
        else:
            rep = self.engine.count(self.graph, route="local", options=o)
            self.triangles = int(rep.triangles)
            if o.per_vertex:
                self.per_vertex = np.asarray(rep.per_vertex).astype(np.int64)
            self._levels = rep.levels
            self._c1, self._c2 = rep.c1, rep.c2
            self._k = rep.k
            self._num_horizontal = rep.num_horizontal
        self._touched[:] = False
        self.refreshes += 1
        if not self.exact:
            self.exact = True
            self.estimator.reseed(self.state.sorted_keys())

    # ------------------------------------------------------------ count
    def count(self):
        """The session's live answer as a ``TriangleReport``
        (``route="stream"``).

        Freshly refreshed sessions carry the full cover-edge payload
        (levels, ``c1``/``c2``, measured ``k``); sessions with pending
        mutations answer exactly in the level-free regime (``c1``/``c2``
        ``None``, ``k`` ``NaN``), with the :class:`StreamStats` payload
        either way.  An approximate-lane session answers the estimator's
        rounded point estimate with its ``ApproxEstimate`` attached (and
        no per-vertex array)."""
        from repro_torch.api import Overflow, TriangleReport
        from repro_torch.core.intersect import resolve_backend

        o = self.options
        backend = resolve_backend(o.backend, self.state.device)
        stats = self.stats()
        if not self.exact:
            est = self.estimator.estimate(
                self.state.sorted_keys(), self.state.deg
            )
            return TriangleReport(
                triangles=int(round(est.triangles)), k=float("nan"),
                num_horizontal=0, c1=None, c2=None, overflow=Overflow(),
                route="stream", backend=backend,
                plan_id=f"stream-reservoir/{est.samples}", options=o,
                approx=est, stream=stats,
            )
        pv = degs = None
        if o.per_vertex and self.per_vertex is not None:
            pv = self.per_vertex.copy()
            degs = self.state.deg.copy()
        return TriangleReport(
            triangles=int(self.triangles), k=float(self._k),
            num_horizontal=int(self._num_horizontal),
            c1=self._c1, c2=self._c2, overflow=Overflow(),
            route="stream", backend=backend,
            plan_id=f"stream-delta/b{int(o.stream_buffer)}", options=o,
            levels=self._levels, per_vertex=pv, degrees=degs,
            stream=stats,
        )
