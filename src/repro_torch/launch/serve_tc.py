"""Triangle-analytics serving: the batch route as a request/response
front end (counterpart of ``repro.launch.serve_tc``).

The server batches a stream of edge-list requests (the per-community,
per-ego-net query shape of triangle analytics) over a
``repro_torch.api.TriangleEngine``: each request is rounded onto the
engine's ``BudgetGrid`` cell, each cell keeps its own queue, and a full
queue flushes as one ``GraphBatch`` — BFS, compaction and the probe of
every lane with one bounded plan from the engine's cache (one K1 launch
per bucket for all lanes on the card).  A partial queue flushes at
``drain`` on the smallest power-of-two lane count that holds it.

Batches in flight are pipelined: a flush records a ``torch.cuda.Event``
after its batch, and the batch is read back once the event has passed
(``Event.query()``), when more than ``max_inflight`` are queued, or at
``drain``.  The BFS syncs the host once per sweep inside the flush, so
the overlap is little.  On the CPU a batch is ready when it returns.

Robustness (DESIGN.md §7), governed by the engine's ``TCOptions``:

* **deadlines** — a request carries a deadline (``submit(deadline_s=)``
  or ``options.deadline_s``), and a cell's partial queue flushes once
  its oldest deadline's slack falls below the cell's measured flush
  cost (an EWMA of flush-to-read-back seconds, ``EWMA_PRIOR_S`` for a
  cold cell).  The server has no thread: ``submit`` and ``drain`` pump,
  and an open-loop driver calls :meth:`TriangleServer.pump`.
* **admission** — with ``options.admission_tokens``, a cell holding
  that many pending and in-flight requests degrades the next one: the
  host-side wedge-sampled estimate (``engine.count_approx`` at
  ``seed=request id``, ``route="approx"``), or a structured shed with
  ``approx_on_overload=False``.
* **failures** — a flush whose fault hook raises :class:`FaultInjected`
  (``launch/robust.py``'s ``FaultPlan``), or whose host-side packing
  raises ``ValueError``/``TypeError``, answers every lane of its batch
  through the same ladder and releases the cell's tokens.  Any other
  error — a kernel that does not build, a CUDA error at launch, at the
  event's ``query()`` or at read-back — propagates from
  ``submit``/``pump``/``drain``, so host answers never stand in for a
  broken kernel.  (The reference degrades every exception.)

* **over-budget requests** — over a capped ``BudgetGrid``, a request
  past the top cell is answered on the distributed route (Algorithm 2
  over the engine's shard group, K3 on the card) at its own shape.  With
  ``options.distributed_timeout_s`` an attempt runs on a worker thread
  (on the card, on a CUDA stream of its own) under a wall-clock timeout;
  a timed-out or injected-failed attempt retries once in ``ring`` mode
  at an 8x smaller gather buffer, and a second failure degrades through
  the ladder.  A timed-out attempt is abandoned (counted), its thread
  left to finish: it holds its own graph reference and stream, so the
  retry shares no buffer with it.

Every submitted request id receives exactly one result — exact
(:class:`TriangleAnalytics`, ``route="batched"`` or ``"distributed"``),
approx, or a :class:`RejectedRequest` — and ``submit``/``drain`` never
raise on bad input or an injected failure (``strict=True`` raises on
malformed input).

Autotuning hooks (``repro_torch.tune``): ``recorder`` (a
``TraceRecorder``) captures every validated request's route, cell,
degree meta and edges; ``prewarm=True`` plans every cell of the engine's
tuned profile at every lane count of the drain ladder, runs each plan
once on an empty batch and loads the kernels' libraries, before the
first request.  ``summary()["jit_compiles"]`` counts the libraries
loaded (or built) since the server came up, the port's counterpart of
the reference's jit compiles.

    PYTHONPATH=src python -m repro_torch.launch.serve_tc --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_tc --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_tc --requests 96 \\
        --batch-sizes 1 8 16 --out serve.json

It runs on the card unless ``--device cpu`` is given, and writes a file
only when ``--out`` names one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import time
import warnings
from collections import defaultdict, deque
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.graph import generators as gen
from repro_torch.graph.csr import (
    BudgetGrid,
    ShapeBudget,
    from_edges,
    from_edges_batch,
)
from repro_torch.kernels import build


@dataclasses.dataclass
class TriangleAnalytics:
    """One request's response: the paper's per-graph analytics and the
    latency from submit to the answer.  ``route`` is ``"batched"`` (a
    lane of a batch), ``"distributed"`` (an over-budget graph answered
    by Algorithm 2: ``c1``/``c2`` ``None``, ``report`` the full report,
    ``budget`` the graph's own shape) or ``"approx"`` (the degraded
    lane: ``approx`` is the
    :class:`~repro_torch.core.approx.ApproxEstimate`, ``report`` the
    full report, ``c1``/``c2`` ``None``, ``k`` ``NaN``).  ``overflow``
    is the lane's width-overflow flag: False whenever the bounded plan's
    bounds were true upper bounds; True marks the count invalid, never
    silently wrong.  ``per_vertex`` is the request's own vertices'
    credit when the engine runs with ``TCOptions(per_vertex=True)``;
    always ``None`` on the approx route."""

    request_id: int
    n_nodes: int
    triangles: int
    c1: Optional[int]
    c2: Optional[int]
    num_horizontal: int
    k: float
    latency_s: float
    budget: Optional[ShapeBudget]
    overflow: bool = False
    route: str = "batched"
    report: Optional[object] = None
    approx: Optional[object] = None
    per_vertex: Optional[np.ndarray] = None


@dataclasses.dataclass
class RejectedRequest:
    """The shed rung of the degradation ladder: a structured answer for
    a request the server could not serve, carrying its id, so one bad
    request never aborts a batch of good ones.  ``reason`` is
    ``"malformed"`` (the request did not validate), ``"overloaded"``
    (admission shed it: its cell was full and the approx rung is off)
    or ``"failed"`` (its batch failed, and the approx rung is off or
    failed too)."""

    request_id: int
    reason: str
    detail: str
    latency_s: float = 0.0
    route: str = "rejected"


#: everything ``TriangleServer.results`` holds: one entry per submitted id
ServeResult = Union[TriangleAnalytics, RejectedRequest]


class FaultInjected(RuntimeError):
    """A deterministic injected failure (``launch.robust.FaultPlan``): a
    type of its own, so chaos tests tell injected faults from real
    failures of the paths they exercise."""


@dataclasses.dataclass
class _Pending:
    request_id: int
    edges: np.ndarray
    n_nodes: int
    t_submit: float
    #: absolute ``perf_counter`` deadline (``None``: the request flushes
    #: only on batch size or drain)
    deadline: Optional[float] = None


@dataclasses.dataclass
class _InFlight:
    reqs: list
    budget: ShapeBudget
    res: object  # the batch's lane-axis TCResult
    t_flush: float
    done: Optional[torch.cuda.Event]  # None on the CPU


class TriangleServer:
    """Budget-bucketed batching front end over a ``TriangleEngine``
    (construct it with ``TriangleEngine.serve()``).

    ``submit`` puts a request on its budget cell's queue and flushes the
    queue as one batch when it holds ``batch_size`` requests; ``drain``
    flushes the partial queues, each at the smallest power of two lanes
    that holds it (:func:`lanes_ladder`), and reads back every batch in
    flight.  A flush pools its batch's meta to the cell's high-water
    mark (``engine.pool_meta``), so a cell's batches share one plan per
    lane count, taken from the engine's plan cache.

    The robustness mechanics of the module docstring (deadlines and
    :meth:`pump`, the admission tokens, the approx-or-shed ladder for
    overload and failed batches) follow the reference's rules and
    counters.  ``faults`` (a ``launch.robust.FaultPlan``) gets
    ``before_batch(batches_run)`` at every flush; ``batches_run``
    advances only on a flush that dispatched, so a plan's failure
    ordinal repeats until the schedule moves past it, as in the
    reference.  Only an injected fault or a packing error fails a
    batch; a device error propagates and leaves the server unusable.
    """

    #: flush-cost prior (seconds) of a budget cell before its first
    #: measured flush: conservative, so the first deadline-carrying
    #: request of a cold cell flushes early, not late
    EWMA_PRIOR_S = 0.05
    #: EWMA smoothing of each cell's flush-to-read-back seconds
    EWMA_ALPHA = 0.3

    def __init__(self, engine, *, batch_size: int = 8, max_inflight: int = 8,
                 strict: bool = False, faults=None, prewarm: bool = False,
                 recorder=None):
        o = engine.options
        if o.d_max is not None or o.cap_h is not None:
            raise ValueError(
                "serving runs cached bounded plans; d_max/cap_h only "
                "apply to the local route's exact planning"
            )
        if int(batch_size) <= 0 or int(max_inflight) < 0:
            raise ValueError(f"batch_size must be positive and max_inflight "
                             f">= 0; got {batch_size}, {max_inflight}")
        self.engine = engine
        self.batch_size = int(batch_size)
        self.max_inflight = int(max_inflight)
        self.strict = bool(strict)
        self.faults = faults
        self._pending: dict[ShapeBudget, list[_Pending]] = defaultdict(list)
        self._inflight: deque[_InFlight] = deque()
        self._next_id = 0
        self.results: list[ServeResult] = []
        self.batches_run = 0
        self.distributed_requests = 0
        self.distributed_timeouts = 0
        self.distributed_retries = 0
        #: distributed attempts abandoned after their timeout; each one's
        #: thread runs on to its end (a running count is not cancelled)
        self.abandoned_distributed = 0
        #: pending + in-flight requests per budget cell (the admission
        #: ledger)
        self._tokens: dict[ShapeBudget, int] = defaultdict(int)
        self._flush_ewma_s: dict[ShapeBudget, float] = {}
        self.deadline_flushes = 0
        self.size_flushes = 0
        self.approx_answers = 0
        self.rejected_requests = 0
        self.failed_batches = 0
        #: named live stream sessions: mutation requests address graphs
        #: by name
        self._sessions: dict[str, object] = {}
        self.stream_mutations = 0
        #: a ``repro_torch.tune.trace.TraceRecorder`` fed every validated
        #: request, or None
        self.recorder = recorder
        if prewarm:
            self.prewarm()
        # plan_hit and jit_compiles in summary() count from here on: the
        # prewarm's own misses and loads are its point, not serving cost
        ps = engine.plan_cache_stats()
        self._plan_baseline = (ps["hits"], ps["misses"])
        self._loads_baseline = build.loads()

    def prewarm(self) -> None:
        """Plan and load before the first request, from the engine's
        tuned profile (nothing without one).

        For every profile cell with a meta ceiling: pool the ceiling into
        the engine's mark, then for each lane count of
        :func:`lanes_ladder` pack an empty batch at that ceiling, plan it
        (``engine.plan_for``) and run it (``count_batch_raw``) — the
        ``(budget, lanes, plan)`` keys that serving flushes use.  The
        meta quantizers commute with ``max``, so every flush of covered
        traffic then hits a cached plan.  On the card the intersection
        kernels' library is loaded first (built where missing), and each
        empty batch launches K1 (K2 with per-vertex credit) on every
        bucket of its plan, padding rows only, as a real batch of that
        lane count would, so CUDA loads each kernel the plan reaches."""
        eng = self.engine
        if eng.profile is None:
            return
        if eng.device.type == "cuda":
            build.library("intersect")
        for cell in eng.profile.cells:
            if cell.meta is None:
                continue  # no ceiling to key the warm plan on
            pooled = eng.pool_meta(cell.budget, cell.meta)
            for lanes in lanes_ladder(self.batch_size):
                gb = from_edges_batch([], budget=cell.budget,
                                      batch_size=lanes, device=eng.device)
                gb = dataclasses.replace(gb, meta=pooled)
                res = eng.count_batch_raw(gb, plan=eng.plan_for(gb))
                res.triangles.cpu()  # wait for the batch

    @property
    def grid(self) -> BudgetGrid:
        return self.engine.budgets

    def submit(self, edges: np.ndarray, n_nodes: int, *,
               deadline_s: Optional[float] = None,
               strict: Optional[bool] = None) -> int:
        """Enqueue one graph and return its request id; flush its budget
        cell's queue when full, or earlier when a pending deadline's
        slack runs out (results land in ``self.results``).

        Malformed input (an edge array that does not parse, a negative
        ``n_nodes``, endpoints outside ``[0, n_nodes)``) is answered with
        a :class:`RejectedRequest` of this id; ``strict=True`` (per call
        or server-wide) raises instead.  A request whose cell holds
        ``options.admission_tokens`` is answered at once through the
        degradation ladder.  ``deadline_s`` is relative to now; ``None``
        falls back to ``options.deadline_s`` (``None`` there too: no
        deadline)."""
        self._poll_inflight()  # stamp finished batches BEFORE new host work
        self._pump_deadlines()  # expiring lanes flush BEFORE new admits
        rid = self._next_id
        self._next_id += 1
        strict = self.strict if strict is None else bool(strict)
        t_submit = time.perf_counter()
        try:
            edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
            n_nodes = int(n_nodes)
            if n_nodes < 0:
                raise ValueError(f"n_nodes must be >= 0; got {n_nodes}")
            if edges.size and (edges.min() < 0 or edges.max() >= n_nodes):
                raise ValueError(
                    f"edge endpoints must lie in [0, {n_nodes}); "
                    f"got [{edges.min()}, {edges.max()}]"
                )
        except (ValueError, TypeError) as exc:
            if strict:
                raise ValueError(f"request {rid}: {exc}") from exc
            self._reject(rid, "malformed", str(exc), t_submit)
            return rid
        o = self.engine.options
        rel = deadline_s if deadline_s is not None else o.deadline_s
        deadline = t_submit + float(rel) if rel is not None else None
        # the server is the batch route: its one dispatch decision is the
        # batch queue or, past a capped grid's top cell, Algorithm 2
        if self.engine.route_for(n_nodes, edges.shape[0],
                                 route="auto") == "distributed":
            self._record_trace(rid, edges, n_nodes, "distributed", None, rel)
            self._serve_distributed(rid, edges, n_nodes, t_submit)
            return rid
        budget = self.grid.budget_for(n_nodes, edges.shape[0])
        self._record_trace(rid, edges, n_nodes, "batch", budget, rel)
        if (o.admission_tokens is not None
                and self._tokens[budget] >= o.admission_tokens):
            # the cell is full: the ladder's degrade rung (shed if off)
            self._degrade(rid, edges, n_nodes, t_submit, budget=budget,
                          why="overloaded",
                          detail=f"budget cell {budget} at "
                                 f"{self._tokens[budget]} tokens")
            return rid
        self._tokens[budget] += 1
        q = self._pending[budget]
        q.append(_Pending(rid, edges, n_nodes, t_submit, deadline))
        if len(q) >= self.batch_size:
            self._flush(budget, cause="size")
        return rid

    def _record_trace(self, rid, edges, n_nodes, route, budget, rel) -> None:
        """Feed one validated, routed request to the recorder.  A
        recorder failure is warned about and never raised: recording is
        observability, and ``submit`` does not raise on it."""
        if self.recorder is None:
            return
        try:
            self.recorder.record(request_id=rid, edges=edges,
                                 n_nodes=n_nodes, route=route,
                                 budget=budget, deadline_s=rel)
        except Exception as exc:  # noqa: BLE001 — tracing must not stop serving
            warnings.warn(f"trace recorder failed on request {rid}: {exc}")

    # ------------------------------------------------ degradation ladder
    def _reject(self, rid: int, reason: str, detail: str,
                t_submit: float) -> None:
        self.rejected_requests += 1
        self.results.append(RejectedRequest(
            request_id=rid, reason=reason, detail=detail,
            latency_s=time.perf_counter() - t_submit,
        ))

    def _degrade(self, rid: int, edges: np.ndarray, n_nodes: int,
                 t_submit: float, *, budget: Optional[ShapeBudget],
                 why: str, detail: str) -> None:
        """The ladder's lower rungs: answer through the host-side
        wedge-sampled estimate (error bars attached), else shed with a
        structured rejection.  Never raises: an estimator failure falls
        through to the shed rung."""
        o = self.engine.options
        if o.approx_on_overload:
            try:
                report = self.engine.count_approx((edges, n_nodes),
                                                  seed=rid, options=o)
            except Exception as exc:  # noqa: BLE001 — the ladder must not raise
                detail = f"{detail}; approx lane failed: {exc}"
            else:
                self.approx_answers += 1
                self.results.append(TriangleAnalytics(
                    request_id=rid, n_nodes=n_nodes,
                    triangles=report.triangles, c1=None, c2=None,
                    num_horizontal=0, k=float("nan"),
                    latency_s=time.perf_counter() - t_submit,
                    budget=budget, overflow=False, route="approx",
                    report=report, approx=report.approx,
                ))
                return
        self._reject(rid, why, detail, t_submit)

    def pump(self) -> None:
        """One poll step for open-loop drivers: read back every finished
        batch in flight and fire any due deadline flush.  Safe at any
        time, in any state, at any frequency."""
        self._poll_inflight()
        self._pump_deadlines()

    def _pump_deadlines(self) -> None:
        """Flush every partial queue whose oldest pending deadline has
        less slack left than the cell's measured flush cost (the prior
        for a cold cell)."""
        now = time.perf_counter()
        for budget in [b for b, q in self._pending.items() if q]:
            dls = [p.deadline for p in self._pending[budget]
                   if p.deadline is not None]
            if not dls:
                continue
            cost = self._flush_ewma_s.get(budget, self.EWMA_PRIOR_S)
            if min(dls) - now <= cost:
                self._flush(budget, cause="deadline")

    # -------------------------------------------------- stream sessions
    def stream_session(self, name: str, graph_or_edges=None, *,
                       options=None, seed: int = 0):
        """Open (with ``graph_or_edges``) or fetch (without) the named
        live :class:`~repro_torch.stream.session.StreamSession` over this
        server's engine.  Re-opening a live name raises: close it
        first."""
        if graph_or_edges is None:
            try:
                return self._sessions[name]
            except KeyError:
                raise KeyError(
                    f"no open stream session named {name!r}; open one "
                    "with stream_session(name, (edges, n_nodes))"
                ) from None
        if name in self._sessions:
            raise ValueError(
                f"stream session {name!r} is already open; "
                "close_session() it before re-opening the name"
            )
        sess = self.engine.stream(graph_or_edges, options=options,
                                  seed=seed)
        self._sessions[name] = sess
        return sess

    def mutate(self, name: str, updates, *, refresh=None):
        """Apply one mutation request to the named session and return
        its ``StreamUpdate``.  Mutations run at once and never enter the
        batch queues."""
        up = self.stream_session(name).apply(updates, refresh=refresh)
        self.stream_mutations += len(up.statuses)
        return up

    def stream_count(self, name: str):
        """The named session's current ``route="stream"`` report."""
        return self.stream_session(name).count()

    def close_session(self, name: str):
        """Close the named session and return its final ``StreamStats``."""
        sess = self.stream_session(name)
        del self._sessions[name]
        return sess.stats()

    # ----------------------------------------------------------- batches
    def _serve_distributed(self, rid: int, edges: np.ndarray, n_nodes: int,
                           t_submit: float) -> None:
        """Answer one over-budget request on the engine's distributed
        route, at the graph's own shape: the response has ``c1``/``c2``
        ``None`` and the full report.  A timed-out or injected-failed
        attempt retries once in ``ring`` mode at an 8x smaller gather
        buffer; a second failure degrades through the ladder.  Any other
        error (a device error) propagates, as on the batch path."""
        o = self.engine.options
        g = from_edges(edges, n_nodes, device=self.engine.device)
        attempts = [o]
        if o.mode != "ring" or o.gather_buffer_limit_bytes > (1 << 20):
            attempts.append(dataclasses.replace(
                o, mode="ring",
                gather_buffer_limit_bytes=max(
                    1 << 20, o.gather_buffer_limit_bytes >> 3),
            ))
        report, last_err = None, "no attempt ran"
        for attempt, opts in enumerate(attempts):
            try:
                report = self._run_distributed(g, opts, rid, attempt)
                break
            except (FaultInjected, TimeoutError) as exc:
                last_err = f"attempt {attempt} ({opts.mode}): {exc}"
                if attempt + 1 < len(attempts):
                    self.distributed_retries += 1
        # batches that finished while the distributed run held the host
        self._poll_inflight()
        if report is None:
            self._degrade(rid, edges, n_nodes, t_submit, budget=None,
                          why="failed", detail=f"distributed: {last_err}")
            return
        self.distributed_requests += 1
        self.results.append(TriangleAnalytics(
            request_id=rid, n_nodes=n_nodes, triangles=report.triangles,
            c1=report.c1, c2=report.c2,
            num_horizontal=report.num_horizontal, k=report.k,
            latency_s=time.perf_counter() - t_submit,
            budget=ShapeBudget(n_budget=g.n_nodes, slot_budget=g.num_slots),
            overflow=report.overflow.any, route="distributed",
            report=report, per_vertex=report.per_vertex,
        ))

    def _run_distributed(self, g, opts, rid: int, attempt: int):
        """One distributed attempt, wall-clock-bounded when
        ``opts.distributed_timeout_s`` is set: then it runs on a worker
        thread (on the card, on a CUDA stream of its own, after the
        graph's stream), and a timed-out attempt is abandoned (counted)
        rather than blocking the serving loop."""
        dev = self.engine.device

        def call():
            if self.faults is not None:
                self.faults.before_distributed(rid, attempt)
            return self.engine.count(g, route="distributed", options=opts)

        timeout = opts.distributed_timeout_s
        if timeout is None:
            return call()

        def on_own_stream():
            if dev.type != "cuda":
                return call()
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                return call()

        ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"tc-dist-{rid}")
        fut = ex.submit(on_own_stream)
        try:
            return fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            self.distributed_timeouts += 1
            self.abandoned_distributed += 1
            raise TimeoutError(
                f"exceeded distributed_timeout_s={timeout}") from None
        finally:
            ex.shutdown(wait=False)

    def drain(self) -> list[ServeResult]:
        """Flush every partial queue (right-sized), read back every
        batch in flight, and return all results so far (the empty list
        on a server that has seen no request)."""
        for budget in [b for b, q in self._pending.items() if q]:
            self._flush(budget, cause="drain")
        while self._inflight:
            self._finalize_one()
        return self.results

    def _flush(self, budget: ShapeBudget, *, cause: str = "size") -> None:
        """Dispatch a cell's queue as one batch.  ``cause`` is
        ``"deadline"`` (counted apart), ``"size"`` or ``"drain"``.  A
        :class:`FaultInjected` from the fault hook, or a ``ValueError``
        or ``TypeError`` from packing, fails the batch
        (:meth:`_fail_batch`); an error of the dispatch propagates."""
        reqs = self._pending.pop(budget, [])
        if not reqs:
            return
        if cause == "deadline":
            self.deadline_flushes += 1
        else:
            self.size_flushes += 1
        lanes = self.batch_size
        if len(reqs) < lanes:  # partial flush: smallest pow2 ladder step
            lanes = min(lanes, 1 << (len(reqs) - 1).bit_length())
        t_flush = time.perf_counter()
        eng = self.engine
        try:
            if self.faults is not None:
                self.faults.before_batch(self.batches_run)
            gb = from_edges_batch([(r.edges, r.n_nodes) for r in reqs],
                                  budget=budget, batch_size=lanes,
                                  device=eng.device)
            gb = dataclasses.replace(gb, meta=eng.pool_meta(budget, gb.meta))
        except (FaultInjected, ValueError, TypeError) as exc:
            self._fail_batch(reqs, budget, exc)
            return
        res = eng.count_batch_raw(gb, plan=eng.plan_for(gb))
        done = None
        if eng.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(eng.device))
        self._inflight.append(_InFlight(reqs, budget, res, t_flush, done))
        self.batches_run += 1
        self._poll_inflight()
        while len(self._inflight) > self.max_inflight:
            self._finalize_one()

    def _fail_batch(self, reqs, budget: ShapeBudget, exc: Exception) -> None:
        """A flush failed before dispatch: release the cell's tokens and
        answer every request of the batch through the ladder."""
        self.failed_batches += 1
        self._tokens[budget] -= len(reqs)
        for r in reqs:
            self._degrade(r.request_id, r.edges, r.n_nodes, r.t_submit,
                          budget=budget, why="failed",
                          detail=f"batch dispatch failed: {exc}")

    @staticmethod
    def _batch_ready(f: _InFlight) -> bool:
        return f.done is None or f.done.query()

    def _poll_inflight(self) -> None:
        """Read back every batch in flight that has finished on the
        device, so its requests' latency is stamped near its end."""
        while self._inflight and self._batch_ready(self._inflight[0]):
            self._finalize_one()

    def _finalize_one(self) -> None:
        """Read back the oldest batch in flight (an error of the read-back
        is the device's, and propagates)."""
        f = self._inflight.popleft()
        res = f.res
        tri, c1, c2, nh, ovf = torch.stack([
            res.triangles, res.c1, res.c2, res.num_horizontal,
            res.h_overflow.to(torch.int32)]).cpu().numpy()
        k = res.k.cpu().numpy()
        pv = (res.per_vertex.cpu().numpy()
              if res.per_vertex is not None else None)
        done = time.perf_counter()
        sample = done - f.t_flush  # flush to read-back, per cell
        prev = self._flush_ewma_s.get(f.budget)
        self._flush_ewma_s[f.budget] = (
            sample if prev is None
            else self.EWMA_ALPHA * sample + (1 - self.EWMA_ALPHA) * prev
        )
        self._tokens[f.budget] -= len(f.reqs)
        for i, r in enumerate(f.reqs):
            self.results.append(TriangleAnalytics(
                request_id=r.request_id, n_nodes=r.n_nodes,
                triangles=int(tri[i]), c1=int(c1[i]), c2=int(c2[i]),
                num_horizontal=int(nh[i]), k=float(k[i]),
                latency_s=done - r.t_submit, budget=f.budget,
                overflow=bool(ovf[i]),
                # the request's own vertices out of its budget-padded lane
                per_vertex=pv[i, :r.n_nodes] if pv is not None else None,
            ))

    def summary(self) -> dict:
        """The ops scrape, safe at any moment (before the first submit,
        with lanes in flight, after an all-rejected storm), with the
        reference's keys.  Percentiles are over completed (exact and
        approx) answers.  ``plan_hit`` and ``jit_compiles`` (libraries
        loaded or built, :func:`repro_torch.kernels.build.loads`) count
        from the server's start, after its prewarm."""
        completed = [r for r in self.results
                     if isinstance(r, TriangleAnalytics)]
        lat = sorted(r.latency_s for r in completed)
        by_route: dict[str, int] = defaultdict(int)
        for r in self.results:
            by_route[r.route] += 1
        ps = self.engine.plan_cache_stats()
        hits = ps["hits"] - self._plan_baseline[0]
        looked = hits + ps["misses"] - self._plan_baseline[1]
        return {
            "plan_hit": 1.0 if looked <= 0 else hits / looked,
            "jit_compiles": build.loads() - self._loads_baseline,
            "requests": len(self.results),
            "completed": len(completed),
            "rejected": self.rejected_requests,
            "by_route": dict(by_route),
            "batches": self.batches_run,
            "failed_batches": self.failed_batches,
            "distributed_requests": self.distributed_requests,
            "distributed_timeouts": self.distributed_timeouts,
            "distributed_retries": self.distributed_retries,
            "abandoned_distributed": self.abandoned_distributed,
            "deadline_flushes": self.deadline_flushes,
            "size_flushes": self.size_flushes,
            "approx_answers": self.approx_answers,
            "stream_sessions": len(self._sessions),
            "stream_mutations": self.stream_mutations,
            "pending": sum(len(q) for q in self._pending.values()),
            "inflight": len(self._inflight),
            "flush_cost_ewma_ms": {
                f"{b.n_budget}x{b.slot_budget}": 1e3 * v
                for b, v in sorted(self._flush_ewma_s.items())
            },
            "p50_ms": _pct_ms(lat, 50),
            "p99_ms": _pct_ms(lat, 99),
        }


def _pct_ms(sorted_lat: Sequence[float], p: float) -> float:
    """Nearest-rank percentile of a sorted latency list, in ms."""
    if not sorted_lat:
        return 0.0
    i = max(0, math.ceil(p / 100.0 * len(sorted_lat)) - 1)
    return 1e3 * sorted_lat[min(len(sorted_lat) - 1, i)]


def synth_requests(num: int, *, seed: int = 0,
                   smoke: bool = False) -> list[tuple[np.ndarray, int]]:
    """The reference's mixed small/medium analytics stream (the same
    graphs for the same seed): per-community ER graphs, RMAT ego-net
    graphs and dense cliques over 2–3 budget cells."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(num):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            n = int(rng.integers(24, 120))
            reqs.append(gen.erdos_renyi(
                n, float(rng.uniform(0.05, 0.15)),
                seed=int(rng.integers(1 << 30)),
            ))
        elif kind == 1:
            scale = int(rng.integers(5, 7 if smoke else 8))
            reqs.append(gen.rmat(scale, 8, seed=int(rng.integers(1 << 30))))
        else:
            reqs.append(gen.complete(int(rng.integers(5, 14))))
    return reqs


def lanes_ladder(batch_size: int) -> list[int]:
    """The lane counts a server of this ``batch_size`` can flush at:
    1, 2, 4, ... then ``batch_size`` itself."""
    ladder, lanes = [], 1
    batch_size = int(batch_size)
    while lanes < batch_size:
        ladder.append(lanes)
        lanes <<= 1
    ladder.append(batch_size)
    return ladder


def sequential_loop(engine, reqs: Sequence[tuple[np.ndarray, int]]):
    """The budget-padded sequential loop: each request packed to its
    budget cell on the engine's device, counted alone on the local
    route and read back.  Returns ``(wall seconds, sorted per-request
    seconds, answers)``, each answer ``(triangles, c1, c2, n_h, k's
    float32 bytes)`` in request order (what :func:`_same` compares)."""
    lats, want = [], []
    t0 = time.perf_counter()
    for e, n in reqs:
        t1 = time.perf_counter()
        b = engine.budgets.budget_for(n, np.asarray(e).reshape(-1, 2).shape[0])
        g = from_edges(e, b.n_budget, num_slots=b.slot_budget,
                       device=engine.device)
        r = engine.count_raw(g)
        want.append((int(r.triangles), int(r.c1), int(r.c2),
                     int(r.num_horizontal), r.k.cpu().numpy().tobytes()))
        lats.append(time.perf_counter() - t1)
    return time.perf_counter() - t0, sorted(lats), want


def _same(r, want) -> bool:
    """A served answer equal to the sequential loop's (triangles, c1,
    c2, n_h, k's float32 bits) and not flagged."""
    return ((r.triangles, r.c1, r.c2, r.num_horizontal) == want[:4]
            and np.float32(r.k).tobytes() == want[4] and not r.overflow)


def measure_serve(
    *,
    num_requests: int = 96,
    batch_sizes: Sequence[int] = (1, 2, 8, 16),
    backend: str = "auto",
    seed: int = 0,
    smoke: bool = False,
    device: Union[str, torch.device] = "cuda",
    requests: Optional[Sequence[tuple[np.ndarray, int]]] = None,
    out: Optional[str] = None,
) -> dict:
    """Throughput and latency of the server against the sequential loop
    of one count per request, on one request mix (``requests``, else
    ``synth_requests(num_requests, seed=seed, smoke=smoke)``).

    The loop gets the same shapes: each graph is padded to its budget
    cell and counted alone on the local route, its result read back.
    Both sides run once unmeasured on the same requests first; one
    ``TriangleEngine`` serves all of it.  ``agree`` is True iff every
    request id's served answer equals the loop's (triangles, c1, c2,
    n_h, k bit for bit) and no lane overflowed.  Writes the row to
    ``out`` when given and prints one CSV line per run."""
    from repro_torch.api import TCOptions, TriangleEngine

    engine = TriangleEngine(TCOptions(backend=backend), device=device)
    dev = engine.device
    reqs = list(requests) if requests is not None else synth_requests(
        num_requests, seed=seed, smoke=smoke)
    num_requests = len(reqs)
    budgets = [
        engine.budgets.budget_for(n, np.asarray(e).reshape(-1, 2).shape[0])
        for e, n in reqs
    ]
    sequential_loop(engine, reqs)  # warm-up
    seq_wall, seq_lats, want = sequential_loop(engine, reqs)
    row: dict = {
        "num_requests": num_requests,
        "seed": seed,
        "smoke": smoke,
        "backend": backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "budget_cells": len(set(budgets)),
        "sequential": {
            "graphs_per_s": num_requests / seq_wall,
            "wall_s": seq_wall,
            "p50_ms": _pct_ms(seq_lats, 50),
            "p99_ms": _pct_ms(seq_lats, 99),
            "triangles_total": sum(w[0] for w in want),
        },
        "batched": [],
        "agree": True,
    }
    print(f"serve_seq,{seq_wall / num_requests * 1e6:.0f},"
          f"graphs_per_s={num_requests / seq_wall:.1f}"
          f"|p50_ms={_pct_ms(seq_lats, 50):.2f}"
          f"|p99_ms={_pct_ms(seq_lats, 99):.2f}", flush=True)

    for B in batch_sizes:
        warm = engine.serve(batch_size=B)
        for e, n in reqs:
            warm.submit(e, n)
        warm.drain()  # the plan cache now holds every cell's plan
        engine.plan_cache_stats(reset=True)
        loads0 = build.loads()
        server = engine.serve(batch_size=B)
        t0 = time.perf_counter()
        for e, n in reqs:
            server.submit(e, n)
        server.drain()
        wall = time.perf_counter() - t0
        stats = server.summary()
        plan_stats = engine.plan_cache_stats()
        # per request id, not a stream total that errors could cancel in
        by_id = {r.request_id: r for r in server.results}
        agree = len(by_id) == num_requests and all(
            _same(by_id[i], want[i]) for i in range(num_requests))
        row["agree"] = row["agree"] and agree
        looked = plan_stats["hits"] + plan_stats["misses"]
        entry = {
            "batch_size": B,
            "graphs_per_s": num_requests / wall,
            "wall_s": wall,
            "p50_ms": stats["p50_ms"],
            "p99_ms": stats["p99_ms"],
            "batches": stats["batches"],
            "speedup_vs_sequential": seq_wall / wall,
            "plan_cache_hit_rate": plan_stats["hits"] / max(looked, 1),
            "jit_compiles_measured": build.loads() - loads0,
            "triangles_total": sum(r.triangles for r in server.results),
            "agree": agree,
        }
        row["batched"].append(entry)
        print(f"serve_b{B},{wall / num_requests * 1e6:.0f},"
              f"graphs_per_s={entry['graphs_per_s']:.1f}"
              f"|speedup={entry['speedup_vs_sequential']:.2f}x"
              f"|p50_ms={entry['p50_ms']:.2f}|p99_ms={entry['p99_ms']:.2f}"
              f"|plan_hit={entry['plan_cache_hit_rate']:.2f}"
              f"|agree={agree}", flush=True)

    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(row, f, indent=2)
        print(f"serve_json,0,written={os.path.normpath(out)}")
    return row


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small fixed workload: 24 requests, batch size 8")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=None)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="write the result row as JSON to this path")
    args = ap.parse_args(argv)
    num = args.requests or (24 if args.smoke else 96)
    sizes = tuple(args.batch_sizes or ((8,) if args.smoke else (1, 2, 8, 16)))
    row = measure_serve(
        num_requests=num, batch_sizes=sizes, backend=args.backend,
        seed=args.seed, smoke=args.smoke, device=args.device, out=args.out,
    )
    if not row["agree"]:
        raise SystemExit(
            "FAIL: batched serving results disagree with the sequential loop"
        )
    return row


if __name__ == "__main__":
    main()
