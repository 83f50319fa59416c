"""One front door for cover-edge triangle counting (the port).

Counterpart of ``repro.api`` for the routes ported so far: the exact
single-graph count on the local route (Algorithm 1), with per-vertex
credit, triangle finding, the batch route (budget-padded lanes probed
with one cached plan — the serving path), the stream route (live
counts under edge mutation streams) and the approx route (a host-side
wedge-sampled estimate with its error bar, the serving layer's degraded
lane).

* :class:`TCOptions` — the knobs of the ported routes, validated as in
  the reference; :meth:`TCOptions.plan_view` is the bounded-plan cache
  key.
* :class:`TriangleEngine` — ``count`` on the local, batch, distributed,
  stream and approx routes, ``count_batch``, ``count_distributed_raw``,
  ``count_approx``, ``find``, ``stream`` and ``serve``, on the engine's
  device (``"cuda"`` unless the caller asks for ``"cpu"``) and, for the
  distributed route, its shard group (``mesh=``).  It
  owns the budget grid (``budgets=``), whose top cell ``route_for``
  reads, and the LRU bounded-plan cache.
* :class:`TriangleReport` — the result contract: ``triangles``, ``k``,
  ``c1``/``c2``, the normalized :class:`Overflow` flags, provenance and,
  with ``per_vertex``, each vertex's triangle count and degree.

    from repro_torch.api import TCOptions, TriangleEngine

    engine = TriangleEngine()
    report = engine.count((edges, n_nodes))
    print(report.triangles, report.k, report.backend)
    rep = engine.count((edges, n_nodes), options=TCOptions(per_vertex=True))
    print(rep.top_k(10), rep.transitivity())
    tri, count = engine.find((edges, n_nodes), max_triangles=1000)
    reports = engine.count_batch([(edges, n_nodes), (edges2, n2)])
    session = engine.stream((edges, n_nodes))
    update = session.apply([(+1, 0, 5), (-1, 2, 3)])
    print(update.delta_triangles, session.count().triangles)

The distributed route (Algorithm 2, ``core/parallel_tc.py``) runs over
the engine's shard group (``mesh=``): ``LocalShards(p, "cuda")`` puts p
logical shards on one card, ``GroupShards`` one shard a rank of a
``torch.distributed`` group.

    from repro_torch.core.shards import LocalShards

    engine = TriangleEngine(mesh=LocalShards(8, "cuda"))
    report = engine.count((edges, n_nodes), route="distributed")
    print(report.triangles, report.per_device, report.comm.phase_bytes())
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import parallel_tc as _ptc
from repro_torch.core import sequential as _seq
from repro_torch.core.approx import ApproxEstimate, wedge_sample_estimate
from repro_torch.core.comm_instrument import CommTally, choose_hedge_mode
from repro_torch.core.intersect import (
    BACKENDS,
    DEFAULT_BUCKET_WIDTHS,
    IntersectPlan,
    resolve_backend,
)
from repro_torch.core.shards import ShardGroup, as_shards
from repro_torch.device import resolve_device
from repro_torch.graph.csr import (
    DEFAULT_BUDGET_GRID,
    BudgetGrid,
    Graph,
    GraphBatch,
    ShapeBudget,
    from_edges,
    from_edges_batch,
)
from repro_torch.stream.session import StreamSession, StreamStats

__all__ = [
    "ROUTES",
    "Overflow",
    "TCOptions",
    "TriangleEngine",
    "TriangleReport",
]

#: The reference's dispatch targets, all answered.  ``auto`` resolves
#: per call through ``TriangleEngine.route_for``: ``local`` while the
#: request fits the budget grid, ``distributed`` beyond its top cell.
ROUTES = ("auto", "local", "batch", "distributed", "approx", "stream")

_HEDGE_MODES = ("auto", "allgather", "ring")
_FRONTIER_DTYPES = ("int32", "uint8")

#: edge-list input: ``(edges int[any, 2], n_nodes)``
EdgeList = tuple


def _check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}; got {route!r}")


@dataclasses.dataclass(frozen=True)
class TCOptions:
    """The execution knobs of the ported routes, frozen and hashable.

      backend:        ``"auto" | "torch" | "cuda"`` intersection backend
                      (``auto`` = the Hopper kernel on a CUDA device, the
                      plain probe on the CPU).
      bucket_widths:  degree-bucket boundaries of the intersection plan.
      query_chunk:    probe-chunk rows (bounds peak memory); also
                      overrides ``row_mult`` when set.
      row_mult:       bucket-row quantization of the plan.
      per_vertex:     also return per-vertex triangle attribution
                      (``TriangleReport.per_vertex`` + derived
                      clustering / transitivity / top-k), from the same
                      probe pass through the hit mask.
      d_max:          lossy candidate-width clamp (``None`` = exact).
      cap_h:          cap on the compacted horizontal-query block.
      root:           BFS root.
      compact:        ``False`` = the dense seed reference path.

    Distributed route (Algorithm 2):
      mode:           hedge exchange — ``"auto"`` picks allgather vs ring
                      by live-buffer size (``choose_hedge_mode``).
      slack:          transpose sample-sort capacity slack.
      d_pad:          hedge-plan pad width (``None`` = graph max degree).
      hedge_chunk:    hedge plan's probe slice / bucket granularity.
      frontier_dtype: BFS frontier wire dtype (``"uint8"`` = 4x fewer
                      BFS bytes a sweep).
      gather_buffer_limit_bytes: allgather live-buffer bound for
                      ``mode="auto"``.

      route:          default dispatch of ``TriangleEngine.count``:
                      ``"auto"``, ``"local"``, ``"batch"``,
                      ``"distributed"``, ``"stream"`` or ``"approx"``.
      grid:           :class:`~repro_torch.graph.csr.BudgetGrid` of the
                      batch route and the serving queues (``None`` = the
                      default grid; ``TriangleEngine(budgets=...)``
                      outranks it).  Plan-irrelevant: the cell is in the
                      plan-cache key already.

    Serving robustness (``launch/serve_tc.py``'s ``TriangleServer``):
      deadline_s:     default per-request deadline (relative seconds); a
                      cell's partial lane flushes once its oldest
                      deadline's slack falls below the cell's measured
                      flush cost.  ``None`` = no deadline (size and
                      drain flushes only).
      admission_tokens: bound on pending + in-flight requests per budget
                      cell; past it the server walks the degradation
                      ladder (approx lane, then shed).  ``None`` = no
                      bound.
      approx_samples: wedge samples of the approx route's estimator.
      approx_on_overload: ``False`` skips the approx rung: overload and
                      failed batches shed with a structured rejection.
      distributed_timeout_s: wall-clock timeout of one attempt on the
                      server's distributed route; a timed-out or failed
                      attempt retries once in ``ring`` mode, then
                      degrades.

    Stream route knobs (``repro_torch.stream``):
      stream_buffer:  mutation buffer capacity — an ``apply`` stream
                      longer than this is split into batches of this
                      many updates, each applied and delta-probed on its
                      own.
      stream_staleness: the touched-vertex fraction past which a session
                      re-derives BFS levels and the cover classification
                      with one full count (in between it answers exactly
                      in the level-free regime: ``c1``/``c2`` ``None``).
      stream_exact_edges: per-batch exact budget — a batch changing more
                      edges than this skips the delta probes and the
                      session answers through the reservoir-sampled
                      approximate lane until the next refresh (``None`` =
                      always exact).
      stream_approx_rate: the approximate lane's edge-reservoir sampling
                      rate (capacity ≈ rate × initial edge count, min 64).
    """

    backend: str = "auto"
    bucket_widths: tuple = DEFAULT_BUCKET_WIDTHS
    query_chunk: Optional[int] = None
    row_mult: int = 64
    per_vertex: bool = False
    d_max: Optional[int] = None
    cap_h: Optional[int] = None
    root: int = 0
    compact: bool = True
    mode: str = "auto"
    slack: float = 4.0
    d_pad: Optional[int] = None
    hedge_chunk: Optional[int] = None
    frontier_dtype: str = "int32"
    gather_buffer_limit_bytes: int = 64 << 20
    route: str = "auto"
    grid: Optional[BudgetGrid] = None
    deadline_s: Optional[float] = None
    admission_tokens: Optional[int] = None
    approx_samples: int = 8192
    approx_on_overload: bool = True
    distributed_timeout_s: Optional[float] = None
    stream_buffer: int = 4096
    stream_staleness: float = 0.25
    stream_exact_edges: Optional[int] = None
    stream_approx_rate: float = 0.05

    def __post_init__(self):
        object.__setattr__(
            self, "bucket_widths",
            tuple(int(w) for w in self.bucket_widths),
        )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}; got {self.backend!r}"
            )
        if self.mode not in _HEDGE_MODES:
            raise ValueError(
                f"mode must be one of {_HEDGE_MODES}; got {self.mode!r}"
            )
        if self.frontier_dtype not in _FRONTIER_DTYPES:
            raise ValueError(
                f"frontier_dtype must be one of {_FRONTIER_DTYPES}; "
                f"got {self.frontier_dtype!r}"
            )
        _check_route(self.route)
        if self.grid is not None and not isinstance(self.grid, BudgetGrid):
            raise TypeError(
                f"grid must be a BudgetGrid or None; "
                f"got {type(self.grid).__name__}"
            )
        for name in ("query_chunk", "d_max", "cap_h", "d_pad",
                     "hedge_chunk"):
            v = getattr(self, name)
            if v is not None and int(v) <= 0:
                raise ValueError(f"{name} must be positive; got {v}")
        if any(w <= 0 for w in self.bucket_widths):
            raise ValueError(
                f"bucket_widths must be positive; got {self.bucket_widths}"
            )
        if self.row_mult <= 0:
            raise ValueError(f"row_mult must be positive; got {self.row_mult}")
        if self.slack <= 0:
            raise ValueError(f"slack must be positive; got {self.slack}")
        if self.gather_buffer_limit_bytes <= 0:
            raise ValueError("gather_buffer_limit_bytes must be positive")
        for name in ("deadline_s", "distributed_timeout_s"):
            v = getattr(self, name)
            if v is not None and float(v) <= 0:
                raise ValueError(f"{name} must be positive; got {v}")
        if self.admission_tokens is not None and int(self.admission_tokens) <= 0:
            raise ValueError(
                f"admission_tokens must be positive; got {self.admission_tokens}"
            )
        if self.approx_samples <= 0:
            raise ValueError(
                f"approx_samples must be positive; got {self.approx_samples}"
            )
        if self.stream_buffer <= 0:
            raise ValueError(
                f"stream_buffer must be positive; got {self.stream_buffer}"
            )
        if self.stream_staleness <= 0:
            raise ValueError(
                f"stream_staleness must be positive; "
                f"got {self.stream_staleness}"
            )
        if (self.stream_exact_edges is not None
                and int(self.stream_exact_edges) <= 0):
            raise ValueError(
                f"stream_exact_edges must be positive; "
                f"got {self.stream_exact_edges}"
            )
        if not 0.0 < self.stream_approx_rate <= 1.0:
            raise ValueError(
                f"stream_approx_rate must lie in (0, 1]; "
                f"got {self.stream_approx_rate}"
            )

    def plan_view(self, device: Union[str, torch.device]) -> "TCOptions":
        """The plan-relevant projection, the bounded-plan cache key: the
        backend resolved against ``device``, ``row_mult`` folded into
        ``query_chunk`` when chunking (bucket rows must be a chunk
        multiple), every other field at its default.  Two option sets
        that lay out the same plan project to the same value."""
        return TCOptions(
            backend=resolve_backend(self.backend, device),
            bucket_widths=self.bucket_widths,
            query_chunk=self.query_chunk,
            row_mult=(int(self.query_chunk) if self.query_chunk
                      else self.row_mult),
        )


@dataclasses.dataclass(frozen=True)
class Overflow:
    """Every way a count can be less than exact, normalized into one
    struct.  ``h``: horizontal queries dropped (``cap_h``), or a width
    clamp (``d_max``) truncated candidate lists.  ``transpose`` /
    ``hedge``: the distributed route's transpose chunk or horizontal
    buffer (or a hedge bucket's width) overflowed."""

    h: bool = False
    transpose: bool = False
    hedge: bool = False

    @property
    def any(self) -> bool:
        return self.h or self.transpose or self.hedge

    def __bool__(self) -> bool:
        return self.any


@dataclasses.dataclass(frozen=True)
class TriangleReport:
    """The result contract of the local route: ``triangles``, ``k``
    (measured horizontal-edge fraction), ``num_horizontal``, the apex
    level split ``c1``/``c2``, ``overflow``, provenance (``route``,
    resolved ``backend``, ``plan_id``, ``options``) and the BFS
    ``levels`` as a host array.

    With ``TCOptions(per_vertex=True)`` it also carries ``per_vertex``
    (int[n_nodes], each vertex's triangle count — ``sum(per_vertex) ==
    3 * triangles``) and ``degrees`` (int[n_nodes]), from which
    :meth:`local_clustering`, :meth:`transitivity` and :meth:`top_k`
    derive.

    Stream-route reports (``route="stream"``) always carry ``stream``
    (the session's :class:`~repro_torch.stream.session.StreamStats`).  A
    freshly refreshed session reports the full cover-edge payload; one
    with pending mutations answers exactly in the level-free regime
    (``c1``/``c2`` ``None``, ``k`` ``NaN``); an over-budget session
    answers the estimate (``approx`` payload, no attribution) until its
    next refresh.

    Approx-route reports (``route="approx"``, ``plan_id=
    "wedge-sample/<k>"``) carry the estimate in ``approx`` and its
    rounded point estimate in ``triangles``; ``k`` is ``NaN``,
    ``c1``/``c2`` and ``levels`` are ``None``, ``num_horizontal`` is 0,
    and there is no per-vertex attribution.

    Distributed-route reports (``plan_id="hedge/{mode}/p{p}"``) have
    ``c1``/``c2`` and ``levels`` ``None`` (Algorithm 2 has no apex-level
    split), ``comm`` (the run's
    :class:`~repro_torch.core.comm_instrument.CommTally`) and
    ``per_device`` (each shard's t_i, int32[p])."""

    triangles: int
    k: float
    num_horizontal: int
    c1: Optional[int]
    c2: Optional[int]
    overflow: Overflow
    route: str
    backend: str
    plan_id: str
    options: TCOptions
    levels: Optional[np.ndarray] = None
    approx: Optional[ApproxEstimate] = None
    per_vertex: Optional[np.ndarray] = None
    degrees: Optional[np.ndarray] = None
    stream: Optional[StreamStats] = None
    comm: Optional[CommTally] = None
    per_device: Optional[np.ndarray] = None

    def _require_per_vertex(self) -> None:
        if self.per_vertex is None or self.degrees is None:
            raise ValueError(
                "this report carries no per-vertex attribution; run with "
                "TCOptions(per_vertex=True) on an exact route"
            )

    def local_clustering(self) -> np.ndarray:
        """Per-vertex local clustering coefficient ``t(v) / C(deg(v), 2)``
        (0 where ``deg(v) < 2``), float64[n_nodes]."""
        self._require_per_vertex()
        d = self.degrees.astype(np.int64)
        wedges = d * (d - 1) // 2
        out = np.zeros(d.shape, np.float64)
        np.divide(
            self.per_vertex.astype(np.float64), wedges,
            out=out, where=wedges > 0,
        )
        return out

    def transitivity(self) -> float:
        """Global transitivity ``3T / #wedges`` (0.0 on wedge-free
        graphs) — closed triples over connected triples."""
        self._require_per_vertex()
        d = self.degrees.astype(np.int64)
        wedges = int((d * (d - 1) // 2).sum())
        return 0.0 if wedges == 0 else 3.0 * self.triangles / wedges

    def top_k(self, k: int) -> np.ndarray:
        """Vertex ids of the ``k`` triangle-densest vertices, descending
        by ``per_vertex`` count (ties broken by lower id)."""
        self._require_per_vertex()
        pv = self.per_vertex.astype(np.int64)
        order = np.lexsort((np.arange(pv.shape[0]), -pv))
        return order[: max(0, min(int(k), pv.shape[0]))]


def _plan_id(plan: IntersectPlan, kind: str) -> str:
    """Provenance tag of an intersection plan, as in the reference
    (with the port's backend names, ``cuda``/``torch``)."""
    shape = "+".join(f"{b.rows}x{b.d_cand}" for b in plan.buckets) or "empty"
    return f"{kind}/{plan.backend}/{shape}"


def _graph_edges(g: Graph) -> tuple[torch.Tensor, int]:
    """A graph's unique undirected edges as an ``int64[m, 2]`` tensor on
    the graph's device, with its vertex count — how a packed ``Graph``
    opens a stream session without a host round trip."""
    keep = (g.src < g.dst) & (g.dst < g.n_nodes)
    return (torch.stack([g.src[keep], g.dst[keep]], dim=1).to(torch.int64),
            g.n_nodes)


def _host_edges(g: Graph) -> tuple[np.ndarray, int]:
    """A graph's unique undirected edges on the host: the batch route
    packs a ``Graph`` input again onto a grid cell."""
    e, n = _graph_edges(g)
    return e.cpu().numpy(), n


class TriangleEngine:
    """The facade of the port: one object that owns the device, the
    default options, the budget grid and the bounded-plan cache.

    Args:
      options: default :class:`TCOptions` for every call (per-call
        overrides via ``options=`` / ``route=``).
      budgets: the :class:`~repro_torch.graph.csr.BudgetGrid` of the
        batch route and the serving queues; its top cell is the
        local/distributed boundary of ``route="auto"``.  ``None``
        resolves ``options.grid``, then the default grid.
      device: where the engine runs — ``"cuda"`` (default) or ``"cpu"``.
        A CUDA device on a host without a card raises here.
      plan_cache_capacity: LRU bound of the engine's bounded-plan cache
        (``None`` = unbounded).
      mesh: the distributed route's shard group
        (:class:`~repro_torch.core.shards.LocalShards` or
        :class:`~repro_torch.core.shards.GroupShards`) on the engine's
        device type; ``None`` is one shard on the engine's device (p = 1,
        one H100).
      profile: a :class:`~repro_torch.tune.profile.TunedProfile` or a
        path to one: tuned default options (``options=None``), grid
        (``budgets`` and ``options.grid`` unset), per-cell overrides
        (:meth:`options_for`) and per-cell meta ceilings, which seed the
        pooled-meta marks here and which ``serve(prewarm=True)`` plans
        and loads before the first request.  An unusable file degrades
        to defaults with a warning.
    """

    def __init__(self, options: Optional[TCOptions] = None, *,
                 budgets: Optional[BudgetGrid] = None,
                 device: Union[str, torch.device] = "cuda",
                 plan_cache_capacity: Optional[int] = (
                     _seq.DEFAULT_PLAN_CACHE_CAPACITY),
                 mesh: Optional[ShardGroup] = None,
                 profile=None):
        if options is not None and not isinstance(options, TCOptions):
            raise TypeError(
                f"options must be a TCOptions, got {type(options).__name__}"
            )
        self.profile = self._resolve_profile(profile)
        if options is None and self.profile is not None:
            options = self.profile.options
        self.options = options or TCOptions()
        self.device = resolve_device(device)
        self.budgets = (
            budgets
            or self.options.grid
            or (self.profile.grid if self.profile is not None else None)
            or DEFAULT_BUDGET_GRID
        )
        self._plan_cache = _seq.PlanCache(plan_cache_capacity)
        self._plan_stats = {"hits": 0, "misses": 0}
        self._meta_ceiling: dict = {}  # ShapeBudget -> BatchDegreeMeta
        self.mesh = as_shards(mesh, self.device)
        if self.profile is not None:
            # every flush the trace covered lands on the ceiling's plan
            # key from the first request on, prewarmed or not
            for cell in self.profile.cells:
                if cell.meta is not None:
                    self.pool_meta(cell.budget, cell.meta)

    @staticmethod
    def _resolve_profile(profile):
        if profile is None:
            return None
        from repro_torch.tune.profile import TunedProfile, load_profile

        if isinstance(profile, TunedProfile):
            return profile
        return load_profile(profile)  # None and a warning when unusable

    def _graph(self, graph_or_edges, clock=None) -> Graph:
        if isinstance(graph_or_edges, Graph):
            if graph_or_edges.device.type != self.device.type:
                raise ValueError(
                    f"graph lives on {graph_or_edges.device}; this engine "
                    f"runs on {self.device}"
                )
            return graph_or_edges
        edges, n_nodes = graph_or_edges
        if clock is not None:
            clock.start()
        g = from_edges(np.asarray(edges), int(n_nodes), device=self.device)
        if clock is not None:
            clock.lap("csr")
        return g

    # --------------------------------------------------------- routing
    def route_for(self, n_nodes: int, n_edges_und: int, *,
                  route: Optional[str] = None) -> str:
        """Resolve ``auto`` for a request of this size: ``local`` while
        the request's grid cell fits the budget grid's top cell,
        ``distributed`` beyond it (the reference's one dispatch
        policy)."""
        r = route or self.options.route
        if r not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}; got {r!r}")
        if r != "auto":
            return r
        fits = self.budgets.fits(int(n_nodes), int(n_edges_und))
        return "local" if fits else "distributed"

    # -------------------------------------------------------- planning
    def options_for(self, budget: ShapeBudget) -> TCOptions:
        """The options of a budget cell: a tuned profile's override where
        a cell of it covers ``budget``, else the engine's options.
        Explicit constructor ``options`` outrank the profile's default,
        not its per-cell overrides."""
        if self.profile is not None:
            cell = self.profile.cell_for(budget)
            if cell is not None and cell.options is not None:
                return cell.options
        return self.options

    def plan_for(self, gb: GraphBatch) -> IntersectPlan:
        """The bounded plan of ``gb`` from the engine's LRU plan cache,
        keyed on ``(budget, meta, options_for(budget).plan_view())``."""
        return _seq.batch_plan_for(
            gb, options=self.options_for(gb.budget),
            cache=self._plan_cache, stats=self._plan_stats,
        )

    def compile_space(self, *, batch_size: int = 8) -> list:
        """The statically enumerated prewarm set: every warm batch a
        ``serve(prewarm=True)`` server over this engine runs, one
        :class:`~repro_torch.analysis.compile_set.CompileKey` per profile
        cell with a meta ceiling × lane count of the drain ladder — empty
        when there is no profile.  Pure host arithmetic; nothing runs on
        the device and the plan cache is untouched.  This is the set
        ``repro_torch.analysis.audit`` asserts finite."""
        from repro_torch.analysis.compile_set import enumerate_compile_keys

        return enumerate_compile_keys(self, batch_size=batch_size)

    def pool_meta(self, budget: ShapeBudget, meta):
        """Pool a batch's degree meta up to the engine's per-cell
        high-water mark and return the pooled meta: still a true upper
        bound (``BatchDegreeMeta.union``), and every batch the cell has
        covered lands on one plan per lane count, whichever requests it
        happened to group.  The mark only rises."""
        prev = self._meta_ceiling.get(budget)
        pooled = meta if prev is None else prev.union(meta)
        self._meta_ceiling[budget] = pooled
        return pooled

    def plan_cache_stats(self, reset: bool = False) -> dict:
        """``{"hits", "misses", "size", "evictions", "capacity"}`` of
        this engine's plan cache."""
        out = dict(
            self._plan_stats,
            size=len(self._plan_cache),
            evictions=self._plan_cache.evictions,
            capacity=self._plan_cache.capacity,
        )
        if reset:
            self._plan_stats.update(hits=0, misses=0)
        return out

    # ------------------------------------------------- raw-result API
    def count_raw(self, graph_or_edges, *,
                  options: Optional[TCOptions] = None,
                  clock: Optional[_seq.StageClock] = None) -> _seq.TCResult:
        """Local (Algorithm 1) count returning the raw ``TCResult``."""
        return _seq._triangle_count(
            self._graph(graph_or_edges, clock), options or self.options,
            clock=clock,
        )

    def count_batch_raw(self, gb: GraphBatch, *,
                        options: Optional[TCOptions] = None,
                        plan: Optional[IntersectPlan] = None,
                        clock: Optional[_seq.StageClock] = None,
                        ) -> _seq.TCResult:
        """Batched count returning the raw lane-axis ``TCResult``: the
        fused path with ``plan`` (see :meth:`plan_for`), the exact
        two-stage path without."""
        if gb.device.type != self.device.type:
            raise ValueError(f"batch lives on {gb.device}; this engine "
                             f"runs on {self.device}")
        return _seq._triangle_count_batch(gb, options or self.options,
                                          plan=plan, clock=clock)

    def count_distributed_raw(self, graph_or_edges, *,
                              mesh: Optional[ShardGroup] = None,
                              options: Optional[TCOptions] = None,
                              clock: Optional[_seq.StageClock] = None,
                              ) -> _ptc.ParallelTCResult:
        """Distributed (Algorithm 2) count returning the raw
        ``ParallelTCResult``, over ``mesh`` (default: the engine's shard
        group).  Resolves ``mode="auto"`` here: the hedge exchange is
        routing policy, and policy lives in the engine.  ``clock``
        records the stages ``shard``, ``bfs``, ``transpose``, ``hedge``
        and ``reduce``."""
        o = options or self.options
        shards = self.mesh if mesh is None else as_shards(mesh, self.device)
        g = self._graph(graph_or_edges, clock)
        o = self._resolve_hedge_mode(g, shards, o)
        return _ptc._parallel_triangle_count(g, shards, options=o,
                                             clock=clock)

    def _resolve_hedge_mode(self, g: Graph, shards: ShardGroup,
                            o: TCOptions) -> TCOptions:
        """``mode="auto"`` -> allgather vs ring by the live gathered
        buffer's size (``choose_hedge_mode``)."""
        if o.mode != "auto":
            return o
        return dataclasses.replace(o, mode=choose_hedge_mode(
            int(g.n_edges_dir.item()), shards.p,
            gather_buffer_limit_bytes=o.gather_buffer_limit_bytes,
            slack=o.slack,
        ))

    # ------------------------------------------------------ public API
    def count(
        self,
        graph_or_edges: Union[Graph, EdgeList],
        *,
        route: Optional[str] = None,
        options: Optional[TCOptions] = None,
        clock: Optional[_seq.StageClock] = None,
    ) -> TriangleReport:
        """Count the triangles of one graph — a packed :class:`Graph` or
        an ``(edges, n_nodes)`` pair — on the resolved route.

        ``local`` runs the graph at its own shape; ``batch`` rounds it
        onto the engine's budget grid and runs the cached-plan batch
        path as one lane (its ``levels`` keep the budget's length, its
        ``per_vertex``/``degrees`` the graph's); ``distributed`` runs
        Algorithm 2 over the engine's shard group; ``stream`` opens a
        one-shot session (:meth:`stream`), whose opening refresh is the
        full local count, and answers its report; ``approx`` answers
        :meth:`count_approx` at seed 0.  ``auto`` goes through
        :meth:`route_for`.  Degenerate n=0 graphs are answered here
        without running a pipeline.  ``clock`` (a
        :class:`~repro_torch.core.sequential.StageClock`) records the
        per-stage seconds of the local route, each closed by a device
        synchronize: CSR build, BFS (and its sweep count), horizontal
        compaction, plan, probe.
        """
        o = options or self.options
        if isinstance(graph_or_edges, GraphBatch):
            raise TypeError(
                "count() takes one graph; use count_batch() for a "
                "GraphBatch"
            )
        is_graph = isinstance(graph_or_edges, Graph)
        if is_graph:
            g, edges, n_nodes = graph_or_edges, None, graph_or_edges.n_nodes
        else:
            g = None
            edges, n_nodes = graph_or_edges
            edges, n_nodes = np.asarray(edges), int(n_nodes)
        m_und = 0
        if (route or o.route) == "auto":
            # the routing size: an edge list's row count (what the server
            # routes on); for a packed Graph num_slots / 2, refined to the
            # true edge count only when slot padding would not fit
            if is_graph:
                m_und = g.num_slots // 2
                if not self.budgets.fits(n_nodes, m_und):
                    m_und = int(g.n_edges_dir.item()) // 2
            elif edges.size:
                m_und = edges.reshape(-1, 2).shape[0]
        r = self.route_for(n_nodes, m_und, route=route or o.route)
        if r == "batch" and (o.d_max is not None or o.cap_h is not None):
            raise ValueError(
                "route='batch' uses cached bounded plans; d_max/cap_h "
                "only apply to the local route's exact planning"
            )
        backend = resolve_backend(o.backend, self.device)
        if n_nodes == 0:
            # an estimate and Algorithm 2 have no split and no levels
            split = r not in ("distributed", "approx")
            empty_pv = (np.zeros((0,), np.int32)
                        if o.per_vertex and r != "approx" else None)
            return TriangleReport(
                triangles=0, k=0.0, num_horizontal=0,
                c1=0 if split else None, c2=0 if split else None,
                overflow=Overflow(), route=r, backend=backend,
                plan_id="empty", options=o,
                levels=np.zeros((0,), np.int32) if split else None,
                per_vertex=empty_pv, degrees=empty_pv,
            )
        if r == "approx":
            return self.count_approx(graph_or_edges, options=o)
        if r == "stream":
            return self.stream(graph_or_edges, options=o).count()
        if r == "batch":
            # pack the raw edges once (a Graph goes back to host edges)
            if clock is not None:
                clock.start()
            gb = from_edges_batch(
                [_host_edges(g) if is_graph else (edges, n_nodes)],
                grid=self.budgets, device=self.device,
            )
            if clock is not None:
                clock.lap("pack")
            plan = self.plan_for(gb)
            if clock is not None:
                clock.lap("plan")
            res = _seq._squeeze_lane(
                self.count_batch_raw(gb, options=o, plan=plan, clock=clock))
            # the lane is budget-padded: credit and degrees are sliced back
            # to the request's own vertices
            return self._report_local(res, o, route="batch",
                                      plan_id=_plan_id(plan, "bounded"),
                                      deg=gb.deg[0], n=n_nodes)
        g = self._graph((edges, n_nodes) if g is None else g, clock)
        if r == "distributed":
            # resolve the hedge mode BEFORE the report, so its provenance
            # (options.mode, plan_id) names the mode that ran
            o = self._resolve_hedge_mode(g, self.mesh, o)
            res = self.count_distributed_raw(g, options=o, clock=clock)
            return self._report_distributed(res, o, self.mesh, deg=g.deg)
        res = _seq._triangle_count(g, o, clock=clock)
        return self._report_local(res, o, route="local",
                                  plan_id=f"exact/{backend}", deg=g.deg)

    def count_batch(
        self,
        graphs: Union[GraphBatch, Sequence],
        *,
        options: Optional[TCOptions] = None,
        clock: Optional[_seq.StageClock] = None,
    ) -> list:
        """Count every graph of a batch — a packed :class:`GraphBatch`
        or a sequence of ``(edges, n_nodes)`` pairs, packed here onto the
        engine's budget grid — returning one :class:`TriangleReport` per
        real graph (every lane of a ``GraphBatch``).

        A batch with degree metadata and no ``d_max``/``cap_h`` runs the
        cached bounded plan (:meth:`plan_for`); any other runs the exact
        two-stage path.  Each lane equals ``count(..., route="local")``
        of its graph; ``per_vertex`` and ``degrees`` are sliced to the
        lane's ``n_nodes``, ``levels`` keep the budget's length.  A
        ``clock`` records pack, plan, bfs, compact and probe.
        """
        o = options or self.options
        if clock is not None:
            clock.start()
        if isinstance(graphs, GraphBatch):
            gb, n_real = graphs, graphs.batch_size
        else:
            graphs = list(graphs)
            gb = from_edges_batch(
                [(np.asarray(e), int(n)) for e, n in graphs],
                grid=self.budgets, device=self.device,
            )
            n_real = len(graphs)
        if clock is not None:
            clock.lap("pack")
        plan = None
        if gb.meta is not None and o.d_max is None and o.cap_h is None:
            plan = self.plan_for(gb)
            if clock is not None:
                clock.lap("plan")
        res = self.count_batch_raw(gb, options=o, plan=plan, clock=clock)
        backend = resolve_backend(o.backend, self.device)
        pid = (_plan_id(plan, "bounded") if plan is not None
               else f"exact/{backend}")
        ints = torch.stack([res.triangles, res.c1, res.c2,
                            res.num_horizontal, res.h_overflow.to(torch.int32),
                            gb.n_nodes]).cpu().numpy()
        tri, c1, c2, nh, ovf, n_lane = ints
        k, lev = res.k.cpu().numpy(), res.levels.cpu().numpy()
        pv_b = deg_b = None
        if o.per_vertex:
            pv_b, deg_b = res.per_vertex.cpu().numpy(), gb.deg.cpu().numpy()
        return [
            TriangleReport(
                triangles=int(tri[i]), k=float(k[i]),
                num_horizontal=int(nh[i]), c1=int(c1[i]), c2=int(c2[i]),
                overflow=Overflow(h=bool(ovf[i])),
                route="batch", backend=backend, plan_id=pid, options=o,
                levels=lev[i],
                per_vertex=(pv_b[i, :n_lane[i]] if pv_b is not None
                            else None),
                degrees=(deg_b[i, :n_lane[i]] if deg_b is not None
                         else None),
            )
            for i in range(n_real)
        ]

    def count_approx(
        self,
        graph_or_edges: Union[Graph, EdgeList],
        *,
        samples: Optional[int] = None,
        seed: int = 0,
        options: Optional[TCOptions] = None,
    ) -> TriangleReport:
        """The degraded lane: a host-side wedge-sampled estimate
        (:func:`~repro_torch.core.approx.wedge_sample_estimate`) in the
        report contract.

        ``triangles`` is the rounded point estimate, ``approx`` carries
        the full :class:`ApproxEstimate` (stderr, 95% CI), ``k`` is
        ``NaN`` and ``c1``/``c2`` are ``None``: nothing about the answer
        pretends the exact pipeline ran.  ``samples`` defaults to
        ``options.approx_samples``.  The estimator never touches the
        device (a ``Graph`` goes back to host edges first): the server
        answers with it when the device path is saturated or failing.
        ``backend`` is the engine's, for provenance."""
        o = options or self.options
        if isinstance(graph_or_edges, Graph):
            edges, n_nodes = _host_edges(graph_or_edges)
        else:
            edges, n_nodes = graph_or_edges
            edges, n_nodes = np.asarray(edges), int(n_nodes)
        est = wedge_sample_estimate(
            edges, n_nodes,
            samples=int(samples) if samples else o.approx_samples,
            seed=seed,
        )
        return TriangleReport(
            triangles=int(round(est.triangles)), k=float("nan"),
            num_horizontal=0, c1=None, c2=None, overflow=Overflow(),
            route="approx", backend=resolve_backend(o.backend, self.device),
            plan_id=f"wedge-sample/{est.samples}", options=o, approx=est,
        )

    def find(
        self,
        graph_or_edges: Union[Graph, EdgeList],
        *,
        max_triangles: int,
        options: Optional[TCOptions] = None,
        clock: Optional[_seq.StageClock] = None,
    ):
        """Triangle *finding* (local route): the triangles themselves,
        ``(tri int32[max_triangles, 3], count)`` as tensors on the
        engine's device; each row is ``(u, w, apex)`` with ``u < w`` the
        horizontal edge that found it, and rows past ``count`` are
        ``-1``.  Same pipeline, same options, as ``count``; the order is
        the reference's (bucket by bucket, row-major)."""
        return _seq._find_triangles(
            self._graph(graph_or_edges, clock), options or self.options,
            max_triangles=int(max_triangles), clock=clock,
        )

    def stream(
        self,
        graph_or_edges: Union[Graph, EdgeList],
        *,
        options: Optional[TCOptions] = None,
        seed: int = 0,
    ) -> StreamSession:
        """Open a live :class:`~repro_torch.stream.session.StreamSession`
        on this engine's device.

        The session ingests edge mutation streams in batches of
        ``stream_buffer`` updates, keeps the exact triangle total (and
        per-vertex credit, with ``per_vertex=True``) current by the batch
        delta rule, and re-derives the cover-edge state once staleness
        passes ``stream_staleness``.  Batches whose net change exceeds
        ``stream_exact_edges`` flip the session to the reservoir-sampled
        approximate lane until its next refresh.  ``seed`` drives only
        that lane's reservoir."""
        return StreamSession(
            self, graph_or_edges, options=options or self.options,
            seed=seed,
        )

    def serve(self, *, batch_size: int = 8, max_inflight: int = 8,
              strict: bool = False, faults=None, prewarm: bool = False,
              recorder=None):
        """A :class:`~repro_torch.launch.serve_tc.TriangleServer` wired to
        this engine: its budget grid buckets the queues, its plan cache
        feeds every flush, its options govern every lane (the deadline,
        admission and degradation knobs too).  ``strict=True`` raises on
        a malformed ``submit``; ``faults`` is a
        :class:`~repro_torch.launch.robust.FaultPlan` whose server-side
        hooks the server calls; ``prewarm=True`` plans every cell of the
        tuned profile at every lane count of the drain ladder and loads
        the kernels' libraries before the first request; ``recorder``
        (a :class:`~repro_torch.tune.trace.TraceRecorder`) captures the
        workload for the sweep."""
        from repro_torch.launch.serve_tc import TriangleServer

        return TriangleServer(self, batch_size=batch_size,
                              max_inflight=max_inflight, strict=strict,
                              faults=faults, prewarm=prewarm,
                              recorder=recorder)

    def _report_local(self, res: _seq.TCResult, o: TCOptions, *, route: str,
                      plan_id: str, deg: torch.Tensor,
                      n: Optional[int] = None) -> TriangleReport:
        """The report of one graph's raw result; ``n`` slices a
        budget-padded lane's credit and degrees to the graph's own
        vertices."""
        tri, c1, c2, nh, k, ovf = (
            x.item() for x in (res.triangles, res.c1, res.c2,
                               res.num_horizontal, res.k, res.h_overflow)
        )
        pv = degs = None
        if o.per_vertex:
            pv, degs = res.per_vertex.cpu().numpy(), deg.cpu().numpy()
            if n is not None:
                pv, degs = pv[:n], degs[:n]
        return TriangleReport(
            triangles=int(tri), k=float(k), num_horizontal=int(nh),
            c1=int(c1), c2=int(c2), overflow=Overflow(h=bool(ovf)),
            route=route, backend=resolve_backend(o.backend, self.device),
            plan_id=plan_id, options=o, levels=res.levels.cpu().numpy(),
            per_vertex=pv, degrees=degs,
        )

    def _report_distributed(self, res: _ptc.ParallelTCResult, o: TCOptions,
                            shards: ShardGroup, *,
                            deg: torch.Tensor) -> TriangleReport:
        """The report of one Algorithm 2 result over ``shards``:
        ``c1``/``c2`` ``None`` (no apex-level split), overflow
        ``transpose``/``hedge``, the backend the shard group's device
        resolves to."""
        ints = torch.stack([
            res.triangles.to(torch.int64), res.num_horizontal.to(torch.int64),
            res.transpose_overflow.to(torch.int64),
            res.hedge_overflow.to(torch.int64)]).cpu().numpy()
        tri, nh, t_ovf, h_ovf = (int(x) for x in ints)
        pd = res.per_device.cpu().numpy()
        pv = degs = None
        if res.per_vertex is not None:
            pv, degs = res.per_vertex.cpu().numpy(), deg.cpu().numpy()
        return TriangleReport(
            triangles=tri, k=float(res.k.item()), num_horizontal=nh,
            c1=None, c2=None,
            overflow=Overflow(transpose=bool(t_ovf), hedge=bool(h_ovf)),
            route="distributed",
            backend=resolve_backend(o.backend, shards.device),
            plan_id=f"hedge/{o.mode}/p{pd.shape[0]}", options=o,
            comm=res.comm, per_device=pd, per_vertex=pv, degrees=degs,
        )

    #: the reference's ``find_raw`` returns device arrays where its
    #: ``find`` returns host ones; here ``find`` already returns tensors
    #: on the engine's device, so the two are one function
    find_raw = find
