"""One front door for cover-edge triangle counting (the port).

Counterpart of ``repro.api`` for the routes ported so far: the exact
single-graph count on the local route (Algorithm 1), with per-vertex
credit, triangle finding, and the stream route (live counts under edge
mutation streams).

* :class:`TCOptions` — the local route's knobs, validated as in the
  reference.
* :class:`TriangleEngine` — ``count`` on the local and stream routes,
  ``find`` and ``stream``, on the engine's device (``"cuda"`` unless the
  caller asks for ``"cpu"``).
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
    session = engine.stream((edges, n_nodes))
    update = session.apply([(+1, 0, 5), (-1, 2, 3)])
    print(update.delta_triangles, session.count().triangles)

The other routes of the reference (batch, distributed, approx) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import sequential as _seq
from repro_torch.core.approx import ApproxEstimate
from repro_torch.core.intersect import (
    BACKENDS,
    DEFAULT_BUCKET_WIDTHS,
    resolve_backend,
)
from repro_torch.device import resolve_device
from repro_torch.graph.csr import Graph, from_edges
from repro_torch.stream.session import StreamSession, StreamStats

__all__ = [
    "ROUTES",
    "Overflow",
    "TCOptions",
    "TriangleEngine",
    "TriangleReport",
]

#: The reference's dispatch targets.  The port answers ``auto``,
#: ``local`` and ``stream``; every other route names the ROADMAP item
#: that ports it.
ROUTES = ("auto", "local", "batch", "distributed", "approx", "stream")

_UNPORTED_ROUTES = {
    "batch": "ROADMAP Queue 1 item 5 (batch lanes and the serving path)",
    "distributed": "ROADMAP Queue 1 item 10 (distributed Algorithm 2)",
    "approx": "ROADMAP Queue 1 item 8 (approx route)",
}

#: edge-list input: ``(edges int[any, 2], n_nodes)``
EdgeList = tuple


def _check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}; got {route!r}")
    if route in _UNPORTED_ROUTES:
        raise NotImplementedError(
            f"route {route!r} is not ported to repro_torch yet: "
            f"{_UNPORTED_ROUTES[route]}"
        )


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
      route:          default dispatch of ``TriangleEngine.count``:
                      ``"auto"``, ``"local"`` or ``"stream"``.

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
    route: str = "auto"
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
        _check_route(self.route)
        for name in ("query_chunk", "d_max", "cap_h"):
            v = getattr(self, name)
            if v is not None and int(v) <= 0:
                raise ValueError(f"{name} must be positive; got {v}")
        if any(w <= 0 for w in self.bucket_widths):
            raise ValueError(
                f"bucket_widths must be positive; got {self.bucket_widths}"
            )
        if self.row_mult <= 0:
            raise ValueError(f"row_mult must be positive; got {self.row_mult}")
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


@dataclasses.dataclass(frozen=True)
class Overflow:
    """Every way a count can be less than exact, normalized into one
    struct.  ``h``: horizontal queries dropped (``cap_h``), or a width
    clamp (``d_max``) truncated candidate lists.  ``transpose`` /
    ``hedge`` belong to the distributed route and stay False here."""

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
    next refresh."""

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


def _graph_edges(g: Graph) -> tuple[torch.Tensor, int]:
    """A graph's unique undirected edges as an ``int64[m, 2]`` tensor on
    the graph's device, with its vertex count — how a packed ``Graph``
    opens a stream session without a host round trip."""
    keep = (g.src < g.dst) & (g.dst < g.n_nodes)
    return (torch.stack([g.src[keep], g.dst[keep]], dim=1).to(torch.int64),
            g.n_nodes)


class TriangleEngine:
    """The facade of the port: one object that owns the device and the
    default options of every count.

    Args:
      options: default :class:`TCOptions` for every call (per-call
        overrides via ``options=`` / ``route=``).
      device: where the engine runs — ``"cuda"`` (default) or ``"cpu"``.
        A CUDA device on a host without a card raises here.
    """

    def __init__(self, options: Optional[TCOptions] = None, *,
                 device: Union[str, torch.device] = "cuda"):
        if options is not None and not isinstance(options, TCOptions):
            raise TypeError(
                f"options must be a TCOptions, got {type(options).__name__}"
            )
        self.options = options or TCOptions()
        self.device = resolve_device(device)

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

    def count_raw(self, graph_or_edges, *,
                  options: Optional[TCOptions] = None,
                  clock: Optional[_seq.StageClock] = None) -> _seq.TCResult:
        """Local (Algorithm 1) count returning the raw ``TCResult``."""
        return _seq._triangle_count(
            self._graph(graph_or_edges, clock), options or self.options,
            clock=clock,
        )

    def count(
        self,
        graph_or_edges: Union[Graph, EdgeList],
        *,
        route: Optional[str] = None,
        options: Optional[TCOptions] = None,
        clock: Optional[_seq.StageClock] = None,
    ) -> TriangleReport:
        """Count the triangles of one graph — a packed :class:`Graph` or
        an ``(edges, n_nodes)`` pair — on the local route (``"auto"`` or
        ``"local"``) or the stream route.

        ``route="stream"`` opens a one-shot session (:meth:`stream`),
        whose opening refresh is the full local count, and answers its
        report: the same numbers with stream provenance.  Degenerate n=0
        graphs are answered here without running the pipeline.
        ``clock`` (a :class:`~repro_torch.core.sequential.StageClock`)
        records per-stage seconds of the local route, each closed by a
        device synchronize: CSR build, BFS (and its sweep count),
        horizontal compaction, plan, probe.
        """
        o = options or self.options
        r = route or o.route
        _check_route(r)
        if r != "stream":
            r = "local"
        backend = resolve_backend(o.backend, self.device)
        if isinstance(graph_or_edges, Graph):
            n_nodes = graph_or_edges.n_nodes
        else:
            n_nodes = int(graph_or_edges[1])
        if n_nodes == 0:
            empty_pv = np.zeros((0,), np.int32) if o.per_vertex else None
            return TriangleReport(
                triangles=0, k=0.0, num_horizontal=0, c1=0, c2=0,
                overflow=Overflow(), route=r, backend=backend,
                plan_id="empty", options=o,
                levels=np.zeros((0,), np.int32),
                per_vertex=empty_pv, degrees=empty_pv,
            )
        if r == "stream":
            return self.stream(graph_or_edges, options=o).count()
        g = self._graph(graph_or_edges, clock)
        res = _seq._triangle_count(g, o, clock=clock)
        tri, c1, c2, nh, k, ovf = (
            x.item() for x in (res.triangles, res.c1, res.c2,
                               res.num_horizontal, res.k, res.h_overflow)
        )
        pv = degs = None
        if o.per_vertex:
            pv, degs = res.per_vertex.cpu().numpy(), g.deg.cpu().numpy()
        return TriangleReport(
            triangles=int(tri), k=float(k), num_horizontal=int(nh),
            c1=int(c1), c2=int(c2), overflow=Overflow(h=bool(ovf)),
            route=r, backend=backend, plan_id=f"exact/{backend}",
            options=o, levels=res.levels.cpu().numpy(),
            per_vertex=pv, degrees=degs,
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

    #: the reference's ``find_raw`` returns device arrays where its
    #: ``find`` returns host ones; here ``find`` already returns tensors
    #: on the engine's device, so the two are one function
    find_raw = find
