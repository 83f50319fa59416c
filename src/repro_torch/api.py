"""One front door for cover-edge triangle counting (the port).

Counterpart of ``repro.api`` for the routes ported so far: the exact
single-graph count on the local route (Algorithm 1).

* :class:`TCOptions` — the local route's knobs, validated as in the
  reference.
* :class:`TriangleEngine` — ``count`` on the local route, on the
  engine's device (``"cuda"`` unless the caller asks for ``"cpu"``).
* :class:`TriangleReport` — the result contract: ``triangles``, ``k``,
  ``c1``/``c2``, the normalized :class:`Overflow` flags and provenance.

    from repro_torch.api import TriangleEngine

    report = TriangleEngine().count((edges, n_nodes))
    print(report.triangles, report.k, report.backend)

The other routes of the reference (batch, distributed, approx, stream)
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import sequential as _seq
from repro_torch.core.intersect import (
    BACKENDS,
    DEFAULT_BUCKET_WIDTHS,
    resolve_backend,
)
from repro_torch.device import resolve_device
from repro_torch.graph.csr import Graph, from_edges

__all__ = [
    "ROUTES",
    "Overflow",
    "TCOptions",
    "TriangleEngine",
    "TriangleReport",
]

#: The reference's dispatch targets.  The port answers ``auto`` and
#: ``local``; every other route names the ROADMAP item that ports it.
ROUTES = ("auto", "local", "batch", "distributed", "approx", "stream")

_UNPORTED_ROUTES = {
    "batch": "ROADMAP Queue 1 item 5 (batch lanes and the serving path)",
    "distributed": "ROADMAP Queue 1 item 10 (distributed Algorithm 2)",
    "approx": "ROADMAP Queue 1 item 8 (approx route)",
    "stream": "ROADMAP Queue 1 item 9 (streaming)",
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
    """The local route's execution knobs, frozen and hashable.

      backend:        ``"auto" | "torch" | "cuda"`` intersection backend
                      (``auto`` = the Hopper kernel on a CUDA device, the
                      plain probe on the CPU).
      bucket_widths:  degree-bucket boundaries of the intersection plan.
      query_chunk:    probe-chunk rows (bounds peak memory); also
                      overrides ``row_mult`` when set.
      row_mult:       bucket-row quantization of the plan.
      d_max:          lossy candidate-width clamp (``None`` = exact).
      cap_h:          cap on the compacted horizontal-query block.
      root:           BFS root.
      compact:        ``False`` = the dense seed reference path.
      route:          default dispatch of ``TriangleEngine.count``:
                      ``"auto"`` or ``"local"``.
    """

    backend: str = "auto"
    bucket_widths: tuple = DEFAULT_BUCKET_WIDTHS
    query_chunk: Optional[int] = None
    row_mult: int = 64
    d_max: Optional[int] = None
    cap_h: Optional[int] = None
    root: int = 0
    compact: bool = True
    route: str = "auto"

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
    ``levels`` as a host array."""

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
        an ``(edges, n_nodes)`` pair — on the local route.

        Degenerate n=0 graphs are answered here without running the
        pipeline.  ``clock`` (a :class:`~repro_torch.core.sequential.
        StageClock`) records per-stage seconds, each closed by a device
        synchronize: host CSR build, BFS (and its sweep count),
        horizontal compaction, plan, probe.
        """
        o = options or self.options
        r = route or o.route
        _check_route(r)
        r = "local"
        backend = resolve_backend(o.backend, self.device)
        if isinstance(graph_or_edges, Graph):
            n_nodes = graph_or_edges.n_nodes
        else:
            n_nodes = int(graph_or_edges[1])
        if n_nodes == 0:
            return TriangleReport(
                triangles=0, k=0.0, num_horizontal=0, c1=0, c2=0,
                overflow=Overflow(), route=r, backend=backend,
                plan_id="empty", options=o,
                levels=np.zeros((0,), np.int32),
            )
        res = self.count_raw(graph_or_edges, options=o, clock=clock)
        tri, c1, c2, nh, k, ovf = (
            x.item() for x in (res.triangles, res.c1, res.c2,
                               res.num_horizontal, res.k, res.h_overflow)
        )
        return TriangleReport(
            triangles=int(tri), k=float(k), num_horizontal=int(nh),
            c1=int(c1), c2=int(c2), overflow=Overflow(h=bool(ovf)),
            route=r, backend=backend, plan_id=f"exact/{backend}",
            options=o, levels=res.levels.cpu().numpy(),
        )
