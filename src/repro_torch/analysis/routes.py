"""Engine-route enumeration of the port's auditor (counterpart of
``repro.analysis.routes``).

One definition of "every program the engine can run" that every pass
shares: local / batch / find / stream with per-vertex credit on and off
(find off only), and distributed × hedge mode (``allgather``, ``ring``)
× shard count × per-vertex on ``LocalShards(p, device)``.

The reference lowers each route from ``ShapeDtypeStruct``s.  The port's
programs are eager, so a :class:`RouteSpec` *runs* its route once, at
the reference's budget (``n_budget=64``, ``slot_budget=256``,
``batch=2``), on the seeded graphs of :data:`ROUTE_GRAPHS`.  The backend
is pinned to ``"torch"`` (the plain probe), so the enumeration and every
site key are the same on any host, as the reference pins ``jnp`` and
interpreted Pallas; ``RouteSpec.run(device="cuda")`` with the ``"cuda"``
backend runs the same route through the kernels on the card.

Each route runs what the engine runs on its hot path, on inputs packed
before the run (:meth:`RouteSpec.prepare`): ``count_raw`` (local),
``count_batch_raw`` on the batch's bounded plan (batch, the serving
path), ``find`` with room for 64 triangles, the stream route's one
level-free probe of an 8-edge delta block (``stream.delta.probe_sum``)
and ``count_distributed_raw`` (distributed).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.intersect import IntersectPlan, plan_buckets_bounded
from repro_torch.graph.csr import (
    META_ROW_QUANT,
    META_WIDTHS,
    BatchDegreeMeta,
)

#: intersection backends every route is audited under (pinned: never
#: ``"auto"``, so the report is the same on any host)
BACKENDS = ("torch",)

#: distributed hedge exchange modes
HEDGE_MODES = ("allgather", "ring")

#: the audited graphs, one a lane: (generator, its arguments).  Lane 0
#: is the one graph of the single-graph routes.
ROUTE_GRAPHS = (
    ("karate", {}),
    ("erdos_renyi", {"n": 48, "p": 0.1, "seed": 1}),
)

#: edges of the stream route's delta block (the first of lane 0's)
STREAM_DELTA_EDGES = 8

#: the find route's triangle buffer
FIND_MAX_TRIANGLES = 64


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _ceil_to(x: int, mult: int) -> int:
    return max(mult, -(-int(x) // mult) * mult)


def synthetic_meta(n_budget: int, slot_budget: int,
                   *, d_pad: Optional[int] = None) -> BatchDegreeMeta:
    """A valid ``BatchDegreeMeta`` for a worst-case batch at this budget
    — every bound at its ceiling, exceedance decaying across the width
    grid so bounded plans lay out realistic multi-bucket shapes (the
    reference's function)."""
    d = int(d_pad) if d_pad is not None else min(
        _next_pow2(max(2, n_budget // 8)), 1024
    )
    h_rows = _ceil_to(max(1, slot_budget // 2), META_ROW_QUANT)
    exceed = []
    for i, w in enumerate(META_WIDTHS):
        c = h_rows >> (i + 1) if w < d else 0
        exceed.append((w, _ceil_to(c, META_ROW_QUANT) if c else 0))
    return BatchDegreeMeta(d_pad=d, h_rows=h_rows, exceed=tuple(exceed))


def bounded_plan(meta: BatchDegreeMeta, *, backend: str = "torch",
                 query_chunk: Optional[int] = None) -> IntersectPlan:
    """The serving-path bounded plan for a synthetic meta — host-only."""
    return plan_buckets_bounded(
        meta.h_rows, d_pad=meta.d_pad, exceed=meta.exceed,
        backend=backend, query_chunk=query_chunk,
        row_mult=META_ROW_QUANT, sort_queries=False,
    )


def route_graphs() -> list[tuple[np.ndarray, int]]:
    """The ``(edges, n_nodes)`` of :data:`ROUTE_GRAPHS`."""
    from repro_torch.graph import generators as gen

    return [getattr(gen, name)(**kw) for name, kw in ROUTE_GRAPHS]


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """One audited engine configuration.  ``name`` is the stable
    finding-site prefix; :meth:`run` runs the route once."""

    name: str
    route: str                # local | batch | find | distributed | stream
    backend: str
    per_vertex: bool
    mode: Optional[str] = None     # distributed hedge mode
    p: int = 1                     # distributed shard count
    n_budget: int = 64
    slot_budget: int = 256
    batch: int = 2

    def options(self):
        from repro_torch.api import TCOptions

        return TCOptions(backend=self.backend, per_vertex=self.per_vertex,
                         mode=self.mode or "auto")

    def prepare(self, device="cpu") -> tuple[Callable, Callable]:
        """``(run, sweeps)``: the route's inputs are packed on ``device``
        here, ``run()`` runs the route once on them and ``sweeps(result)``
        is the BFS sweep count of the run (0 for the stream route's
        level-free probe).  Only ``run()`` belongs in a recording."""
        from repro_torch.api import TriangleEngine
        from repro_torch.core.bfs import bfs_levels_iters
        from repro_torch.graph.csr import (
            ShapeBudget,
            from_edges,
            from_edges_batch,
        )

        o = self.options()
        eng = TriangleEngine(o, device=device)
        graphs = route_graphs()
        edges, _ = graphs[0]

        def bfs_sweeps(g):
            def sweeps(_):
                return bfs_levels_iters(g.src, g.dst, g.n_nodes, int(o.root),
                                        row_offsets=g.row_offsets)[1]
            return sweeps

        if self.route == "batch":
            gb = from_edges_batch(
                graphs[:self.batch],
                budget=ShapeBudget(self.n_budget, self.slot_budget),
                batch_size=self.batch, device=eng.device)
            plan = eng.plan_for(gb)
            return (lambda: eng.count_batch_raw(gb, plan=plan),
                    bfs_sweeps(gb.lane_view()))
        g = from_edges(edges, self.n_budget, num_slots=self.slot_budget,
                       device=eng.device)
        if self.route == "local":
            return lambda: eng.count_raw(g), bfs_sweeps(g)
        if self.route == "find":
            return (lambda: eng.find(g, max_triangles=FIND_MAX_TRIANGLES),
                    bfs_sweeps(g))
        if self.route == "stream":
            from repro_torch.stream.delta import probe_sum

            deg = g.deg.cpu().numpy().astype(np.int64)
            und = np.unique(np.sort(np.asarray(edges, np.int64), 1), axis=0)
            delta = und[und[:, 0] != und[:, 1]][:STREAM_DELTA_EDGES]
            return (lambda: probe_sum(g, delta, deg, options=o,
                                      per_vertex=self.per_vertex),
                    lambda _: 0)
        if self.route == "distributed":
            from repro_torch.core.shards import LocalShards

            shards = LocalShards(self.p, eng.device)
            return (lambda: eng.count_distributed_raw(g, mesh=shards),
                    lambda res: int(res.comm.bfs_sweeps))
        raise ValueError(f"unknown route {self.route!r}")

    def run(self, device="cpu"):
        """The route's result, run once on ``device``."""
        return self.prepare(device)[0]()


def enumerate_route_specs(
    *,
    n_budget: int = 64,
    slot_budget: int = 256,
    batch: int = 2,
    p_values: tuple[int, ...] = (1,),
    backends: tuple[str, ...] = BACKENDS,
) -> list[RouteSpec]:
    """The full audited route space: local/batch/find/stream × backend
    × per_vertex, plus distributed × backend × per_vertex × mode × p, in
    the reference's order.  ``backends=("cuda",)`` names the same space
    through the kernels (a card run)."""
    shape = dict(n_budget=n_budget, slot_budget=slot_budget, batch=batch)
    specs: list[RouteSpec] = []
    for backend in backends:
        for pv in (False, True):
            tag = f"{backend}{'/pv' if pv else ''}"
            specs.append(RouteSpec(
                name=f"batch/{tag}", route="batch", backend=backend,
                per_vertex=pv, **shape,
            ))
            specs.append(RouteSpec(
                name=f"local/{tag}", route="local", backend=backend,
                per_vertex=pv, **shape,
            ))
            if not pv:  # finding has no per-vertex variant
                specs.append(RouteSpec(
                    name=f"find/{tag}", route="find", backend=backend,
                    per_vertex=pv, **shape,
                ))
            specs.append(RouteSpec(
                name=f"stream/{tag}", route="stream", backend=backend,
                per_vertex=pv, **shape,
            ))
            for mode in HEDGE_MODES:
                for p in p_values:
                    specs.append(RouteSpec(
                        name=f"distributed/{tag}/{mode}/p{p}",
                        route="distributed", backend=backend,
                        per_vertex=pv, mode=mode, p=p, **shape,
                    ))
    return specs
