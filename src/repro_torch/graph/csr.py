"""CSR graph container of the port (counterpart of ``repro.graph.csr``).

A graph is stored as

  * a symmetrized directed edge list ``(src, dst)`` sorted by ``(src, dst)``
    — i.e. CSR order — optionally padded with the sentinel vertex ``n``,
  * CSR ``row_offsets`` / ``deg`` derived from it,

all as int32 tensors on one device.  Construction moves the raw edge
array to the device once and packs it there, with the same set semantics
as the reference's host-numpy packing and the same arrays.

The batch route packs B requests into one :class:`GraphBatch` of a
shared ``(n_budget, slot_budget)`` cell of a :class:`BudgetGrid`: each
request is normalized on the host in numpy, as the reference does, the
quantized :class:`BatchDegreeMeta` is taken from the host degrees, and
the packed batch crosses to the device in one copy.  Each lane is a
valid graph whose vertex count is the budget: vertices ``n_nodes[i] ..
n_budget - 1`` are isolated and change neither BFS levels of real
vertices, nor horizontal marking, nor any count.
"""
from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.dtypes import torch_index_dtype
from repro_torch.core.hostio import note_wait
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Symmetrized graph in CSR-ordered edge-list form.

    A :meth:`GraphBatch.lane_view` is a ``Graph`` whose tensors carry a
    leading lane axis, with the budget as ``n_nodes``; the BFS and the
    compaction (``core/bfs.py``, ``core/edges.py``) run on either form.

    Attributes:
      src, dst:     int32[num_slots] directed edges, CSR-sorted; padded
                    entries have ``src == dst == n`` (the sentinel vertex).
      row_offsets:  int32[n + 2] CSR offsets (the extra row is the sentinel
                    vertex, so ``row_offsets[n+1] == num_slots``).
      deg:          int32[n] vertex degrees.
      n_edges_dir:  int32 scalar — number of *real* directed edges (2m).
      n_nodes:      python int, number of real vertices.
    """

    src: torch.Tensor
    dst: torch.Tensor
    row_offsets: torch.Tensor
    deg: torch.Tensor
    n_edges_dir: torch.Tensor
    n_nodes: int

    @property
    def num_slots(self) -> int:
        return self.src.shape[-1]

    @property
    def sentinel(self) -> int:
        return self.n_nodes

    @property
    def device(self) -> torch.device:
        return self.src.device


def _normalize_edges(
    edges: torch.Tensor, n_nodes: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packing step, on the device the edges live on: dedup, drop
    self-loops, symmetrize, CSR-sort.  Returns ``(src, dst)`` int64
    directed tensors of length 2m.

    The graph is a simple undirected SET of edges: repeats of ``(u, v)``,
    its reverse ``(v, u)``, or both collapse to ONE undirected edge via a
    sorted unique over the packed ``lo * n + hi`` keys, and self-loops
    are dropped.  An empty edge array and/or ``n_nodes == 0`` give an
    empty graph without tripping the ``// n_nodes`` key arithmetic.  The
    arrays equal the reference's host-numpy ones element for element.
    """
    z = torch.zeros(0, dtype=torch.int64, device=edges.device)
    if edges.numel() == 0 or n_nodes <= 0:
        return z, z
    edges = edges.reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    note_wait()  # the bool mask's size
    if edges.shape[0] == 0:
        return z, z
    lo = torch.minimum(edges[:, 0], edges[:, 1])
    hi = torch.maximum(edges[:, 0], edges[:, 1])
    und = torch.unique(lo * n_nodes + hi, sorted=True)
    note_wait()  # the unique keys' count
    lo, hi = und // n_nodes, und % n_nodes
    # both directions as packed ``src * n + dst`` keys: they are unique,
    # so one sort of the keys is the lexicographic (src, dst) order
    key = torch.sort(torch.cat([und, hi * n_nodes + lo])).values
    return key // n_nodes, key % n_nodes


def graph_from_numpy(
    src, dst, row_offsets, deg, n_edges_dir, n_nodes: int, *,
    device: str | torch.device = "cuda",
) -> Graph:
    """A :class:`Graph` from host arrays (any integer dtype that fits
    int32) — how a graph packed elsewhere, e.g. by the JAX package,
    crosses into the port unchanged."""
    dev = resolve_device(device)
    n_nodes = int(n_nodes)
    slots = int(np.asarray(src).shape[0])
    torch_index_dtype(max(n_nodes, slots), site="csr.graph_from_numpy")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)

    return Graph(
        src=t(src), dst=t(dst), row_offsets=t(row_offsets), deg=t(deg),
        n_edges_dir=t(np.asarray(n_edges_dir).reshape(())),
        n_nodes=n_nodes,
    )


def from_edges(
    edges: np.ndarray,
    n_nodes: int,
    *,
    num_slots: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> Graph:
    """Build a ``Graph`` from an undirected edge array ``int[any, 2]``
    (numpy or a tensor).

    The edges move to ``device`` once, as int64 — a tensor already there
    is used as it is, with no host round trip — and are deduplicated,
    stripped of self-loops, symmetrized and CSR-sorted there (see
    ``_normalize_edges``).  ``num_slots`` pads the directed edge list to
    a fixed budget (>= 2m).  Vertex ids are bounded by the sentinel
    (``n``) and CSR offsets by the slot count; either past int32 raises
    ``IndexWidthError`` before the edges are packed.
    """
    dev = resolve_device(device)
    n_nodes = int(n_nodes)
    torch_index_dtype(n_nodes, site="csr.from_edges vertex ids")
    if isinstance(edges, torch.Tensor):
        if edges.device.type != dev.type:
            note_wait()  # the blocking copy to the device
        e = edges.to(dev, torch.int64)
    else:
        e = torch.as_tensor(np.asarray(edges, dtype=np.int64)).to(dev)
        note_wait()  # the blocking copy to the device
    s, d = _normalize_edges(e, n_nodes)
    m2 = s.shape[0]
    slots = int(num_slots) if num_slots is not None else m2
    if slots < m2:
        raise ValueError(f"num_slots={slots} < 2m={m2}")
    torch_index_dtype(slots, site="csr.from_edges row_offsets")
    i32 = dict(dtype=torch.int32, device=dev)
    pad = torch.full((slots - m2,), n_nodes, **i32)
    counts = torch.bincount(s, minlength=n_nodes + 1)
    row_offsets = torch.zeros(n_nodes + 2, dtype=torch.int64, device=dev)
    row_offsets[1:] = torch.cumsum(counts, 0)
    row_offsets[n_nodes + 1] = slots
    note_wait(2)  # bincount's size; the Python scalar's blocking copy
    return Graph(
        src=torch.cat([s.to(torch.int32), pad]),
        dst=torch.cat([d.to(torch.int32), pad]),
        row_offsets=row_offsets.to(torch.int32),
        deg=counts[:n_nodes].to(torch.int32),
        n_edges_dir=torch.tensor(m2, **i32),
        n_nodes=n_nodes,
    )


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _ceil_to(x: int, mult: int) -> int:
    return max(mult, -(-int(x) // mult) * mult)


# ---------------------------------------------------------------- batching

#: Candidate-width grid the packer's exceedance metadata is computed on
#: (a superset of ``DEFAULT_BUCKET_WIDTHS``, so bounded batch plans can
#: bucket at any of these without re-reading the graph).
META_WIDTHS = (8, 32, 64, 256, 1024)

#: Quantization step of the degree metadata: row counts are rounded up
#: to this multiple so same-scale traffic shares plan-cache keys.
META_ROW_QUANT = 64

#: Fewest edge rows of a batch whose lanes the packer normalizes on
#: threads, one lane a thread (numpy's sorts release the GIL); below it
#: the threads' start-up costs more than they save.
PARALLEL_PACK_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True, order=True)
class ShapeBudget:
    """One cell of the grid a request is rounded onto: ``n_budget``
    vertex slots and ``slot_budget`` directed edge slots."""

    n_budget: int
    slot_budget: int


@dataclasses.dataclass(frozen=True)
class BudgetGrid:
    """Rounds request sizes onto a geometric grid of ``ShapeBudget``s, so
    the number of distinct batch shapes (and plan-cache entries) grows
    with the log of the largest request, not with the number of distinct
    request shapes.

    The geometry — base cell ``(min_nodes, min_slots)``, geometric
    ``factor``, top cell ``(max_nodes, max_slots)`` — is a frozen,
    validated value, as in the reference.  A request whose cell would
    pass either cap does not ``fit``, and ``budget_for`` raises for it:
    the reference answers such requests on the distributed route.
    ``None`` (default) leaves the grid unbounded.
    """

    min_nodes: int = 64
    min_slots: int = 256
    factor: float = 2.0
    max_nodes: Optional[int] = None
    max_slots: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "min_nodes", int(self.min_nodes))
        object.__setattr__(self, "min_slots", int(self.min_slots))
        object.__setattr__(self, "factor", float(self.factor))
        for name in ("max_nodes", "max_slots"):
            v = getattr(self, name)
            object.__setattr__(self, name, int(v) if v is not None else None)
        if self.min_nodes <= 0 or self.min_slots <= 0:
            raise ValueError(
                f"grid base cell must be positive; got min_nodes="
                f"{self.min_nodes}, min_slots={self.min_slots}"
            )
        if not self.factor > 1.0:
            raise ValueError(f"factor must be > 1; got {self.factor}")
        if self.max_nodes is not None and self.max_nodes < self.min_nodes:
            raise ValueError(
                f"max_nodes={self.max_nodes} < min_nodes={self.min_nodes}"
            )
        if self.max_slots is not None and self.max_slots < self.min_slots:
            raise ValueError(
                f"max_slots={self.max_slots} < min_slots={self.min_slots}"
            )

    @property
    def capped(self) -> bool:
        """True iff the grid has a top cell."""
        return self.max_nodes is not None or self.max_slots is not None

    def _round(self, x: int, lo: int) -> int:
        if x <= lo:
            return lo
        k = math.ceil(math.log(x / lo) / math.log(self.factor) - 1e-9)
        return int(math.ceil(lo * self.factor ** k))

    def _cell(self, n_nodes: int, n_edges_und: int) -> ShapeBudget:
        return ShapeBudget(
            n_budget=self._round(int(n_nodes), self.min_nodes),
            slot_budget=self._round(2 * int(n_edges_und), self.min_slots),
        )

    def fits(self, n_nodes: int, n_edges_und: int) -> bool:
        """True iff the request's grid cell is within the top cell."""
        b = self._cell(n_nodes, n_edges_und)
        return (self.max_nodes is None or b.n_budget <= self.max_nodes) and (
            self.max_slots is None or b.slot_budget <= self.max_slots
        )

    def budget_for(self, n_nodes: int, n_edges_und: int) -> ShapeBudget:
        """Smallest grid cell fitting ``n_nodes`` vertices and
        ``n_edges_und`` undirected edges (2 directed slots each).  Raises
        for a request over the top cell."""
        if not self.fits(n_nodes, n_edges_und):
            raise ValueError(
                f"request ({n_nodes} nodes, {n_edges_und} edges) exceeds "
                f"the grid's top cell (max_nodes={self.max_nodes}, "
                f"max_slots={self.max_slots}); route it to the "
                f"distributed backend"
            )
        return self._cell(n_nodes, n_edges_und)


DEFAULT_BUDGET_GRID = BudgetGrid()


@dataclasses.dataclass(frozen=True)
class BatchDegreeMeta:
    """Quantized host-side degree metadata of one packed batch: all the
    bounded planner needs to lay out an exact ``IntersectPlan`` before
    the BFS (``core.sequential.batch_plan_for``).

    ``d_pad``: pow2-rounded max degree over the batch.  ``h_rows``:
    row-quantized upper bound on any lane's horizontal-query count (its
    undirected edge count).  ``exceed``: per ``META_WIDTHS`` width ``w``,
    a row-quantized upper bound on any lane's number of undirected edges
    whose smaller endpoint has degree > ``w``.  Every bound is rounded
    up, so plans built from them stay exact.
    """

    d_pad: int
    h_rows: int
    exceed: tuple[tuple[int, int], ...]

    def union(self, other: "BatchDegreeMeta") -> "BatchDegreeMeta":
        """Elementwise max of two metas: an upper bound for any batch
        either one bounds (how the server pools each flush's meta to a
        per-cell high-water mark, so a cell's batches share one plan)."""
        if [w for w, _ in self.exceed] != [w for w, _ in other.exceed]:
            raise ValueError("cannot union metas over different width grids")
        return BatchDegreeMeta(
            d_pad=max(self.d_pad, other.d_pad),
            h_rows=max(self.h_rows, other.h_rows),
            exceed=tuple(
                (w, max(c, oc))
                for (w, c), (_, oc) in zip(self.exceed, other.exceed)
            ),
        )


def _normalize_edges_host(
    edges: np.ndarray, n_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """The reference's host packing step in numpy: dedup, drop
    self-loops, symmetrize, CSR-sort; ``(src, dst)`` int64 of length 2m.

    The same set semantics and the same arrays as the reference's
    ``_normalize_edges`` (and as :func:`_normalize_edges` on a device):
    the directed edges are unique, so one sort of their packed ``src * n
    + dst`` keys stands in for its lexsort.  An empty edge array and/or
    ``n_nodes == 0`` (the empty lanes of a partial batch) give an empty
    graph."""
    edges = np.asarray(edges, dtype=np.int64)
    z = np.zeros(0, dtype=np.int64)
    if edges.size == 0 or n_nodes <= 0:
        return z, z
    edges = edges.reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if edges.shape[0] == 0:
        return z, z
    n = np.int64(n_nodes)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    # np.unique by hand: a sort and a mask of first occurrences give the
    # same array, and numpy 2.3's np.unique is many times slower than its
    # sort on integer keys
    und = np.sort(lo * n + hi)
    und = und[np.concatenate([[True], und[1:] != und[:-1]])]
    lo, hi = und // n, und % n
    key = np.sort(np.concatenate([und, hi * n + lo]))
    return key // n, key % n


def _degree_stats(s: np.ndarray, d: np.ndarray, counts: np.ndarray):
    """``(d_max, h_count, {w: exceed})`` of one normalized request with
    degrees ``counts`` (the unquantized statistics of the meta)."""
    und = s < d
    mind = np.minimum(counts[s[und]], counts[d[und]])
    return (int(counts.max()), s.shape[0] // 2,
            {w: int((mind > w).sum()) for w in META_WIDTHS})


def _quantized_meta(d_max: int, h_count: int, exceed: dict):
    return BatchDegreeMeta(
        d_pad=_next_pow2(max(d_max, 1)),
        h_rows=_ceil_to(max(h_count, 1), META_ROW_QUANT),
        exceed=tuple(
            (w, _ceil_to(c, META_ROW_QUANT) if c else 0)
            for w, c in sorted(exceed.items())
        ),
    )


def degree_meta(edges: np.ndarray, n_nodes: int) -> BatchDegreeMeta:
    """Quantized ``BatchDegreeMeta`` of ONE ``(edges, n_nodes)`` request.
    The quantizers commute with elementwise max, so the union of
    per-request metas bounds the meta of any batch packed from them."""
    s, d = _normalize_edges_host(edges, n_nodes)
    if not s.shape[0]:
        return _quantized_meta(0, 0, dict.fromkeys(META_WIDTHS, 0))
    counts = np.bincount(s, minlength=n_nodes + 1)[: max(n_nodes, 1)]
    return _quantized_meta(*_degree_stats(s, d, counts))


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """B budget-padded graphs of one shape, on one device.

    Attributes:
      src, dst:     int32[B, slot_budget] per-lane CSR-sorted directed
                    edges; padding has ``src == dst == n_budget``.
      row_offsets:  int32[B, n_budget + 2] per-lane CSR offsets.
      deg:          int32[B, n_budget] per-lane degrees.
      n_nodes:      int32[B], each lane's real vertex count.
      n_edges_dir:  int32[B], each lane's real directed edge count.
      n_budget:     python int, the shared vertex budget (= the lane
                    sentinel).
      meta:         the ``BatchDegreeMeta`` (``from_edges_batch``
                    attaches it; ``None`` on a ``to_batch`` view).

    The batch's lane view (``core.intersect.LaneView``) numbers vertex
    ``v`` of lane ``i`` as ``i * (n_budget + 1) + v`` and slot ``j`` of
    lane ``i`` as ``i * slot_budget + j``, so both products must fit in
    int32: a batch past that raises ``IndexWidthError`` here.
    """

    src: torch.Tensor
    dst: torch.Tensor
    row_offsets: torch.Tensor
    deg: torch.Tensor
    n_nodes: torch.Tensor
    n_edges_dir: torch.Tensor
    n_budget: int
    meta: Optional[BatchDegreeMeta] = None

    def __post_init__(self):
        b, slots = self.src.shape
        torch_index_dtype(b * (self.n_budget + 1),
                          site="csr.GraphBatch lane-view vertex ids")
        torch_index_dtype(b * slots, site="csr.GraphBatch lane-view slots")

    @property
    def batch_size(self) -> int:
        return self.src.shape[0]

    @property
    def slot_budget(self) -> int:
        return self.src.shape[1]

    @property
    def budget(self) -> ShapeBudget:
        return ShapeBudget(self.n_budget, self.slot_budget)

    @property
    def device(self) -> torch.device:
        return self.src.device

    def lane_view(self) -> Graph:
        """The batch as a ``Graph`` with a leading lane axis on every
        tensor and the budget as ``n_nodes``: what the BFS and the
        compaction run on, lane by lane."""
        return Graph(
            src=self.src, dst=self.dst, row_offsets=self.row_offsets,
            deg=self.deg, n_edges_dir=self.n_edges_dir,
            n_nodes=self.n_budget,
        )


def from_edges_batch(
    graphs: Sequence[tuple[np.ndarray, int]],
    *,
    budget: Optional[ShapeBudget] = None,
    grid: Optional[BudgetGrid] = None,
    batch_size: Optional[int] = None,
    with_meta: bool = True,
    device: str | torch.device = "cuda",
) -> GraphBatch:
    """Pack ``(edges, n_nodes)`` requests into one ``GraphBatch``.

    Each request is normalized on the host
    (:func:`_normalize_edges_host`; a batch of at least
    ``PARALLEL_PACK_ROWS`` edge rows one lane a thread) and padded onto
    ``budget`` — by default the smallest ``grid`` cell fitting the
    largest request.
    ``batch_size`` pads the batch with empty lanes; ``with_meta``
    attaches the quantized ``BatchDegreeMeta`` of the host degrees.  The
    packed arrays cross to ``device`` in one copy.
    """
    dev = resolve_device(device)
    if batch_size is not None and len(graphs) > batch_size:
        raise ValueError(f"{len(graphs)} graphs > batch_size={batch_size}")
    graphs = [(e, int(n)) for e, n in graphs]
    rows = sum(int(np.size(e)) // 2 for e, _ in graphs)
    threads = (min(len(graphs), os.cpu_count() or 1)
               if len(graphs) > 1 and rows >= PARALLEL_PACK_ROWS else 1)
    pool = ThreadPoolExecutor(threads) if threads > 1 else None
    try:
        run = pool.map if pool is not None else map
        norm = [(sd, n) for sd, (_, n) in zip(
            run(lambda g: _normalize_edges_host(*g), graphs), graphs)]
        if budget is None:
            grid = grid or DEFAULT_BUDGET_GRID
            budget = grid.budget_for(
                max((n for _, n in norm), default=0),
                max((s.shape[0] for (s, _), _ in norm), default=0) // 2,
            )
        nb, slots = budget.n_budget, budget.slot_budget
        torch_index_dtype(nb, site="csr.from_edges_batch vertex ids")
        torch_index_dtype(slots, site="csr.from_edges_batch row_offsets")
        for i, ((s, _), n) in enumerate(norm):
            if n > nb:
                raise ValueError(f"graph {i}: n_nodes={n} > n_budget={nb}")
            if s.shape[0] > slots:
                raise ValueError(
                    f"graph {i}: 2m={s.shape[0]} > slot_budget={slots}")
        B = int(batch_size) if batch_size is not None else max(1, len(norm))
        # one host buffer, one copy: src, dst, row_offsets, deg, n_nodes, 2m
        sizes = (B * slots, B * slots, B * (nb + 2), B * nb, B, B)
        buf = np.zeros(sum(sizes), dtype=np.int32)
        parts = np.split(buf, np.cumsum(sizes)[:-1])
        src, dst = parts[0].reshape(B, slots), parts[1].reshape(B, slots)
        row, deg = parts[2].reshape(B, nb + 2), parts[3].reshape(B, nb)
        src[:] = nb
        dst[:] = nb
        row[:, nb + 1] = slots  # the sentinel row closes at the slot
        #   budget on every lane, empty padding lanes included
        parts[4][:len(norm)] = [n for _, n in norm]
        parts[5][:len(norm)] = [s.shape[0] for (s, _), _ in norm]

        def fill(i):
            """Lane ``i``'s rows of the buffer (disjoint from every other
            lane's) and its unquantized degree statistics."""
            (s, d), _ = norm[i]
            m2 = s.shape[0]
            src[i, :m2] = s
            dst[i, :m2] = d
            counts = np.bincount(s, minlength=nb + 1)[:nb]
            deg[i] = counts
            np.cumsum(counts, out=row[i, 1:nb + 1])
            return _degree_stats(s, d, counts) if with_meta and m2 else None

        stats = [x for x in run(fill, range(len(norm))) if x is not None]
    finally:
        if pool is not None:
            pool.shutdown()
    meta = None
    if with_meta:
        meta = _quantized_meta(
            max((x[0] for x in stats), default=0),
            max((x[1] for x in stats), default=0),
            {w: max((x[2][w] for x in stats), default=0)
             for w in META_WIDTHS},
        )
    t = torch.from_numpy(buf).to(dev)
    tp = torch.split(t, sizes)
    return GraphBatch(
        src=tp[0].view(B, slots), dst=tp[1].view(B, slots),
        row_offsets=tp[2].view(B, nb + 2), deg=tp[3].view(B, nb),
        n_nodes=tp[4], n_edges_dir=tp[5], n_budget=nb, meta=meta,
    )


def to_batch(g: Graph) -> GraphBatch:
    """A B=1 ``GraphBatch`` view of a ``Graph`` (no copy; the budget is
    the graph's own shape, and there is no meta)."""
    return GraphBatch(
        src=g.src[None], dst=g.dst[None],
        row_offsets=g.row_offsets[None], deg=g.deg[None],
        n_nodes=torch.tensor([g.n_nodes], dtype=torch.int32,
                             device=g.device),
        n_edges_dir=g.n_edges_dir.reshape(1),
        n_budget=g.n_nodes,
    )


def undirected_edges(
    g: Graph,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unique undirected edges as ``(u, w, valid)`` with ``u < w``.

    Returned tensors have ``num_slots`` entries; exactly ``m`` are valid
    (marked by ``valid``), the rest are sentinel-padded.  Order matches the
    CSR edge order restricted to ``src < dst``.
    """
    keep = g.src < g.dst
    n = torch.tensor(g.n_nodes, dtype=torch.int32, device=g.device)
    return torch.where(keep, g.src, n), torch.where(keep, g.dst, n), keep


def gather_rows(
    flat: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
    *, width: int, pad: int,
) -> torch.Tensor:
    """Dense ``int32[len(starts), width]`` view of the variable-length
    slices ``flat[starts[i] : starts[i] + lens[i]]``, ``pad``-filled past
    each slice's length."""
    q = starts.shape[0]
    if flat.shape[0] == 0:
        return torch.full((q, width), pad, dtype=torch.int32,
                          device=starts.device)
    pos = torch.arange(width, dtype=torch.int32, device=starts.device)
    idx = (starts[:, None] + pos[None, :]).clamp_(0, flat.shape[0] - 1)
    ok = pos[None, :] < lens[:, None]
    pad_t = torch.tensor(pad, dtype=torch.int32, device=starts.device)
    return torch.where(ok, flat[idx], pad_t)


def gather_neighbors(g: Graph, v: torch.Tensor, *, width: int,
                     pad: int) -> torch.Tensor:
    """Dense ``int32[len(v), width]`` adjacency rows for vertices ``v``.

    Rows of sentinel vertices (``v == n``) and slots past each vertex's
    degree are filled with ``pad``; neighbour order is CSR order, i.e.
    sorted ascending (``kernels/intersect/ops.py``'s front end)."""
    n = g.n_nodes
    deg_ext = torch.cat([g.deg, torch.zeros(1, dtype=torch.int32,
                                            device=g.deg.device)])
    vc = v.clamp(0, n)
    lens = torch.where(v < n, deg_ext[vc], 0)
    return gather_rows(g.dst, g.row_offsets[vc], lens, width=width, pad=pad)


def bounded_binary_search(
    sorted_arr: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    queries: torch.Tensor,
    *,
    num_steps: int,
) -> torch.Tensor:
    """Branch-free membership test of ``queries[i]`` in the sorted slice
    ``sorted_arr[starts[i] : starts[i] + lengths[i]]``.

    Runs ``num_steps`` halving iterations (pass ``ceil(log2(max_len +
    1))``); fewer steps under-search exactly as the reference does.
    Returns bool of ``queries``' shape.
    """
    lo = starts
    hi = starts + lengths  # exclusive; lower-bound search
    last = sorted_arr.shape[0] - 1
    for _ in range(num_steps):
        cont = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        val = sorted_arr[mid.clamp(0, last)]
        less = (val < queries) & cont
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(cont & ~less, mid, hi)
    return (lo < starts + lengths) & (
        sorted_arr[lo.clamp(0, last)] == queries
    )


def max_degree(g: Graph) -> int:
    """Host-side max degree (static for kernel padding decisions)."""
    return int(g.deg.max().item()) if g.n_nodes else 0
