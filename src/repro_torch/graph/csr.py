"""CSR graph container of the port (counterpart of ``repro.graph.csr``).

A graph is stored as

  * a symmetrized directed edge list ``(src, dst)`` sorted by ``(src, dst)``
    — i.e. CSR order — optionally padded with the sentinel vertex ``n``,
  * CSR ``row_offsets`` / ``deg`` derived from it,

all as int32 tensors on one device.  Construction moves the raw edge
array to the device once and packs it there, with the same set semantics
as the reference's host-numpy packing and the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.dtypes import torch_index_dtype
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Symmetrized graph in CSR-ordered edge-list form.

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
        return self.src.shape[0]

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
    if edges.shape[0] == 0:
        return z, z
    lo = torch.minimum(edges[:, 0], edges[:, 1])
    hi = torch.maximum(edges[:, 0], edges[:, 1])
    und = torch.unique(lo * n_nodes + hi, sorted=True)
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
        e = edges.to(dev, torch.int64)
    else:
        e = torch.as_tensor(np.asarray(edges, dtype=np.int64)).to(dev)
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
