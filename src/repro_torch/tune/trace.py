"""Workload traces: record what a serving process saw, replay it bit for
bit, and reduce it to a workload-shape signature (counterpart of
``repro.tune.trace``).

A trace is a JSONL file of :class:`TraceRecord` lines, one a request:

* its **shape signature** — the budget cell under the grid the recorder
  served with, its quantized per-request
  :class:`~repro_torch.graph.csr.BatchDegreeMeta`
  (:func:`~repro_torch.graph.csr.degree_meta`: grid-independent, and the
  union over requests bounds any packed batch's meta), its route and its
  relative deadline;
* its **replayable payload** — the undirected edge list as submitted, so
  the sweep re-serves the same workload under candidate configs and
  checks the answers bit for bit.

The lines are the reference's: a trace that either package writes, the
other reads record for record.  A recorder with no path keeps its
records in memory only (a real-size trace, ~10^6 edge rows a request, is
too large to write as JSON).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import IO, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.graph.csr import BatchDegreeMeta, ShapeBudget, degree_meta

TRACE_VERSION = 1


def _meta_to_json(meta: BatchDegreeMeta) -> dict:
    return {
        "d_pad": meta.d_pad,
        "h_rows": meta.h_rows,
        "exceed": [[int(w), int(c)] for w, c in meta.exceed],
    }


def _meta_from_json(d: dict) -> BatchDegreeMeta:
    return BatchDegreeMeta(
        d_pad=int(d["d_pad"]),
        h_rows=int(d["h_rows"]),
        exceed=tuple((int(w), int(c)) for w, c in d["exceed"]),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class TraceRecord:
    """One served request: shape signature and replayable edge payload."""

    request_id: int
    n_nodes: int
    n_edges: int  # undirected rows as submitted (before dedup)
    route: str  # "batch" | "distributed"
    budget: Optional[ShapeBudget]  # None on the distributed route
    meta: Optional[BatchDegreeMeta]
    deadline_s: Optional[float]
    edges: Optional[np.ndarray] = None  # int64[n_edges, 2]; None: no payload

    def request(self) -> Tuple[np.ndarray, int]:
        """The ``(edges, n_nodes)`` pair to resubmit on replay."""
        if self.edges is None:
            raise ValueError(
                f"trace record {self.request_id} carries no edge payload; "
                "signature-only traces cannot be replayed"
            )
        return self.edges, self.n_nodes

    def to_json(self) -> dict:
        return {
            "v": TRACE_VERSION,
            "id": int(self.request_id),
            "n_nodes": int(self.n_nodes),
            "n_edges": int(self.n_edges),
            "route": self.route,
            "budget": (
                [self.budget.n_budget, self.budget.slot_budget]
                if self.budget is not None else None
            ),
            "meta": _meta_to_json(self.meta) if self.meta is not None else None,
            "deadline_s": self.deadline_s,
            "edges": self.edges.tolist() if self.edges is not None else None,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TraceRecord":
        v = int(d.get("v", 0))
        if v > TRACE_VERSION:
            raise ValueError(f"trace record version {v} > supported "
                             f"{TRACE_VERSION}")
        edges = d.get("edges")
        if edges is not None:
            edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        budget = d.get("budget")
        meta = d.get("meta")
        deadline = d.get("deadline_s")
        return cls(
            request_id=int(d["id"]),
            n_nodes=int(d["n_nodes"]),
            n_edges=int(d["n_edges"]),
            route=str(d["route"]),
            budget=ShapeBudget(int(budget[0]), int(budget[1])) if budget else None,
            meta=_meta_from_json(meta) if meta else None,
            deadline_s=float(deadline) if deadline is not None else None,
            edges=edges,
        )


class TraceRecorder:
    """Collects :class:`TraceRecord`\\ s and, with a ``path``, appends
    each as a flushed JSONL line as it arrives.  Pass one to
    ``engine.serve(recorder=...)``."""

    def __init__(self, path: Optional[str] = None):
        self.path = os.fspath(path) if path is not None else None
        self.records: List[TraceRecord] = []
        self._fh: Optional[IO[str]] = None
        if self.path is not None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")

    def record(self, *, request_id: int, edges, n_nodes: int, route: str,
               budget: Optional[ShapeBudget] = None,
               deadline_s: Optional[float] = None) -> TraceRecord:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        rec = TraceRecord(
            request_id=int(request_id),
            n_nodes=int(n_nodes),
            n_edges=int(edges.shape[0]),
            route=route,
            budget=budget,
            meta=degree_meta(edges, n_nodes),
            deadline_s=deadline_s,
            edges=edges,
        )
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec.to_json()) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TraceRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self.records)


def write_trace(records: Iterable[TraceRecord], path: str) -> str:
    d = os.path.dirname(os.fspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec.to_json()) + "\n")
    return os.fspath(path)


def read_trace(path: str) -> List[TraceRecord]:
    out: List[TraceRecord] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(TraceRecord.from_json(json.loads(line)))
    return out


def trace_signature(records: Sequence[TraceRecord]) -> str:
    """Canonical workload-shape key: each cell's share of the requests,
    rounded to one decimal so re-recordings of one mix give one string
    (``"v1|64x256:0.4|128x1024:0.6"``; the distributed route is the
    ``dist`` pseudo-cell; a cell rounding to 0.0 is kept)."""
    if not records:
        return f"v{TRACE_VERSION}|empty"
    counts: dict = {}
    for rec in records:
        label = (f"{rec.budget.n_budget}x{rec.budget.slot_budget}"
                 if rec.budget is not None else "dist")
        counts[label] = counts.get(label, 0) + 1
    total = sum(counts.values())
    parts = [f"{label}:{round(counts[label] / total, 1)}"
             for label in sorted(counts)]
    return "|".join([f"v{TRACE_VERSION}"] + parts)


def record_serve_trace(num: int = 160, *, seed: int = 0, smoke: bool = False,
                       batch_size: int = 8, heavy_every: int = 0,
                       path: Optional[str] = None, engine=None,
                       device: Union[str, torch.device] = "cuda",
                       ) -> List[TraceRecord]:
    """Serve the reference's benchmark mix through an engine (a default
    one on ``device`` when none is given) with a recorder attached, and
    return the trace (also written to ``path`` when given).

    ``heavy_every=k`` (k > 0) replaces every k-th request with
    ``rmat(scale, 8)``, scale 8–9, drawn from ``default_rng(seed +
    0x7EA7)`` in the reference's order, so both packages record the same
    requests."""
    from repro_torch.api import TriangleEngine
    from repro_torch.graph import generators as gen
    from repro_torch.launch.serve_tc import synth_requests

    if engine is None:
        engine = TriangleEngine(device=device)
    reqs = synth_requests(num, seed=seed, smoke=smoke)
    if heavy_every > 0:
        hrng = np.random.default_rng(seed + 0x7EA7)
        for i in range(heavy_every - 1, len(reqs), heavy_every):
            scale = int(hrng.integers(8, 10))
            reqs[i] = gen.rmat(scale, 8, seed=int(hrng.integers(1 << 30)))
    with TraceRecorder(path) as recorder:
        server = engine.serve(batch_size=batch_size, recorder=recorder)
        for edges, n in reqs:
            server.submit(edges, n, deadline_s=1e9)
        server.drain()
        if len(recorder.records) != len(reqs):
            warnings.warn(f"trace captured {len(recorder.records)} of "
                          f"{len(reqs)} requests")
        return list(recorder.records)
