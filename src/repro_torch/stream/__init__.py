"""The stream route: incremental triangle maintenance under edge
mutation streams (counterpart of ``repro.stream``).

* :mod:`repro_torch.stream.state` — the mutable edge set
  (:class:`MutableGraph`, sorted keys on the device) with stream-ordered
  ``apply`` and structured per-update statuses.
* :mod:`repro_torch.stream.delta` — the exactly-once batch delta rule:
  three level-free ``run_plan`` probes per phase (K3 on the card).
* :mod:`repro_torch.stream.session` — the session handle
  (``TriangleEngine.stream()``): live exact totals and per-vertex
  credit, the lazily refreshed cover-edge state, and the reservoir-backed
  approximate lane.
"""
from repro_torch.stream.delta import DeltaCounts, batch_delta, probe_sum
from repro_torch.stream.session import (
    StreamSession,
    StreamStats,
    StreamUpdate,
)
from repro_torch.stream.state import (
    EDGE_STATUSES,
    MutableGraph,
    MutationResult,
    normalize_stream,
)

__all__ = [
    "EDGE_STATUSES",
    "DeltaCounts",
    "MutableGraph",
    "MutationResult",
    "StreamSession",
    "StreamStats",
    "StreamUpdate",
    "batch_delta",
    "normalize_stream",
    "probe_sum",
]
