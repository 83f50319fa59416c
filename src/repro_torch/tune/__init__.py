"""repro_torch.tune — trace-driven autotuning of the triangle-counting
plan space (counterpart of ``repro.tune``).

Three layers, each usable alone:

* :mod:`repro_torch.tune.trace` — record a serving workload (each
  request's budget cell, quantized ``BatchDegreeMeta``, route and
  replayable edge payload) to JSONL, read it back, and reduce it to a
  workload-shape signature.
* :mod:`repro_torch.tune.profile` — versioned :class:`TunedProfile`
  files: the sweep's winning ``TCOptions``, ``BudgetGrid`` and per-cell
  meta ceilings, kept under ``results/tuned_torch``.
  ``TriangleEngine(profile=...)`` reads them; a corrupt or unknown file
  degrades to defaults with a warning.
* :mod:`repro_torch.tune.sweep` — replay a trace through the real
  serving path for every candidate config under successive-halving
  pruning, every answer checked bit for bit against the default's, and
  build the winner's profile.
"""
from repro_torch.tune.profile import (  # noqa: F401
    PROFILE_VERSION,
    CellProfile,
    TunedProfile,
    load_profile,
    profile_from_reference,
)
from repro_torch.tune.sweep import (  # noqa: F401
    SweepConfig,
    build_profile,
    default_space,
    evaluate_config,
    prewarm_replay,
    successive_halving,
)
from repro_torch.tune.trace import (  # noqa: F401
    TRACE_VERSION,
    TraceRecord,
    TraceRecorder,
    read_trace,
    record_serve_trace,
    trace_signature,
    write_trace,
)

__all__ = [
    "PROFILE_VERSION",
    "TRACE_VERSION",
    "CellProfile",
    "SweepConfig",
    "TraceRecord",
    "TraceRecorder",
    "TunedProfile",
    "build_profile",
    "default_space",
    "evaluate_config",
    "load_profile",
    "prewarm_replay",
    "profile_from_reference",
    "read_trace",
    "record_serve_trace",
    "successive_halving",
    "trace_signature",
    "write_trace",
]
