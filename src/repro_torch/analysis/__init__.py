"""The port's static auditor (counterpart of ``repro.analysis``).

Five passes over the engine's routes — compile-set enumeration
(``compile_set``), int32 index bounds at host and launch sites
(``bounds``), host-sync detection (``hostsync``), collective
completeness (``collectives``) — plus the unused-public-symbol sweep
(``deadcode``).  ``python -m repro_torch.analysis.audit`` runs them all
on the CPU and diffs the findings against
``results/AUDIT_torch_baseline.json``.  A report written by either
package loads in the other.

This package ``__init__`` stays import-light on purpose: it pulls in
only the findings model and the index-dtype policy, because
``graph.csr`` imports :func:`torch_index_dtype` at module load.
"""
from repro_torch.analysis.dtypes import (  # noqa: F401
    INT32_MAX,
    IndexWidthError,
    index_dtype,
    torch_index_dtype,
)
from repro_torch.analysis.findings import (  # noqa: F401
    REPORT_VERSION,
    BaselineDiff,
    Finding,
    Report,
    diff_reports,
    merge_findings,
)

__all__ = [
    "BaselineDiff",
    "Finding",
    "INT32_MAX",
    "IndexWidthError",
    "REPORT_VERSION",
    "Report",
    "diff_reports",
    "index_dtype",
    "merge_findings",
    "torch_index_dtype",
]
