"""int32 index-overflow audit at Graph500 scales (counterpart of
``repro.analysis.bounds``).

The paper's headline scales put 2³¹⁺ directed edge slots on a host long
before anything runs out of memory, and every device index of the port
is int32.  Two halves, each evaluated at synthetic Graph500 scales
(scale ``s`` is ``n = 2^s`` vertices at edge factor 16, ``2m = 32·n``
directed slots — scale 26 is the first whose slot count, 2³¹, no longer
fits an int32 index, scale 36 the first whose vertex ids do not):

* **Host sites** (:data:`HOST_SITES`): every ``torch_index_dtype`` call
  of ``graph/csr.py``, evaluated at its bound.  A scale whose bound
  needs int64 is reported as ``host:{site}@scale{s}`` — the build then
  fails loudly (``IndexWidthError``) instead of wrapping — and a call
  the table does not cover is an error.  The lane-view sites of a
  ``GraphBatch`` multiply by the lane count
  (:data:`LAUNCH_BATCH`), so they cross int32 at a smaller scale than a
  single graph's (``data["first_scale"]``).
* **Launch sites** (in place of the reference's interval walk over the
  fused jaxpr): every integer that reaches K1–K3 is an int32 tensor or
  a Python int passed as ``ctypes.c_int``
  (``kernels/intersect/intersect.py:_ARGTYPES``).  ctypes does not
  refuse a value past its range: ``ctypes.c_int(2**40).value`` is 0.
  :data:`LAUNCH_ARGS` bounds the value at every ``c_int`` position and
  names the wrapper check that refuses it, and :data:`INT32_OPERANDS`
  bounds the int32 tensors the kernels index; each bound comes from the
  bounded plan of ``synthetic_meta(n, slots, d_pad=1024)`` at the
  scale, over a lane view of :data:`LAUNCH_BATCH` lanes (the serving
  path's widest launch).  Each bound past 2³¹ − 1 is reported as
  ``launch:{kernel}:{arg}@scale{s}``: a warning where a wrapper check
  refuses it, an error where nothing does.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Callable

from repro_torch.analysis.dtypes import (
    INT32_MAX,
    IndexWidthError,
    torch_index_dtype,
)
from repro_torch.analysis.findings import Finding, finding_data
from repro_torch.analysis.routes import bounded_plan, synthetic_meta
from repro_torch.core.bfs import UNVISITED

#: Graph500 edgefactor: m = 16·n undirected edges, 2m directed slots.
EDGEFACTOR = 16

#: Default synthetic scales: last-clean / first-slot-overflow /
#: first-vertex-id-overflow.
DEFAULT_SCALES = (20, 26, 36)

#: lanes of the serving path's lane view that the lane-view and launch
#: bounds assume (a server's default ``batch_size``)
LAUNCH_BATCH = 8


def scale_shape(scale: int) -> tuple[int, int]:
    """``(n_vertices, directed_slots)`` of a Graph500-scale graph."""
    n = 1 << int(scale)
    return n, 2 * EDGEFACTOR * n


@dataclasses.dataclass(frozen=True)
class HostSite:
    """One ``torch_index_dtype`` call of ``graph/csr.py``: ``name`` is the
    finding's site, ``policy_site`` the call's ``site=`` string and
    ``bound(n, slots, lanes)`` the largest index it admits."""

    name: str
    policy_site: str
    bound: Callable[[int, int, int], int]


HOST_SITES = (
    HostSite("graph_from_numpy:ids-and-offsets", "csr.graph_from_numpy",
             lambda n, s, b: max(n, s)),
    HostSite("from_edges:vertex-ids", "csr.from_edges vertex ids",
             lambda n, s, b: n),
    HostSite("from_edges:row_offsets", "csr.from_edges row_offsets",
             lambda n, s, b: s),
    HostSite(f"GraphBatch[b{LAUNCH_BATCH}]:lane-vertex-ids",
             "csr.GraphBatch lane-view vertex ids",
             lambda n, s, b: b * (n + 1)),
    HostSite(f"GraphBatch[b{LAUNCH_BATCH}]:lane-slots",
             "csr.GraphBatch lane-view slots", lambda n, s, b: b * s),
    HostSite("from_edges_batch:vertex-ids",
             "csr.from_edges_batch vertex ids", lambda n, s, b: n),
    HostSite("from_edges_batch:row_offsets",
             "csr.from_edges_batch row_offsets", lambda n, s, b: s),
)


def policy_sites(path: Path | None = None) -> list[str]:
    """The ``site=`` strings of every ``torch_index_dtype`` call in a
    module (default ``graph/csr.py``), in source order — what
    :data:`HOST_SITES` must cover."""
    if path is None:
        from repro_torch.graph import csr

        path = Path(csr.__file__)
    out = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "torch_index_dtype"):
            for kw in node.keywords:
                if kw.arg == "site" and isinstance(kw.value, ast.Constant):
                    out.append(kw.value.value)
    return out


def _first_scale(bound) -> int | None:
    for s in range(1, 64):
        n, slots = scale_shape(s)
        if bound(n, slots, LAUNCH_BATCH) > INT32_MAX:
            return s
    return None


def audit_host_sites(scale: int) -> list[Finding]:
    """The host-side construction sites of ``graph/csr.py``, evaluated by
    the index-dtype policy itself at one scale: a bound the policy
    refuses is a warning finding (the pinned worklist; the build fails
    loudly with ``IndexWidthError`` instead of wrapping)."""
    n, slots = scale_shape(scale)
    out = []
    for site in HOST_SITES:
        bound = site.bound(n, slots, LAUNCH_BATCH)
        try:
            torch_index_dtype(bound, site=site.policy_site)
        except IndexWidthError:
            out.append(Finding(
                pass_name="bounds",
                site=f"host:{site.name}@scale{scale}",
                severity="warning",
                detail=(
                    f"{site.policy_site}: bound {bound} needs int64 at "
                    f"Graph500 scale {scale}; device index tensors are "
                    f"int32, so the build raises IndexWidthError (per "
                    f"policy) instead of wrapping"
                ),
                data=finding_data(bound=bound, dtype="int64", scale=scale,
                                  first_scale=_first_scale(site.bound)),
            ))
    return out


@dataclasses.dataclass(frozen=True)
class LaunchContext:
    """The largest values a launch of K1–K3 takes at one scale: the
    bounded plan of ``synthetic_meta(n, slots, d_pad=1024)`` run over a
    lane view of ``lanes`` lanes."""

    scale: int
    n: int
    slots: int
    lanes: int
    q: int          # rows of one launch (a bucket slice, all lanes)
    d_cand: int
    d_targ: int
    lane_cells: int  # Σ rows · min(d_cand, d_targ) over a lane's buckets

    @classmethod
    def at(cls, scale: int, lanes: int = LAUNCH_BATCH) -> "LaunchContext":
        n, slots = scale_shape(scale)
        plan = bounded_plan(synthetic_meta(n, slots, d_pad=1024))
        rows = max(min(b.rows, plan.query_chunk or b.rows)
                   for b in plan.buckets)
        return cls(
            scale=scale, n=n, slots=slots, lanes=lanes, q=lanes * rows,
            d_cand=max(b.d_cand for b in plan.buckets),
            d_targ=max(b.d_targ for b in plan.buckets),
            lane_cells=sum(b.rows * min(b.d_cand, b.d_targ)
                           for b in plan.buckets),
        )

    @property
    def ids(self) -> int:
        """Largest vertex id of the lane view (its sentinel)."""
        return self.lanes * (self.n + 1)

    @property
    def offsets(self) -> int:
        """Largest offset into the lane view's flat neighbour array."""
        return self.lanes * self.slots


_ROWS_GUARD = "intersect._check (operand rows < 2**31 on the card)"
_WIDTH_GUARD = "intersect.item_layout (d_cand, d_targ < 2**31)"

#: per kernel, per ``c_int`` position of ``_ARGTYPES``: ``(argument, its
#: bound at a launch context, the wrapper check that refuses a value past
#: int32 or None)``
LAUNCH_ARGS = {
    "intersect_levels": {
        6: ("n_level", lambda c: c.ids, _ROWS_GUARD),
        12: ("q", lambda c: c.q, _ROWS_GUARD),
        13: ("d_cand", lambda c: c.d_cand, _WIDTH_GUARD),
        14: ("d_targ", lambda c: c.d_targ, _WIDTH_GUARD),
    },
    "intersect_hits": {
        10: ("q", lambda c: c.q, _ROWS_GUARD),
        11: ("d_cand", lambda c: c.d_cand, _WIDTH_GUARD),
        12: ("d_targ", lambda c: c.d_targ, _WIDTH_GUARD),
    },
    "intersect_count": {
        10: ("q", lambda c: c.q, _ROWS_GUARD),
        11: ("d_cand", lambda c: c.d_cand, _WIDTH_GUARD),
        12: ("d_targ", lambda c: c.d_targ, _WIDTH_GUARD),
    },
}

_COMMON = {
    "flat": lambda c: c.ids,          # neighbour ids
    "s_s": lambda c: c.offsets,       # slice starts into flat
    "s_l": lambda c: c.offsets,
    "l_s": lambda c: c.n,             # slice lengths (degrees)
    "l_l": lambda c: c.n,
    "perm": lambda c: c.q + 1,        # the layout's row order
    "item_start": lambda c: c.q + 1,
    "n_items": lambda c: c.q + 1,
}

#: per kernel, the int32 tensors it indexes or writes, each with its
#: bound at a launch context (``c1``, ``c2`` and ``cnt`` summed over a
#: lane's rows, as ``run_plan`` sums them in int32)
INT32_OPERANDS = {
    "intersect_levels": {
        **_COMMON,
        "level": lambda c: max(c.n, UNVISITED),
        "lev_u": lambda c: max(c.n, UNVISITED),
        "c1": lambda c: c.lane_cells,
        "c2": lambda c: c.lane_cells,
    },
    "intersect_hits": dict(_COMMON),
    "intersect_count": {**_COMMON, "cnt": lambda c: c.lane_cells},
}


def launch_table(scale: int) -> list[dict]:
    """Every bounded launch value of K1–K3 at one scale: ``{kernel,
    arg, position (None for a tensor), bound, guard}``."""
    ctx = LaunchContext.at(scale)
    rows = []
    for kernel, args in LAUNCH_ARGS.items():
        for pos, (arg, bound, guard) in sorted(args.items()):
            rows.append(dict(kernel=kernel, arg=arg, position=pos,
                             bound=int(bound(ctx)), guard=guard))
        for arg, bound in INT32_OPERANDS[kernel].items():
            rows.append(dict(kernel=kernel, arg=arg, position=None,
                             bound=int(bound(ctx)), guard=None))
    return rows


def audit_launch_sites(scale: int) -> list[Finding]:
    """One finding per launch value of K1–K3 past int32 at one scale: a
    ``c_int`` argument past it is an error unless a wrapper check
    refuses it (ctypes would truncate it without a word); an int32
    operand past it is a warning (the host sites refuse the graph
    first)."""
    out = []
    for row in launch_table(scale):
        if row["bound"] <= INT32_MAX:
            continue
        is_arg = row["position"] is not None
        how = ("a ctypes.c_int argument" if is_arg
               else "an int32 tensor operand")
        guard = (f"refused first by {row['guard']}" if row["guard"]
                 else ("NOTHING refuses it: ctypes truncates it" if is_arg
                       else "the host sites refuse the graph first"))
        out.append(Finding(
            pass_name="bounds",
            site=f"launch:{row['kernel']}:{row['arg']}@scale{scale}",
            severity="error" if is_arg and not row["guard"] else "warning",
            detail=(
                f"{row['kernel']} {row['arg']} ({how}) reaches "
                f"{row['bound']} at Graph500 scale {scale} over "
                f"{LAUNCH_BATCH} lanes, past int32; {guard}"
            ),
            data=finding_data(scale=scale, lanes=LAUNCH_BATCH, **row),
        ))
    return out


def audit_site_coverage(path: Path | None = None) -> list[Finding]:
    """An error for every ``torch_index_dtype`` call of ``graph/csr.py``
    (or ``path``) that :data:`HOST_SITES` gives no bound: a new index
    site must be bounded before it is audited."""
    covered = {s.policy_site for s in HOST_SITES}
    return [
        Finding(
            pass_name="bounds",
            site=f"host:unbounded-site:{site}",
            severity="error",
            detail=(
                f"torch_index_dtype(site={site!r}) has no entry in "
                f"analysis.bounds.HOST_SITES: its bound is not audited"
            ),
            data=finding_data(policy_site=site),
        )
        for site in policy_sites(path) if site not in covered
    ]


def audit_bounds(scales: tuple[int, ...] = DEFAULT_SCALES) -> list[Finding]:
    """The full pass: the host sites' coverage, then host policy sites
    and launch sites at every scale."""
    findings: list[Finding] = audit_site_coverage()
    for s in scales:
        findings.extend(audit_host_sites(s))
        findings.extend(audit_launch_sites(s))
    return findings
