"""The intersection work that an exact count needs, counted from the
graph and its horizontal edges and not from any kernel's launch shapes,
and the card's published peaks that turn it into a least time.

Work of one count (Algorithm 1's intersections, whichever kernel or path
runs them):

* queries: the horizontal edges ``(u, w)``, ``L(u) == L(w)`` under the
  reference's BFS levels, each undirected edge once;
* operations: one membership test per entry of the shorter of the two
  lists, ``sum min(deg u, deg w)``, one int32 operation each;
* bytes, each input read once: the adjacency list of every vertex that
  ends a horizontal edge (4 B an entry), the two endpoints of each query
  (8 B), and the level of every vertex those lists name (4 B each).

The least time is the larger of operations over the int32 rate and
bytes over HBM's rate; ``bound_by`` says which.
"""
from __future__ import annotations

import subprocess

import torch

from portbench.reference import degrees

#: NVIDIA H100 SXM, dense, at its 700 W limit: HBM3 bandwidth from
#: NVIDIA's data sheet; the int32 rate from the Hopper architecture white
#: paper (64 INT32 lanes an SM x 132 SMs x the 1.98 GHz boost clock), as
#: the data sheet gives none
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def intersection_work(lo: torch.Tensor, hi: torch.Tensor, n: int,
                      level: torch.Tensor) -> dict:
    """``{"horizontal", "ops", "bytes"}`` of one count of the graph with
    undirected edges ``(lo, hi)`` (``reference.simple_graph``) and BFS
    levels ``level`` (``reference.bfs_levels``)."""
    deg = degrees(lo, hi, n)
    h = level[lo] == level[hi]
    qu, qw = lo[h], hi[h]
    horizontal = int(qu.shape[0])
    ops = int(torch.minimum(deg[qu], deg[qw]).sum().item())
    ends = torch.zeros(n, dtype=torch.bool, device=lo.device)
    ends[qu] = True
    ends[qw] = True
    adj_entries = int(deg[ends].sum().item())
    named = ends.clone()
    named[hi[ends[lo]]] = True
    named[lo[ends[hi]]] = True
    nbytes = 4 * adj_entries + 8 * horizontal + 4 * int(named.sum().item())
    return {"horizontal": horizontal, "ops": ops, "bytes": nbytes}


def least_seconds(work: dict) -> tuple[float, str]:
    """``(seconds, bound_by)``: the least time the card could take for
    ``work`` and whether ``"operations"`` or ``"bytes"`` set it."""
    t_ops = work["ops"] / INT32_OPS_PER_S
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable: {err}"
