"""Measured communication of Algorithm 2 (counterpart of
``repro.core.comm_instrument``, the parts with a torch meaning).

``core.comm_model`` *models* what the distributed run should move; this
module holds three views that must agree, per phase of
``comm_model.WIRE_PHASES``:

  1. **analytic tally** — :class:`CommTally`: per-phase wire bytes from
     the static capacities plus the one dynamic quantity, the BFS sweep
     count (``tally_comm``), carried by every ``ParallelTCResult``;
  2. **measured** — the shard group's own call record of the run
     (``core/shards.py``: every collective's kind, per-shard payload
     bytes, whether it ran in the BFS loop), each call priced by the
     ``comm_model.*_wire_bytes`` conventions with the reference's
     attribution rules (``_price_site``);
  3. **modeled** — ``comm_model.wire_bytes_report``.

Phase attribution is structural, as in the reference: all-to-alls are
the transpose; all-gathers before the first all-to-all are the splitter
gossip and after it the horizontal exchange; ppermutes are ring-mode
horizontal rounds; n-vector reductions are BFS level syncs (a pmax, or
any reduction inside the BFS loop); everything else that reduces — the
scalar psums/pmaxes and, with per-vertex credit, the n-vector credit
psum — is the final reduction.

Not ported, because it has no torch meaning: the jaxpr and StableHLO
walk (``collect_collective_sites``, ``hlo_collective_counts``,
``verify_against_hlo``, ``measure_tc_comm``).  The call record takes
its place (ROADMAP, beside item 14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.comm_model import (
    NUM_SCALAR_REDUCES,
    WIRE_PHASES,
    allgather_wire_bytes,
    allreduce_wire_bytes,
    alltoall_wire_bytes,
    ppermute_wire_bytes,
    wire_bytes_report,
)
from repro_torch.core.shards import CollectiveCall

__all__ = [
    "TALLY_SAT_BYTES",
    "CommTally",
    "choose_hedge_mode",
    "comm_report",
    "hedge_round_buffer_bytes",
    "measured_phase_bytes",
    "tally_comm",
]

#: Largest per-field value the tally stores: a phase beyond ~2 GiB of
#: wire saturates here, as the reference's int32 tally does; the
#: float-valued ``comm_model.wire_bytes_report`` is the accounting tool
#: at that scale.
TALLY_SAT_BYTES = 2**31 - 1


def _sat32(x) -> int:
    return min(int(x), TALLY_SAT_BYTES)


@dataclasses.dataclass(frozen=True)
class CommTally:
    """Per-phase wire bytes (summed over ALL shards) of one Algorithm 2
    run, each field saturated at :data:`TALLY_SAT_BYTES`.

    ``bfs_sweeps`` is the one data-dependent factor: the frontier
    exchanges the level-synchronous BFS ran (= max level + 1, reseeds
    included).  The BFS phase is stored as its parts (``bfs_fixed`` +
    ``bfs_per_sweep``, resolved with unbounded arithmetic in
    ``phase_bytes``); every other phase is a pure function of the static
    capacities."""

    bfs_fixed: int      # has-edge seeding pmax, once per run
    bfs_per_sweep: int  # frontier pmax, once per BFS sweep
    splitter: int
    transpose: int
    hedge: int
    reduce: int
    bfs_sweeps: int

    def phase_bytes(self) -> dict[str, int]:
        """``{phase: total_bytes}`` keyed by ``WIRE_PHASES``."""
        out = {"bfs": int(self.bfs_fixed)
               + int(self.bfs_per_sweep) * int(self.bfs_sweeps)}
        for ph in WIRE_PHASES[1:]:
            out[ph] = int(getattr(self, ph))
        return out

    @property
    def total(self) -> int:
        return sum(self.phase_bytes().values())


def tally_comm(*, n: int, p: int, cap_chunk: int, cap_hedge: int, mode: str,
               frontier_dtype: str, sweeps: int,
               per_vertex: bool = False) -> CommTally:
    """Analytic :class:`CommTally` of one run; ``sweeps`` is the run's
    BFS sweep count, every other argument static.  Formulas mirror
    ``comm_model.wire_bytes_report`` term by term; ``per_vertex`` adds
    the n-vector credit psum to the reduce phase."""
    word = 4
    fsize = np.dtype(frontier_dtype).itemsize
    if mode == "allgather":
        hedge = 2 * int(allgather_wire_bytes(cap_hedge * word, p))
    elif mode == "ring":
        # p-1 rounds x p-cycle cross pairs — equals the allgather volume
        cross = p if p > 1 else 0
        hedge = 2 * (p - 1) * int(ppermute_wire_bytes(cap_hedge * word,
                                                      cross))
    else:
        raise ValueError(mode)
    return CommTally(
        bfs_fixed=_sat32(allreduce_wire_bytes(n * word, p)),
        bfs_per_sweep=_sat32(allreduce_wire_bytes(n * fsize, p)),
        splitter=_sat32(allgather_wire_bytes(p * word, p)),
        transpose=_sat32(2 * alltoall_wire_bytes(p * cap_chunk * word, p)),
        hedge=_sat32(hedge),
        reduce=_sat32(
            NUM_SCALAR_REDUCES * allreduce_wire_bytes(word, p)
            + (allreduce_wire_bytes(n * word, p) if per_vertex else 0)
        ),
        bfs_sweeps=int(sweeps),
    )


def _price_call(call: CollectiveCall, *, n: int, p: int,
                before_transpose: bool) -> tuple[str, int]:
    """``(phase, wire bytes)`` of one recorded call, by the reference's
    ``_price_site`` rules."""
    nbytes = call.nbytes
    if call.kind == "all_to_all":
        return "transpose", int(alltoall_wire_bytes(nbytes, p))
    if call.kind == "all_gather":
        return ("splitter" if before_transpose else "hedge",
                int(allgather_wire_bytes(nbytes, p)))
    if call.kind == "ppermute":
        return "hedge", int(ppermute_wire_bytes(nbytes, call.cross))
    if call.kind in ("psum", "pmax"):
        vol = int(allreduce_wire_bytes(nbytes, p))
        # an n-vector pmax (or any reduction in the BFS loop) is a level
        # sync; an n-vector psum outside the loop is the credit reduce
        if math.prod(call.shape) >= n and (call.in_bfs
                                           or call.kind != "psum"):
            return "bfs", vol
        return "reduce", vol
    raise ValueError(call.kind)


def measured_phase_bytes(calls: Sequence[CollectiveCall], *, n: int,
                         p: int) -> dict[str, int]:
    """Fold a run's call record into per-phase wire bytes."""
    out = {ph: 0 for ph in WIRE_PHASES}
    seen_a2a = False
    for call in calls:
        phase, vol = _price_call(call, n=n, p=p,
                                 before_transpose=not seen_a2a)
        out[phase] += vol
        if call.kind == "all_to_all":
            seen_a2a = True
    return out


def comm_report(n: int, m2: int, p: int, *, sweeps: int,
                calls: Sequence[CollectiveCall], mode: str = "allgather",
                frontier_dtype: str = "int32", slack: float = 4.0,
                n_levels_model: int | None = None,
                per_vertex: bool = False) -> dict:
    """Per-phase ``{measured, tally, modeled}`` wire bytes of one run:
    ``calls`` is its shard group's record (``ParallelTCResult.
    collectives``), ``sweeps`` its BFS sweep count (``comm.bfs_sweeps``).
    ``n_levels_model`` feeds the closed-form model (``None`` = ``sweeps``,
    so modeled == measured exactly)."""
    from repro_torch.core.parallel_tc import _capacities

    _, cap_chunk, cap_hedge = _capacities(m2, p, slack)
    measured = measured_phase_bytes(calls, n=n, p=p)
    tally = tally_comm(
        n=n, p=p, cap_chunk=cap_chunk, cap_hedge=cap_hedge, mode=mode,
        frontier_dtype=frontier_dtype, sweeps=int(sweeps),
        per_vertex=per_vertex,
    ).phase_bytes()
    modeled = wire_bytes_report(
        n, p, cap_chunk=cap_chunk, cap_hedge=cap_hedge,
        n_levels=int(n_levels_model if n_levels_model is not None
                     else sweeps),
        mode=mode, frontier_dtype=frontier_dtype, per_vertex=per_vertex,
    )
    return {
        "n": n, "m2": m2, "p": p, "mode": mode, "sweeps": int(sweeps),
        "phases": {
            ph: {"measured": measured[ph], "tally": tally[ph],
                 "modeled": modeled[ph]}
            for ph in WIRE_PHASES
        },
        "measured_total": sum(measured.values()),
        "tally_total": sum(tally.values()),
        "modeled_total": sum(modeled.values()),
        # per-shard peak buffer of the horizontal exchange — the router
        # signal: the gathered block is p x the per-round ring buffer
        "hedge_round_buffer_bytes": hedge_round_buffer_bytes(m2, p, mode,
                                                             slack=slack),
    }


def hedge_round_buffer_bytes(m2: int, p: int, mode: str, *,
                             slack: float = 4.0) -> int:
    """Per-shard bytes the horizontal exchange materializes at once:
    allgather holds the full gathered ``(hv, hw)`` block, ring only one
    shard's — same total wire volume, a p x smaller live buffer."""
    from repro_torch.core.parallel_tc import _capacities

    cap_hedge = _capacities(m2, p, slack)[2]
    rows = p * cap_hedge if mode == "allgather" else cap_hedge
    return 2 * rows * 4


def choose_hedge_mode(m2: int, p: int, *,
                      gather_buffer_limit_bytes: int = 64 << 20,
                      slack: float = 4.0) -> str:
    """The router's policy for the distributed route: both exchange
    modes move the same hedge volume, so pick by the live buffer —
    ``allgather`` (one collective, fewer rounds) until its gathered
    block exceeds ``gather_buffer_limit_bytes`` per shard, ``ring`` (a
    p x smaller per-round buffer, p - 1 rounds) beyond."""
    gathered = hedge_round_buffer_bytes(m2, p, "allgather", slack=slack)
    return "allgather" if gathered <= gather_buffer_limit_bytes else "ring"
