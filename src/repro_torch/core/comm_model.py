"""Closed-form communication accounting of Algorithm 2 (paper §V-A/§V-B,
Table I): the port's own copy of ``repro.core.comm_model``, pure Python,
every formula and constant unchanged.

Two deliberately separate views are kept:

  * **paper-bits** (``cover_edge_comm`` / ``wedge_comm_bits``) — the
    paper's information-theoretic accounting: every exchanged quantity is
    charged its minimal packed width, ⌈log₂ D⌉ bits per BFS level and
    ⌈log₂ n⌉ bits per vertex id.  This is the currency of the paper's
    Table I and of the 21×/176× headline reductions.

  * **wire-bytes** (``wire_bytes_report``) — what the port's collectives
    move: whole int32 words (no bit packing) at the *static* capacities
    ``core.parallel_tc`` allocates (padded chunks, not exact counts).
    It is strictly larger than paper-bits — by the 32/⌈log n⌉ packing
    ratio and the capacity slack — but scales identically.

    This view is keyed by the phase names in ``WIRE_PHASES`` and shares
    its per-collective transmit-bytes convention (the ``*_wire_bytes``
    helpers below) with the *measured* side (``core.comm_instrument``,
    which prices the shard group's call record), so model and
    measurement compare term by term: modeled == measured whenever the
    model's capacities and level count match the run's.

Scale-36 (p=128) gives 408 TB, 21.04x; scale-42 (p=256) 57.1 PB, 176.5x
(``TABLE_I``); PB/EB are binary (2^50/2^60) per the paper's footnote.
"""
from __future__ import annotations

import dataclasses
import math


def _clog2(x: float) -> int:
    return max(1, math.ceil(math.log2(max(x, 2))))


@dataclasses.dataclass(frozen=True)
class CommBreakdown:
    """Per-phase bit volumes of Algorithm 2 (paper §V-A), one field per
    algorithm phase in execution order — see ``cover_edge_comm`` for the
    closed forms and ``parallel_tc._tc_shard`` for the collective each
    phase maps onto."""

    bfs_bits: float        # line 2: level exchanges of the parallel BFS
    splitter_bits: float   # lines 6-20: regular-sampling splitter gossip
    transpose_bits: float  # lines 21-28: the (2-k)m N-hat all-to-all
    hedge_bits: float      # lines 29-43: k·m horizontal edges × p rounds
    reduce_bits: float     # line 44: the final count reduction

    @property
    def total_bits(self) -> float:
        return (
            self.bfs_bits
            + self.splitter_bits
            + self.transpose_bits
            + self.hedge_bits
            + self.reduce_bits
        )

    @property
    def total_bytes(self) -> float:
        return self.total_bits / 8


def cover_edge_comm(
    n: float, m: float, k: float, p: int, *, log_d: int | None = None
) -> CommBreakdown:
    """Paper §V-A: total volume of Alg. 2 in bits, phase by phase.

    The closed forms, in the paper's own terms (log n = ⌈log₂ n⌉ bits per
    vertex id, log D per BFS level, m undirected edges, k the horizontal
    fraction):

    * BFS: each directed edge is touched once over the whole traversal
      and ships a (level, vertex, vertex, vertex) tuple — 2m(log D +
      3 log n).
    * splitters: regular sampling gossips p samples per device plus the
      broadcast back — (2p² − p) log n.
    * transpose: the modified neighborhoods N-hat hold (2−k)m directed
      entries (lines 3–5 dropped k·m of the 2m), each shipped once in
      the value-partitioned all-to-all — (2−k)·m·log n.
    * horizontal rounds: all k·m horizontal edges visit all p devices
      (pairwise swap or all-gather, same volume) — k·m·p·log n.  For
      k ≈ 0.65 and large p this term dominates, which is why the paper's
      reduction is ≈ wedges/(k·m·p) versus the wedge baseline.
    * reduction: one partial count per device — (p−1) log n.

    ``log_d=None`` uses the paper's Graph500 estimate ⌈log₂ D⌉ = 4
    (Beamer et al.: RMAT diameter ≈ 7 levels); per-graph values for the
    SNAP rows are unpublished, which is why those rows deviate ≤ ~5%
    while the RMAT-36/42 rows reproduce exactly (Table I's 408 TB /
    21.04× and 57.1 PB / 176.47×).
    """
    log_n = _clog2(n)
    if log_d is None:
        log_d = 4  # paper's Graph500 estimate (Beamer et al.: ~7 levels)
    return CommBreakdown(
        bfs_bits=2 * m * (log_d + 3 * log_n),
        splitter_bits=(2 * p * p - p) * log_n,
        transpose_bits=(2 - k) * m * log_n,
        hedge_bits=k * m * p * log_n,
        reduce_bits=(p - 1) * log_n,
    )


def wedge_comm_bits(wedges: float, n: float, *, bits_per_vertex: int | None = None
                    ) -> float:
    """Prior wedge-query algorithms (Table I's "previous" column): one
    (v1, v2) closing-edge query per wedge, 2⌈log₂ n⌉ bits each.  Wedge
    counts grow like Σ d(v)² — far faster than the k·m·p horizontal
    volume above on skewed graphs, which is the whole comparison."""
    b = bits_per_vertex if bits_per_vertex is not None else _clog2(n)
    return wedges * 2 * b


def speedup(n: float, m: float, k: float, p: int, wedges: float,
            *, log_d: int | None = None) -> float:
    return wedge_comm_bits(wedges, n) / cover_edge_comm(
        n, m, k, p, log_d=log_d
    ).total_bits


def fmt_bytes(b: float) -> str:
    """Binary units per the paper's footnote (PB = 2^50 B)."""
    for unit, exp in (("EB", 60), ("PB", 50), ("TB", 40), ("GB", 30),
                      ("MB", 20), ("KB", 10)):
        if b >= 2 ** exp:
            return f"{b / 2 ** exp:.3g}{unit}"
    return f"{b:.0f}B"


# ---- Table I as printed (for benchmark comparison) -----------------------
# The paper's own published columns, kept verbatim so benchmarks can
# compare the closed-form model against the printed numbers row by row.  The two RMAT rows are the paper's headline
# claims and our model reproduces them exactly; SNAP rows use the
# unpublished per-graph ⌈log D⌉, hence the ≤ ~5% deviation noted there.
# name: (n, m, triangles, wedges, k, p, previous, this_paper, speedup)
TABLE_I = {
    "ca-GrQc": (5242, 14484, 48260, 165798, 0.522, 4, "514KB", "225KB", 2.28),
    "ca-HepTh": (9877, 25973, 28339, 277389, 0.423, 4, "926KB", "420KB", 2.20),
    "as-caida20071105": (26475, 53381, 36365, 776895, 0.225, 4, "2.78MB", "866KB", 3.21),
    "facebook_combined": (4039, 88234, 1612010, 17051688, 0.914, 4, "48.8MB", "1.42MB", 34.38),
    "ca-CondMat": (23133, 93439, 173361, 1567373, 0.511, 4, "5.61MB", "1.66MB", 3.38),
    "ca-HepPh": (12008, 118489, 3358499, 5081984, 0.621, 4, "17.0MB", "2.04MB", 8.33),
    "email-Enron": (36692, 183831, 727044, 5933045, 0.478, 4, "22.6MB", "3.44MB", 6.58),
    "ca-AstroPh": (18772, 198050, 1351441, 8451765, 0.667, 4, "30.2MB", "3.68MB", 8.21),
    "loc-brightkite_edges": (58228, 214078, 494728, 6956250, 0.441, 4, "26.5MB", "3.96MB", 6.70),
    "soc-Epinions1": (75879, 405740, 1624481, 21377935, 0.498, 4, "86.7MB", "8.10MB", 10.70),
    "amazon0601": (403394, 2443408, 3986507, 96348699, 0.529, 8, "436MB", "66.5MB", 6.56),
    "com-Youtube": (1134890, 2987624, 3056386, 209811585, 0.347, 8, "1.03GB", "80.1MB", 13.11),
    "RMAT-36": (2 ** 36, 16 * 2 ** 36, 2.7e13, 1.05e15, 0.65, 128, "8.39PB", "408TB", 21.04),
    "RMAT-42": (2 ** 42, 16 * 2 ** 42, 8.64e14, 1.08e18, 0.65, 256, "9.84EB", "57.1PB", 176.47),
}


# ---- wire-bytes view: shared phase names + transfer conventions ----------

#: Phase names of Algorithm 2's communication, in execution order.  The
#: modeled report below, the analytic ``CommTally`` threaded through
#: ``parallel_tc._tc_shard`` and the measured per-collective extraction
#: in ``core.comm_instrument`` are all keyed by exactly these names.
WIRE_PHASES = ("bfs", "splitter", "transpose", "hedge", "reduce")

#: Scalar cross-device reductions the shard program performs per run
#: (``core.parallel_tc._tc_shard``: transpose-overflow pmax, hedge-overflow
#: pmax, width-overflow pmax, and the t_i / n_h / m psums).  Kept in
#: lockstep with the implementation — the comm-instrument tests assert
#: the shard group's call record holds exactly this many scalar
#: all-reduces.
NUM_SCALAR_REDUCES = 6



def allreduce_wire_bytes(payload_bytes: float, p: int) -> float:
    """Total wire bytes, summed over devices, of one all-reduce
    (psum/pmax) of a ``payload_bytes`` buffer: the standard ring
    all-reduce ships 2(p-1)/p of the payload per device."""
    return 2 * (p - 1) * payload_bytes


def allgather_wire_bytes(shard_bytes: float, p: int) -> float:
    """Total wire bytes of one all-gather of a ``shard_bytes`` shard:
    each of the p shards must reach the other p-1 devices."""
    return p * (p - 1) * shard_bytes


def alltoall_wire_bytes(staging_bytes: float, p: int) -> float:
    """Total wire bytes of one all-to-all over a per-device staging
    buffer of ``staging_bytes`` (p chunks): every device keeps its own
    chunk and ships the other p-1."""
    return (p - 1) * staging_bytes


def ppermute_wire_bytes(buffer_bytes: float, cross_pairs: int) -> float:
    """Total wire bytes of one ppermute: every (src != dst) pair ships
    the whole ``buffer_bytes`` buffer (a p-cycle has p cross pairs for
    p > 1, none for p == 1)."""
    return cross_pairs * buffer_bytes


def wire_bytes_report(
    n: int,
    p: int,
    *,
    cap_chunk: int,
    cap_hedge: int,
    n_levels: int,
    mode: str = "allgather",
    frontier_dtype: str = "int32",
    per_vertex: bool = False,
) -> dict[str, float]:
    """Bytes our ``parallel_tc`` implementation moves (int32 wire), per
    phase (keys = ``WIRE_PHASES``), per full algorithm run, summed over
    devices.

    This is the wire-bytes view (module docstring): capacities are the
    *static* buffers the shard function allocates (``cap_chunk`` padded
    transpose chunks, ``cap_hedge`` horizontal slots — see
    ``parallel_tc._capacities``), so each term is the paper-bits term's
    hardware spelling: same shape in (n, m, k, p), int32 words instead
    of packed bits, capacity slack instead of exact counts.  Each term
    uses the ``*_wire_bytes`` convention shared with the measured side
    (``core.comm_instrument``), so with ``n_levels`` set to the run's
    actual BFS sweep count the report equals the measured volumes
    exactly; with an upper-bound ``n_levels`` it is a per-phase
    envelope.  ``mode`` is accepted for interface symmetry: the ring
    spelling's (p-1) rounds of p-cycle ppermutes move exactly the
    all-gather volume (the paper's equivalence, asserted by the
    instrument tests).  ``per_vertex`` adds the attribution feature's
    n-vector credit psum to the reduce phase (the scalar-reduce count
    ``NUM_SCALAR_REDUCES`` is unchanged — the credit reduce is the one
    vector-valued member of the reduction phase)."""
    import numpy as np

    word = 4
    # same resolution as tally_comm — an unknown dtype must fail loudly,
    # not silently price the BFS exchange at the wrong width
    fsize = np.dtype(str(frontier_dtype)).itemsize
    if mode not in ("allgather", "ring"):
        raise ValueError(mode)
    return {
        # one has-edge seeding pmax (int32) + one frontier pmax
        # (frontier_dtype) per BFS sweep, each over the n-vector
        "bfs": allreduce_wire_bytes(n * word, p)
        + n_levels * allreduce_wire_bytes(n * fsize, p),
        # regular-sampling gossip: all-gather of p int32 samples/device
        "splitter": allgather_wire_bytes(p * word, p),
        # the N-hat transpose: two all-to-alls (values, carry) over the
        # (p, cap_chunk) staging buffers
        "transpose": 2 * alltoall_wire_bytes(p * cap_chunk * word, p),
        # horizontal rounds: two buffers of cap_hedge words visit every
        # other device once — all-gather and ring spell it identically
        "hedge": 2 * allgather_wire_bytes(cap_hedge * word, p),
        # the scalar overflow pmaxes + count psums, plus (opt-in) the
        # per-vertex credit psum over the n-vector
        "reduce": NUM_SCALAR_REDUCES * allreduce_wire_bytes(word, p)
        + (allreduce_wire_bytes(n * word, p) if per_vertex else 0),
    }
