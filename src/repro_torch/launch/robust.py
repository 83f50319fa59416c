"""Chaos harness of the triangle server (counterpart of
``repro.launch.robust``): deterministic fault injection, an open-loop
bursty load generator, and the replay driver that checks the serving
invariant.

The invariant (DESIGN.md §7): every submitted request id receives
exactly one structured result — exact, approx with an error bar, or
rejected — and ``submit``/``drain`` never raise and never leak a batch
in flight, whatever the stream does or the plan injects.  A real device
error is not degraded: it propagates (``serve_tc``'s module docstring).

* :class:`FaultPlan` — a frozen schedule keyed on trace ordinals and
  batch ordinals (malformed requests, oversized graphs, stalls and
  injected failures at batch dispatch, stalls and failures of the
  distributed route's attempts).  The same plan and the same trace give
  the same faults, so a chaos failure reproduces.
  :class:`CountingFaultPlan` records the faults it injects, so a driver
  holds ``failed_batches`` to them.
* :func:`synth_requests` / :func:`timed_trace` — the open-loop trace:
  requests stamped with arrival times, ``"poisson"`` (steady load) or
  ``"burst"`` (back-to-back bursts between idle gaps, the stream that
  starves a fixed-size flush policy and makes deadline flushes earn
  their p99).
* :func:`run_chaos` — replays a trace against a ``TriangleServer`` in
  real time (pumping between arrivals), applies the plan's stream-side
  mutations, drains, and audits the invariant.

Every exact answer is a lane of a batch through the port's batch route
(K1, or K2 with ``per_vertex``, on the card); only the degraded lane
runs on the host.

    PYTHONPATH=src python -m repro_torch.launch.robust --smoke
    PYTHONPATH=src python -m repro_torch.launch.robust --smoke --device cpu

It runs on the card unless ``--device cpu`` is given, over the default
(uncapped) grid, where an oversized request goes to a larger cell and is
answered exactly.  It exits non-zero unless the audit is ``ok``, some
answer is exact, and ``failed_batches`` equals both the faults the plan
injected and the ordinal rule's count.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.graph import generators as gen
from repro_torch.launch import serve_tc
from repro_torch.launch.serve_tc import (
    FaultInjected,
    RejectedRequest,
    TriangleAnalytics,
)

ARRIVALS = ("poisson", "burst")


def _hits(every: int, i: int) -> bool:
    """Deterministic schedule predicate: ordinal ``i`` is selected when
    ``every > 0`` and ``i % every == every - 1`` (never ordinal 0, so a
    run's first request or batch takes the happy path)."""
    return every > 0 and i % every == every - 1


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault-injection schedule.

    Stream-side mutations (applied by :func:`run_chaos` before submit,
    keyed on the request's trace ordinal):

      malformed_every:  replace the request with an out-of-range edge
                        list; it must come back ``RejectedRequest``
                        ("malformed"), not an exception.
      oversized_every:  replace it with a star of ``oversized_nodes``;
                        over an uncapped grid it lands in a larger cell
                        and is answered exactly.

    Server-side injections (the server calls :meth:`before_batch` with
    its ``batches_run``, which only a dispatched flush advances):

      stall_batch_every / stall_s: sleep before dispatching the batch (a
                        simulated compile stall: deadlines slip, every
                        request is still answered).
      fail_batch_every: raise :class:`FaultInjected` at dispatch (a
                        simulated device failure: every lane answered
                        through the degradation ladder).  The ordinal
                        does not advance on a failed flush, so from
                        ordinal ``fail_batch_every - 1`` on every flush
                        fails, as in the reference.
      fail_distributed_every / fail_distributed_attempts: raise
                        :class:`FaultInjected` in the first
                        ``fail_distributed_attempts`` attempts of every
                        ``fail_distributed_every``-th request id on the
                        distributed route (the server calls
                        :meth:`before_distributed` per attempt): one
                        attempt fails and the ring retry answers; two
                        fail and the request degrades.
      stall_distributed_every / distributed_stall_s: sleep before each
                        attempt of those request ids (with
                        ``distributed_timeout_s`` below the stall, each
                        attempt times out and is abandoned).
    """

    malformed_every: int = 0
    oversized_every: int = 0
    oversized_nodes: int = 4096
    stall_batch_every: int = 0
    stall_s: float = 0.05
    fail_batch_every: int = 0
    fail_distributed_every: int = 0
    fail_distributed_attempts: int = 1
    stall_distributed_every: int = 0
    distributed_stall_s: float = 0.5

    # ------------------------------------------ stream-side mutation
    def mutate(self, i: int, edges: np.ndarray, n_nodes: int):
        """The (possibly faulted) request submitted for trace ordinal
        ``i``."""
        if _hits(self.malformed_every, i):
            # endpoint == n_nodes: the aliasing class submit() rejects
            return np.array([[0, int(n_nodes)]], dtype=np.int64), int(n_nodes)
        if _hits(self.oversized_every, i):
            return gen.star(int(self.oversized_nodes))
        return edges, n_nodes

    # ---------------------------------------- server-side injections
    def before_batch(self, batch_idx: int) -> None:
        """TriangleServer hook: called once per flush, before dispatch."""
        if _hits(self.stall_batch_every, batch_idx):
            time.sleep(self.stall_s)
        if _hits(self.fail_batch_every, batch_idx):
            raise FaultInjected(f"injected device failure @ batch {batch_idx}")

    def before_distributed(self, rid: int, attempt: int) -> None:
        """TriangleServer hook: called per distributed attempt."""
        if _hits(self.stall_distributed_every, rid):
            time.sleep(self.distributed_stall_s)
        if (_hits(self.fail_distributed_every, rid)
                and attempt < self.fail_distributed_attempts):
            raise FaultInjected(
                f"injected distributed failure @ request {rid} "
                f"attempt {attempt}"
            )


@dataclasses.dataclass(frozen=True)
class CountingFaultPlan(FaultPlan):
    """A :class:`FaultPlan` that records the batch ordinal of every
    :class:`FaultInjected` it raises: a failed batch it did not inject
    is a real failure."""

    injected: list = dataclasses.field(default_factory=list, compare=False,
                                       hash=False)

    def before_batch(self, batch_idx: int) -> None:
        try:
            super().before_batch(batch_idx)
        except FaultInjected:
            self.injected.append(batch_idx)
            raise


def ordinal_failures(plan: FaultPlan, flushes: int) -> int:
    """The failed batches ``flushes`` flushes give under ``plan``:
    ``batches_run`` advances only on a dispatched flush, so every flush
    from ordinal ``fail_batch_every - 1`` on fails (ROADMAP Queue 3,
    reference caveat 4)."""
    if plan.fail_batch_every <= 0:
        return 0
    return max(0, flushes - (plan.fail_batch_every - 1))


class TimedRequest(NamedTuple):
    """One open-loop arrival: submit ``(edges, n_nodes)`` at ``t``
    seconds after the trace's start."""

    t: float
    edges: np.ndarray
    n_nodes: int


def timed_trace(
    reqs: Sequence[tuple[np.ndarray, int]],
    *,
    arrival: str = "poisson",
    rate_hz: float = 200.0,
    burst_len: int = 16,
    burst_gap_s: float = 0.25,
    seed: int = 0,
) -> list[TimedRequest]:
    """``reqs`` stamped with arrival times, the first at 0, by
    :func:`synth_requests`' rule (the reference's draws for the same
    ``seed``)."""
    if arrival not in ARRIVALS:
        raise ValueError(f"arrival must be one of {ARRIVALS}; got {arrival!r}")
    num = len(reqs)
    if not num:
        return []
    rng = np.random.default_rng(seed + 0x5EED)
    if arrival == "poisson":
        gaps = rng.exponential(1.0 / rate_hz, size=num)
    else:
        gaps = np.full(num, 0.1 / rate_hz)
        gaps[::burst_len] = burst_gap_s  # a gap opens each burst
    t = np.cumsum(gaps) - gaps[0]
    return [TimedRequest(float(t[i]), e, n) for i, (e, n) in enumerate(reqs)]


def synth_requests(
    num: int,
    *,
    arrival: str = "poisson",
    rate_hz: float = 200.0,
    burst_len: int = 16,
    burst_gap_s: float = 0.25,
    mix: str = "serve",
    uniform_scale: int = 6,
    seed: int = 0,
    smoke: bool = False,
) -> list[TimedRequest]:
    """Arrival-stamped open-loop trace (the reference's, request for
    request and time for time).

    ``"poisson"``: exponential gaps at ``rate_hz``.  ``"burst"``: groups
    of ``burst_len`` arriving back to back (at 10× ``rate_hz`` spacing)
    separated by ``burst_gap_s`` idle, so every burst strands its tail
    across partially filled cells until the next burst or a deadline.

    ``mix="serve"`` draws the serving mix (``serve_tc.synth_requests``:
    several budget cells); ``mix="uniform"`` draws same-scale RMAT graphs
    of varying seeds, one cell and one plan, so a comparison of flush
    policies measures the policy.
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"arrival must be one of {ARRIVALS}; got {arrival!r}")
    if mix not in ("serve", "uniform"):
        raise ValueError(f"mix must be 'serve' or 'uniform'; got {mix!r}")
    rng0 = np.random.default_rng(seed)
    if mix == "uniform":
        base = [gen.rmat(uniform_scale, 8, seed=int(rng0.integers(1 << 30)))
                for _ in range(num)]
    else:
        base = serve_tc.synth_requests(num, seed=seed, smoke=smoke)
    return timed_trace(base, arrival=arrival, rate_hz=rate_hz,
                       burst_len=burst_len, burst_gap_s=burst_gap_s,
                       seed=seed)


def run_chaos(
    server,
    trace: list[TimedRequest],
    *,
    faults: Optional[FaultPlan] = None,
    speed: float = 1.0,
    pump_interval_s: float = 0.002,
) -> dict:
    """Replay ``trace`` open loop against ``server`` (submitting at the
    stamped arrival times, scaled by ``speed``, and pumping between
    arrivals), apply ``faults``' stream-side mutations, drain, and audit
    the serving invariant.

    Returns the audit: ``unanswered``/``duplicates`` (both must be
    empty), the count of each category, wall seconds and the server's
    final summary.  The plan's server-side hooks must already be on the
    server (``faults=`` at construction); this driver owns only the
    stream-side mutations, so a plan-free replay is the same code path.
    """
    t0 = time.perf_counter()
    submitted: list[int] = []
    for i, req in enumerate(trace):
        target = t0 + req.t / speed
        while (now := time.perf_counter()) < target:
            server.pump()
            time.sleep(min(pump_interval_s, target - now))
        edges, n_nodes = (faults.mutate(i, req.edges, req.n_nodes)
                          if faults is not None
                          else (req.edges, req.n_nodes))
        submitted.append(server.submit(edges, n_nodes))
    results = server.drain()
    wall = time.perf_counter() - t0

    ids = [r.request_id for r in results]
    seen: set[int] = set()
    duplicates = sorted({i for i in ids if i in seen or seen.add(i)})
    unanswered = sorted(set(submitted) - seen)
    stats = server.summary()
    return {
        "submitted": len(submitted),
        "answered": len(seen),
        "unanswered": unanswered,
        "duplicates": duplicates,
        "exact": sum(1 for r in results
                     if isinstance(r, TriangleAnalytics)
                     and r.route in ("batched", "distributed")),
        "approx": sum(1 for r in results
                      if isinstance(r, TriangleAnalytics)
                      and r.route == "approx"),
        "rejected": sum(1 for r in results
                        if isinstance(r, RejectedRequest)),
        "leaked_pending": stats["pending"],
        "leaked_inflight": stats["inflight"],
        "wall_s": wall,
        "summary": stats,
        "ok": (not unanswered and not duplicates
               and stats["pending"] == 0 and stats["inflight"] == 0),
    }


def main(argv: Optional[list[str]] = None) -> dict:
    """Chaos smoke: a bursty trace under the plan's batch-path fault
    classes, over the default grid.  Exits non-zero unless the audit is
    ``ok``, some answer is exact, and ``failed_batches`` equals the
    injected faults and :func:`ordinal_failures`.  Returns the audit,
    with ``injected`` added."""
    from repro_torch.api import TCOptions, TriangleEngine

    ap = argparse.ArgumentParser(description="Serving chaos smoke")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke mix's small graphs (RMAT ego-nets of "
                         "scale 5-6)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    num = args.requests or 48

    plan = CountingFaultPlan(malformed_every=7, oversized_every=11,
                             oversized_nodes=600, stall_batch_every=5,
                             stall_s=0.02, fail_batch_every=6)
    engine = TriangleEngine(
        TCOptions(deadline_s=0.05, admission_tokens=16, approx_samples=4096),
        device=args.device,
    )
    server = engine.serve(batch_size=8, faults=plan)
    trace = synth_requests(num, arrival="burst", rate_hz=400.0,
                           burst_len=12, burst_gap_s=0.05,
                           seed=args.seed, smoke=args.smoke)
    audit = run_chaos(server, trace, faults=plan)
    s = audit["summary"]
    audit["injected"] = len(plan.injected)
    ok = (audit["ok"] and audit["exact"] > 0
          and s["failed_batches"] == len(plan.injected) == ordinal_failures(
              plan, s["deadline_flushes"] + s["size_flushes"]))
    print(f"chaos,{audit['wall_s'] / num * 1e6:.0f},"
          f"answered={audit['answered']}/{audit['submitted']}"
          f"|exact={audit['exact']}|approx={audit['approx']}"
          f"|rejected={audit['rejected']}"
          f"|failed_batches={s['failed_batches']}"
          f"|injected={len(plan.injected)}|ok={ok}", flush=True)
    if not ok:
        raise SystemExit(f"FAIL: chaos audit violated the serving "
                         f"invariant, or a batch failed that the plan did "
                         f"not fail: {audit}")
    return audit


if __name__ == "__main__":
    main()
