"""Reading a profiled stretch of the window.

Only the device is profiled (``ProfilerActivity.CUDA``), and the
profiler's raw records are read (``kineto_results.events()``): a copy of
the idea of the program's ``chip_smoke.py:device_busy``, whose notes
found ``prof.events()`` ~39 s slow on a long run.  Each record becomes
``(name, start_ns, end_ns)`` on the profiler's clock, the Unix epoch in
nanoseconds, the clock of ``time.time_ns()``; the benchmark's stage
spans are taken on that clock too.
"""
from __future__ import annotations

from collections import defaultdict


def device_events(prof) -> list[tuple[str, int, int]]:
    """Every device record (kernels, copies, fills) of a finished
    ``torch.profiler.profile``, sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns())))
    out.sort(key=lambda r: r[1])
    return out


def merged(events, t0: int, t1: int) -> list[tuple[int, int]]:
    """The union of the records' intervals, clipped to ``[t0, t1]``."""
    out: list[list[int]] = []
    for _, s, e in sorted(events, key=lambda r: r[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(events, t0: int, t1: int) -> int:
    """Nanoseconds of ``[t0, t1]`` in which some device record ran."""
    return sum(e - s for s, e in merged(events, t0, t1))


def stage_at(spans, t: int, default: str = "harness") -> str:
    """The stage whose span ``(stage, begin_ns, end_ns)`` holds ``t``."""
    for stage, b, e in spans:
        if b <= t < e:
            return stage
    return default


def idle_gaps(events, spans, t0: int, t1: int,
              k: int = 10) -> list[list]:
    """The ``k`` longest stretches of ``[t0, t1]`` with nothing on the
    device, longest first, each ``[stage, seconds]`` named by the stage
    the host was in at the gap's middle (``"harness"`` outside every
    stage: the benchmark's own code between answers)."""
    gaps = []
    last = t0
    for s, e in merged(events, t0, t1) + [(t1, t1)]:
        if s > last:
            gaps.append((s - last, stage_at(spans, (s + last) // 2)))
        last = max(last, e)
    gaps.sort(key=lambda g: -g[0])
    return [[stage, ns / 1e9] for ns, stage in gaps[:k]]


def top_ops(events, k: int = 10, width: int = 96) -> list[list]:
    """The ``k`` device operations that took most time, by name (cut to
    ``width`` characters), ``[name, seconds]``."""
    per: dict[str, int] = defaultdict(int)
    for name, s, e in events:
        per[name[:width]] += e - s
    top = sorted(per.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in top]


def stage_device_ns(events, spans, stage: str) -> int:
    """Summed durations of the device records that start inside a span of
    ``stage``: the stage ends with a synchronize, so its device work runs
    inside its span."""
    own = [(b, e) for st, b, e in spans if st == stage]
    total = 0
    for _, s, e in events:
        if any(b <= s < en for b, en in own):
            total += e - s
    return total
