"""``probe_roofline_pct``: the least time the card could take for the
intersections of the profiled answers (``work.py``: counted from each
graph and its horizontal edges, not from launch shapes) over the device
time of the records that ran inside the ``probe`` stage's spans, in
percent."""
from portbench import devtrace


def read(outcome: dict):
    tr = outcome.get("trace")
    if not tr or not outcome["work"]:
        return None
    probe_ns = devtrace.stage_device_ns(tr["events"], tr["spans"], "probe")
    if probe_ns <= 0:
        return None
    least = sum(w["least_s"] for w in outcome["work"])
    return 100.0 * least / (probe_ns / 1e9)
