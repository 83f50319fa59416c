"""``device_idle_pct``: the share of the profiled stretch in which no
device record (kernel, copy, fill) ran, in percent."""
from portbench import devtrace


def read(outcome: dict):
    tr = outcome.get("trace")
    if not tr or tr["t1"] <= tr["t0"] or not tr["events"]:
        return None
    busy = devtrace.busy_ns(tr["events"], tr["t0"], tr["t1"])
    return 100.0 * (1.0 - busy / (tr["t1"] - tr["t0"]))
