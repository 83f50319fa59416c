"""``probe_launches``: the intersection kernels' launches an answer makes
(K1, K2 and K3; the program's ``StageClock.counts["probe_launches"]``,
from ``kernels/intersect/intersect.py:LAUNCHES``), the mean over the
traced window's answers."""
from portbench.readers import count_mean


def read(outcome: dict):
    return count_mean(outcome, "probe_launches")
