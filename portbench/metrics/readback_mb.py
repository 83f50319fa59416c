"""``readback_mb``: bytes an answer copies from the card to the host, in
units of 1e6 (the program's ``StageClock.counts["readback_bytes"]``,
from the counter ``core/hostio.py:HOST_IO["d2h_bytes"]``), the mean over
the traced window's answers."""
from portbench.readers import count_mean


def read(outcome: dict):
    b = count_mean(outcome, "readback_bytes")
    return None if b is None else b / 1e6
