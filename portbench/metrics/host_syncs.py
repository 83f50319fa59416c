"""``host_syncs``: the places an answer's host waits for the card (the
program's ``StageClock.counts["host_syncs"]``, from the counter
``core/hostio.py:HOST_IO["syncs"]``), the mean over the traced window's
answers."""
from portbench.readers import count_mean


def read(outcome: dict):
    return count_mean(outcome, "host_syncs")
