"""``bfs_sweeps``: BFS sweeps an answer takes, each one host sync (the
program's ``StageClock.counts["bfs_sweeps"]``), the mean over the
traced window's answers."""
from portbench.readers import count_mean


def read(outcome: dict):
    return count_mean(outcome, "bfs_sweeps")
