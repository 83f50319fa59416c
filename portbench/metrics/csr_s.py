"""``csr_s``: seconds an answer spends in the ``csr`` stage, the
program's ``StageClock`` (each stage closed by a synchronize), the mean
over the traced window's answers."""
from portbench.readers import stage_mean


def read(outcome: dict):
    return stage_mean(outcome, "csr")
