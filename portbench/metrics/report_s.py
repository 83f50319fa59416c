"""``report_s``: seconds an answer spends in the ``report`` stage, the
program's ``StageClock`` lap that closes ``TriangleEngine.count``: the
scalars and arrays read back into the report, up to the return; the
mean over the traced window's answers."""
from portbench.readers import stage_mean


def read(outcome: dict):
    return stage_mean(outcome, "report")
