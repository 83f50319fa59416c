"""``plan_host_s``: seconds an answer spends in the plan's host pass
(``plan_buckets`` after the degree profile's read-back), the program's
host-only span ``plan.host`` nested in the ``plan`` stage, the mean over
the traced window's answers."""
from portbench.readers import stage_mean


def read(outcome: dict):
    return stage_mean(outcome, "plan.host")
