"""``credit_s``: seconds a per-vertex answer spends making the hit list
and crediting each triangle's corners (``StageClock`` stages
``hit_list`` and ``credit``), the mean over the traced window's answers;
nothing on a path without those stages."""
from portbench.readers import stage_mean


def read(outcome: dict):
    return stage_mean(outcome, "hit_list", "credit")
