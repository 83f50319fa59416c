"""Arithmetic the metric readers (``metrics/<name>.py``) share."""
from __future__ import annotations

from typing import Optional


def stage_mean(outcome: dict, *stages: str) -> Optional[float]:
    """Mean seconds an answer spent in ``stages`` (summed), over the
    answers whose ``StageClock`` recorded any of them; ``None`` where
    none did (an untraced run, or a path without those stages)."""
    per = [sum(s.get(st, 0.0) for st in stages) for s in outcome["stages"]
           if any(st in s for st in stages)]
    return sum(per) / len(per) if per else None


def count_mean(outcome: dict, name: str) -> Optional[float]:
    """Mean of the ``StageClock`` counter ``name`` over the answers that
    recorded it."""
    per = [c[name] for c in outcome["counts"] if name in c]
    return sum(per) / len(per) if per else None
