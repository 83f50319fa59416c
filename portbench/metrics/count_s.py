"""``count_s``: wall seconds per exact answer, the window's seconds over
the answers completed in it (the window ends when the answer in flight
at ``--seconds`` completes)."""


def read(outcome: dict):
    if not outcome["answers"]:
        return None
    return outcome["window_s"] / outcome["answers"]
