"""Launches of the cohort masked-Adam kernel per round, from the program's
counter (``MaskedAdamCohort.launches``) over the window: one per bucket and
local step when every step goes through the kernel."""


def read(run):
    if not run.rounds:
        return None
    return run.launches / len(run.rounds)
