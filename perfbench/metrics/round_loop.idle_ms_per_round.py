"""Device idle milliseconds a round whose gap middle lies outside every
``fl.local_step`` range of the program: what the host's work between local
steps (batches, aggregation, eval, the round loop, the calls) costs the
card."""

from perfbench.spans import idle_seconds_outside, per_round_ms

LABEL = "fl.local_step"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(idle_seconds_outside(run.trace, LABEL), run)
