"""Host milliseconds a round inside the program's ``fl.batches`` ranges:
each bucket's batch plans, the copy of every client's data to the card and
the stack of its batches."""

from perfbench.spans import host_seconds, per_round_ms

LABEL = "fl.batches"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(host_seconds(run.trace, LABEL), run)
