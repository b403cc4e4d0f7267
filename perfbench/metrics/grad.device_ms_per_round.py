"""Device milliseconds a round launched inside the program's ``fl.grad``
ranges: every local step's vmapped forward and backward."""

from perfbench.spans import device_seconds, per_round_ms

LABEL = "fl.grad"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(device_seconds(run.trace, LABEL), run)
