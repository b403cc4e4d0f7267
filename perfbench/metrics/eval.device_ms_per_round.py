"""Device milliseconds a round launched inside the program's ``fl.eval``
ranges: the global model's forward on the eval set and its accuracy."""

from perfbench.spans import device_seconds, per_round_ms

LABEL = "fl.eval"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(device_seconds(run.trace, LABEL), run)
