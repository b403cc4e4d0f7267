"""Device milliseconds a round launched inside the program's
``fl.aggregate`` ranges: the stacked FedAvg and its splice into the global
weights."""

from perfbench.spans import device_seconds, per_round_ms

LABEL = "fl.aggregate"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(device_seconds(run.trace, LABEL), run)
