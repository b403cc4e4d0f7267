"""Device milliseconds a round launched inside the program's
``fl.optimizer`` ranges: the masked-Adam launch of every local step and any
copy of its gradient."""

from perfbench.spans import device_seconds, per_round_ms

LABEL = "fl.optimizer"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(device_seconds(run.trace, LABEL), run)
