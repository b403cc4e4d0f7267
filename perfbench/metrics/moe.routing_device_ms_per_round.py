"""Device milliseconds a round launched inside the program's ``moe_route``,
``moe_dispatch`` and ``moe_combine`` ranges: the MoE layers' router, top-k,
balance loss, sort by expert, group ends and combine, in the
forward (local steps and eval).  The ranges follow each other, so their
device times add."""

from perfbench.spans import device_seconds, per_round_ms

LABELS = ("moe_route", "moe_dispatch", "moe_combine")


def read(run):
    if run.trace is None:
        return None
    parts = [device_seconds(run.trace, label) for label in LABELS]
    if any(p is None for p in parts):
        return None
    return per_round_ms(sum(parts), run)
