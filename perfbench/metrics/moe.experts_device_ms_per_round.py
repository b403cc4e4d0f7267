"""Device milliseconds a round launched inside the program's ``moe_experts``
ranges: the MoE layers' held experts, forward (local steps and eval) and
backward (the gathered entries, the recomputed gate and up products, the
input and weight gradients)."""

from perfbench.spans import device_seconds, per_round_ms

LABEL = "moe_experts"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(device_seconds(run.trace, LABEL), run)
