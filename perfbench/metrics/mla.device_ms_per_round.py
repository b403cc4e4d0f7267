"""Device milliseconds a round launched inside the program's ``mla`` ranges:
every whole-sequence MLA block's forward (projections, RoPE, scores,
softmax, output), in the local steps and the eval, and the scores'
backward (recomputed probabilities, dS, the products with q, k and v); the
projections' backward is launched by the autograd engine outside the
range and is not counted."""

from perfbench.spans import device_seconds, per_round_ms

LABEL = "mla"


def read(run):
    if run.trace is None:
        return None
    return per_round_ms(device_seconds(run.trace, LABEL), run)
