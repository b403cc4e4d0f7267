"""Share of the window's ``fl.grad`` ranges that hold an ``fl.grad.pruned``
range, in %: the local steps whose gradient the program took over the
round's trained group alone (the fused cohort step on a homogeneous partial
round).  0 where no pruned range opened; ``None`` without a trace or
without a ``fl.grad`` range to count against."""

from perfbench.spans import spans

LABEL = "fl.grad.pruned"
STEP_LABEL = "fl.grad"


def read(run):
    if run.trace is None:
        return None
    steps = spans(run.trace, STEP_LABEL)
    if not steps:
        return None
    return 100.0 * len(spans(run.trace, LABEL)) / len(steps)
