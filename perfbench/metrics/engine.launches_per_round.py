"""CUDA kernel launches per round in the traced window: the host's work per
round."""


def read(run):
    if run.trace is None or not run.rounds:
        return None
    return run.trace.kernels()[0] / len(run.rounds)
