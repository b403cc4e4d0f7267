"""The cohort masked-Adam kernel's share of its roofline: the sum over the
window's launches of each launch's least time (its bytes at the card's
memory bandwidth, or its operations at the float32 peak if longer;
``perfbench.kernelcounts``) over the kernel's device time in the trace."""

from perfbench.kernelcounts import masked_adam_launch

KERNEL = "masked_adam_cohort"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    launches, seconds = run.trace.kernels(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    least = 0.0
    for _, group in run.rounds:
        nbytes, ops = masked_adam_launch(run.leaves, group, run.traffic.clients)
        least += run.traffic.steps_per_client * max(
            nbytes / run.peaks["hbm_bytes_per_s"], ops / run.peaks["f32_flops"])
    return 100.0 * least / seconds
