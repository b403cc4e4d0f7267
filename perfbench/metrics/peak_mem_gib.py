"""Peak device memory allocated during the window
(``torch.cuda.max_memory_allocated`` after a reset as the window opens), GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30
