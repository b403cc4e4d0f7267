"""Client training samples per second: every client's batches of every
round in the window, over the window's whole length on the host clock
(local steps, aggregation, eval and the calls' own work included)."""


def read(run):
    return run.samples / run.window_s
