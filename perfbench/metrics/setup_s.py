"""Seconds from the process's start to the window's opening: imports, the
CUDA context, the masked-Adam library (built on a checkout's first run),
data and weights from the seed, and the checked rounds that warm every
shape."""


def read(run):
    return run.setup_s
