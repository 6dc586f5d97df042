"""From the process's start to the window's start: imports, the CUDA
context, the kernel library (built by a checkout's first run), weights
drawn on the card and loaded, the traffic drawn, one warm request of each
shape."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
