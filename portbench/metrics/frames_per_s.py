"""Output frames of the measured window over all of its time (the first
request's start to the last one's end; whole requests only)."""

from portbench.window import rate

UNIT, BETTER, SOURCE = "frames/s", "higher", "host_clock"


def read(run):
    return rate(run.frames, run.window_s) if run.frames else None
