"""The 90th percentile (nearest rank) of every request of the window, a
request running from its phases.generate call to its packed codes being on
the host."""

from portbench.window import nearest_rank

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return nearest_rank(run.request_s, 90) if len(run.request_s) >= 10 else None
