"""1 - (union of the device's kernel, copy and memset intervals) / (the
traced window's wall time), in percent."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"


def read(run):
    if run.trace is None or not run.trace.intervals:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
