"""Device time of the device-to-host copies (the packed codes' way to the
host) per output frame."""

UNIT, BETTER, SOURCE = "ms/frame", "lower", "device_trace"
LAYER = "output stream"


def read(run):
    if run.trace is None or not run.frames:
        return None
    s = run.trace.copies_s("DtoH")
    return 1000.0 * s / run.frames if s > 0 else None
