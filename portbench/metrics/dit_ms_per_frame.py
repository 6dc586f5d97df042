"""Device spans of the program's runner.dit_step ranges, summed, per output
frame."""

UNIT, BETTER, SOURCE = "ms/frame", "lower", "program_span"
LAYER = "DiT"


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans("runner.dit_step")
    return 1000.0 * sum(spans) / run.frames if spans and run.frames else None
