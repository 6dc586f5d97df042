"""Device spans of the program's runner.vae_encode and runner.vae_decode
ranges (each instance's first event to its last, gaps inside included),
summed, per output frame."""

UNIT, BETTER, SOURCE = "ms/frame", "lower", "program_span"
LAYER = "VAE"


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans("runner.vae_encode") + run.trace.spans("runner.vae_decode")
    return 1000.0 * sum(spans) / run.frames if spans and run.frames else None
