"""Device time of the program's vae.causal_pad ranges (models/vae/
causal_conv.py:CausalConv3d.forward: the time axis extended by the cached
frames or the replicated first frame, and the copy of the next slice's
cache) per output frame."""

UNIT, BETTER, SOURCE = "ms/frame", "lower", "program_span"
LAYER = "VAE"


def read(run):
    if run.trace is None or not run.frames or not run.trace.ranges.get("vae.causal_pad"):
        return None
    return 1000.0 * run.trace.busy("vae.causal_pad") / run.frames
