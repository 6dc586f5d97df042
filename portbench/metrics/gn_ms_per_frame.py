"""Device time of the program's vae.group_norm ranges (every GroupNorm pass
of the VAE outside a conv kernel: K8's tables and K9 on the card, K4's
tables on the fused route) per output frame."""

UNIT, BETTER, SOURCE = "ms/frame", "lower", "program_span"
LAYER = "VAE"


def read(run):
    if run.trace is None or not run.frames or not run.trace.ranges.get("vae.group_norm"):
        return None
    return 1000.0 * run.trace.busy("vae.group_norm") / run.frames
