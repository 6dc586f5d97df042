"""The whole step's share of the card's peak: work.py's FLOPs of every call
of the traced window (the VAE's convolutions and mid attention, the DiT's
linears and window attention over real tokens) over window seconds x
989 TFLOP/s (dense bf16)."""

from portbench.work import PEAK_FLOPS

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "whole step"


def read(run):
    if run.calls is None:
        return None
    flops = run.calls.step().flops
    return 100.0 * flops / (run.window_s * PEAK_FLOPS) if flops else None
