"""The least time of the VAE convolutions' work (work.py: each call's
ops and bytes from its shapes; the decoder's upsamples as the one
low-resolution conv they compose to) over the device time of the pb.conv
ranges around every CausalConv3d and FoldedUpsample call (the GroupNorm +
SiLU a call applies to its input included), in percent."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"


def read(run):
    if run.trace is None or run.calls is None or not run.calls.conv:
        return None
    busy = run.trace.busy("pb.conv")
    return 100.0 * sum(w.least_s() for w in run.calls.conv) / busy if busy > 0 else None
