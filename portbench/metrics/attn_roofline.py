"""The least time of the DiT's window attention (work.py: Q K^T and P V
over each window's real video and text tokens, q, k, v read and the
outputs written once, layer by layer) over the device time of the pb.attn
ranges around each layer's attention call less their nested qkv and output
projections (pb.attn_proj): the preparation, the gathers and the flash
loop, whichever route runs them. In percent."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"


def read(run):
    if run.trace is None or run.calls is None or not run.calls.attention:
        return None
    busy = run.trace.busy("pb.attn", exclude="pb.attn_proj")
    return 100.0 * sum(w.least_s() for w in run.calls.attention) / busy if busy > 0 else None
