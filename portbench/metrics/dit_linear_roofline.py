"""The least time of the DiT's linears (work.py: patch in and out, text in,
the time embedding, and in each layer qkv, out and the MLP of both
streams, each forward's work summed as step_mfu sums it) over the device
time of the program's dit.linear ranges (models/dit/nadit.py:DiTLinear:
one range a product, K7 on an int8 weight, the bf16 matmul and its bias
otherwise), in percent.

work.py counts a weight as 2 bytes. Where the block linears are stored
int8 (1 byte a weight, 4 a scale of an output column), that count would
overstate the least bytes, so the bytes here are work.py's less 1 a
weight of every linear: below both the int8 and the bf16 count, so the
least time stays a lower bound and the share cannot read over 100%. At
the benchmark's row counts the operations set the bound either way."""

from portbench import work

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER = "kernels"


def read(run):
    if run.trace is None or run.calls is None or not run.calls.dit_linears:
        return None
    busy = run.trace.busy("dit.linear")
    if busy <= 0:
        return None
    weights = work.dit_linears(run.calls.dit_cfg, 0, 0, 0).bytes / work.ACT  # weights of one forward
    least = sum(max(w.flops / work.PEAK_FLOPS, (w.bytes - weights) / work.PEAK_BYTES) for w in run.calls.dit_linears)
    return 100.0 * least / busy
