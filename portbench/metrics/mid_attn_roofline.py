"""The least time of the VAE mid attention's work (work.py: the q, k, v and
out projections, Q K^T and P V of every frame) over the device time of the
program's vae.mid_attention ranges (models/vae/model.py:MidAttention, the
whole call: its GroupNorm, the frame loop, the out projection, the
residual), in percent."""

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER = "kernels"


def read(run):
    if run.trace is None or run.calls is None or not run.calls.mid_attention:
        return None
    busy = run.trace.busy("vae.mid_attention")
    return 100.0 * sum(w.least_s() for w in run.calls.mid_attention) / busy if busy > 0 else None
