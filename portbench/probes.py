"""What the traced run adds around the program: ``record_function`` ranges
around calls into its layers, put in place from here (the program is not
edited) and taken out after, and a record of each call's shapes for
work.py. Recording reads only shapes and flags on the host: it never waits
for the device.

Ranges (read by trace.py and the metrics):

- ``pb.conv``: every CausalConv3d call (the GroupNorm + SiLU that the call
  applies to its input included) and every FoldedUpsample call;
- ``pb.attn``: each DiT layer's window attention call (either route), with
  ``pb.attn_proj`` nested around its qkv and output projections;
- the program's own ``runner.<stage>`` ranges (pipeline/runner.py).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List

from torch.profiler import record_function

from . import work


class Calls:
    """The work of every recorded call, by layer."""

    def __init__(self, dit_cfg: dict):
        self.dit_cfg = dit_cfg
        self.conv: List[work.Work] = []
        self.mid_attention: List[work.Work] = []
        self.dit_linears: List[work.Work] = []
        self.attention: List[work.Work] = []  # one a DiT layer

    def step(self) -> work.Work:
        """Everything the counted layers did."""
        return work.total(self.conv + self.mid_attention + self.dit_linears + self.attention)


def _ranged(name: str, fn):
    @functools.wraps(fn)
    def call(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return call


@contextlib.contextmanager
def installed(calls: Calls):
    """The ranges and the call record, for the length of the block."""
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.models.vae.causal_conv import CausalConv3d
    from seedvr2_tpu_torch.models.vae.folded_upsample import FoldedUpsample
    from seedvr2_tpu_torch.models.vae.model import MidAttention

    saved = [
        (CausalConv3d, "forward", CausalConv3d.forward),
        (FoldedUpsample, "forward", FoldedUpsample.forward),
        (MidAttention, "forward", MidAttention.forward),
        (nadit.NaDiT, "forward", nadit.NaDiT.forward),
        (nadit.NaDiT, "_window_attention_fused", nadit.NaDiT._window_attention_fused),
        (nadit.NaDiT, "_window_attention_unfused", nadit.NaDiT._window_attention_unfused),
        (nadit.NaDiT, "_qkv_tokens", nadit.NaDiT.__dict__["_qkv_tokens"]),
        (nadit, "_row_linear", nadit._row_linear),
    ]
    conv_forward, up_forward, mid_forward, dit_forward = (s[2] for s in saved[:4])

    def conv(self, x, ctx, name, gn=None):
        kt, kh, kw, cin, cout = self.spec["w"][0]
        T = x.shape[1]
        if ctx.mode == "active":
            t_ext = T + kt - self.stride[0]
        else:
            t_ext = T + 2 * self.temporal_pad
        calls.conv.append(work.conv3d(tuple(x.shape), (kt, kh, kw), cout, self.stride, self.spatial_pad, t_ext))
        with record_function("pb.conv"):
            return conv_forward(self, x, ctx, name, gn)

    def up(self, x, ctx, name):
        calls.conv.append(work.upsample(tuple(x.shape), self.temporal_up, ctx.mode == "active"))
        with record_function("pb.conv"):
            return up_forward(self, x, ctx, name)

    def mid(self, x):
        calls.mid_attention.append(work.mid_attention(tuple(x.shape)))
        return mid_forward(self, x)

    def dit(self, vid, txt, timestep, dplans):
        B, T, H, W, _ = vid.shape
        lin, attn = work.dit_forward(calls.dit_cfg, (T, H, W), txt.shape[1], B)
        calls.dit_linears.append(lin)
        calls.attention.extend(attn)
        return dit_forward(self, vid, txt, timestep, dplans)

    try:
        CausalConv3d.forward = conv
        FoldedUpsample.forward = up
        MidAttention.forward = mid
        nadit.NaDiT.forward = dit
        for attr in ("_window_attention_fused", "_window_attention_unfused"):
            setattr(nadit.NaDiT, attr, _ranged("pb.attn", getattr(nadit.NaDiT, attr)))
        nadit.NaDiT._qkv_tokens = staticmethod(_ranged("pb.attn_proj", nadit.NaDiT.__dict__["_qkv_tokens"].__func__))
        nadit._row_linear = _ranged("pb.attn_proj", nadit._row_linear)
        yield calls
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
