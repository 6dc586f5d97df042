"""Temporally causal 3D convolution with explicit streaming state
(counterpart of seedvr2_tpu/models/vae/causal_conv.py).

- first slice, or no streaming: the head is extended by replicating the
  first frame 2 * temporal_pad times;
- streaming ("active"): the carry (the last kt - stride_t frames of the
  previous slice's extended input) is prepended instead.

Stride-1 3x3x3 convs whose Cin and Cout are multiples of 128 run K1
(ops/conv3d_kernel.py), the routing rule of the JAX package; the others
(conv_in, conv_out, 1x1x1 shortcuts, strided downsamplers) run F.conv3d.
The weight is stored once, at load, in the layout of its route.

GroupNorm + SiLU fusion (``gn_fusion``, set for the whole model by
VAE.set_gn_fusion; off by default, as the JAX package's set_gn_fusion):
a K1-routed conv given ``gn=`` then runs K4 with the per-frame tables of
its raw extended input, instead of normalising the input first (``gn_silu``:
on the card K8's tables, then K9's pass; ops/normalization.py).

Profiler ranges (utils/spans.py): "vae.causal_pad" around the temporal
extension and the next slice's carry, "vae.group_norm" around every
GroupNorm pass (K4's tables included), "vae.conv_plain" around the
F.conv3d route with its layout copies.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops import conv3d_kernel
from ...ops.normalization import group_norm_frames
from ...utils.spans import span
from ..params import NORMAL, ZEROS, Leaf

State = Dict[str, torch.Tensor]


class _Scope:
    """One level of a StreamCtx's module path, for a ``with`` block. A plain
    object: a class made per call would close over the context in a
    reference cycle and keep its carries on the device until Python's
    cyclic collector happened to run."""

    __slots__ = ("ctx", "name")

    def __init__(self, ctx: "StreamCtx", name: str):
        self.ctx, self.name = ctx, name

    def __enter__(self):
        self.ctx._path.append(self.name)

    def __exit__(self, *exc):
        self.ctx._path.pop()


class StreamCtx:
    """Streaming state of one VAE forward: mode "disabled" (single shot),
    "init" (first temporal slice) or "active" (later slices, which consume
    the carries in ``in_state``); carries are keyed by module path."""

    def __init__(self, mode: str = "disabled", in_state: Optional[State] = None):
        if mode not in ("disabled", "init", "active"):
            raise ValueError(mode)
        self.mode = mode
        self.in_state = in_state or {}
        self.out_state: State = {}
        self._path = []

    def scope(self, name: str) -> _Scope:
        return _Scope(self, name)

    @property
    def path(self) -> str:
        return "/".join(self._path)

    def get(self, leaf: str) -> Optional[torch.Tensor]:
        return self.in_state.get(f"{self.path}/{leaf}")

    def put(self, leaf: str, value: torch.Tensor) -> None:
        self.out_state[f"{self.path}/{leaf}"] = value


def gn_silu(x: torch.Tensor, norm: Leaf, groups: int) -> torch.Tensor:
    """Per-frame GroupNorm (stats per (b, t)) then SiLU in fp32, on NDHWC
    (on the card: K8's tables, then K9)."""
    with span("vae.group_norm"):
        return group_norm_frames(x, norm.w, norm.b, groups, silu=True)


class CausalConv3d(Leaf):
    gn_fusion = False  # K4 for a K1-routed conv with gn= (VAE.set_gn_fusion)

    def __init__(
        self,
        kernel: Tuple[int, int, int],
        cin: int,
        cout: int,
        device,
        dtype,
        stride: Tuple[int, int, int] = (1, 1, 1),
        spatial_pad: Tuple[Tuple[int, int], Tuple[int, int]] = ((1, 1), (1, 1)),
        temporal_pad: Optional[int] = None,
    ):
        kt, kh, kw = kernel
        self.k1 = spatial_pad == ((1, 1), (1, 1)) and conv3d_kernel.enabled_for((kt, kh, kw, cin, cout), stride)
        super().__init__(
            {"w": ((kt, kh, kw, cin, cout), (NORMAL, (kt * kh * kw * cin) ** -0.5)), "b": ((cout,), (ZEROS, 0.0))},
            device,
            dtype,
        )
        self.stride = tuple(stride)
        self.spatial_pad = spatial_pad
        self.temporal_pad = (kt - 1) // 2 if temporal_pad is None else temporal_pad

    # K1 takes DHWIO weights and an fp32 bias; F.conv3d takes OIDHW.
    def stored_shape(self, name, shape):
        return shape if (name == "b" or self.k1) else (shape[4], shape[3], *shape[:3])

    def stored_dtype(self, name):
        return torch.float32 if (name == "b" and self.k1) else self.dtype

    def convert(self, name, t):
        return t if (name == "b" or self.k1) else t.permute(4, 3, 0, 1, 2)

    def forward(self, x: torch.Tensor, ctx: StreamCtx, name: str, gn=None) -> torch.Tensor:
        """x [B, T, H, W, Cin] -> [B, T', H', W', Cout]. ``gn`` = (norm leaf,
        groups) applies per-frame GroupNorm + SiLU to the extended input first
        (it commutes with the temporal extension, so the carry stays raw);
        under gn_fusion a K1-routed conv folds it into its load (K4)."""
        kt = self.spec["w"][0][0]
        with ctx.scope(name), span("vae.causal_pad"):
            mem = ctx.get("mem") if ctx.mode == "active" else None
            if mem is not None:
                x_ext = torch.cat([mem.to(x.dtype), x], dim=1)
            elif self.temporal_pad > 0:
                x_ext = torch.cat([x[:, :1].expand(-1, 2 * self.temporal_pad, -1, -1, -1), x], dim=1)
            else:
                x_ext = x
            cache = kt - self.stride[0]
            if cache > 0 and ctx.mode != "disabled":
                # a copy: a view would keep all of x_ext alive until the next slice
                ctx.put("mem", x_ext[:, -cache:].clone())
        if gn is not None and self.k1 and self.gn_fusion:
            (norm, groups), x_ext = gn, x_ext.contiguous()
            with span("vae.group_norm"):
                scale, shift = conv3d_kernel.gn_silu_tables(x_ext, norm.w, norm.b, groups)
            return conv3d_kernel.conv3d_3x3x3(x_ext, self.w, self.b, scale, shift)
        if gn is not None:
            x_ext = gn_silu(x_ext, *gn)
        if self.k1:
            return conv3d_kernel.conv3d_3x3x3(x_ext.contiguous(), self.w, self.b)
        with span("vae.conv_plain"):
            (ht, hb), (wl, wr) = self.spatial_pad
            xc = x_ext.permute(0, 4, 1, 2, 3)
            if (ht, wl) == (hb, wr):
                y = F.conv3d(xc, self.w, None, self.stride, padding=(0, ht, wl))
            else:
                y = F.conv3d(F.pad(xc, (wl, wr, ht, hb)), self.w, None, self.stride)
            return y.permute(0, 2, 3, 4, 1) + self.b
