"""Causal 3D video VAE, channels-last [B, T, H, W, C] (counterpart of
seedvr2_tpu/models/vae/model.py). 8x spatial / 4x temporal, per-frame
GroupNorm, mid-block per-frame single-head attention, folded upsampling.

Encoder: conv_in -> 4 down blocks (2 resnets; spatial down on blocks 0-2,
temporal down on 1-2) -> mid -> GroupNorm/SiLU/conv_out -> 2*latent.
Decoder mirrors it with 3-resnet up blocks and folded upsamples.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...config import VAEConfig
from ...ops.mid_attention import mid_attention
from ...ops.normalization import group_norm_frames
from ...utils.spans import span
from ..params import ONES, ZEROS, Leaf, Linear
from .causal_conv import CausalConv3d, StreamCtx, gn_silu
from .folded_upsample import FoldedUpsample


def _norm(c: int, device, dtype) -> Leaf:
    return Leaf({"w": ((c,), (ONES, 0.0)), "b": ((c,), (ZEROS, 0.0))}, device, dtype)


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: VAEConfig, device, dtype):
        super().__init__()
        kt1 = 3 if cfg.time_receptive_field == "full" else 1
        self.groups = cfg.norm_num_groups
        self.norm1 = _norm(cin, device, dtype)
        self.conv1 = CausalConv3d((kt1, 3, 3), cin, cout, device, dtype)
        self.norm2 = _norm(cout, device, dtype)
        self.conv2 = CausalConv3d((3, 3, 3), cout, cout, device, dtype)
        if cin != cout:
            self.conv_shortcut = CausalConv3d((1, 1, 1), cin, cout, device, dtype, spatial_pad=((0, 0), (0, 0)))

    def forward(self, x, ctx: StreamCtx, name: str):
        with ctx.scope(name):
            h = self.conv1(x, ctx, "conv1", gn=(self.norm1, self.groups))
            h = self.conv2(h, ctx, "conv2", gn=(self.norm2, self.groups))
            if hasattr(self, "conv_shortcut"):
                x = self.conv_shortcut(x, ctx, "shortcut")
            return x + h


class MidAttention(nn.Module):
    """Per-frame single-head 2D self-attention with residual: the q, k and v
    projections once over every frame's pixels, then ops/mid_attention.py
    (K10 on the card: fp32 logits and softmax, never the n x n logits in
    memory; the plain version on the CPU) for all frames at once; the whole
    call a "vae.mid_attention" range (utils/spans.py)."""

    def __init__(self, c: int, cfg: VAEConfig, device, dtype):
        super().__init__()
        self.groups = cfg.norm_num_groups
        self.group_norm = _norm(c, device, dtype)
        for n in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, n, Linear(c, c, device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        with span("vae.mid_attention"):
            with span("vae.group_norm"):
                h = group_norm_frames(x, self.group_norm.w, self.group_norm.b, self.groups, silu=False)
            h = h.reshape(B * T, H * W, C)
            out = mid_attention(self.to_q(h), self.to_k(h), self.to_v(h))
            return self.to_out(out).reshape(B, T, H, W, C) + x


class Mid(nn.Module):
    def __init__(self, c: int, cfg: VAEConfig, device, dtype):
        super().__init__()
        self.resnet0 = Resnet(c, c, cfg, device, dtype)
        if cfg.mid_block_attention:
            self.attn = MidAttention(c, cfg, device, dtype)
        self.resnet1 = Resnet(c, c, cfg, device, dtype)

    def forward(self, x, ctx: StreamCtx, name: str):
        with ctx.scope(name):
            x = self.resnet0(x, ctx, "resnet0")
            if hasattr(self, "attn"):
                x = self.attn(x)
            return self.resnet1(x, ctx, "resnet1")


class Block(nn.Module):
    """A down block (``downsample``) or an up block (``upsample``)."""

    def __init__(self, resnets, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, sampler)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        self.conv_in = CausalConv3d((3, 3, 3), cfg.in_channels, boc[0], device, dtype)
        cin = boc[0]
        for i, cout in enumerate(boc):
            resnets = [Resnet(cin if j == 0 else cout, cout, cfg, device, dtype) for j in range(cfg.layers_per_block)]
            down = None
            if i < cfg.num_blocks - 1:
                td = cfg.encoder_temporal_down(i)
                down = CausalConv3d(
                    (3 if td else 1, 3, 3), cout, cout, device, dtype, stride=(2 if td else 1, 2, 2),
                    spatial_pad=((0, 1), (0, 1)), temporal_pad=1 if td else 0,
                )
            setattr(self, f"down{i}", Block(resnets, "downsample", down))
            cin = cout
        self.mid = Mid(boc[-1], cfg, device, dtype)
        self.norm_out = _norm(boc[-1], device, dtype)
        self.conv_out = CausalConv3d((3, 3, 3), boc[-1], 2 * cfg.latent_channels, device, dtype)

    def forward(self, x: torch.Tensor, ctx: StreamCtx) -> torch.Tensor:
        """[B, T, H, W, 3] -> moments [B, T', H/8, W/8, 2*latent]."""
        with ctx.scope("encoder"):
            h = self.conv_in(x, ctx, "conv_in")
            for i in range(self.cfg.num_blocks):
                blk = getattr(self, f"down{i}")
                with ctx.scope(f"down{i}"):
                    for j, rn in enumerate(blk.resnets):
                        h = rn(h, ctx, f"resnet{j}")
                    if hasattr(blk, "downsample"):
                        h = blk.downsample(h, ctx, "downsample")
            h = self.mid(h, ctx, "mid")
            return self.conv_out(gn_silu(h, self.norm_out, self.cfg.norm_num_groups), ctx, "conv_out")


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv3d((3, 3, 3), cfg.latent_channels, rev[0], device, dtype)
        self.mid = Mid(rev[0], cfg, device, dtype)
        cin = rev[0]
        for i, cout in enumerate(rev):
            resnets = [
                Resnet(cin if j == 0 else cout, cout, cfg, device, dtype) for j in range(cfg.layers_per_block + 1)
            ]
            up = None
            if i < cfg.num_blocks - 1:
                up = FoldedUpsample(cout, cfg.decoder_temporal_up(i), device, dtype)
            setattr(self, f"up{i}", Block(resnets, "upsample", up))
            cin = cout
        self.norm_out = _norm(rev[-1], device, dtype)
        self.conv_out = CausalConv3d((3, 3, 3), rev[-1], cfg.out_channels, device, dtype)

    def forward(self, z: torch.Tensor, ctx: StreamCtx) -> torch.Tensor:
        """[B, T', H', W', latent] -> [B, 4(T'-1)+1, 8H', 8W', 3]."""
        with ctx.scope("decoder"):
            h = self.conv_in(z, ctx, "conv_in")
            h = self.mid(h, ctx, "mid")
            for i in range(self.cfg.num_blocks):
                blk = getattr(self, f"up{i}")
                with ctx.scope(f"up{i}"):
                    for j, rn in enumerate(blk.resnets):
                        h = rn(h, ctx, f"resnet{j}")
                    if hasattr(blk, "upsample"):
                        h = blk.upsample(h, ctx, "upsample")
            return self.conv_out(gn_silu(h, self.norm_out, self.cfg.norm_num_groups), ctx, "conv_out")


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None, dtype=torch.bfloat16, gn_fusion: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device, dtype)
        self.decoder = Decoder(cfg, device, dtype)
        self.set_gn_fusion(gn_fusion)

    def set_gn_fusion(self, on: bool) -> "VAE":
        """Fold each resnet's GroupNorm + SiLU into its K1-routed conv (K4)
        or not (normalise first, then K1). The counterpart of the JAX
        package's module-global causal_conv.set_gn_fusion, held by the
        model; off by default, as there."""
        self.gn_fusion = bool(on)
        for m in self.modules():
            if isinstance(m, CausalConv3d):
                m.gn_fusion = self.gn_fusion
        return self


def posterior_mode(moments: torch.Tensor) -> torch.Tensor:
    """Mean of the diagonal Gaussian: the first half of the channels."""
    return moments[..., : moments.shape[-1] // 2]


def posterior_sample(moments: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A draw of the diagonal Gaussian: mean + exp(logvar / 2) * eps in
    fp32, logvar clipped to [-30, 20], returned in the moments' type.
    ``eps``: standard normal noise of the mean's shape; drawn from
    ``generator`` (fp32, on the moments' device) when not given."""
    c = moments.shape[-1] // 2
    mean = moments[..., :c]
    std = torch.exp(0.5 * moments[..., c:].clamp(-30.0, 20.0).float())
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=moments.device, dtype=torch.float32)
    return (mean.float() + std * eps).to(mean.dtype)
