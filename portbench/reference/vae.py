"""The causal video VAE (8x space, 4x time) in plain PyTorch, float32,
channels first [B, C, T, H, W], on the published checkpoint's keys and
layouts (``spec``).

A causal convolution extends the clip's head by repeating its first frame
twice (a 3-tap time kernel) and pads space symmetrically by 1, or, in the
encoder's downsamplers, by one row and column at the bottom and right. Its
work is done a few output frames at a time, so that no padded copy of a
whole activation is ever made. GroupNorm (eps 1e-6) takes statistics per
frame. The decoder upsamples as MAGViT does: a 1x1x1 expansion to
4 (or 8) x C channels, depth to space (and to time), the duplicated second
frame dropped after a time upsample, then a 3x3x3 causal convolution at the
new size. The mid blocks hold per-frame single-head attention over all
pixels, computed in blocks of query rows.

Only a clip that one pass covers is taken (5 frames or 1), as the
program's fused path encodes and decodes it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .numerics import Numerics

CHUNK_BYTES = 2 << 30  # the largest padded input slab of one convolution call


BIAS_STD = 0.1  # every bias: N(0, BIAS_STD^2)
NORM_STD = 0.2  # every norm weight: 1 + N(0, NORM_STD^2)
EXPAND_STD = 0.2  # the upsamplers' expansion: identity + N(0, EXPAND_STD^2 / C)


def spec(cfg) -> List[Tuple[str, tuple, str, float]]:
    """(key, shape, init, scale) of every tensor of the checkpoint. init:
    "normal" (N(0, scale^2)), "1+normal" (1 + N(0, scale^2)),
    "identity+normal" (the expansion's weight[o, i] = [o % C == i] +
    N(0, scale^2)). Every bias, norm weight and the expansion differ from
    the trivial values, so that no affine term of the program can be left
    out unseen."""
    out = []

    def bias(key, c):
        out.append((f"{key}.bias", (c,), "normal", BIAS_STD))

    def conv(key, cout, cin, k):
        out.append((f"{key}.weight", (cout, cin, *k), "normal", (k[0] * k[1] * k[2] * cin) ** -0.5))
        bias(key, cout)

    def norm(key, c):
        out.append((f"{key}.weight", (c,), "1+normal", NORM_STD))
        bias(key, c)

    def lin(key, c):
        out.append((f"{key}.weight", (c, c), "normal", c**-0.5))
        bias(key, c)

    kt1 = 3 if cfg.time_receptive_field == "full" else 1

    def resnet(key, cin, cout):
        norm(f"{key}.norm1", cin)
        conv(f"{key}.conv1", cout, cin, (kt1, 3, 3))
        norm(f"{key}.norm2", cout)
        conv(f"{key}.conv2", cout, cout, (3, 3, 3))
        if cin != cout:
            conv(f"{key}.conv_shortcut", cout, cin, (1, 1, 1))

    def mid(key, c):
        resnet(f"{key}.resnets.0", c, c)
        resnet(f"{key}.resnets.1", c, c)
        if cfg.mid_block_attention:
            norm(f"{key}.attentions.0.group_norm", c)
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(f"{key}.attentions.0.{n}", c)

    boc = list(cfg.block_out_channels)
    nb = len(boc)
    conv("encoder.conv_in", boc[0], cfg.in_channels, (3, 3, 3))
    cin = boc[0]
    for i, cout in enumerate(boc):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < nb - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout, (3 if temporal_down(cfg, i) else 1, 3, 3))
        cin = cout
    mid("encoder.mid_block", boc[-1])
    norm("encoder.conv_norm_out", boc[-1])
    conv("encoder.conv_out", 2 * cfg.latent_channels, boc[-1], (3, 3, 3))

    rev = boc[::-1]
    conv("decoder.conv_in", rev[0], cfg.latent_channels, (3, 3, 3))
    mid("decoder.mid_block", rev[0])
    cin = rev[0]
    for i, cout in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < nb - 1:
            ratio = 8 if temporal_up(cfg, i) else 4
            key = f"decoder.up_blocks.{i}.upsamplers.0"
            out.append((f"{key}.upscale_conv.weight", (ratio * cout, cout, 1, 1, 1), "identity+normal",
                        EXPAND_STD * cout**-0.5))
            bias(f"{key}.upscale_conv", ratio * cout)
            conv(f"{key}.conv", cout, cout, (3, 3, 3))
        cin = cout
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", cfg.out_channels, rev[-1], (3, 3, 3))
    return out


def temporal_down(cfg, i: int) -> bool:
    nb = len(cfg.block_out_channels)
    return nb - cfg.temporal_scale_num - 1 <= i < nb - 1


def temporal_up(cfg, i: int) -> bool:
    return i < cfg.temporal_scale_num and i < len(cfg.block_out_channels) - 1


class VAE:
    def __init__(self, cfg, sd: Dict[str, torch.Tensor], num: Numerics):
        self.cfg, self.sd, self.num = cfg, sd, num

    # ------------------------------ layers ------------------------------ #

    def conv(self, key: str, x: torch.Tensor, stride=(1, 1, 1), pad_hw=((1, 1), (1, 1)), tpad=None) -> torch.Tensor:
        """Causal conv: x [B, C, T, H, W] -> [B, Cout, T', H', W']."""
        w, b = self.sd[f"{key}.weight"], self.sd[f"{key}.bias"]
        kt = w.shape[2]
        tpad = (kt - 1) // 2 if tpad is None else tpad
        B, C, T, H, W = x.shape
        (ht, hb), (wl, wr) = pad_hw
        src = [0] * (2 * tpad) + list(range(T))  # frames of the extended clip
        t_out = (len(src) - kt) // stride[0] + 1
        per = max(1, CHUNK_BYTES // (B * C * (H + ht + hb) * (W + wl + wr) * 4 * max(kt, stride[0])))
        outs = []
        for o0 in range(0, t_out, per):
            o1 = min(t_out, o0 + per)
            frames = src[o0 * stride[0] : (o1 - 1) * stride[0] + kt]
            xs = x[:, :, frames]
            if (ht, hb, wl, wr) != (0, 0, 0, 0):
                xs = F.pad(xs, (wl, wr, ht, hb))
            outs.append(self.num.conv3d(xs, w, b, stride, 0))
            del xs
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)

    def group_norm(self, key: str, x: torch.Tensor, silu: bool) -> torch.Tensor:
        """Per-frame GroupNorm (statistics per (b, t)), then SiLU."""
        w, b = self.sd[f"{key}.weight"].float(), self.sd[f"{key}.bias"].float()
        out = torch.empty_like(x)
        for t in range(x.shape[2]):
            y = F.group_norm(x[:, :, t], self.cfg.norm_num_groups, w, b, eps=1e-6)
            out[:, :, t] = F.silu(y) if silu else y
        return out

    def resnet(self, key: str, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(f"{key}.conv1", self.group_norm(f"{key}.norm1", x, True))
        h = self.conv(f"{key}.conv2", self.group_norm(f"{key}.norm2", h, True))
        if f"{key}.conv_shortcut.weight" in self.sd:
            x = self.conv(f"{key}.conv_shortcut", x, pad_hw=((0, 0), (0, 0)))
        return x + h

    def attention(self, key: str, x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
        B, C, T, H, W = x.shape
        h = self.group_norm(f"{key}.group_norm", x, False)
        num, sd = self.num, self.sd
        out = torch.empty_like(x)
        for b in range(B):
            for t in range(T):
                tok = h[b, :, t].reshape(C, H * W).t()  # [HW, C]
                q = num.linear(tok, sd[f"{key}.to_q.weight"], sd[f"{key}.to_q.bias"])
                k = num.linear(tok, sd[f"{key}.to_k.weight"], sd[f"{key}.to_k.bias"])
                v = num.linear(tok, sd[f"{key}.to_v.weight"], sd[f"{key}.to_v.bias"])
                o = torch.empty_like(q)
                for r in range(0, H * W, rows):
                    p = torch.softmax(num.matmul(q[r : r + rows], k.t()) * C**-0.5, dim=-1)
                    o[r : r + rows] = num.matmul(p, v)
                o = num.linear(o, sd[f"{key}.to_out.0.weight"], sd[f"{key}.to_out.0.bias"])
                out[b, :, t] = o.t().reshape(C, H, W)
        return out + x

    def mid(self, key: str, x: torch.Tensor) -> torch.Tensor:
        x = self.resnet(f"{key}.resnets.0", x)
        if self.cfg.mid_block_attention:
            x = self.attention(f"{key}.attentions.0", x)
        return self.resnet(f"{key}.resnets.1", x)

    def upsample(self, key: str, x: torch.Tensor, tup: bool) -> torch.Tensor:
        B, C, T, H, W = x.shape
        tz = 2 if tup else 1
        y = self.num.conv3d(x, self.sd[f"{key}.upscale_conv.weight"], self.sd[f"{key}.upscale_conv.bias"], 1, 0)
        # channel o = ((sh * 2 + sw) * tz + st) * C + c
        y = y.reshape(B, 2, 2, tz, C, T, H, W).permute(0, 4, 5, 3, 6, 1, 7, 2).reshape(B, C, T * tz, 2 * H, 2 * W)
        if tup:
            y = torch.cat([y[:, :, :1], y[:, :, 2:]], dim=2)
        return self.conv(f"{key}.conv", y)

    # ------------------------------ halves ------------------------------ #

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, T, H, W] in [-1, 1] -> moments [B, 2 * latent, T', H/8, W/8]."""
        cfg = self.cfg
        h = self.conv("encoder.conv_in", x)
        for i in range(len(cfg.block_out_channels)):
            p = f"encoder.down_blocks.{i}"
            for j in range(cfg.layers_per_block):
                h = self.resnet(f"{p}.resnets.{j}", h)
            if i < len(cfg.block_out_channels) - 1:
                td = temporal_down(cfg, i)
                h = self.conv(f"{p}.downsamplers.0.conv", h, stride=(2 if td else 1, 2, 2), pad_hw=((0, 1), (0, 1)),
                              tpad=1 if td else 0)
        h = self.mid("encoder.mid_block", h)
        return self.conv("encoder.conv_out", self.group_norm("encoder.conv_norm_out", h, True))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, latent, T', h, w] -> [B, 3, 4 (T' - 1) + 1, 8h, 8w]."""
        cfg = self.cfg
        h = self.conv("decoder.conv_in", z)
        h = self.mid("decoder.mid_block", h)
        for i in range(len(cfg.block_out_channels)):
            p = f"decoder.up_blocks.{i}"
            for j in range(cfg.layers_per_block + 1):
                h = self.resnet(f"{p}.resnets.{j}", h)
            if i < len(cfg.block_out_channels) - 1:
                h = self.upsample(f"{p}.upsamplers.0", h, temporal_up(cfg, i))
        return self.conv("decoder.conv_out", self.group_norm("decoder.conv_norm_out", h, True))
