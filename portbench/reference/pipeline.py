"""One batch of SeedVR2 upscaling in plain PyTorch, float32: the frames as
uint8 codes in, the upscaled frames as 8-bit codes out.

1. Resize so that the short side is ``resolution`` (the long side floored),
   bicubic with antialias (a = -0.5), clamp to [0, 1], zero-pad bottom and
   right to a multiple of 16, scale to [-1, 1].
2. VAE encode, the posterior's mode, (mode - shift) * scaling_factor.
3. One Euler step of the rectified flow from t = T: the DiT sees [noise |
   latent | 1] and the text embedding at timestep T; with the v_lerp
   prediction the step returns noise - prediction. The noise is the
   program's documented draw: torch.randn of the latent's (t, h, w, C)
   shape, float32, from a generator on the run's device seeded with the
   request's seed.
4. VAE decode of latent / scaling_factor + shift.
5. Trim to the true size (even), the wavelet colour fix (five levels of a
   dilated 3 x 3 binomial blur with replicated edges: the decoded frame's
   high frequencies plus the transformed input's low ones, clamped to
   [-1, 1]), then codes floor((x / 2 + 1 / 2) * 255 + 1 / 2).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .dit import DiT
from .numerics import Numerics, strict_fp32
from .vae import VAE


def config(raw: dict) -> SimpleNamespace:
    """A configuration file's sections as attribute namespaces (lists as
    tuples)."""
    def ns(d):
        return SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    return SimpleNamespace(dit=ns(raw["dit"]), vae=ns(raw["vae"]), diffusion=ns(raw["diffusion"]))


def resize_dims(h: int, w: int, resolution: int) -> Tuple[int, int]:
    short, long_ = (h, w) if h <= w else (w, h)
    new_long = int(resolution * long_ / short)
    return (resolution, new_long) if h <= w else (new_long, resolution)


def transform(frames: torch.Tensor, resolution: int) -> torch.Tensor:
    """uint8 [T, h, w, 3] -> float32 [T, 3, H16, W16] in [-1, 1]."""
    x = frames.permute(0, 3, 1, 2).float() / 255.0
    th, tw = resize_dims(x.shape[2], x.shape[3], resolution)
    x = F.interpolate(x, size=(th, tw), mode="bicubic", align_corners=False, antialias=True).clamp(0.0, 1.0)
    x = F.pad(x, (0, (-tw) % 16, 0, (-th) % 16))
    return x * 2.0 - 1.0


_TAPS = ((1, 2, 1), (2, 4, 2), (1, 2, 1))


def blur(x: torch.Tensor, radius: int) -> torch.Tensor:
    H, W = x.shape[-2:]
    r = min(radius, max(1, min(H, W) // 8))
    p = F.pad(x, (r, r, r, r), mode="replicate")
    out = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            out += p[..., i * r : i * r + H, j * r : j * r + W] * (_TAPS[i][j] / 16.0)
    return out


def wavelet_fix(content: torch.Tensor, style: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """[T, 3, H, W] each in [-1, 1]."""
    def split(x):
        high = torch.zeros_like(x)
        for i in range(levels):
            low = blur(x, 2**i)
            high += x - low
            x = low
        return high, x

    return (split(content)[0] + split(style)[1]).clamp(-1.0, 1.0)


class Reference:
    """The plain model of one configuration file over one pair of state
    dicts in the published layouts; ``precision`` "fp8" is the control."""

    def __init__(self, raw_config: dict, dit_sd: Dict[str, torch.Tensor], vae_sd: Dict[str, torch.Tensor],
                 text: torch.Tensor, precision: str = "fp32"):
        self.cfg = config(raw_config)
        num = Numerics(precision)
        self.dit = DiT(self.cfg.dit, dit_sd, num)
        self.vae = VAE(self.cfg.vae, vae_sd, num)
        self.text = text.float()

    @torch.no_grad()
    def upscale(self, frames: torch.Tensor, resolution: int, seed: int) -> torch.Tensor:
        """uint8 frames [T, h, w, 3] (T = 1 or 5) on the device -> uint8
        codes [T, true_h, true_w, 3] on the device."""
        vc, dc = self.cfg.vae, self.cfg.diffusion
        if (dc.sampling_steps, dc.cfg_scale, dc.prediction_type) != (1, 1.0, "v_lerp"):
            raise NotImplementedError("one v_lerp step without guidance")
        with strict_fp32():
            tv = transform(frames, resolution)
            T = tv.shape[0]
            th, tw = resize_dims(frames.shape[1], frames.shape[2], resolution)
            true_h, true_w = th // 2 * 2, tw // 2 * 2
            moments = self.vae.encode(tv.permute(1, 0, 2, 3)[None])
            latent = (moments[:, : vc.latent_channels] - vc.shifting_factor) * vc.scaling_factor
            latent = latent.permute(0, 2, 3, 4, 1)  # [1, t, h, w, C]
            del moments
            gen = torch.Generator(device=frames.device).manual_seed(seed)
            noise = torch.randn(tuple(latent.shape[1:]), generator=gen, device=frames.device, dtype=torch.float32)[None]
            cond = torch.cat([latent, torch.ones_like(latent[..., :1])], dim=-1)
            t = torch.full((1,), dc.schedule_T, dtype=torch.float32, device=frames.device)
            pred = self.dit.forward(torch.cat([noise, cond], dim=-1), self.text[None], t)
            x0 = noise - pred
            del pred, cond, noise, latent
            z = x0 / vc.scaling_factor + vc.shifting_factor
            dec = self.vae.decode(z.permute(0, 4, 1, 2, 3))[0].permute(1, 0, 2, 3)  # [T, 3, H, W]
            dec = dec[:T, :, :true_h, :true_w]
            fixed = wavelet_fix(dec, tv[:, :, :true_h, :true_w])
            codes = ((fixed * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0 + 0.5).floor()
        return codes.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
